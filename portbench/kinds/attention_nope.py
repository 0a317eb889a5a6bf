"""Attention with no positional encoding (NoPE), as Jamba's attention
layers: qkv rows [q | k | v] with no biases and no head norms, causal
softmax at scale head_dim^-1/2 (MQA where kv_heads is 1), then the out
projection. The work of one call is full attention's."""

from __future__ import annotations

from .full_attention import attention_work, decode_work, prefill_work  # noqa: F401

# the kernel group that serves this kind's attention core
KERNEL_GROUP = "attention"


def linears(spec):
    h, g, dh, d = spec.heads, spec.kv_heads, spec.head_dim, spec.d
    return [("qkv", (h + 2 * g) * dh, d), ("out", d, h * dh)]


def vectors(spec):
    return []


def port_mixer(spec, cm, norm):
    """The port's AttentionConfig (`cm`: `uzu_tpu_torch.config.model`)."""
    return cm.AttentionConfig(
        qkv_projection_config=cm.LinearConfig(), out_projection_config=cm.LinearConfig(),
        query_norm_config=None, key_norm_config=None,
        num_heads=spec.heads, num_groups=spec.kv_heads, head_dim=spec.head_dim,
        is_causal=True, scale=None, sliding_window_size=None, logit_soft_cap=None,
        has_sinks=False, has_qkv_biases=False, has_out_biases=False,
        gate_projection_config=None, normalize_values=False, is_kv_sharing=False)


def port_rope(spec, cm):
    return None


def port_params(raw, p, quantized):
    return {"qkv": {"w": quantized(p + "qkv")}, "out": {"w": quantized(p + "out")}}

"""GQA attention with per-head RMS QK norm and RoPE: qkv rows [q | k | v],
then the out projection."""

from __future__ import annotations

# the kernel group that serves this kind's attention core
KERNEL_GROUP = "attention"


def linears(spec):
    h, g, dh, d = spec.heads, spec.kv_heads, spec.head_dim, spec.d
    return [("qkv", (h + 2 * g) * dh, d), ("out", d, h * dh)]


def vectors(spec):
    return [("q_norm", (spec.head_dim,), 0.1), ("k_norm", (spec.head_dim,), 0.1)]


def port_mixer(spec, cm, norm):
    """The port's AttentionConfig (`cm`: `uzu_tpu_torch.config.model`)."""
    return cm.AttentionConfig(
        qkv_projection_config=cm.LinearConfig(), out_projection_config=cm.LinearConfig(),
        query_norm_config=norm(spec.qk_norm_eps), key_norm_config=norm(spec.qk_norm_eps),
        num_heads=spec.heads, num_groups=spec.kv_heads, head_dim=spec.head_dim,
        is_causal=True, scale=None, sliding_window_size=None, logit_soft_cap=None,
        has_sinks=False, has_qkv_biases=False, has_out_biases=False,
        gate_projection_config=None, normalize_values=False, is_kv_sharing=False)


def port_rope(spec, cm):
    return cm.UnscaledRoPEConfig(base=spec.rope_theta, max_sequence_length=spec.max_positions,
                                 head_dim=spec.head_dim)


def port_params(raw, p, quantized):
    return {"qkv": {"w": quantized(p + "qkv")}, "out": {"w": quantized(p + "out")},
            "q_norm_scales": raw[p + "q_norm"], "k_norm_scales": raw[p + "k_norm"]}


def attention_work(spec, q_rows: int, keys_sum: int, kv_tokens: int):
    """(FLOPs, bytes) of one layer's attention core: `q_rows` query rows
    attending to `keys_sum` keys in all, over `kv_tokens` distinct cached
    tokens. FLOPs: QK^T and PV, 2 per multiply-add; bytes: K and V of the
    distinct tokens read once, Q read and O written once, all bf16."""
    h, g, dh = spec.heads, spec.kv_heads, spec.head_dim
    return 4 * h * dh * keys_sum, 2 * 2 * g * dh * kv_tokens + 2 * 2 * h * dh * q_rows


def prefill_work(spec, pos0: int, take: int):
    """A prefill chunk of `take` real rows from position `pos0`, causal."""
    return attention_work(spec, take, take * pos0 + take * (take + 1) // 2, pos0 + take)


def decode_work(spec, lengths):
    """One decode step: each live row attends to its `length` keys."""
    total = int(sum(lengths))
    return attention_work(spec, len(lengths), total, total)

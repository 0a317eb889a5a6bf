"""Jamba (`model_type` "jamba"): Mamba-1 mixers with NoPE attention where
`i % attn_layer_period == attn_layer_offset`, a dense SwiGLU feed-forward
in every layer when `num_experts` is 1, RMSNorm, a tied embedding.

The Mamba sizes ride on `JambaSpec`: d_inner = mamba_expand * hidden_size,
the state width, dt's rank and the conv's taps (`conv_kernel`). A program
without a Mamba-1 mixer config cannot build the model: `spec` says so
before any kernel is built, so such a run fails at once."""

from __future__ import annotations

import dataclasses

from ..spec import ModelSpec


@dataclasses.dataclass(frozen=True)
class JambaSpec(ModelSpec):
    inner: int = 0  # d_inner
    state: int = 0  # d_state (N)
    dt_rank: int = 0


def spec(c: dict) -> JambaSpec:
    from uzu_tpu_torch.config import model as port_model

    if not hasattr(port_model, "Mamba1Config"):
        raise RuntimeError("the program has no Mamba-1 mixer (uzu_tpu_torch.config.model."
                           "Mamba1Config): it cannot build a Jamba model")
    if c["num_experts"] != 1:
        raise ValueError("a Jamba with experts needs a family-supplied MoE feed-forward, "
                         "which the harness does not build")
    n, d, heads = c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"]
    kinds = tuple("attention_nope" if i % c["attn_layer_period"] == c["attn_layer_offset"]
                  else "mamba1" for i in range(n))
    return JambaSpec(
        name=c["name"], d=d, ffn=c["intermediate_size"], vocab=c["vocab_size"], kinds=kinds,
        heads=heads, kv_heads=c["num_key_value_heads"], head_dim=d // heads,
        norm_eps=c["rms_norm_eps"], qk_norm_eps=c["rms_norm_eps"], rope_theta=0.0,
        max_positions=c["max_position_embeddings"], conv_kernel=c["mamba_d_conv"],
        inner=c["mamba_expand"] * d, state=c["mamba_d_state"], dt_rank=c["mamba_dt_rank"])

"""LFM2 (`model_type` "lfm2"): ShortConv layers (in_proj to B, C, x; B*x
through a depthwise causal conv of `conv_L_cache` taps; C times that;
out_proj) with GQA full-attention layers where `layer_types` says so
(per-head RMS QK norm), SwiGLU, RMSNorm, RoPE.

The feed-forward width follows the config's auto-adjust rule when
`block_auto_adjust_ff_dim` is set: 2/3 of `block_ff_dim`, times
`block_ffn_dim_multiplier`, rounded up to `block_multiple_of`."""

from __future__ import annotations

from ..spec import ModelSpec


def ff_dim(c: dict) -> int:
    ff = c["block_ff_dim"]
    if c.get("block_auto_adjust_ff_dim"):
        ff = int(2 * ff / 3)
        mult = c.get("block_ffn_dim_multiplier")
        if mult is not None:
            ff = int(mult * ff)
        m = c["block_multiple_of"]
        ff = m * ((ff + m - 1) // m)
    return ff


def spec(c: dict) -> ModelSpec:
    d, heads = c["hidden_size"], c["num_attention_heads"]
    kinds = tuple("conv" if t == "conv" else "full_attention" for t in c["layer_types"])
    if len(kinds) != c["num_hidden_layers"]:
        raise ValueError("layer_types must name every layer")
    return ModelSpec(
        name=c["name"], d=d, ffn=ff_dim(c), vocab=c["vocab_size"], kinds=kinds,
        heads=heads, kv_heads=c["num_key_value_heads"], head_dim=d // heads,
        norm_eps=c["norm_eps"], qk_norm_eps=c["norm_eps"], rope_theta=float(c["rope_theta"]),
        max_positions=c["max_position_embeddings"], conv_kernel=c["conv_L_cache"])

"""Qwen3 dense (`model_type` "qwen3"): GQA with per-head RMS QK norm,
SwiGLU, RMSNorm, RoPE, every layer full attention."""

from __future__ import annotations

from ..spec import ModelSpec


def spec(c: dict) -> ModelSpec:
    n = c["num_hidden_layers"]
    return ModelSpec(
        name=c["name"], d=c["hidden_size"], ffn=c["intermediate_size"], vocab=c["vocab_size"],
        kinds=tuple(c.get("layer_types") or ["full_attention"] * n),
        heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], norm_eps=c["rms_norm_eps"], qk_norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), max_positions=c["max_position_embeddings"])

"""Tiny cells of both families for the CPU tests: the configs' shapes cut
to a test's size, and a closed-loop mix of three clients."""

from __future__ import annotations

import copy

QWEN = {"name": "tiny-qwen3", "model_type": "qwen3", "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 1e6, "vocab_size": 256,
        "max_position_embeddings": 4096,
        "engine": {"kind": "paged", "batch_size": 3, "decode_chunk": 4, "max_context": 256,
                   "page_size": 16, "num_pages": 3 * 16 + 1, "prefill_buckets": [16, 32, 64]}}
LFM2 = {"name": "tiny-lfm2", "model_type": "lfm2", "hidden_size": 64, "block_ff_dim": 192,
        "block_auto_adjust_ff_dim": True, "block_ffn_dim_multiplier": 1.0,
        "block_multiple_of": 32, "num_hidden_layers": 3,
        "layer_types": ["conv", "full_attention", "conv"], "num_attention_heads": 4,
        "num_key_value_heads": 2, "norm_eps": 1e-5, "rope_theta": 1e6, "vocab_size": 256,
        "max_position_embeddings": 4096, "conv_L_cache": 3,
        "engine": {"kind": "dense", "batch_size": 3, "decode_chunk": 4, "max_context": 256,
                   "prefill_buckets": [16, 32, 64]}}
MIX = {"loop": "closed", "clients": 3, "prompt": {"dist": "log_uniform", "min": 20, "max": 150},
       "output": {"dist": "uniform", "min": 4, "max": 12}, "warm_completions": 3, "sample_tokens": 24}
E2E = [{"name": n, "unit": u} for n, u in (("output_tok_s", "tokens/s"), ("ttft_p90_ms", "ms"),
                                           ("tpot_p90_ms", "ms"), ("setup_s", "s"))]


def loaded(config: dict, limit: float = 0.25) -> dict:
    """A cell as `harness.load_cell` gives it."""
    return {"cell": {"name": "tiny." + config["name"], "chips": 1},
            "config": copy.deepcopy(config), "mix": dict(MIX),
            "limits": {"max_logit_gap": {"limit": limit}}, "end_to_end": E2E, "per_layer": []}

"""Decoding state: per-layer KV caches + global position.

Counterpart of `uzu_tpu/models/state.py`: a fixed [C, G, Dh] cache of
`max_context` slots per attention layer (slot j holds position j) and the
position as a 0-d int32 tensor on the device, so a decode step advances it
without a host sync. KV-shared layers own no cache.
"""

from __future__ import annotations

import torch

from ..config.model import AttentionConfig, DecoderConfig
from .kv_cache import make_cache


def init_state(
    cfg: DecoderConfig,
    max_context: int,
    dtype=torch.bfloat16,
    *,
    device=None,
    kv_quant: bool = False,
    ring_windows: bool = False,
    ring_extra: int = 0,
) -> dict:
    layers = []
    for layer_cfg in cfg.transformer_config.layer_configs:
        m = layer_cfg.mixer_config
        if not isinstance(m, AttentionConfig):
            raise NotImplementedError(
                f"{type(m).__name__} mixers (recurrent state) are not ported yet")
        if m.is_kv_sharing or layer_cfg.kv_source_layer_index is not None:
            layers.append(None)
        else:
            layers.append(make_cache(
                m.num_groups, m.head_dim, max_context, dtype, device=device,
                quantized=kv_quant,
                window=m.sliding_window_size if ring_windows else None,
                ring_extra=ring_extra))
    return {
        "layers": layers,
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


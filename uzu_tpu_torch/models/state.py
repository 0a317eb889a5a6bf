"""Decoding state: per-layer KV caches / recurrent states + global position.

Counterpart of `uzu_tpu/models/state.py`: a fixed [C, G, Dh] cache of
`max_context` slots per attention layer (slot j holds position j; with
`ring_windows`, a sliding-window layer keeps a ring of window +
ring_extra slots instead, `models/kv_cache.py`), the
conv tail and recurrent state of each recurrent mixer (`models/ssm.py`),
and the position as a 0-d int32 tensor on the device, so a decode step
advances it without a host sync. KV-shared layers own no cache.
`LanguageModel.new_state(batch_size=B)` stacks every leaf on a leading
[B] dimension (a ring's caches [B, c, G, Dh] and positions [B, c]).
"""

from __future__ import annotations

import torch

from ..config.model import AttentionConfig, DecoderConfig
from .kv_cache import make_cache
from .ssm import make_ssm_state


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
            layers.append(make_ssm_state(m, cfg.transformer_config.model_dim, dtype, device))
        elif m.is_kv_sharing or layer_cfg.kv_source_layer_index is not None:
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


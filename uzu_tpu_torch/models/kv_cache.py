"""KV cache, full contiguous layout; counterpart of `uzu_tpu/models/kv_cache.py`.

Slot i holds position i ([C, G, Dh]); rollback and padding are free
because slots >= pos are invisible to the causal mask. The JAX package's
other layouts (INT8 codes + scales, the sliding-window ring) wait for a
later slice of the port, with kernel K4.

Unlike the JAX package, whose arrays are immutable, `append` writes the
new rows into the cache tensors in place and returns the same dict.
"""

from __future__ import annotations

import torch


def make_cache(
    num_groups: int,
    head_dim: int,
    max_context: int,
    dtype=torch.bfloat16,
    *,
    device=None,
    quantized: bool = False,
    window: int | None = None,
    ring_extra: int = 0,
) -> dict:
    if quantized:
        raise NotImplementedError("INT8 KV caches are not ported yet")
    if window and window < max_context:
        raise NotImplementedError("ring (sliding-window) KV caches are not ported yet")
    shape = (max_context, num_groups, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def append(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
           positions: torch.Tensor, true_length=None) -> dict:
    """Write S new rows at slots positions[0] .. positions[0]+S-1, in place.

    The start is clamped so the rows fit, as `lax.dynamic_update_slice`
    does in the JAX package; positions may live on the device, so no host
    sync happens here. `true_length` needs no handling in this layout:
    padded rows land in future slots that the causal mask hides."""
    s = k_new.shape[0]
    c = cache["k"].shape[0]
    start = torch.clamp(positions[0].long(), 0, c - s)
    idx = start + torch.arange(s, device=positions.device)
    cache["k"].index_copy_(0, idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(0, idx, v_new.to(cache["v"].dtype))
    return cache


def read(cache: dict):
    """-> (k, v, kv_positions or None)."""
    return cache["k"], cache["v"], cache.get("pos")

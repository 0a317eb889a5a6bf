"""KV cache, full contiguous layout; counterpart of `uzu_tpu/models/kv_cache.py`.

Slot i holds position i ([C, G, Dh]); rollback and padding are free
because slots >= pos are invisible to the causal mask. Two layouts:

  {"k", "v"}                    full, bf16 or f32
  {"k_q", "k_s", "v_q", "v_s"}  full INT8: codes [C, G, Dh] int8 + f32
                                scales [C, G], one absmax scale per
                                (slot, kv-head) over head_dim

The JAX package's sliding-window ring layout waits for a later slice of
the port.

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
    if window and window < max_context:
        raise NotImplementedError("ring (sliding-window) KV caches are not ported yet")
    shape = (max_context, num_groups, head_dim)
    if quantized:
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:2], dtype=torch.float32, device=device),
            "v_s": torch.zeros(shape[:2], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def is_quantized(cache: dict) -> bool:
    return "k_q" in cache


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 codes [..., Dh], f32 scales [...]): absmax / 127
    per row, round half to even, as the JAX package's `_quantize_rows`."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The f32 values INT8 codes stand for (codes * scale per row)."""
    return codes.float() * scales.float()[..., None]


def append(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
           positions: torch.Tensor, true_length=None) -> dict:
    """Write S new rows at slots positions[0] .. positions[0]+S-1, in place.

    The start is clamped so the rows fit, as `lax.dynamic_update_slice`
    does in the JAX package; positions may live on the device, so no host
    sync happens here. `true_length` needs no handling in this layout:
    padded rows land in future slots that the causal mask hides."""
    s = k_new.shape[0]
    if is_quantized(cache):
        k_q, k_s = quantize_rows(k_new)
        v_q, v_s = quantize_rows(v_new)
        rows = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    else:
        rows = {"k": k_new, "v": v_new}
    c = next(iter(cache.values())).shape[0]
    start = torch.clamp(positions[0].long(), 0, c - s)
    idx = start + torch.arange(s, device=positions.device)
    for name, new in rows.items():
        cache[name].index_copy_(0, idx, new.to(cache[name].dtype))
    return cache


def read(cache: dict):
    """-> (k, v, kv_positions or None); an INT8 cache is dequantized to f32
    (attention over a contiguous cache reads the codes instead, through
    `read_quantized` and kernel K4)."""
    if is_quantized(cache):
        return (dequantize_rows(cache["k_q"], cache["k_s"]),
                dequantize_rows(cache["v_q"], cache["v_s"]), cache.get("pos"))
    return cache["k"], cache["v"], cache.get("pos")


def read_quantized(cache: dict):
    """-> (k codes, k scales, v codes, v scales) of an INT8 cache."""
    return cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"]

"""KV cache layouts; counterpart of `uzu_tpu/models/kv_cache.py`.

- full: slot i holds position i ([C, G, Dh]); rollback and padding are
  free because slots >= pos are invisible to the causal mask;
- ring: a sliding-window layer keeps only c = min(window + ring_extra,
  max_context) slots, position p in slot p % c, with a per-slot position
  array "pos" [c] that the attention masks with (NEG_POS in an empty
  slot, which fails the window test; a global layer sharing a windowed
  layer's ring masks causally alone and so sees it, as in the JAX
  package). ring_extra (the largest prefill chunk)
  keeps a chunk written before its queries attend from evicting keys
  those queries still need;
- int8: codes [C, G, Dh] int8 + f32 scales [C, G], one absmax scale per
  (slot, kv-head) over head_dim. It composes with the ring.

The dict's keys are the layout's tag:
  {"k", "v"}                    full, bf16 or f32
  {"k", "v", "pos"}             ring
  {"k_q", "k_s", "v_q", "v_s"}  full INT8
  {..., "pos"}                  INT8 ring

A batched state (the dense `BatchEngine`) stacks these on a leading [B]
dimension: caches [B, c, G, Dh] and, for a ring, "pos" [B, c].

Unlike the JAX package, whose arrays are immutable, `append` writes the
new rows into the cache tensors in place and returns the same dict.
"""

from __future__ import annotations

import torch

NEG_POS = -(1 << 30)  # "empty slot" position: fails every sliding-window test


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
    """One layer's cache: a ring where `window` < max_context."""
    c = min(window + ring_extra, max_context) if window else max_context
    shape = (c, num_groups, head_dim)
    if quantized:
        cache = {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    else:
        cache = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    if window and window < max_context:
        cache["pos"] = torch.full((c,), NEG_POS, dtype=torch.int32, device=device)
    return cache


def is_ring(cache: dict) -> bool:
    return "pos" in cache


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


def _ring_write(cache: dict, rows: dict, positions: torch.Tensor, true_length) -> None:
    """The ring branch of `append`: keep the rows at positions p with
    positions[0] + true_length - c <= p < positions[0] + true_length, each
    into slot p % c, and drop the rest, as the JAX package does. No host
    sync (positions and true_length may be device tensors), and no scatter
    with repeated indices, whose order is unspecified on the card: where S
    <= c the S consecutive positions fall in distinct slots and a dropped
    row writes back the slot's old contents; a longer chunk is gathered
    slot by slot instead (slot j takes the kept row that lands there, if
    any)."""
    c = cache["pos"].shape[0]
    s = positions.shape[0]
    positions = positions.to(torch.int32)
    end = positions[0] + true_length  # the first position not written
    keep = (positions < end) & (positions >= end - c)
    rows = dict(rows, pos=positions)
    if s <= c:
        idx = (positions.long() % c)
        for name, new in rows.items():
            buf = cache[name]
            k = keep.reshape((s,) + (1,) * (buf.ndim - 1))
            buf.index_copy_(0, idx, torch.where(k, new.to(buf.dtype), buf.index_select(0, idx)))
        return
    slot = torch.arange(c, device=positions.device)
    hit = (positions.long()[None, :] % c == slot[:, None]) & keep[None, :]  # [c, S]
    found = hit.any(dim=1)
    row = hit.to(torch.int8).argmax(dim=1)
    for name, new in rows.items():
        buf = cache[name]
        f = found.reshape((c,) + (1,) * (buf.ndim - 1))
        buf.copy_(torch.where(f, new.to(buf.dtype).index_select(0, row), buf))


def append(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
           positions: torch.Tensor, true_length=None) -> dict:
    """Write S new rows at their positions, in place.

    Full layout: slots positions[0] .. positions[0]+S-1, the start clamped
    so the rows fit, as `lax.dynamic_update_slice` does in the JAX package;
    `true_length` needs no handling there: padded rows land in future slots
    that the causal mask hides. Ring: see `_ring_write`; padded rows share
    slots (mod c) with live data, so they are dropped. positions are
    consecutive and may live on the device: no host sync happens here."""
    s = k_new.shape[0]
    if is_quantized(cache):
        k_q, k_s = quantize_rows(k_new)
        v_q, v_s = quantize_rows(v_new)
        rows = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    else:
        rows = {"k": k_new, "v": v_new}
    if is_ring(cache):
        _ring_write(cache, rows, positions, s if true_length is None else true_length)
        return cache
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

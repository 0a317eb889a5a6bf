"""Paged KV cache: a shared page pool + per-slot page tables.

Counterpart of `uzu_tpu/models/paged_kv.py`. B slots do not preallocate
B x max_context KV: they draw fixed-size pages from a shared per-layer
pool as they grow, so KV memory follows the tokens actually held, and a
shared prompt prefix is one set of physical pages that several page
tables point at. Reads go through the paged decode-attention kernels
(`ops/cuda/paged_attention.py`, K5/K6); writes are indexed writes into the
pool at (table[pos // page], pos % page).

The pool is [G, P, page, Dh] per layer; the page table [B, MAXP] int32.
The host-side `PagePool` (plain numpy, a copy of the JAX package's) owns
the free list and the refcounts; tables travel to the device per dispatch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config.model import AttentionConfig
from .kv_cache import quantize_rows


class PagePoolOverflow(RuntimeError):
    pass


@dataclasses.dataclass
class PagePool:
    """Host-side page allocator (free list + per-slot logical page lists)."""

    num_pages: int
    page_size: int

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._slots: dict[int, list[int]] = {}
        self._refcount = np.zeros(self.num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def ensure(self, slot: int, num_tokens: int) -> list[int]:
        """Grow slot's page list to cover num_tokens; returns the list."""
        pages = self._slots.setdefault(slot, [])
        needed = -(-num_tokens // self.page_size)
        while len(pages) < needed:
            if not self._free:
                raise PagePoolOverflow(
                    f"pool exhausted ({self.num_pages} pages of {self.page_size})"
                )
            p = self._free.pop()
            self._refcount[p] += 1
            pages.append(p)
        return pages

    def share_prefix(self, src_slot: int, dst_slot: int, num_pages: int) -> None:
        """Point dst's first pages at src's (copy-on-write is the caller's
        job: fit for immutable shared prompt prefixes). Refcounts rise
        before dst is released, so a self-share (src == dst) cannot drop a
        still-owned page to refcount 0 and onto the free list."""
        src = self._slots.get(src_slot, [])[:num_pages]
        for p in src:
            self._refcount[p] += 1
        self.release(dst_slot)
        self._slots[dst_slot] = list(src)

    def release(self, slot: int) -> None:
        for p in self._slots.pop(slot, []):
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    def pages(self, slot: int) -> list[int]:
        """The slot's current logical->physical page list (possibly empty)."""
        return list(self._slots.get(slot, []))

    def table(self, slot: int, max_pages: int, fill: int = 0) -> np.ndarray:
        """[MAXP] int32 page table (`fill`-padded tail; mask via lengths)."""
        pages = self._slots.get(slot, [])
        out = np.full(max_pages, fill, np.int32)
        out[: len(pages)] = pages
        return out


def init_pools(decoder_config, num_pages: int, page_size: int,
               dtype=torch.bfloat16, quantized: bool = False, device=None) -> list:
    """Per-layer page pools (None for KV-shared layers): bf16 -> (k_pool,
    v_pool) [G, P, page, Dh]; quantized (INT8 KV, the dense caches'
    per-(token, kv-head) absmax scheme) -> (k_q, k_s, v_q, v_s) with codes
    [G, P, page, Dh] int8 + scales [G, P, page] f32, half the bytes of the
    bf16 pool. The tuple's length tells the two apart."""
    pools = []
    for lc in decoder_config.transformer_config.layer_configs:
        m = lc.mixer_config
        if isinstance(m, AttentionConfig) and not m.is_kv_sharing \
                and lc.kv_source_layer_index is None:
            shape = (m.num_groups, num_pages, page_size, m.head_dim)
            if quantized:
                sshape = shape[:3]
                pools.append((
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(sshape, dtype=torch.float32, device=device),
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(sshape, dtype=torch.float32, device=device),
                ))
            else:
                pools.append((torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device)))
        else:
            pools.append(None)
    return pools


def append_token(pool_kv, k_new, v_new, physical_page, offset):
    """Write one token's K/V rows [G, Dh] into a bf16/f32 pool at
    (physical_page, offset), in place; returns the pool tuple."""
    k_pool, v_pool = pool_kv
    k_pool[:, physical_page, offset] = k_new.to(k_pool.dtype)
    v_pool[:, physical_page, offset] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def write_rows(pool_kv, k_new, v_new, pages, offsets):
    """Write N tokens' K/V rows [N, G, Dh] into the pool at (pages[i],
    offsets[i]) with one indexed write per pool tensor, in place. An INT8
    pool quantizes the rows first. Where two rows share an index the
    write order is unspecified: the callers send only rows bound for the
    trash page there."""
    pages, offsets = pages.long(), offsets.long()
    if len(pool_kv) == 4:
        k_pool, k_s, v_pool, v_s = pool_kv
        k_q, k_sc = quantize_rows(k_new)
        v_q, v_sc = quantize_rows(v_new)
        k_pool[:, pages, offsets] = k_q.transpose(0, 1)
        v_pool[:, pages, offsets] = v_q.transpose(0, 1)
        k_s[:, pages, offsets] = k_sc.transpose(0, 1)
        v_s[:, pages, offsets] = v_sc.transpose(0, 1)
    else:
        k_pool, v_pool = pool_kv
        k_pool[:, pages, offsets] = k_new.transpose(0, 1).to(k_pool.dtype)
        v_pool[:, pages, offsets] = v_new.transpose(0, 1).to(v_pool.dtype)
    return pool_kv

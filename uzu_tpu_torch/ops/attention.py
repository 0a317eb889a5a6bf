"""GQA attention over a KV cache; counterpart of `uzu_tpu/ops/attention.py`.

Causal masking against absolute token positions, sliding window, tanh
logit soft cap, attention sinks (per-head extra softmax logit), f32
softmax accumulation. The cache layout is [C, G, Dh] with slot j holding
token position j unless `kv_positions` says otherwise; queries carry
absolute positions so prefill chunks and decode steps share one code path.

Dispatch mirrors the JAX package's kernel mode: wherever the flash kernel's
semantic gate holds (causal, contiguous layout, no tree or padding mask,
enough query rows), the call goes to K3 (`ops/cuda/flash_attention.py`),
or to K4 when the cache is INT8 codes with `k_scales`/`v_scales`. Decode
widths and the other masks stay on the plain einsum / online-softmax paths
below, in f32; an INT8 cache is dequantized for them.
"""

from __future__ import annotations

import torch

from ..models.kv_cache import dequantize_rows
from .cuda import flash_attention as fa

NEG_INF = -1e30
ONLINE_CHUNK = 1024
ONLINE_MIN_S = 64  # below this many query rows the fused einsum wins


def attention_reference(
    q: torch.Tensor,  # [S, H, Dh]
    k_cache: torch.Tensor,  # [C, G, Dh]
    v_cache: torch.Tensor,  # [C, G, Dh]
    q_positions: torch.Tensor,  # [S] absolute token positions of queries
    *,
    scale: float,
    is_causal: bool = True,
    sliding_window_size: int | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # [H]
    kv_positions: torch.Tensor | None = None,  # [C], defaults to arange
    kv_valid_length=None,  # mask kv slots >= this (bidirectional padding)
    suffix_start=None,  # slot index where tree-suffix nodes begin
    suffix_mask: torch.Tensor | None = None,  # [S, M] ancestor mask
    k_scales: torch.Tensor | None = None,  # [C, G] f32: k/v are INT8 codes
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    rep = h // g

    if fa.supported(s, h, g, dh, c, is_causal=is_causal, suffix_mask=suffix_mask,
                    kv_valid_length=kv_valid_length, kv_positions=kv_positions):
        if k_scales is None:
            k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
        out = fa.flash_attention(
            q, k_cache, v_cache, q_positions, scale=scale,
            sliding_window_size=sliding_window_size,
            logit_soft_cap=logit_soft_cap, sinks=sinks,
            k_scales=k_scales, v_scales=v_scales)
        return out.to(q.dtype)
    if k_scales is not None:
        k_cache = dequantize_rows(k_cache, k_scales)
        v_cache = dequantize_rows(v_cache, v_scales)

    if suffix_mask is None and s >= ONLINE_MIN_S and c % ONLINE_CHUNK == 0:
        return attention_online(
            q, k_cache, v_cache, q_positions, scale=scale, is_causal=is_causal,
            sliding_window_size=sliding_window_size, logit_soft_cap=logit_soft_cap,
            sinks=sinks, kv_positions=kv_positions, kv_valid_length=kv_valid_length,
        )
    dev = q.device
    if kv_positions is None:
        kv_positions = torch.arange(c, dtype=torch.int32, device=dev)

    qf = q.float().reshape(s, g, rep, dh)
    scores = torch.einsum("sgrd,cgd->grsc", qf, k_cache.float()) * scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)

    qpos = q_positions.to(torch.int32)[:, None]  # [s, 1]
    kpos = kv_positions.to(torch.int32)[None, :]  # [1, c]
    valid = kpos <= qpos if is_causal else torch.ones((s, c), dtype=torch.bool, device=dev)
    if suffix_mask is not None:
        # tree verification: slots [suffix_start, suffix_start+M) hold tree
        # nodes whose visibility is the ancestor matrix, not position order
        m = suffix_mask.shape[1]
        slot = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        in_suffix = (slot >= suffix_start) & (slot < suffix_start + m)
        idx = torch.clamp(slot - suffix_start, 0, m - 1).expand(s, c).long()
        tree_ok = torch.gather(suffix_mask, 1, idx)
        valid = torch.where(in_suffix, tree_ok, valid)
    if kv_valid_length is not None:
        valid = valid & (kpos < kv_valid_length)
    if sliding_window_size is not None:
        valid = valid & (kpos > qpos - sliding_window_size)
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))

    if sinks is not None:
        sink = sinks.float().reshape(g, rep, 1, 1).expand(g, rep, s, 1)
        probs = torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :c]
    else:
        probs = torch.softmax(scores, dim=-1)

    out = torch.einsum("grsc,cgd->sgrd", probs, v_cache.float())
    return out.reshape(s, h, dh).to(q.dtype)


def attention_online(
    q: torch.Tensor,  # [S, H, Dh]
    k_cache: torch.Tensor,  # [C, G, Dh]
    v_cache: torch.Tensor,  # [C, G, Dh]
    q_positions: torch.Tensor,  # [S]
    *,
    scale: float,
    is_causal: bool = True,
    sliding_window_size: int | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    kv_valid_length=None,
) -> torch.Tensor:
    """Online softmax over KV chunks with running (max, sum, acc): O(S*chunk)
    score memory instead of O(S*C)."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    rep = h // g
    chunk = min(ONLINE_CHUNK, c)
    if c % chunk:
        raise ValueError(f"context {c} is not a multiple of the chunk {chunk}")
    dev = q.device
    if kv_positions is None:
        kv_positions = torch.arange(c, dtype=torch.int32, device=dev)

    qf = q.float().reshape(s, g, rep, dh)
    qpos = q_positions.to(torch.int32)
    m_run = torch.full((g, rep, s), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((g, rep, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((g, rep, s, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, c, chunk):
        k_blk = k_cache[c0:c0 + chunk].float()
        v_blk = v_cache[c0:c0 + chunk].float()
        kpos = kv_positions[c0:c0 + chunk].to(torch.int32)[None, :]
        scores = torch.einsum("sgrd,cgd->grsc", qf, k_blk) * scale
        if logit_soft_cap is not None:
            scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
        valid = (kpos <= qpos[:, None] if is_causal
                 else torch.ones((s, chunk), dtype=torch.bool, device=dev))
        if kv_valid_length is not None:
            valid = valid & (kpos < kv_valid_length)
        if sliding_window_size is not None:
            valid = valid & (kpos > qpos[:, None] - sliding_window_size)
        scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("grsc,cgd->grsd", p, v_blk)
        m_run = m_new

    if sinks is not None:
        sink = sinks.float().reshape(g, rep, 1)
        m_new = torch.maximum(m_run, sink)
        l_run = l_run * torch.exp(m_run - m_new) + torch.exp(sink - m_new)
        acc = acc * torch.exp(m_run - m_new)[..., None]

    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.permute(2, 0, 1, 3).reshape(s, h, dh).to(q.dtype)

"""Sequence-parallel prefill: a prompt's rows split over the ranks of a
group.

Counterpart of `uzu_tpu/parallel/seqpar.py`, with two designs:

- `sequence_parallel_prefill`: each rank embeds and projects its slice of
  the end-padded prompt; K/V and their positions are all-gathered in every
  attention layer (`decoder_forward(seq_group=...)`), so every rank's
  cache holds the whole chunk and its queries (at pos0 + r·s_local ..)
  attend over the whole context. MLP, norms and the readout run on 1/n of
  the rows. The logits come from the rank owning the last real row,
  broadcast to every rank. Attention mixers only.
- `ring_attention`: the primitive for a sequence-split cache: K/V blocks
  travel the ring (`batch_isend_irecv`) while each rank folds them into a
  running online-softmax accumulator, so no rank holds the whole context.
  Tested against the attention reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.decoder import decoder_forward

NEG_INF = -1e30
SP_AXIS = "sp"


def _ring_shift(tensors: list, group) -> list:
    """Each tensor to the next rank of the ring; the previous rank's back."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(
    q: torch.Tensor,  # [S_l, H, Dh] this rank's query block
    k: torch.Tensor,  # [S_l, G, Dh] this rank's key block
    v: torch.Tensor,  # [S_l, G, Dh]
    q_positions: torch.Tensor,  # [S_l] absolute positions of the local queries
    kv_positions: torch.Tensor,  # [S_l] absolute positions of the local keys
    *,
    group,
    scale: float,
    is_causal: bool = True,
    sliding_window_size: int | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # [H]
) -> torch.Tensor:
    """Blockwise (ring) attention with online softmax; the KV block travels
    the ring while the accumulator stays put. Returns [S_l, H, Dh]."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    s, h, dh = q.shape
    g = k.shape[1]
    rep = h // g
    qf = q.float().reshape(s, g, rep, dh)
    qpos = q_positions.long()

    m_run = torch.full((g, rep, s), NEG_INF, device=q.device)
    l_run = torch.zeros((g, rep, s), device=q.device)
    acc = torch.zeros((g, rep, s, dh), device=q.device)
    blk = [k.float(), v.float(), kv_positions.long()]
    for step in range(n):
        k_blk, v_blk, p_blk = blk
        scores = torch.einsum("sgrd,cgd->grsc", qf, k_blk) * scale
        if logit_soft_cap is not None:
            scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
        kpos = p_blk[None, :]
        valid = kpos <= qpos[:, None] if is_causal else torch.ones_like(kpos <= qpos[:, None])
        if sliding_window_size is not None:
            valid = valid & (kpos > qpos[:, None] - sliding_window_size)
        scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("grsc,cgd->grsd", p, v_blk)
        m_run = m_new
        if step < n - 1:
            blk = _ring_shift(blk, group)
    if sinks is not None:
        sink = sinks.float().reshape(g, rep)[:, :, None]
        m_new = torch.maximum(m_run, sink)
        l_run = l_run * torch.exp(m_run - m_new) + torch.exp(sink - m_new)
        acc = acc * torch.exp(m_run - m_new)[..., None]
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.permute(2, 0, 1, 3).reshape(s, h, dh).to(q.dtype)


def make_sp_mesh(n: int | None = None, device_type: str | None = None):
    """A one-axis ("sp",) mesh over every rank of the default process group
    (n, if given, must be the world size)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import initialize
    from .mesh import _default_device_type

    device_type = device_type or _default_device_type()
    initialize(device_type=device_type)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"an sp mesh of {n} needs a world of {n} ranks, not {world}")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(SP_AXIS,))


def sequence_parallel_prefill(cfg, params, state, tokens, mesh, axis: str = SP_AXIS):
    """Prefill `tokens` with their rows split over `mesh[axis]`. params and
    state are whole on every rank and every rank's state comes out the
    same (the cache is written from the gathered K/V); tokens are
    end-padded to a multiple of the axis size, the padded rows landing at
    future cache slots the causal mask hides. Returns (logits [V] of the
    last real row, new_state), the same on every rank."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    tokens = np.asarray(tokens, np.int64)
    true_len = len(tokens)
    s_pad = -(-true_len // n) * n
    s_local = s_pad // n
    padded = np.zeros(s_pad, np.int64)
    padded[:true_len] = tokens
    dev = state["pos"].device
    toks = torch.from_numpy(padded[r * s_local:(r + 1) * s_local]).to(dev)
    positions = (state["pos"] + r * s_local
                 + torch.arange(s_local, dtype=torch.int32, device=dev)).to(torch.int32)
    row = min(max(true_len - 1 - r * s_local, 0), s_local - 1)
    logits, new_state = decoder_forward(cfg, params, toks, state, last_only=True,
                                        true_length=true_len, positions=positions,
                                        readout_row=row, seq_group=group)
    logits = logits[0].contiguous()
    owner = (true_len - 1) // s_local
    dist.broadcast(logits, src=dist.get_global_rank(group, owner), group=group)
    return logits, new_state

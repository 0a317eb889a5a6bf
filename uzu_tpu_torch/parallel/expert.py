"""Expert parallelism (EP): MoE experts split over ranks, tokens sent to
their experts' owners with all-to-all.

Counterpart of `uzu_tpu/parallel/expert.py`, with the same capacity-based
dispatch over `torch.distributed.all_to_all_single`:

  router (whole on every rank, local tokens)
    -> per-assignment destination = expert_id // experts_per_rank
    -> capacity-bucketed send buffer [n_ranks, capacity, D]
    -> all-to-all (tokens travel to their experts)
    -> local experts compute (masked dense over the rank's E/n experts)
    -> all-to-all back
    -> weighted combine at the source rows

Assignments beyond `capacity` per destination are dropped (the router's
weight for that expert is lost). With capacity >= S*K every assignment
fits and the result equals the single-rank `moe_forward`.

`params`' expert leaves are this rank's [E/n, ...] slice of the stacks
(`Split(dim=0)` over the group); the router and shared experts are whole;
x is this rank's token slice. The local compute is the JAX package's
masked dense f32 einsum over dequantized local stacks, which is no Pallas
kernel there, so plain PyTorch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config.model import MixtureOfExpertsConfig
from ..models.moe import _expert_hidden, router_topk
from ..quant.format import StackedQuantized, dequantize_stacked


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row block i of `t` to rank i; row block j of the result from rank j."""
    import torch.distributed as dist

    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def moe_forward_ep(cfg: MixtureOfExpertsConfig, params: dict, x: torch.Tensor, *,
                   group, capacity: int) -> torch.Tensor:
    """x [S_local, D] -> [S_local, D] in x's dtype."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    s, d = x.shape
    e_total = cfg.num_routed_experts
    if e_total % n:
        raise ValueError(f"{e_total} experts do not split over {n} ranks")
    e_local = e_total // n
    kk = cfg.num_active_routed_experts
    dev = x.device

    ids, probs = router_topk(cfg, params, x)  # [S, K]
    flat_ids = ids.reshape(-1)
    flat_probs = probs.reshape(-1).float()
    src_row = torch.arange(s, device=dev).repeat_interleave(kk)
    dest = flat_ids // e_local
    eid_local = flat_ids % e_local

    # position of each assignment in its destination bucket (stable, in
    # assignment order): a cumsum over a one-hot, as the JAX package does
    onehot = F.one_hot(dest, n)
    before = torch.cumsum(onehot, 0) - onehot
    pos_in_dest = before.gather(1, dest[:, None])[:, 0]
    keep = pos_in_dest < capacity
    slot = torch.where(keep, dest * capacity + pos_in_dest,
                       torch.full_like(dest, n * capacity))

    send_x = x.new_zeros((n * capacity + 1, d))
    send_x[slot] = x[src_row]
    send_eid = torch.full((n * capacity + 1,), -1, dtype=torch.long, device=dev)
    send_eid[slot] = eid_local
    recv_x = _all_to_all(send_x[:-1], group).float()
    recv_eid = _all_to_all(send_eid[:-1], group)

    valid = recv_eid >= 0
    w13, w2 = params["up"]["w"], params["down"]["w"]  # [E_local, 2*dff, D], [E_local, D, dff]
    if isinstance(w13, StackedQuantized):
        w13, w2 = dequantize_stacked(w13), dequantize_stacked(w2)
    up = torch.einsum("ad,ehd->aeh", recv_x, w13.float())
    if "b" in params["up"]:
        up = up + params["up"]["b"].float()[None]
    out = torch.einsum("aeh,edh->aed", _expert_hidden(cfg, up), w2.float())
    if "b" in params["down"]:
        out = out + params["down"]["b"].float()[None]
    sel = F.one_hot(recv_eid.clamp(0, e_local - 1), e_local).float() * valid[:, None].float()
    y_assign = torch.einsum("aed,ae->ad", out, sel)  # [n*capacity, D]

    back = _all_to_all(y_assign, group)
    contrib = back[slot.clamp(max=n * capacity - 1)] * keep[:, None].float()
    y = torch.zeros((s, d), dtype=torch.float32, device=dev)
    y.index_add_(0, src_row, contrib * flat_probs[:, None])

    if "shared" in params:
        fused = x.float() @ params["shared"]["up"]["w"].float().t()
        y = y + _expert_hidden(cfg, fused) @ params["shared"]["down"]["w"].float().t()
    return y.to(x.dtype)


def default_capacity(num_tokens: int, cfg: MixtureOfExpertsConfig, n_ranks: int,
                     factor: float = 1.25) -> int:
    """Per-destination bucket size: the balanced load S*K/n, padded by
    `factor` for routing skew and rounded up to a multiple of 8."""
    base = (num_tokens * cfg.num_active_routed_experts + n_ranks - 1) // n_ranks
    cap = int(base * factor)
    return max(8, -(-cap // 8) * 8)

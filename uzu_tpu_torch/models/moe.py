"""Mixture-of-experts MLP block; counterpart of `uzu_tpu/models/moe.py`.

Semantics: router logits = x @ Wrᵀ + br; top-k with ties to the lower
expert id; softmax over the k selected logits (SoftmaxRouting, else the
raw logits) as combine weights; expert e computes
down_e(act(clip(gate)) * clip(up)) with [up | gate] = up_e(x) + bias; the
block returns sum_k prob_k * expert_k(x), plus, where the model has
shared experts (DeepSeek-style), their dense output for every row, in
plain f32 ops as the JAX package computes it outside any kernel.

Which path a forward of S rows takes follows the JAX package's Pallas
mode, decided on S and on the stack's type alone (the port's kernels take
any shape, so the Mosaic tiling gates are not copied):

| experts | S <= 4 (decode) | 4 < S < 1024 | S >= 1024 |
|---|---|---|---|
| INT4 `StackedQuantized` | K7 | K9 | K9 |
| INT8 `StackedQuantized` | K8 | dequantized bf16 stack, masked loop | dequantized, K10 |
| dense | gather (plain ops) | masked loop (plain ops) | K10 |

Every step stays on the device: a stable sort picks the top k, the grouped
layout keeps its used-tile count on the device, and the per-token combine
is a fixed-order sum over the k pairs of each token (no atomics), so no
host sync enters a decode step and greedy output repeats run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config.model import MixtureOfExpertsConfig, SoftmaxRouting
from ..ops.activation import gated_act_mul
from ..ops.cuda.grouped_matmul import grouped_matmul, grouped_matmul_quant, route_layout
from ..ops.cuda.moe_gemv import moe_expert_gemv
from ..quant.format import StackedQuantized, dequantize_stacked

# at or below this many rows, read only the routed experts' weights
GATHER_PATH_MAX_TOKENS = 4
# at or above this many rows, dense stacks take the grouped kernel (K10)
GROUPED_PATH_MIN_TOKENS = 1024


def router_topk(cfg: MixtureOfExpertsConfig, params: dict, x: torch.Tensor):
    """x [S, D] -> (ids [S, K] int64, probs [S, K] f32)."""
    logits = x.float() @ params["router"]["w"].float().t()
    if "b" in params["router"]:
        logits = logits + params["router"]["b"].float()
    k = cfg.num_active_routed_experts
    # a stable descending sort puts the lower expert id first among ties
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    probs = torch.softmax(vals, dim=-1) if isinstance(cfg.routing_function,
                                                      SoftmaxRouting) else vals
    return ids, probs


def _expert_hidden(cfg: MixtureOfExpertsConfig, up_out: torch.Tensor) -> torch.Tensor:
    """up_out [..., 2*dff] (biases added) -> f32 hidden [..., dff]."""
    ecfg = cfg.expert_config
    dff = up_out.shape[-1] // 2
    return gated_act_mul(ecfg.activation, up_out[..., dff:].float(), up_out[..., :dff].float(),
                         ecfg.gate_clipping, ecfg.up_clipping)


def _combine(out: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """out [S*K, N] pair rows in (token, k) order -> [S, N]: each token's k
    rows weighted by their probs, summed in k order."""
    s, k = probs.shape
    return (out.reshape(s, k, -1) * probs[..., None]).sum(1)


def _gather_forward(cfg, params, xf, ids, probs):
    """S <= GATHER_PATH_MAX_TOKENS: one row per (token, expert) pair; a
    quantized stack goes through K7/K8, a dense one through plain ops."""
    w13, w2 = params["up"]["w"], params["down"]["w"]
    flat = ids.reshape(-1)
    x_pairs = xf.repeat_interleave(cfg.num_active_routed_experts, dim=0)

    def expert_mm(w, rows):
        if isinstance(w, StackedQuantized):
            return moe_expert_gemv(w, rows, flat)
        return torch.einsum("pk,pnk->pn", rows, w[flat].float())

    up_out = expert_mm(w13, x_pairs)
    if "b" in params["up"]:
        up_out = up_out + params["up"]["b"][flat].float()
    out = expert_mm(w2, _expert_hidden(cfg, up_out))
    if "b" in params["down"]:
        out = out + params["down"]["b"][flat].float()
    return _combine(out, probs)


def _grouped_forward(cfg, params, x, ids, probs):
    """Rows sorted by expert into 64-row tiles (`route_layout`); both expert
    matmuls run over the routed rows only: K9 on an INT4 stack (f32 rows,
    dequantized in the kernel), K10 on a dense one (rows in its dtype)."""
    w13, w2 = params["up"]["w"], params["down"]["w"]
    quant = isinstance(w13, StackedQuantized)
    mm = grouped_matmul_quant if quant else grouped_matmul
    k = cfg.num_active_routed_experts
    order, dst, tile_expert, used, row_expert = route_layout(
        ids.reshape(-1), cfg.num_routed_experts)
    row_dtype = torch.float32 if quant else w13.dtype
    x_pad = x.new_zeros((row_expert.shape[0], x.shape[1]), dtype=row_dtype)
    x_pad[dst] = x[order // k].to(row_dtype)
    up_out = mm(x_pad, w13, tile_expert, used)
    if "b" in params["up"]:
        up_out = up_out + params["up"]["b"][row_expert].float()
    hidden = _expert_hidden(cfg, up_out).to(torch.float32 if quant else w2.dtype)
    out = mm(hidden, w2, tile_expert, used)
    if "b" in params["down"]:
        out = out + params["down"]["b"][row_expert].float()
    row_of_pair = torch.empty_like(dst)
    row_of_pair[order] = dst
    return _combine(out[row_of_pair], probs)


def _masked_forward(cfg, params, xf, ids, probs):
    """Every expert over every row, combined with the routed probs (0 for
    an expert a row did not pick); plain f32 ops."""
    weight = torch.einsum("ske,sk->se", F.one_hot(ids, cfg.num_routed_experts).float(), probs)
    up_out = torch.einsum("sd,ehd->seh", xf, params["up"]["w"].float())
    if "b" in params["up"]:
        up_out = up_out + params["up"]["b"].float()[None]
    out = torch.einsum("seh,edh->sed", _expert_hidden(cfg, up_out), params["down"]["w"].float())
    if "b" in params["down"]:
        out = out + params["down"]["b"].float()[None]
    return torch.einsum("sed,se->sd", out, weight)


def _routed_forward(cfg, params, x, ids, probs):
    """The routed experts' combine, f32 [S, D], on the branch of the table
    in the module docstring."""
    s = x.shape[0]
    w13 = params["up"]["w"]
    if isinstance(w13, StackedQuantized) and s > GATHER_PATH_MAX_TOKENS:
        if w13.bits == 4 and params["down"]["w"].bits == 4:
            return _grouped_forward(cfg, params, x, ids, probs)
        # INT8: the chunk runs over dense bf16 stacks, made once per call
        params = {**params, "up": {**params["up"], "w": dequantize_stacked(w13)},
                  "down": {**params["down"], "w": dequantize_stacked(params["down"]["w"])}}
    if s >= GROUPED_PATH_MIN_TOKENS:
        return _grouped_forward(cfg, params, x, ids, probs)
    if s <= GATHER_PATH_MAX_TOKENS:
        return _gather_forward(cfg, params, x.float(), ids, probs)
    return _masked_forward(cfg, params, x.float(), ids, probs)


def moe_forward(cfg: MixtureOfExpertsConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [S, D] -> [S, D] in x's dtype."""
    ids, probs = router_topk(cfg, params, x)
    y = _routed_forward(cfg, params, x, ids, probs)
    if "shared" in params:
        fused = x.float() @ params["shared"]["up"]["w"].float().t()
        y = y + _expert_hidden(cfg, fused) @ params["shared"]["down"]["w"].float().t()
    return y.to(x.dtype)

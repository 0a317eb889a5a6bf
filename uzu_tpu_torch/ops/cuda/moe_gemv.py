"""K7/K8: expert-gather dequant GEMV over stacked INT4/INT8 expert weights.

Wrapper and plain PyTorch version of `csrc/moe_gemv.cu`, which replaces
`uzu_tpu/ops/pallas/moe_gemv.py::_int4_pair_kernel` (K7) and
`::_int8_pair_kernel` (K8). Row p of the result is
x_pairs[p] · dequant(W[ids[p]])ᵀ: one row per routed (token, expert) pair
of an MoE decode step. A CPU tensor takes `moe_expert_gemv_plain`; a CUDA
tensor launches the kernel or raises.

`moe_gemv_plan` is the launch plan, from shapes and the SM count only:
kw (warps over K per 16-row weight tile, from K and the code width: the
`small_kw` of K9's small route) and the blocks that walk the (pair, row
block) items. The kernel reads the pair ids on the device; the host
never does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ...quant.format import StackedQuantized, dequantize_stacked
from .build import LAUNCHES, check, library
from .flash_attention import num_sms
from .quant_matmul import (
    SMALL_ROWS,
    SMALL_STAGE_MAX,
    SMALL_WARPS,
    small_kw,
    staged_bytes,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, ctypes.c_float, _P, *[_I] * 12, _P]
MAX_PAIRS = 65535  # pairs a launch may hold


class MoePlan(NamedTuple):
    """A launch of K7/K8: kw warps over K per 16-row weight tile; `items`
    (pair, row block) items of SMALL_WARPS / kw tiles each, pair-major, in
    contiguous ranges: `first` blocks take `per_first` items each, the rest
    `per_second` each, `blocks` in all; `short` says why the items do not
    fill the SMs (empty when they do)."""

    kw: int
    items: int
    blocks: int
    first: int
    per_first: int
    per_second: int
    short: str = ""


def moe_gemv_plan(p: int, n: int, k: int, bits: int, sms: int) -> MoePlan:
    """The plan of P pairs over an [E, n, k] stack of `bits`-bit codes on a
    card with `sms` SMs. Shapes only: never the ids or the data.

    kw is `small_kw(k, bits)`: at INT4 the kw of K9's small route, so a
    row is the row K9 gives. An SM runs two blocks; its ceil(items / sms)
    items are split between a first-round block (the larger half) and a
    second-round one, so no SM holds two blocks of the larger count."""
    return plan_at_kw(p, n, small_kw(k, bits), sms)


def plan_at_kw(p: int, n: int, kw: int, sms: int) -> MoePlan:
    """`moe_gemv_plan`'s dealing of the items at a given kw."""
    items = p * -(-(-(-n // SMALL_ROWS)) // (SMALL_WARPS // kw))
    per_sm = -(-items // sms)
    per_first, per_second = -(-per_sm // 2), per_sm // 2
    first = min(sms, -(-items // per_first))
    rest = items - first * per_first
    blocks = first + (-(-rest // per_second) if rest > 0 else 0)
    short = "" if items >= sms else "fewer (pair, row block) items than SMs"
    return MoePlan(kw, items, blocks, first, per_first, per_second, short)


def gather_experts(sq: StackedQuantized, ids: torch.Tensor) -> StackedQuantized:
    """The stack of the planes `ids` names, in that order (a copy)."""
    sel = ids.long()
    return dataclasses.replace(sq, codes=sq.codes[sel], scales=sq.scales[sel])


def moe_expert_gemv_plain(sq: StackedQuantized, x_pairs: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Per pair: its expert's plane dequantized in f32, then the product in
    f32 (the oracle of the JAX package's tests)."""
    w = dequantize_stacked(gather_experts(sq, ids), torch.float32)
    return torch.einsum("pk,pnk->pn", x_pairs.float(), w)


def _lib():
    fn = library("moe_gemv").uz_moe_gemv
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def moe_expert_gemv(sq: StackedQuantized, x_pairs: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """x_pairs [P, K] f32, ids [P] expert per pair -> f32 [P, N]."""
    e, n, k = sq.shape
    p = x_pairs.shape[0]
    if x_pairs.dim() != 2 or x_pairs.shape[1] != k or tuple(ids.shape) != (p,):
        raise ValueError(f"moe_expert_gemv: x_pairs {tuple(x_pairs.shape)}, ids "
                         f"{tuple(ids.shape)} do not fit the stack {sq.shape}")
    if x_pairs.device.type == "cpu":
        return moe_expert_gemv_plain(sq, x_pairs, ids)
    if x_pairs.device.type != "cuda" or sq.codes.device != x_pairs.device \
            or ids.device != x_pairs.device:
        raise ValueError(f"moe_expert_gemv: x on {x_pairs.device}, ids on {ids.device}, "
                         f"codes on {sq.codes.device}")
    return launch_moe_gemv(sq, x_pairs, ids)


def launch_moe_gemv(sq: StackedQuantized, x_pairs: torch.Tensor, ids: torch.Tensor,
                    plan: MoePlan | None = None) -> torch.Tensor:
    """K7/K8's launch on the card under `plan`: `moe_gemv_plan`'s by
    default, or another kw to compare."""
    e, n, k = sq.shape
    p = x_pairs.shape[0]
    g = sq.group_size
    kg = -(-k // g)
    if sq.bits not in (4, 8) or k % 8 or g % 8 or not 1 <= p <= MAX_PAIRS:
        raise ValueError(f"moe_gemv kernel needs bits in (4, 8), K % 8 == 0, g % 8 == 0 and "
                         f"1 <= P <= {MAX_PAIRS} (bits={sq.bits}, K={k}, g={g}, P={p})")
    if staged_bytes(1, k) > SMALL_STAGE_MAX:
        raise ValueError(f"moe_gemv kernel: a staged row of K={k} takes "
                         f"{staged_bytes(1, k)} bytes of shared memory, over "
                         f"{SMALL_STAGE_MAX}")
    if x_pairs.dtype != torch.float32:
        raise ValueError(f"moe_gemv kernel takes f32 x_pairs, not {x_pairs.dtype}")
    if sq.codes.dtype != torch.uint8 or sq.scales.dtype not in (torch.bfloat16, torch.float32) \
            or tuple(sq.scales.shape) != (e, n, kg):
        raise ValueError(f"moe_gemv: codes must be uint8 and scales bf16 or f32 "
                         f"[{e}, {n}, {kg}], got {sq.codes.dtype} and {sq.scales.dtype} "
                         f"{tuple(sq.scales.shape)}")
    x_pairs = x_pairs.contiguous()
    ids32 = ids.to(torch.int32).contiguous()
    for t in (x_pairs, sq.codes, sq.scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("moe_gemv: x_pairs, codes and scales must be contiguous and "
                             "16-byte aligned")
    if plan is None:
        plan = moe_gemv_plan(p, n, k, sq.bits, num_sms(x_pairs.device))
    out = torch.empty((p, n), dtype=torch.float32, device=x_pairs.device)
    with torch.cuda.device(x_pairs.device):
        rc = _lib()(
            x_pairs.data_ptr(), ids32.data_ptr(), sq.codes.data_ptr(), sq.scales.data_ptr(),
            int(sq.scales.dtype == torch.bfloat16), float(sq.qbias_coeff), out.data_ptr(),
            p, n, k, g, e, sq.bits, int((k * sq.bits // 8) % 16 == 0), plan.kw, plan.blocks,
            plan.first, plan.per_first, plan.per_second, torch.cuda.current_stream().cuda_stream)
    check(rc, "moe_gemv")
    LAUNCHES["moe_gemv_int4" if sq.bits == 4 else "moe_gemv_int8"] += 1
    return out

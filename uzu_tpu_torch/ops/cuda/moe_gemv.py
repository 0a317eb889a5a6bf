"""K7/K8: expert-gather dequant GEMV over stacked INT4/INT8 expert weights.

Wrapper and plain PyTorch version of `csrc/moe_gemv.cu`, which replaces
`uzu_tpu/ops/pallas/moe_gemv.py::_int4_pair_kernel` (K7) and
`::_int8_pair_kernel` (K8). Row p of the result is
x_pairs[p] · dequant(W[ids[p]])ᵀ: one row per routed (token, expert) pair
of an MoE decode step. A CPU tensor takes `moe_expert_gemv_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...quant.format import StackedQuantized, dequantize_stacked
from .build import LAUNCHES, check, library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _I, _I, _P]
MAX_PAIRS = 65535  # the kernel's grid.y


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
    g = sq.group_size
    kg = -(-k // g)
    if sq.bits not in (4, 8) or k % 8 or g % 8 or not 1 <= p <= MAX_PAIRS:
        raise ValueError(f"moe_gemv kernel needs bits in (4, 8), K % 8 == 0, g % 8 == 0 and "
                         f"1 <= P <= {MAX_PAIRS} (bits={sq.bits}, K={k}, g={g}, P={p})")
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
    out = torch.empty((p, n), dtype=torch.float32, device=x_pairs.device)
    with torch.cuda.device(x_pairs.device):
        rc = _lib()(
            x_pairs.data_ptr(), ids32.data_ptr(), sq.codes.data_ptr(), sq.scales.data_ptr(),
            int(sq.scales.dtype == torch.bfloat16), float(sq.qbias_coeff), out.data_ptr(),
            p, n, k, g, e, sq.bits, int((k * sq.bits // 8) % 16 == 0),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "moe_gemv")
    LAUNCHES["moe_gemv_int4" if sq.bits == 4 else "moe_gemv_int8"] += 1
    return out

"""K9/K10: grouped (ragged) expert matmul for MoE prefill, and its layout.

Wrappers and plain PyTorch versions of `csrc/grouped_matmul.cu`, which
replaces `uzu_tpu/ops/pallas/grouped_matmul.py::_q_kernel` (K9, INT4 expert
stacks dequantized in the kernel) and `::_kernel` (K10, dense bf16/f32
stacks). `route_layout` sorts the routed (token, expert) rows by expert
into a buffer where every 64-row m-tile belongs to one expert; both
kernels multiply each tile by its expert's plane and skip the tiles past
the used count, which stays on the device. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant.format import StackedQuantized, dequantize_stacked
from .build import LAUNCHES, check, library
from .moe_gemv import gather_experts

GROUP_ROWS = 64  # rows per m-tile (the JAX package's _GROUPED_BM)
MAX_TILES = 65535  # the kernels' grid.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES_Q = [_P, _I, _P, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _P]
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]


def route_layout(flat_expert: torch.Tensor, num_experts: int, bm: int = GROUP_ROWS):
    """Expert-sorted, tile-padded layout of T routed rows, all on the device.

    Returns (order [T], dst [T], tile_expert [Tp/bm] int32, used_tiles [1]
    int32, row_expert [Tp]): row order[j] of the routed rows goes to buffer
    row dst[j]; Tp = ceil(T/bm)*bm + E*bm is the static worst case (every
    expert's group padded up to a tile), so no size is read on the host."""
    t = flat_expert.shape[0]
    dev = flat_expert.device
    tp = -(-t // bm) * bm + num_experts * bm
    fe = flat_expert.long()
    order = torch.argsort(fe, stable=True)
    sorted_e = fe[order]
    counts = torch.zeros(num_experts, dtype=torch.long, device=dev).index_add_(
        0, fe, torch.ones_like(fe))
    padded = (counts + bm - 1) // bm * bm
    pstart = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(counts, 0) - counts
    total = padded.sum()
    rank = torch.arange(t, device=dev) - start[sorted_e]
    dst = pstart[sorted_e] + rank
    last = torch.clamp(total - 1, min=0)

    def owner(rows):  # the expert whose padded group holds each row
        idx = torch.searchsorted(pstart, torch.minimum(rows, last), right=True) - 1
        return idx.clamp(0, num_experts - 1)

    tile_expert = owner(torch.arange(tp // bm, device=dev) * bm).to(torch.int32)
    used_tiles = (total // bm).reshape(1).to(torch.int32)
    row_expert = owner(torch.arange(tp, device=dev))
    return order, dst, tile_expert, used_tiles, row_expert


def grouped_matmul_plain(x_pad: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
                         used_tiles: torch.Tensor, bm: int = GROUP_ROWS) -> torch.Tensor:
    """The JAX package's `grouped_matmul_xla`: per m-tile, one gathered
    expert plane, f32 products; every tile is computed."""
    del used_tiles
    tp, k = x_pad.shape
    xt = x_pad.float().reshape(tp // bm, bm, k)
    wt = w[tile_expert.long()].float()
    return torch.einsum("tmk,tnk->tmn", xt, wt).reshape(tp, -1)


def grouped_matmul_quant_plain(x_pad: torch.Tensor, sq: StackedQuantized,
                               tile_expert: torch.Tensor, used_tiles: torch.Tensor,
                               bm: int = GROUP_ROWS) -> torch.Tensor:
    """`grouped_matmul_plain` over the tiles' planes dequantized in f32."""
    planes = dequantize_stacked(gather_experts(sq, tile_expert), torch.float32)
    idx = torch.arange(planes.shape[0], device=planes.device)
    return grouped_matmul_plain(x_pad, planes, idx, used_tiles, bm)


def _fn(name: str, argtypes):
    fn = getattr(library("grouped_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _check_layout(what: str, x_pad, k: int, tile_expert, used_tiles, tensors) -> None:
    tp = x_pad.shape[0]
    if x_pad.dim() != 2 or x_pad.shape[1] != k or tp % GROUP_ROWS \
            or not 1 <= tp // GROUP_ROWS <= MAX_TILES \
            or tuple(tile_expert.shape) != (tp // GROUP_ROWS,) or used_tiles.numel() != 1:
        raise ValueError(f"{what}: x_pad {tuple(x_pad.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)}, used_tiles {tuple(used_tiles.shape)} "
                         f"do not fit K={k} and {GROUP_ROWS}-row tiles")
    if x_pad.device.type != "cuda" or any(t.device != x_pad.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")
    if x_pad.dtype not in (torch.bfloat16, torch.float32) or k % 8:
        raise ValueError(f"{what} kernel needs bf16 or f32 x and K % 8 == 0 "
                         f"({x_pad.dtype}, K={k})")


def _aligned(*tensors) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def grouped_matmul_quant(x_pad: torch.Tensor, sq: StackedQuantized, tile_expert: torch.Tensor,
                         used_tiles: torch.Tensor) -> torch.Tensor:
    """K9. x_pad [Tp, K] (route_layout's buffer), INT4 stack [E, N, K],
    tile_expert [Tp/64], used_tiles [1] -> f32 [Tp, N]; rows of tiles past
    the used count are undefined."""
    e, n, k = sq.shape
    if x_pad.device.type == "cpu":
        return grouped_matmul_quant_plain(x_pad, sq, tile_expert, used_tiles)
    _check_layout("grouped_matmul_quant", x_pad, k, tile_expert, used_tiles,
                  (sq.codes, sq.scales, tile_expert, used_tiles))
    g = sq.group_size
    kg = -(-k // g)
    if sq.bits != 4 or g % 8 or sq.codes.dtype != torch.uint8 \
            or sq.scales.dtype not in (torch.bfloat16, torch.float32) \
            or tuple(sq.scales.shape) != (e, n, kg):
        raise ValueError(f"grouped_matmul_quant kernel needs an INT4 stack with g % 8 == 0 "
                         f"and bf16 or f32 scales [{e}, {n}, {kg}] (bits={sq.bits}, g={g}, "
                         f"scales {sq.scales.dtype} {tuple(sq.scales.shape)})")
    x_pad = x_pad.contiguous()
    te = tile_expert.to(torch.int32).contiguous()
    used = used_tiles.to(torch.int32).contiguous()
    if not _aligned(x_pad, sq.codes, sq.scales):
        raise ValueError("grouped_matmul_quant: x_pad, codes and scales must be contiguous "
                         "and 16-byte aligned")
    tp = x_pad.shape[0]
    out = torch.empty((tp, n), dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        rc = _fn("uz_grouped_matmul_q", _ARGTYPES_Q)(
            x_pad.data_ptr(), int(x_pad.dtype == torch.bfloat16), te.data_ptr(),
            used.data_ptr(), sq.codes.data_ptr(), sq.scales.data_ptr(),
            int(sq.scales.dtype == torch.bfloat16), float(sq.qbias_coeff), out.data_ptr(),
            tp, n, k, g, e, torch.cuda.current_stream().cuda_stream)
    check(rc, "grouped_matmul_quant")
    LAUNCHES["grouped_matmul_int4"] += 1
    return out


def grouped_matmul(x_pad: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
                   used_tiles: torch.Tensor) -> torch.Tensor:
    """K10. x_pad [Tp, K], dense stack w [E, N, K] bf16 or f32,
    tile_expert [Tp/64], used_tiles [1] -> f32 [Tp, N]; rows of tiles past
    the used count are undefined."""
    e, n, k = w.shape
    if x_pad.device.type == "cpu":
        return grouped_matmul_plain(x_pad, w, tile_expert, used_tiles)
    _check_layout("grouped_matmul", x_pad, k, tile_expert, used_tiles,
                  (w, tile_expert, used_tiles))
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grouped_matmul kernel takes a bf16 or f32 stack, not {w.dtype}")
    x_pad = x_pad.contiguous()
    te = tile_expert.to(torch.int32).contiguous()
    used = used_tiles.to(torch.int32).contiguous()
    if not _aligned(x_pad, w):
        raise ValueError("grouped_matmul: x_pad and w must be contiguous and 16-byte aligned")
    tp = x_pad.shape[0]
    out = torch.empty((tp, n), dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        rc = _fn("uz_grouped_matmul", _ARGTYPES)(
            x_pad.data_ptr(), int(x_pad.dtype == torch.bfloat16), te.data_ptr(),
            used.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), out.data_ptr(),
            tp, n, k, e, torch.cuda.current_stream().cuda_stream)
    check(rc, "grouped_matmul")
    LAUNCHES["grouped_matmul"] += 1
    return out

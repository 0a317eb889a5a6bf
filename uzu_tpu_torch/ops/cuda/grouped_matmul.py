"""K9/K10: grouped (ragged) expert matmul for MoE, its layout and its launch plan.

Wrappers and plain PyTorch versions of `csrc/grouped_matmul.cu`, which
replaces `uzu_tpu/ops/pallas/grouped_matmul.py::_q_kernel` (K9, INT4 expert
stacks dequantized in the kernel) and `::_kernel` (K10, dense bf16/f32
stacks). `route_layout` sorts the routed (token, expert) rows by expert
into a buffer where every bm-row tile belongs to one expert; both kernels
multiply each tile by its expert's plane and skip the tiles past the used
count, which stays on the device. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

`grouped_plan` is the launch plan, from shapes and the SM count only: bm
(the layout's rows per tile) and the route with its block geometry. K9
takes the small route (`grouped_small`: bm = S rounded up to 8, 16 or 32,
kw warps over K, each tile's x staged in shared memory) for chunks of S <=
GEMV_MAX_M rows whose staged x fits, and the tile route (`grouped_tile_q`:
bm 64, BN weight rows per block) otherwise; K10 takes the
tile route (`grouped_tile_dense`) on bf16 rows and stacks, and the mma
route (the 64x64 mma.sync tile) otherwise. The wrappers keep the
signature (x_pad, w, tile_expert, used): they read bm from the shapes
(Tp / tiles) and rebuild the same plan with `launch_plan`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...quant.format import StackedQuantized, dequantize_stacked
from .build import LAUNCHES, check, library
from .flash_attention import num_sms
from .moe_gemv import gather_experts
from .quant_matmul import (
    GEMV_MAX_M,
    SMALL_ROWS,
    SMALL_STAGE_MAX,
    SMALL_UNROLL,
    SMALL_WARPS,
    small_kw,
    staged_bytes,
)

GROUP_ROWS = 64  # rows per tile of the tile and mma routes (the JAX package's _GROUPED_BM)
SMALL_BMS = (8, 16, 32)  # rows per tile of the small route: 1, 2 or 4 n8 operands
MAX_TILES = 65535  # tiles a launch may hold (the mma route's grid.y)
SMALL_BLOCKS_PER_SM = 2  # the small route's grid: blocks that walk the (tile, row block) items
# weight rows per tile-route block the plan may take, largest first, and
# the blocks of each that fit on an SM at once (shared memory: QTileGeo /
# DTileGeo in csrc). K9's dequantization favours BN 128 at every T; K10
# takes BN 64 when no expert has a second tile (see launch_plan)
TILE_BNS = {4: (128, 64), 16: (256, 128, 64)}
RESIDENT = {4: {128: 2, 64: 2}, 16: {256: 1, 128: 2, 64: 3}}
_ROUTES = {"small": 0, "tile": 1, "mma": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES_Q = [_P, _I, _P, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _I, _I,
               _I, _I, _I, _P]
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P]


class GroupedPlan(NamedTuple):
    """A launch of K9/K10. route "small" (K9, bm 8/16/32: kw warps over K
    per 16-weight-row tile; a grid of `blocks` that walk the used tiles'
    (tile, row block) items in contiguous ranges, each tile's x staged once
    in shared memory), "tile" (bm 64: BN weight rows per
    warpgroup block, wgmma) or "mma" (K10 on f32 rows or stacks: 64x64
    mma.sync tiles). `tiles` is the used tiles expected under uniform
    routing, `blocks` the blocks with work then, and `short` says why they
    do not fill the SMs (empty when they do)."""

    route: str
    bm: int
    kw: int = 0
    bn: int = 0
    tiles: int = 0
    blocks: int = 0
    short: str = ""


def grouped_bm(s: int, bits: int, k: int) -> int:
    """Rows per tile of the layout of an S-row chunk whose expert matmuls
    contract over at most K: a token's k experts are distinct, so an
    expert holds at most S rows, and an INT4 chunk of S <= GEMV_MAX_M rows
    gives each routed expert one tile of S rows rounded up to 8, 16 or 32,
    where that tile's staged x fits. Everything else takes 64-row tiles."""
    if bits == 4 and s <= GEMV_MAX_M:
        bm = next(b for b in SMALL_BMS if b >= s)
        if staged_bytes(bm, k) <= SMALL_STAGE_MAX:
            return bm
    return GROUP_ROWS


def expected_tiles(tiles: int, bm: int, e: int) -> int:
    """Used tiles of a layout of `tiles` = Tp / bm tiles over e experts
    (ceil(T / bm) = tiles - e row tiles): at least those, and at least the
    experts that (tiles - e) * bm uniformly routed rows touch."""
    row_tiles = max(tiles - e, 0)
    touched = e * (1.0 - (1.0 - 1.0 / e) ** (row_tiles * bm))
    return min(tiles, max(row_tiles, round(touched)))


def launch_plan(tiles: int, bm: int, e: int, n: int, k: int, bits: int,
                sms: int) -> GroupedPlan:
    """The plan of a launch over `tiles` tiles of bm rows, an [e, n, k]
    stack of `bits` (4: INT4; 16: bf16 rows and stack; else f32 somewhere)
    on a card with `sms` SMs. Shapes only. K10's BN: where no expert has
    a second tile (used tiles <= e), BN 64 (every plane is read once
    whatever BN, and more, smaller blocks run 2-5% faster on the H100);
    else, as for K9, the largest BN whose blocks fill the resident slots
    (tiles that share an expert read its N-slice side by side, and a wider
    one re-reads x fewer times)."""
    used = expected_tiles(tiles, bm, e)
    if bits == 4 and bm < GROUP_ROWS:
        kw = small_kw(k)
        items = used * -(-(-(-n // SMALL_ROWS)) // (SMALL_WARPS // kw))
        blocks = max(1, min(items, SMALL_BLOCKS_PER_SM * sms))
        short = "" if blocks >= sms else "fewer routed planes x 16-row weight tiles than SMs"
        return GroupedPlan("small", bm, kw=kw, tiles=used, blocks=blocks, short=short)
    if bits not in TILE_BNS:
        blocks = used * -(-n // 64)
        return GroupedPlan("mma", bm, bn=64, tiles=used, blocks=blocks,
                           short="" if blocks >= sms else "fewer tiles x 64-row blocks than SMs")
    resident = RESIDENT[bits]
    bns = TILE_BNS[bits]
    if bits == 16 and used <= e:
        bns = bns[-1:]
    bn = next((b for b in bns if used * -(-n // b) >= resident[b] * sms), bns[-1])
    blocks = used * -(-n // bn)
    short = "" if blocks >= resident[bn] * sms else \
        f"fewer tiles x {bn}-row blocks than {resident[bn]} a SM at the smallest BN"
    return GroupedPlan("tile", bm, bn=bn, tiles=used, blocks=blocks, short=short)


def grouped_plan(s: int, k_active: int, e: int, n: int, k: int, bits: int,
                 sms: int) -> GroupedPlan:
    """The launch plan of one expert matmul of an S-row MoE chunk: S *
    k_active routed rows over e experts, an [e, n, k] stack of `bits` (4,
    16 for bf16, 32 for f32), `sms` SMs. Shapes only: never the data."""
    bm = grouped_bm(s, bits, k)
    return launch_plan(-(-s * k_active // bm) + e, bm, e, n, k, bits, sms)


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


def tile_rows(x_pad: torch.Tensor, tile_expert: torch.Tensor) -> int:
    """bm of a layout, from its shapes: Tp / tiles (0 when they do not divide)."""
    tiles = tile_expert.shape[0]
    tp = x_pad.shape[0]
    return tp // tiles if tiles and tp % tiles == 0 else 0


def _check_layout(what: str, x_pad, k: int, tile_expert, used_tiles, tensors,
                  bms=(*SMALL_BMS, GROUP_ROWS)) -> int:
    tp = x_pad.shape[0]
    bm = tile_rows(x_pad, tile_expert)
    if x_pad.dim() != 2 or x_pad.shape[1] != k or bm not in bms \
            or not 1 <= tp // bm <= MAX_TILES or tile_expert.dim() != 1 \
            or used_tiles.numel() != 1:
        raise ValueError(f"{what}: x_pad {tuple(x_pad.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)}, used_tiles {tuple(used_tiles.shape)} "
                         f"do not fit K={k} and tiles of {bms} rows")
    if x_pad.device.type != "cuda" or any(t.device != x_pad.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")
    if x_pad.dtype not in (torch.bfloat16, torch.float32) or k % 8:
        raise ValueError(f"{what} kernel needs bf16 or f32 x and K % 8 == 0 "
                         f"({x_pad.dtype}, K={k})")
    return bm


def _aligned(*tensors) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def grouped_matmul_quant(x_pad: torch.Tensor, sq: StackedQuantized, tile_expert: torch.Tensor,
                         used_tiles: torch.Tensor) -> torch.Tensor:
    """K9. x_pad [Tp, K] (route_layout's buffer at bm = Tp / tiles of 8,
    16, 32 or 64), INT4 stack [E, N, K], tile_expert [Tp/bm], used_tiles [1]
    -> f32 [Tp, N]; rows of tiles past the used count are undefined."""
    e, n, k = sq.shape
    if x_pad.device.type == "cpu":
        return grouped_matmul_quant_plain(x_pad, sq, tile_expert, used_tiles,
                                          tile_rows(x_pad, tile_expert))
    bm = _check_layout("grouped_matmul_quant", x_pad, k, tile_expert, used_tiles,
                       (sq.codes, sq.scales, tile_expert, used_tiles))
    if bm < GROUP_ROWS and staged_bytes(bm, k) > SMALL_STAGE_MAX:
        raise ValueError(f"grouped_matmul_quant: {bm}-row tiles of K={k} do not fit in shared "
                         f"memory; lay the rows out at grouped_bm's bm")
    _check_int4(sq)
    plan = launch_plan(tile_expert.shape[0], bm, e, n, k, 4, num_sms(x_pad.device))
    return launch_grouped_quant(x_pad, sq, tile_expert, used_tiles, plan)


def _check_int4(sq: StackedQuantized) -> None:
    e, n, k = sq.shape
    g = sq.group_size
    kg = -(-k // g)
    if sq.bits != 4 or g % 8 or sq.codes.dtype != torch.uint8 \
            or sq.scales.dtype not in (torch.bfloat16, torch.float32) \
            or tuple(sq.scales.shape) != (e, n, kg):
        raise ValueError(f"grouped_matmul_quant kernel needs an INT4 stack with g % 8 == 0 "
                         f"and bf16 or f32 scales [{e}, {n}, {kg}] (bits={sq.bits}, g={g}, "
                         f"scales {sq.scales.dtype} {tuple(sq.scales.shape)})")


def launch_grouped_quant(x_pad: torch.Tensor, sq: StackedQuantized, tile_expert: torch.Tensor,
                         used_tiles: torch.Tensor, plan: GroupedPlan) -> torch.Tensor:
    """K9's launch on the card under `plan` (the wrapper's, or another
    geometry of the same bm to compare)."""
    _check_int4(sq)
    e, n, k = sq.shape
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
            tp, n, k, sq.group_size, e, int((k // 2) % 16 == 0), _ROUTES[plan.route], plan.bm,
            plan.kw if plan.route == "small" else plan.bn, plan.blocks,
            torch.cuda.current_stream().cuda_stream)
    check(rc, "grouped_matmul_quant")
    LAUNCHES["grouped_matmul_int4"] += 1
    return out


def grouped_matmul(x_pad: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
                   used_tiles: torch.Tensor) -> torch.Tensor:
    """K10. x_pad [Tp, K] (64-row tiles), dense stack w [E, N, K] bf16 or
    f32, tile_expert [Tp/64], used_tiles [1] -> f32 [Tp, N]; rows of tiles
    past the used count are undefined."""
    e, n, k = w.shape
    if x_pad.device.type == "cpu":
        return grouped_matmul_plain(x_pad, w, tile_expert, used_tiles,
                                    tile_rows(x_pad, tile_expert))
    _check_layout("grouped_matmul", x_pad, k, tile_expert, used_tiles,
                  (w, tile_expert, used_tiles), bms=(GROUP_ROWS,))
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grouped_matmul kernel takes a bf16 or f32 stack, not {w.dtype}")
    bits = 16 if x_pad.dtype == w.dtype == torch.bfloat16 else 32
    plan = launch_plan(tile_expert.shape[0], GROUP_ROWS, e, n, k, bits, num_sms(x_pad.device))
    return launch_grouped(x_pad, w, tile_expert, used_tiles, plan)


def launch_grouped(x_pad: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
                   used_tiles: torch.Tensor, plan: GroupedPlan) -> torch.Tensor:
    """K10's launch on the card under `plan`."""
    e, n, k = w.shape
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
            tp, n, k, e, _ROUTES[plan.route], plan.bn, torch.cuda.current_stream().cuda_stream)
    check(rc, "grouped_matmul")
    LAUNCHES["grouped_matmul"] += 1
    return out

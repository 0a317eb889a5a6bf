"""K1/K2: fused dequant matmul over INT4/INT8 grouped-quantized weights.

Wrapper and plain PyTorch version of `csrc/quant_matmul.cu`, which
replaces `uzu_tpu/ops/pallas/quant_matmul.py::_int4_kernel` (K1) and
`::_int8_kernel` (K2). A CPU tensor takes `quant_matmul_plain`; a CUDA
tensor launches the kernel or raises. Scale (and stored qbias) rows may
be wider than the weight's ceil(K/g) groups, zero-padded past them, as
the JAX kernel takes them; only the first ceil(K/g) are read.

`qmm_plan` is the launch plan, from shapes and the SM count only: the
route (the f32 GEMV for f32 x at M <= GEMV_MAX_M, `qmm_small`'s tensor
cores for bf16 x there, `qmm_tile`'s wgmma above it) and its parameters.
The wrapper passes it to the kernel, so the plan the CPU tests hold is the
plan launched. A measured table (`autotune.py`, none ships) comes before
the heuristics where its entry can serve the shape. `quant_matmul_split_plain` is the plain version of a plan's
split-K tile: per-split partials, then the fixed-order merge.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...quant.format import QuantizedTensor, qbias_of, unpack_codes
from .build import LAUNCHES, check, library
from .flash_attention import num_sms

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _I, _P, _P]

GEMV_MAX_M = 32  # rows up to which the small-M routes run (csrc's GEMV_MAX_M)
SMALL_WARPS = 8  # warps per qmm_small block
SMALL_ROWS = 16  # weight rows per qmm_small warp: mma.sync's M
SMALL_WARPS_PER_SM = 16  # qmm_small warps the plan asks for per SM
SMALL_UNROLL = 4  # chunks each small-M warp loads before it uses any (csrc SM_UNROLL)
SMALL_STAGE_MAX = 200 * 1024  # shared memory the routed small-M kernels' staged x may take
TILE_N = 128  # weight rows per qmm_tile block: wgmma's N
TILE_K = 64  # k per qmm_tile chunk
TILE_MIN_CHUNKS = 4  # fewest chunks a split of K takes
_ROUTES = {"gemv_f32": 0, "small": 1, "tile": 2}


class QmmPlan(NamedTuple):
    """A launch of K1/K2. route "gemv_f32" (f32 x, M <= GEMV_MAX_M: one warp
    per output row, f32 throughout), "small" (bf16 x, M <= GEMV_MAX_M:
    `qmm_small`, kw warps over K per 16-row tile) or "tile" (`qmm_tile`:
    bm rows of x and TILE_N weight rows per block, K cut into `splits`
    ranges of `chunks_per_split` TILE_K-wide chunks)."""

    route: str
    kw: int = 0
    bm: int = 0
    splits: int = 1
    chunks_per_split: int = 0


def small_chunk(bits: int) -> int:
    """k per qmm_small chunk: 4 lanes x 16 bytes of codes."""
    return 512 // bits


def small_kw(k: int, bits: int = 4) -> int:
    """Warps over K per 16-row tile of the routed small-M kernels (K7/K8's
    moe_small, K9's grouped_small), from K and the code width alone (so a
    row's sum never depends on the other rows, on N or on P): doubles while
    each warp keeps two batches of SMALL_UNROLL chunks or more."""
    chunks = -(-k // small_chunk(bits))
    kw = 1
    while kw < SMALL_WARPS and -(-chunks // (2 * kw)) >= 2 * SMALL_UNROLL:
        kw *= 2
    return kw


def staged_bytes(rows: int, k: int) -> int:
    """Shared memory of `rows` rows of x staged for the routed small-M
    kernels: K rounded up to a whole 128-wide chunk, bf16, plus 16 bytes a
    row (csrc staged_ld)."""
    return rows * (-(-k // small_chunk(4)) * small_chunk(4) * 2 + 16)


def qmm_plan(m: int, n: int, k: int, bits: int, sms: int, x_bf16: bool = True) -> QmmPlan:
    """The launch plan of an [m, k] x [n, k]^T product over `bits`-bit codes
    on a card with `sms` SMs. Shapes only: never the data. A tile table's
    entry for the shape (`autotune.lookup`) comes first where it can serve
    the shape; its small entries are keyed without M, so the sums stay the
    same at every M of the route. Otherwise `heuristic_plan`."""
    from .autotune import lookup

    tabled = lookup(bits, n, k, m, x_bf16)
    return tabled if tabled is not None else heuristic_plan(m, n, k, bits, sms, x_bf16)


def heuristic_plan(m: int, n: int, k: int, bits: int, sms: int,
                   x_bf16: bool = True) -> QmmPlan:
    """`qmm_plan`'s built-in rules, from shapes and the SM count.

    Small M, bf16 x: kw (1, 2, 4 or 8 warps walking one 16-row tile's K)
    doubles while the warps stay below SMALL_WARPS_PER_SM per SM and each
    keeps 2 chunks or more; it does not depend on m, so every m on this
    route sums in the same order. Tile: bm = 128 or 256 rows by m; where
    the (n, m) blocks do not fill the SMs, K is split into the most ranges
    of at least TILE_MIN_CHUNKS chunks that keep the blocks within one wave.
    Above 128 rows bm is 256 whatever the last wave holds: at prefill M a
    bm-128 block takes 0.73-0.80 of a bm-256 block's time (the per-chunk
    dequantization, not the products, sets it), so on an H100 bm 256 was
    the faster at every prefill shape measured, even where bm 128's last
    wave was the fuller (tests/test_torch_qmm_plan.py's PREFILL_MS)."""
    if m <= GEMV_MAX_M:
        if not x_bf16:
            return QmmPlan("gemv_f32")
        tiles = -(-n // SMALL_ROWS)
        chunks = -(-k // small_chunk(bits))
        kw = 1
        while (kw < SMALL_WARPS and tiles * kw < SMALL_WARPS_PER_SM * sms
               and -(-chunks // (2 * kw)) >= 2):
            kw *= 2
        return QmmPlan("small", kw=kw)
    bm = 128 if m <= 128 else 256
    blocks = -(-n // TILE_N) * -(-m // bm)
    chunks = -(-k // TILE_K)
    splits = 1
    if blocks < sms:
        splits = max(1, min(sms // blocks, chunks // TILE_MIN_CHUNKS))
    cps = -(-chunks // splits)
    return QmmPlan("tile", bm=bm, splits=-(-chunks // cps), chunks_per_split=cps)


def plan_blocks(plan: QmmPlan, m: int, n: int) -> int:
    """Thread blocks of the plan's main launch (the GEMV: 4 rows a block, up
    to 8 rows of x a pass)."""
    if plan.route == "small":
        tiles = -(-n // SMALL_ROWS)
        return -(-tiles // (SMALL_WARPS // plan.kw))
    if plan.route == "tile":
        return -(-n // TILE_N) * -(-m // plan.bm) * plan.splits
    mt = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    return -(-n // 4) * -(-m // mt)


def quant_matmul_plain(w: QuantizedTensor, x2: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] -> f32 [M, N]: dequantize in f32, contract in f32."""
    return torch.matmul(x2.float(), _dequantize_f32(w).t())


def _dequantize_f32(w: QuantizedTensor) -> torch.Tensor:
    n, k = w.shape
    codes = unpack_codes(w.codes, w.bits).float()
    g = w.group_size
    scales = torch.repeat_interleave(w.scales.float(), g, dim=1)[:, :k]
    qbias = torch.repeat_interleave(qbias_of(w).float(), g, dim=1)[:, :k]
    return codes * scales + qbias


def quant_matmul_split_plain(w: QuantizedTensor, x2: torch.Tensor,
                             plan: QmmPlan) -> torch.Tensor:
    """The plain version of a tile plan's split K: split z's f32 partial over
    its chunks [z * cps, (z + 1) * cps) of TILE_K, then the partials added
    in split order, as qmm_split_sum adds them."""
    n, k = w.shape
    wd = _dequantize_f32(w)
    xf = x2.float()
    step = plan.chunks_per_split * TILE_K
    out = None
    for z in range(plan.splits):
        ks = slice(z * step, min(k, (z + 1) * step))
        part = torch.matmul(xf[:, ks], wd[:, ks].t())
        out = part if out is None else out + part
    return out


def _lib():
    lib = library("quant_matmul")
    fn = lib.uz_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def quant_matmul(w: QuantizedTensor, x2: torch.Tensor, plan: QmmPlan | None = None
                 ) -> torch.Tensor:
    """x2 [M, K] @ dequant(w)^T -> f32 [M, N]. `plan` (the autotuner's
    candidates) replaces `qmm_plan`'s."""
    n, k = w.shape
    if x2.dim() != 2 or x2.shape[1] != k:
        raise ValueError(f"x {tuple(x2.shape)} does not match weight {w.shape}")
    if x2.device.type == "cpu":
        return quant_matmul_plain(w, x2)
    if x2.device.type != "cuda" or w.codes.device != x2.device:
        raise ValueError(f"quant_matmul: x on {x2.device}, codes on {w.codes.device}")
    m = x2.shape[0]
    g = w.group_size
    if w.bits not in (4, 8) or k % 8 or g % 8:
        raise ValueError(f"quant_matmul kernel needs bits in (4, 8), K % 8 == 0 and "
                         f"g % 8 == 0 (bits={w.bits}, K={k}, g={g})")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul kernel takes bf16 or f32 x, not {x2.dtype}")
    if w.scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul kernel takes bf16 or f32 scales, not {w.scales.dtype}")
    kg = -(-k // g)
    if w.scales.dim() != 2 or w.scales.shape[0] != n or w.scales.shape[1] < kg or (
            w.qbias is not None and w.qbias.shape != w.scales.shape):
        raise ValueError(f"scales/qbias must be [{n}, >= {kg}] and of one shape for codes "
                         f"{tuple(w.codes.shape)}")
    if w.qbias is not None and w.qbias.dtype != w.scales.dtype:
        raise ValueError("qbias and scales must share a dtype")
    if w.codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, not {w.codes.dtype}")
    if plan is None:
        plan = qmm_plan(m, n, k, w.bits, num_sms(x2.device), x2.dtype == torch.bfloat16)
    elif plan.route != "tile" and (m > GEMV_MAX_M or (plan.route == "small")
                                   != (x2.dtype == torch.bfloat16)):
        raise ValueError(f"quant_matmul: plan {plan} cannot serve M={m} with {x2.dtype} x")
    if plan.route == "tile" and x2.dtype != torch.bfloat16:
        x2 = x2.to(torch.bfloat16)  # the tile's operands are bf16
    x2 = x2.contiguous()
    if not _aligned(x2):
        x2 = x2.clone()
    tensors = [w.codes, w.scales] + ([w.qbias] if w.qbias is not None else [])
    for t in tensors:
        if not t.is_contiguous() or not _aligned(t):
            raise ValueError("quantized weight tensors must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    scratch = (torch.empty((plan.splits, m, n), dtype=torch.float32, device=x2.device)
               if plan.splits > 1 else None)
    params = {"gemv_f32": (0, 0, 0), "small": (plan.kw, 0, 0),
              "tile": (plan.bm, plan.splits, plan.chunks_per_split)}[plan.route]
    row_bytes = k * w.bits // 8
    with torch.cuda.device(x2.device):
        rc = _lib()(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), w.codes.data_ptr(),
            w.scales.data_ptr(), None if w.qbias is None else w.qbias.data_ptr(),
            int(w.scales.dtype == torch.bfloat16),
            float(w.qbias_coeff or 0.0), out.data_ptr(), m, n, k, g, w.scales.shape[1], w.bits,
            int(row_bytes % 16 == 0), _ROUTES[plan.route], *params,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "quant_matmul")
    LAUNCHES["quant_matmul_int4" if w.bits == 4 else "quant_matmul_int8"] += 1
    if plan.route == "tile":
        LAUNCHES["quant_matmul_tile"] += 1
    return out

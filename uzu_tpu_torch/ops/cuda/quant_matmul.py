"""K1/K2: fused dequant matmul over INT4/INT8 grouped-quantized weights.

Wrapper and plain PyTorch version of `csrc/quant_matmul.cu`, which
replaces `uzu_tpu/ops/pallas/quant_matmul.py::_int4_kernel` (K1) and
`::_int8_kernel` (K2). A CPU tensor takes `quant_matmul_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant.format import QuantizedTensor, qbias_of, unpack_codes
from .build import LAUNCHES, check, library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _I, _P]


def quant_matmul_plain(w: QuantizedTensor, x2: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] -> f32 [M, N]: dequantize in f32, contract in f32."""
    n, k = w.shape
    codes = unpack_codes(w.codes, w.bits).float()
    g = w.group_size
    scales = torch.repeat_interleave(w.scales.float(), g, dim=1)[:, :k]
    qbias = torch.repeat_interleave(qbias_of(w).float(), g, dim=1)[:, :k]
    wd = codes * scales + qbias
    return torch.matmul(x2.float(), wd.t())


def _lib():
    lib = library("quant_matmul")
    fn = lib.uz_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def quant_matmul(w: QuantizedTensor, x2: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] @ dequant(w)^T -> f32 [M, N]."""
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
    if tuple(w.scales.shape) != (n, kg) or (
            w.qbias is not None and tuple(w.qbias.shape) != (n, kg)):
        raise ValueError(f"scales/qbias must be [{n}, {kg}] for codes {tuple(w.codes.shape)}")
    if w.qbias is not None and w.qbias.dtype != w.scales.dtype:
        raise ValueError("qbias and scales must share a dtype")
    if w.codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, not {w.codes.dtype}")
    x2 = x2.contiguous()
    if not _aligned(x2):
        x2 = x2.clone()
    tensors = [w.codes, w.scales] + ([w.qbias] if w.qbias is not None else [])
    for t in tensors:
        if not t.is_contiguous() or not _aligned(t):
            raise ValueError("quantized weight tensors must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    row_bytes = k * w.bits // 8
    with torch.cuda.device(x2.device):
        rc = _lib()(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), w.codes.data_ptr(),
            w.scales.data_ptr(), None if w.qbias is None else w.qbias.data_ptr(),
            int(w.scales.dtype == torch.bfloat16),
            float(w.qbias_coeff or 0.0), out.data_ptr(), m, n, k, g, w.bits,
            int(row_bytes % 16 == 0), torch.cuda.current_stream().cuda_stream)
    check(rc, "quant_matmul")
    LAUNCHES["quant_matmul_int4" if w.bits == 4 else "quant_matmul_int8"] += 1
    return out

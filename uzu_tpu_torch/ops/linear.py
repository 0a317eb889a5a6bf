"""Linear application over full-precision or quantized weights.

Counterpart of `uzu_tpu/ops/linear.py`. Weights use the OutputInput
layout, W [N, K] and y = x @ W^T. Quantized weights go through the fused
dequant matmul kernel K1/K2 (`ops/cuda/quant_matmul.py`) for up to
GEMM_THRESHOLD_M rows; above that, as in the JAX package, the weight is
dequantized once and contracted by a plain matmul.
"""

from __future__ import annotations

import torch

from ..quant.format import QuantizedTensor, dequantize
from .cuda import quant_matmul as qmm

# above this many rows dequantize-then-matmul amortizes the dequant
GEMM_THRESHOLD_M = 1024


def linear_apply(w, x: torch.Tensor, bias=None) -> torch.Tensor:
    """x: [..., K] -> [..., N]."""
    if isinstance(w, QuantizedTensor):
        y = quant_matmul(w, x)
    elif isinstance(w, torch.Tensor):
        y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
    else:
        y = hybrid_apply(w, x)
    if bias is not None:
        y = (y.float() + bias.float()).to(y.dtype)
    return y


def quant_matmul(w: QuantizedTensor, x: torch.Tensor) -> torch.Tensor:
    """Fused dequant matmul: y[m, n] = sum_k x[m,k] * dq(w)[n,k]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > GEMM_THRESHOLD_M:
        y = torch.matmul(x2.float(), dequantize(w, x.dtype).float().t())
    else:
        y = qmm.quant_matmul(w, x2)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def hybrid_apply(w, x: torch.Tensor) -> torch.Tensor:
    """QLoRA/RHT hybrid linears wait for a later slice of the port."""
    raise NotImplementedError("HybridSpec linears are not ported yet")

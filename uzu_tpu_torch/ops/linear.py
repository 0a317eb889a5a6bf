"""Linear application over full-precision or quantized weights.

Counterpart of `uzu_tpu/ops/linear.py`. Weights use the OutputInput
layout, W [N, K] and y = x @ W^T. Quantized weights go through the fused
dequant matmul kernel K1/K2 (`ops/cuda/quant_matmul.py`) for up to
GEMM_THRESHOLD_M rows; above that, as in the JAX package, the weight is
dequantized once and contracted by a plain matmul. HybridSpec linears
(`HybridLinear`: QLoRA adapter and Hadamard incoherence around a quantized
base) take `hybrid_apply`, whose base runs through the same route.
"""

from __future__ import annotations

import torch

from ..quant.format import HybridLinear, QuantizedTensor, dequantize
from .cuda import quant_matmul as qmm

# above this many rows dequantize-then-matmul amortizes the dequant
GEMM_THRESHOLD_M = 1024


def linear_apply(w, x: torch.Tensor, bias=None) -> torch.Tensor:
    """x: [..., K] -> [..., N]."""
    if isinstance(w, HybridLinear):
        y = hybrid_apply(w, x)
    elif isinstance(w, QuantizedTensor):
        y = quant_matmul(w, x)
    else:
        y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
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


def hybrid_apply(w: HybridLinear, x: torch.Tensor) -> torch.Tensor:
    """QLoRA/RHT hybrid linear, `uzu_tpu/ops/linear.py::hybrid_apply` step
    by step with its roundings: the adapter's down product on the raw x,
    to f32; the base on input_rht(x) in x's type (K1/K2 round it to
    x.dtype, then f32); the adapter's up product added in f32 and the sum
    cast to x.dtype; output_rht to f32, cast to x.dtype. The adapter's
    products run in f64, each rounded to f32 once, as `ops/rht.py` runs
    the Hadamard product: then every row's result is the same whatever
    the number of rows in the call (K1's rows are too), as the batched
    engines need to match the single stream."""
    from .rht import input_rht, output_rht

    inter = None
    if w.adapter_down is not None:
        inter = torch.matmul(x.double(), w.adapter_down.double().t()).float()
    xb = input_rht(x, w.input_signs) if w.input_signs is not None else x
    y = quant_matmul(w.base, xb).float()
    if inter is not None:
        y = y + torch.matmul(inter.double(), w.adapter_up.double().t()).float()
    y = y.to(x.dtype)
    if w.output_signs is not None:
        y = output_rht(y, w.output_signs)
    return y

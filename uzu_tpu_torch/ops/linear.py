"""Linear application over full-precision or quantized weights.

Counterpart of `uzu_tpu/ops/linear.py`. Weights use the OutputInput
layout, W [N, K] and y = x @ W^T. Quantized weights go through the fused
dequant matmul kernel K1/K2 (`ops/cuda/quant_matmul.py`) at every row
count for bf16 x: bf16 x bf16 products with f32 sums, the contraction of
the JAX package's `_xla_quant_matmul`. Other x (f32) above
GEMM_THRESHOLD_M rows is contracted in its own precision by a plain
matmul over the weight dequantized once, since K1's tile would round it
to bf16. HybridSpec linears
(`HybridLinear`: QLoRA adapter and Hadamard incoherence around a quantized
base) take `hybrid_apply`, whose base runs through the same route. Under tensor parallelism a linear
whose input dimension is split over the ranks holds a `SplitInput`: each
rank's product is a partial sum, all-reduced before the bias is added, so
the whole bias is added once. Where that split would cut a quantization
group or a Hadamard block, every rank keeps the whole weight instead: an
input-split linear holds a `GatherInput` (the ranks' input slices are
all-gathered and the whole product taken, with no reduction), an
output-split one a `TakeSections` (the whole product, of which the rank
keeps its part of each output section, the layout its neighbours expect).
"""

from __future__ import annotations

import dataclasses

import torch

from ..quant.format import HybridLinear, QuantizedTensor, dequantize
from .cuda import quant_matmul as qmm
from .cuda.build import LAUNCHES

# above this many rows x that is not bf16 (the deep f32 checks) is
# contracted in its own precision over the dequantized weight, where K1's
# tile would round it to bf16; bf16 x takes K1 at every row count
GEMM_THRESHOLD_M = 1024


@dataclasses.dataclass
class SplitInput:
    """This rank's column slice `w` of a linear whose input dimension is
    split over the tensor-parallel process group `group`
    (`parallel/sharding.py`); `linear_apply` sums the ranks' products."""

    w: object  # torch.Tensor, QuantizedTensor, HybridLinear or StackedQuantized
    group: object  # torch.distributed.ProcessGroup

    def to(self, device) -> "SplitInput":
        return dataclasses.replace(self, w=self.w.to(device))


@dataclasses.dataclass
class GatherInput:
    """A whole weight `w` of a linear whose input dimension tp splits: the
    rank's input slice is all-gathered over `group` in rank order, then
    the whole product is taken on every rank."""

    w: object
    group: object

    def to(self, device) -> "GatherInput":
        return dataclasses.replace(self, w=self.w.to(device))


@dataclasses.dataclass
class TakeSections:
    """A whole weight `w` of a linear whose output dimension tp splits into
    `sections`: the whole product is taken, and rank `rank` of `size` keeps
    its equal part of each section, concatenated in order."""

    w: object
    sections: tuple
    rank: int
    size: int

    def to(self, device) -> "TakeSections":
        return dataclasses.replace(self, w=self.w.to(device))


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` over `group`, concatenated along the last dim in
    rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


def take_sections(y: torch.Tensor, sections, rank: int, size: int) -> torch.Tensor:
    """Rank `rank` of `size`'s part of each section of y's last dim."""
    parts, off = [], 0
    for length in sections:
        part = length // size
        parts.append(y[..., off + rank * part: off + (rank + 1) * part])
        off += length
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0].contiguous()


def all_reduce_sum(y: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `y` over `group`, in f32 (the partial sums
    of a split contraction), returned in y's dtype."""
    import torch.distributed as dist

    yf = y.float().contiguous()
    dist.all_reduce(yf, group=group)
    return yf.to(y.dtype)


def linear_apply(w, x: torch.Tensor, bias=None) -> torch.Tensor:
    """x: [..., K] -> [..., N]."""
    if isinstance(w, SplitInput):
        y = all_reduce_sum(linear_apply(w.w, x), w.group)
    elif isinstance(w, GatherInput):
        y = linear_apply(w.w, all_gather_last(x, w.group))
    elif isinstance(w, TakeSections):
        y = take_sections(linear_apply(w.w, x), w.sections, w.rank, w.size)
    elif isinstance(w, HybridLinear):
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
    if x2.shape[0] > GEMM_THRESHOLD_M and x2.dtype != torch.bfloat16:
        y = torch.matmul(x2.float(), dequantize(w, x.dtype).float().t())
        LAUNCHES["linear_dequant_matmul"] += 1
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

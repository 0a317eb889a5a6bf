"""Quantized weight representation + pack/unpack/dequantize.

Counterpart of `uzu_tpu/quant/format.py`. On-disk layout:

- ``weights``: uint8 ``[N, K/pack]`` — unsigned codes packed little-endian
  along K (4-bit: low nibble = even k).
- ``scales``: ``[N, ceil(K/g)]`` in the weights float dtype.
- method ScaleBias (MLX): ``biases`` ``[N, ceil(K/g)]``; w = scale*code + bias.
- method ScaleZeroPoint: ``zero_points`` uint8 ``[N, ceil(ceil(K/g)/pack)]``
  packed like codes; w = scale*(code - zp).
- method ScaleSymmetric: w = scale*(code - 2^(bits-1)).

In memory all three become ``w = scale*code + qbias`` with a per-group
``qbias`` (= mlx bias, -scale*zp, or -scale*midpoint), so one kernel covers
every method. Symmetric tensors carry no qbias tensor, only the exact
power-of-two coefficient ``qbias_coeff``. `pack_codes` and
`quantize_reference` stay numpy: the synthesizer writes with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..params.safetensors_io import BF16, bf16_to_f32, cast, to_torch


@dataclasses.dataclass
class QuantizedTensor:
    """A [N, K] weight matrix stored as packed unsigned codes + group params.

    w[n, k] = scales[n, k//g] * code[n, k] + qbias[n, k//g]

    For symmetric quantization qbias is exactly ``qbias_coeff * scales``
    (a power of two), so such tensors carry ``qbias=None``.
    """

    codes: torch.Tensor  # uint8 [N, K // (8//bits)]
    scales: torch.Tensor  # [N, ceil(K/g)] float
    qbias: torch.Tensor | None  # [N, ceil(K/g)] float, or None (see qbias_coeff)
    bits: int
    group_size: int
    qbias_coeff: float | None = None  # qbias == qbias_coeff * scales

    @property
    def shape(self) -> tuple[int, int]:
        n, kp = self.codes.shape
        return (n, kp * (8 // self.bits))

    @property
    def dtype(self):
        return self.scales.dtype

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(
            self, codes=self.codes.to(device), scales=self.scales.to(device),
            qbias=None if self.qbias is None else self.qbias.to(device))


@dataclasses.dataclass
class StackedQuantized:
    """A stack of E symmetric-quantized [N, K] matrices (MoE expert
    weights): codes uint8 [E, N, K/pack] packed like `QuantizedTensor`'s,
    scales [E, N, ceil(K/g)], and w = scale * code + qbias_coeff * scale.
    Decode reads only the routed experts' planes (K7/K8), prefill only the
    routed tiles' planes (K9)."""

    codes: torch.Tensor  # uint8 [E, N, K // (8//bits)]
    scales: torch.Tensor  # [E, N, ceil(K/g)]
    bits: int
    group_size: int
    qbias_coeff: float  # symmetric: qbias == qbias_coeff * scales

    @property
    def shape(self) -> tuple[int, int, int]:
        e, n, kp = self.codes.shape
        return (e, n, kp * (8 // self.bits))

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def expert(self, idx: int) -> QuantizedTensor:
        """Expert `idx`'s [N, K] plane as a `QuantizedTensor` view."""
        return QuantizedTensor(codes=self.codes[idx], scales=self.scales[idx], qbias=None,
                               bits=self.bits, group_size=self.group_size,
                               qbias_coeff=self.qbias_coeff)

    def to(self, device) -> "StackedQuantized":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scales=self.scales.to(device))


@dataclasses.dataclass
class HybridLinear:
    """HybridSpec weights, the JAX package's `HybridLinear`: a quantized
    base stored in the incoherence-transformed domain, an optional
    low-rank adapter and optional per-dim Hadamard sign vectors.

    Forward (`ops/linear.py::hybrid_apply`):
        inter = x @ adapter_down^T                (on the raw input)
        y = base @ input_rht(x)                   (signs present)
        y += inter @ adapter_up^T
        y = output_rht(y)                         (signs present)
    """

    base: QuantizedTensor
    adapter_down: torch.Tensor | None  # [rank, K]
    adapter_up: torch.Tensor | None  # [N, rank]
    input_signs: torch.Tensor | None  # [K] f32 (+-1)
    output_signs: torch.Tensor | None  # [N] f32 (+-1)

    @property
    def shape(self) -> tuple[int, int]:
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def to(self, device) -> "HybridLinear":
        def move(t):
            return None if t is None else t.to(device)

        return HybridLinear(base=self.base.to(device), adapter_down=move(self.adapter_down),
                            adapter_up=move(self.adapter_up),
                            input_signs=move(self.input_signs),
                            output_signs=move(self.output_signs))


def dequantize_stacked(sq: StackedQuantized, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [E, N, K]: (code - 2^(bits-1)) * scale in f32, then cast; the
    JAX package's `dequantize_stacked` operation for operation."""
    k = sq.shape[2]
    codes = unpack_codes(sq.codes, sq.bits).float()
    mid = float(1 << (sq.bits - 1))
    sc = torch.repeat_interleave(sq.scales.float(), sq.group_size, dim=-1)[:, :, :k]
    return ((codes - mid) * sc).to(dtype)


def unpack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 packed [..., K/pack] -> uint8 unpacked [..., K] (unsigned codes)."""
    if bits == 8:
        return codes
    if bits == 4:
        lo = codes & 0xF
        hi = codes >> 4
        return torch.stack([lo, hi], dim=-1).reshape(*codes.shape[:-1], -1)
    raise ValueError(f"unsupported bits={bits}")


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """numpy: unsigned codes [..., K] -> packed uint8 [..., K/pack]."""
    codes = np.asarray(codes, dtype=np.uint8)
    if bits == 8:
        return codes
    if bits == 4:
        if codes.shape[-1] % 2:
            raise ValueError("4-bit packing needs an even K")
        lo = codes[..., 0::2]
        hi = codes[..., 1::2]
        return (lo | (hi << 4)).astype(np.uint8)
    raise ValueError(f"unsupported bits={bits}")


def qbias_of(qt: QuantizedTensor) -> torch.Tensor:
    """Materialized [N, Kg] qbias — bit-identical to the stored form for
    coefficient tensors (power-of-two multiply commutes with rounding)."""
    if qt.qbias is not None:
        return qt.qbias
    return (qt.scales.float() * qt.qbias_coeff).to(qt.scales.dtype)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain dequantization to a dense [N, K] matrix (f32 math, then cast)."""
    n, k = qt.shape
    codes = unpack_codes(qt.codes, qt.bits).float()
    g = qt.group_size
    scales = torch.repeat_interleave(qt.scales.float(), g, dim=1)[:, :k]
    qbias = torch.repeat_interleave(qbias_of(qt).float(), g, dim=1)[:, :k]
    return (codes * scales + qbias).to(dtype)


def make_qbias(
    method: str,
    scales: np.ndarray,
    bits: int,
    zero_points_packed: np.ndarray | None = None,
    mlx_biases: np.ndarray | None = None,
) -> np.ndarray:
    """Compute the canonical per-group bias term (f32) from on-disk tensors."""
    s = _f32(scales)
    if method == "scale_bias":
        return _f32(mlx_biases)
    if method == "scale_zero_point":
        kg = s.shape[1]
        zp = np.asarray(zero_points_packed)
        if bits == 4:
            unpacked = np.stack([zp & 0xF, zp >> 4], axis=-1).reshape(zp.shape[0], -1)[:, :kg]
        else:
            unpacked = zp[:, :kg]
        return (-s * unpacked.astype(np.float32)).astype(np.float32)
    if method == "scale_symmetric":
        midpoint = float(1 << (bits - 1))
        return (-s * midpoint).astype(np.float32)
    raise ValueError(f"unknown quantization method {method!r}")


def _f32(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return bf16_to_f32(a) if a.dtype == BF16 else a.astype(np.float32)


def quantize_reference(
    w: np.ndarray, bits: int, group_size: int, method: str = "scale_symmetric", dtype=BF16
) -> dict[str, np.ndarray]:
    """Quantize a float [N, K] matrix into on-disk tensors (for tests/tools).

    Returns dict with keys weights/scales (+biases or zero_points) in the
    safetensors layout; float outputs are in `dtype` (BF16 by default).
    """
    n, k = w.shape
    if k % group_size:
        raise ValueError("partial trailing groups unsupported in the quantizer")
    levels = (1 << bits) - 1
    grouped = w.reshape(n, k // group_size, group_size).astype(np.float32)
    if method == "scale_symmetric":
        amax = np.abs(grouped).max(axis=-1, keepdims=True)
        mid = float(1 << (bits - 1))
        scale = amax / mid
        scale = np.where(scale == 0, 1e-8, scale)
        codes = np.clip(np.round(grouped / scale + mid), 0, levels).astype(np.uint8)
        out = {
            "weights": pack_codes(codes.reshape(n, k), bits),
            "scales": cast(scale[..., 0], dtype),
        }
    elif method == "scale_bias":
        wmin = grouped.min(axis=-1, keepdims=True)
        wmax = grouped.max(axis=-1, keepdims=True)
        scale = (wmax - wmin) / levels
        scale = np.where(scale == 0, 1e-8, scale)
        codes = np.clip(np.round((grouped - wmin) / scale), 0, levels).astype(np.uint8)
        out = {
            "weights": pack_codes(codes.reshape(n, k), bits),
            "scales": cast(scale[..., 0], dtype),
            "biases": cast(wmin[..., 0], dtype),
        }
    elif method == "scale_zero_point":
        wmin = grouped.min(axis=-1, keepdims=True)
        wmax = grouped.max(axis=-1, keepdims=True)
        scale = (wmax - wmin) / levels
        scale = np.where(scale == 0, 1e-8, scale)
        zp = np.clip(np.round(-wmin / scale), 0, levels).astype(np.uint8)
        codes = np.clip(np.round(grouped / scale) + zp, 0, levels).astype(np.uint8)
        kg = k // group_size
        zp2 = zp[..., 0]
        if bits == 4:
            if kg % 2:
                zp2 = np.concatenate([zp2, np.zeros((n, 1), np.uint8)], axis=1)
            zp_packed = (zp2[:, 0::2] | (zp2[:, 1::2] << 4)).astype(np.uint8)
        else:
            zp_packed = zp2
        out = {
            "weights": pack_codes(codes.reshape(n, k), bits),
            "scales": cast(scale[..., 0], dtype),
            "zero_points": zp_packed,
        }
    else:
        raise ValueError(method)
    return out


def from_disk_tensors(
    method: str,
    weights: np.ndarray,
    scales: np.ndarray,
    bits: int,
    group_size: int,
    zero_points: np.ndarray | None = None,
    biases: np.ndarray | None = None,
    dtype=torch.bfloat16,
    device=None,
) -> QuantizedTensor:
    """Build the canonical in-memory form from on-disk (numpy) tensors."""
    codes = to_torch(weights, device)
    scales_t = torch.from_numpy(_f32(scales)).to(dtype).to(device)
    if method == "scale_symmetric":
        # qbias == -midpoint * scales exactly: carry the coefficient, skip
        # the stream (bit-identical — power-of-two multiply is exact).
        return QuantizedTensor(
            codes=codes, scales=scales_t, qbias=None, bits=bits,
            group_size=group_size, qbias_coeff=-float(1 << (bits - 1)),
        )
    qbias = make_qbias(method, scales, bits, zero_points, biases)
    return QuantizedTensor(
        codes=codes, scales=scales_t,
        qbias=torch.from_numpy(qbias).to(dtype).to(device),
        bits=bits, group_size=group_size,
    )

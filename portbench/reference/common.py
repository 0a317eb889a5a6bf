"""Shared pieces of the reference: dequantization of the raw INT4 file
layout, RMSNorm, linear, and the control's fp8 rounding."""

from __future__ import annotations

import torch

ROW_BLOCK = 4096  # rows per product, so that a 32k-token sequence fits


def dequantize(raw: dict, name: str, group: int) -> torch.Tensor:
    """f32 [N, K]: w = scale * (code - 8), codes two to a byte, low nibble
    first, scales one per `group` inputs."""
    codes, scales = raw[name + ".codes"], raw[name + ".scales"]
    n = codes.shape[0]
    q = torch.stack([codes & 0xF, codes >> 4], dim=-1).reshape(n, -1).float() - 8.0
    return (q.view(n, -1, group) * scales.float()[..., None]).view(n, -1)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (the control)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ops:
    """Linear and rounding for one precision: f32 throughout, or (lowp)
    fp8 activations into every product and attention."""

    def __init__(self, lowp: bool = False):
        self.lowp = lowp

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.lowp else x

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [n, K] @ w[N, K]^T in f32, ROW_BLOCK rows at a time."""
        return torch.cat([self.round(x[i:i + ROW_BLOCK]) @ w.t()
                          for i in range(0, x.shape[0], ROW_BLOCK)])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w

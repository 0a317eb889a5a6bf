"""Activations + gated-act-mul; counterpart of `uzu_tpu/ops/activation.py`.

SiLU with alpha, exact/approximate GELU, identity, and out = act(gate) * up
with optional per-side clipping, all in f32 internally.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config.model import GELU, Identity, SiLU


def apply_activation(cfg, x: torch.Tensor) -> torch.Tensor:
    if isinstance(cfg, SiLU):
        xf = x.float()
        return (xf * torch.sigmoid(cfg.alpha * xf)).to(x.dtype)
    if isinstance(cfg, GELU):
        xf = x.float()
        if cfg.approximate:
            return F.gelu(xf, approximate="tanh").to(x.dtype)
        return (xf * (torch.erf(xf / math.sqrt(2.0)) + 1.0) / 2.0).to(x.dtype)
    if isinstance(cfg, Identity):
        return x
    raise ValueError(f"unsupported activation {type(cfg).__name__}")


def _clip(x: torch.Tensor, clipping) -> torch.Tensor:
    if clipping is None:
        return x
    lo, hi = clipping
    if lo is not None:
        x = torch.clamp(x, min=lo)
    if hi is not None:
        x = torch.clamp(x, max=hi)
    return x


def gated_act_mul(activation_cfg, gate, up, gate_clipping=None, up_clipping=None):
    """act(clip(gate)) * clip(up), f32 internally."""
    out_dtype = gate.dtype
    gate = _clip(gate.float(), gate_clipping)
    up = _clip(up.float(), up_clipping)
    return (apply_activation(activation_cfg, gate) * up).to(out_dtype)

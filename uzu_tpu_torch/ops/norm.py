"""Normalization (RMS / LayerNorm); counterpart of `uzu_tpu/ops/norm.py`.

f32 accumulation, variance = E[x^2] - mean^2, `scale + scale_offset`
affine, and two upcast modes:

- FULL_LAYER: normalized value and affine multiply both in f32, then cast;
- ONLY_NORMALIZATION: normalized value cast to the output dtype first, the
  affine multiply happens in the output dtype (Llama-style bf16 weights).
"""

from __future__ import annotations

import torch

from ..config.model import NormalizationConfig, UpcastMode


def normalize(x: torch.Tensor, cfg: NormalizationConfig, scales=None, biases=None,
              out_dtype=None) -> torch.Tensor:
    """Apply RMS/LayerNorm over the last axis.

    x: [..., D]; scales: [D] or None (pure normalization); biases: optional [D].
    """
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    if cfg.subtract_mean:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    else:
        mean = 0.0
        var = (xf * xf).mean(dim=-1, keepdim=True)
    normalized = (xf - mean) * torch.rsqrt(var + cfg.epsilon)
    offset = cfg.scale_offset if cfg.scale_offset is not None else 0.0
    if scales is None:
        scale = torch.tensor(1.0 + offset, dtype=torch.float32, device=x.device)
    else:
        scale = scales.float() + offset
    if cfg.upcast_mode == UpcastMode.FULL_LAYER:
        result = (normalized * scale).to(out_dtype)
    else:
        result = normalized.to(out_dtype) * scale.to(out_dtype)
    if biases is not None:
        result = (result.float() + biases.float()).to(out_dtype)
    return result

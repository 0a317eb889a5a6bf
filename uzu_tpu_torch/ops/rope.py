"""RoPE table computation + application for the full config family.

Counterpart of `uzu_tpu/ops/rope.py`: unscaled / linear / Llama-3
wavelength-ramped / YaRN (with attention scaling 0.1*ln(s)+1) / LongRoPE
per-pair factors. Inverse frequencies are a small host array computed once
per config; the cos/sin tables are computed on the device from the
position tensor, so a decode step needs no host round-trip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config.model import (
    LinearScalingRoPEConfig,
    LlamaRoPEConfig,
    LongRoPEConfig,
    UnscaledRoPEConfig,
    YARNRoPEConfig,
)


def inverse_frequencies(cfg) -> tuple[np.ndarray, float]:
    """Return (inv_freq [head_dim//2] f32, attention_scaling_factor)."""
    head_dim = cfg.head_dim
    assert head_dim > 0 and head_dim % 2 == 0
    half = head_dim // 2
    pair = np.arange(half, dtype=np.float64)
    inv = 1.0 / np.power(float(cfg.base), (pair * 2.0) / head_dim)
    attn_scale = 1.0

    if isinstance(cfg, UnscaledRoPEConfig):
        pass
    elif isinstance(cfg, LinearScalingRoPEConfig):
        inv = inv / cfg.scaling_factor
    elif isinstance(cfg, LlamaRoPEConfig):
        low_wl = cfg.original_context_length / cfg.low_frequency_factor
        high_wl = cfg.original_context_length / cfg.high_frequency_factor
        wavelength = 2.0 * math.pi / inv
        scaled = inv / cfg.scaling_factor
        smooth = (cfg.original_context_length / wavelength - cfg.low_frequency_factor) / (
            cfg.high_frequency_factor - cfg.low_frequency_factor
        )
        mid = smooth * inv + (1.0 - smooth) * scaled
        inv = np.where(wavelength < high_wl, inv, np.where(wavelength > low_wl, scaled, mid))
    elif isinstance(cfg, YARNRoPEConfig):
        dim = float(head_dim)
        base = float(cfg.base)
        octx = float(cfg.original_context_length)
        low = dim * math.log(octx / (cfg.beta_fast * 2.0 * math.pi)) / (2.0 * math.log(base))
        high = dim * math.log(octx / (cfg.beta_slow * 2.0 * math.pi)) / (2.0 * math.log(base))
        if cfg.truncate:
            low, high = math.floor(low), math.ceil(high)
        low = max(low, 0.0)
        high = min(high, float(head_dim - 1))
        if low == high:
            high += 0.001
        ramp = np.clip((pair - low) / (high - low), 0.0, 1.0)
        smoothing = 1.0 - ramp
        scaled = inv / cfg.scaling_factor
        inv = scaled * (1.0 - smoothing) + inv * smoothing
        attn_scale = 0.1 * math.log(cfg.scaling_factor) + 1.0
    elif isinstance(cfg, LongRoPEConfig):
        factors = (
            cfg.long_factor
            if cfg.max_sequence_length > cfg.original_context_length
            else cfg.short_factor
        )
        inv = inv / np.asarray(factors, dtype=np.float64)
        if cfg.scaling_factor > 1.0:
            attn_scale = math.sqrt(
                1.0 + math.log(cfg.scaling_factor) / math.log(cfg.original_context_length)
            )
    else:
        raise ValueError(f"unsupported rope config {type(cfg).__name__}")

    return inv.astype(np.float32), float(attn_scale)


def rope_tables(inv_freq: torch.Tensor, attn_scale: float, positions: torch.Tensor):
    """cos/sin [S, half] f32 from positions [S] (computed on device)."""
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles) * attn_scale, torch.sin(angles) * attn_scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half (neox-style) RoPE, possibly partial rotary.

    x: [S, H, D]; cos/sin: [S, R//2] where rope_dim R <= D.
    """
    half = cos.shape[-1]
    rope_dim = 2 * half
    x1 = x[..., :half].float()
    x2 = x[..., half:rope_dim].float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rope_dim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rope_dim:]], dim=-1)

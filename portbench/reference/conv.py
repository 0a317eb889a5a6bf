"""LFM2's ShortConv as published: in_proj to [B | C | x], B * x through a
depthwise causal conv of L taps (weights [D, L], the last tap on the
current row), C times that, then out_proj."""

from __future__ import annotations

import torch

from .common import dequantize


def weights(spec, raw: dict, p: str) -> dict:
    g = spec.group_size
    return {"in": dequantize(raw, p + "in", g), "out": dequantize(raw, p + "out", g),
            "conv": raw[p + "conv"].float()}


def forward(spec, w: dict, h: torch.Tensor, ops) -> torch.Tensor:
    n, d = h.shape
    taps = w["conv"].shape[1]
    proj = ops.linear(h, w["in"])
    b, c, x = proj[:, :d], proj[:, d:2 * d], proj[:, 2 * d:]
    bx = torch.cat([torch.zeros(taps - 1, d, device=h.device), b * x])
    conv = sum(bx[j:j + n] * w["conv"][:, j] for j in range(taps))
    return ops.linear(c * conv, w["out"])

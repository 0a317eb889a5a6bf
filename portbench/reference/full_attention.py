"""GQA attention as Qwen3 and LFM2 publish it: qkv projections, RMS norm
of each query and key head, rotate-half RoPE (angles in float64), causal
softmax attention with scale head_dim^-1/2, query head h reading KV head
h // (heads / kv_heads), then the out projection."""

from __future__ import annotations

import torch

from .common import dequantize, rms_norm

Q_BLOCK = 512  # query rows per score block


def weights(spec, raw: dict, p: str) -> dict:
    g = spec.group_size
    return {"qkv": dequantize(raw, p + "qkv", g), "out": dequantize(raw, p + "out", g),
            "q_norm": raw[p + "q_norm"].float(), "k_norm": raw[p + "k_norm"].float()}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, heads, dh] at positions 0..n-1."""
    n, _, dh = x.shape
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) * 2 / dh))
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(spec, w: dict, h: torch.Tensor, ops) -> torch.Tensor:
    n = h.shape[0]
    hh, g, dh = spec.heads, spec.kv_heads, spec.head_dim
    rep = hh // g
    qkv = ops.linear(h, w["qkv"])
    q = qkv[:, :hh * dh].reshape(n, hh, dh)
    k = qkv[:, hh * dh:(hh + g) * dh].reshape(n, g, dh)
    v = qkv[:, (hh + g) * dh:].reshape(n, g, dh)
    q = rope(rms_norm(q, w["q_norm"], spec.qk_norm_eps), spec.rope_theta)
    k = rope(rms_norm(k, w["k_norm"], spec.qk_norm_eps), spec.rope_theta)
    q, k, v = (ops.round(t.reshape(n, -1)).reshape(t.shape) for t in (q, k, v))
    kt = k.permute(1, 2, 0)  # [g, dh, n]
    vg = v.permute(1, 0, 2)  # [g, n, dh]
    out = torch.empty(n, hh * dh, device=h.device)
    scale = dh ** -0.5
    for a in range(0, n, Q_BLOCK):
        b = min(n, a + Q_BLOCK)
        qb = q[a:b].reshape(b - a, g, rep, dh).permute(1, 2, 0, 3).reshape(g, rep * (b - a), dh)
        s = (qb @ kt[:, :, :b]).view(g, rep, b - a, b) * scale
        mask = torch.arange(b, device=h.device)[None, :] > torch.arange(a, b, device=h.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        pr = torch.softmax(s, dim=-1).view(g, rep * (b - a), b)
        o = (pr @ vg[:, :b]).view(g, rep, b - a, dh).permute(2, 0, 1, 3)
        out[a:b] = o.reshape(b - a, hh * dh)
    return ops.linear(out, w["out"])

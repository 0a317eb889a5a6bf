"""Attention as Jamba publishes it: qkv projections without biases or head
norms, no positional encoding, causal softmax attention with scale
head_dim^-1/2, query head h reading KV head h // (heads / kv_heads), then
the out projection."""

from __future__ import annotations

import torch

from .common import dequantize

Q_BLOCK = 512  # query rows per score block


def weights(spec, raw: dict, p: str) -> dict:
    g = spec.group_size
    return {"qkv": dequantize(raw, p + "qkv", g), "out": dequantize(raw, p + "out", g)}


def forward(spec, w: dict, h: torch.Tensor, ops) -> torch.Tensor:
    n = h.shape[0]
    hh, g, dh = spec.heads, spec.kv_heads, spec.head_dim
    rep = hh // g
    qkv = ops.linear(h, w["qkv"])
    q = ops.round(qkv[:, :hh * dh]).reshape(n, hh, dh)
    k = ops.round(qkv[:, hh * dh:(hh + g) * dh]).reshape(n, g, dh)
    v = ops.round(qkv[:, (hh + g) * dh:]).reshape(n, g, dh)
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

"""Jamba's Mamba-1 mixer as published (the `jamba` model code's slow path),
over a whole sequence from a zero state:

    [x | z] = in_proj(h);  x = silu(causal depthwise conv(x) + conv_bias)
    [dt | B | C] = x_proj(x);  dt, B, C = RMSNorm(dt), RMSNorm(B), RMSNorm(C)
    delta = softplus(dt_proj(dt) + dt_bias);  A = -exp(A_log)   [Di, N]
    h_t = exp(delta_t A) * h_{t-1} + delta_t B_t x_t;  y_t = h_t C_t + D x_t
    out = out_proj(y * silu(z))

The recurrence is evaluated in blocks of BLOCK rows, each cut into chunks
of CHUNK rows: within every chunk at once, the state from a zero start
and the running product of the decays, step by step; then the chunks'
starting states in order; then each row's state is its chunk-local state
plus the running decay times its chunk's starting state. The same
recurrence, reordered only in where its products are summed; every
factor is a decay <= 1, so nothing overflows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kinds.mamba1 import mapped
from .common import dequantize, rms_norm

BLOCK = 2048  # rows per block of the scan
CHUNK = 64  # rows per chunk inside a block


def weights(spec, raw: dict, p: str) -> dict:
    g = spec.group_size
    w = {name: dequantize(raw, p + name, g) for name in ("in", "x", "dt", "out")}
    w.update(mapped(raw, p))
    for name in ("conv", "D", "dt_norm", "b_norm", "c_norm"):
        w[name] = raw[p + name].float()
    return w


def scan(x, delta, bm, cm, a):
    """x, delta [S, Di]; bm, cm [S, N]; a [Di, N] -> y [S, Di] (without the
    D x skip): h_t C_t for the recurrence above, from h_0 = 0."""
    s, di = x.shape
    n = a.shape[1]
    y = torch.empty(s, di, device=x.device)
    h = torch.zeros(di, n, device=x.device)
    for a0 in range(0, s, BLOCK):
        t = min(BLOCK, s - a0)
        pad = (-t) % CHUNK
        dl, xb = delta[a0:a0 + t], x[a0:a0 + t]
        decay = torch.exp(dl[:, :, None] * a)  # [t, Di, N]
        inp = (dl * xb)[:, :, None] * bm[a0:a0 + t, None, :]
        if pad:  # identity rows: decay 1, input 0
            decay = torch.cat([decay, torch.ones(pad, di, n, device=x.device)])
            inp = torch.cat([inp, torch.zeros(pad, di, n, device=x.device)])
        decay = decay.view(-1, CHUNK, di, n)
        inp = inp.view(-1, CHUNK, di, n)
        local = torch.empty_like(inp)  # each chunk's state from a zero start
        run = torch.empty_like(decay)  # each chunk's running product of decays
        local[:, 0], run[:, 0] = inp[:, 0], decay[:, 0]
        for i in range(1, CHUNK):
            local[:, i] = decay[:, i] * local[:, i - 1] + inp[:, i]
            run[:, i] = run[:, i - 1] * decay[:, i]
        starts = []
        for c in range(decay.shape[0]):
            starts.append(h)
            h = run[c, -1] * h + local[c, -1]
        states = (local + run * torch.stack(starts)[:, None]).view(-1, di, n)[:t]
        y[a0:a0 + t] = torch.einsum("tdn,tn->td", states, cm[a0:a0 + t])
        del decay, inp, local, run, states
    return y


def forward(spec, w: dict, h: torch.Tensor, ops) -> torch.Tensor:
    s = h.shape[0]
    di, n, r = spec.inner, spec.state, spec.dt_rank
    proj = ops.linear(h, w["in"])
    x, z = proj[:, :di], proj[:, di:]
    taps = w["conv"].shape[1]  # the last tap on the current row
    xp = torch.cat([torch.zeros(taps - 1, di, device=h.device), x])
    conv = sum(xp[j:j + s] * w["conv"][:, j] for j in range(taps))
    x = F.silu(conv + w["conv_bias"])
    del proj, xp, conv
    xbc = ops.linear(x, w["x"])
    dt = rms_norm(xbc[:, :r], w["dt_norm"], spec.norm_eps)
    bm = rms_norm(xbc[:, r:r + n], w["b_norm"], spec.norm_eps)
    cm = rms_norm(xbc[:, r + n:], w["c_norm"], spec.norm_eps)
    delta = F.softplus(ops.linear(dt, w["dt"]) + w["dt_bias"])
    y = scan(x, delta, bm, cm, -torch.exp(w["a_log"])) + w["D"] * x
    return ops.linear(y * F.silu(z), w["out"])

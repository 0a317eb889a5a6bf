"""Jamba's Mamba-1 mixer: in projection rows [x | z]; x = silu(causal
depthwise conv of L taps + conv bias); x projection rows [dt | B | C], each
RMS-normalized with its own weight; delta = softplus(dt_proj(dt) +
dt_bias); h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t with A =
-exp(A_log) [Di, N]; y = (h_t C_t + D x_t) silu(z); the out projection.
No RoPE.

`mapped` turns the seed's draws of the vectors whose published
initialisation is not 1 + noise into their values; the reference
(`reference/mamba1.py`) calls it too, so both sides hold the same
weights."""

from __future__ import annotations

import math

import torch

DT_MIN, DT_MAX = 1e-3, 1e-1  # Mamba's dt initialisation range


def linears(spec):
    d, di, n, r = spec.d, spec.inner, spec.state, spec.dt_rank
    return [("in", 2 * di, d), ("x", r + 2 * n, di), ("dt", di, r), ("out", d, di)]


def vectors(spec):
    di, n, r = spec.inner, spec.state, spec.dt_rank
    # drawn as 1 + std N(0, 1) (a name ending in "conv" as std N(0, 1))
    return [("conv", (di, spec.conv_kernel), 0.3), ("conv_bias", (di,), 1.0),
            ("dt_bias", (di,), 1.0), ("D", (di,), 0.1), ("dt_norm", (r,), 0.1),
            ("b_norm", (n,), 0.1), ("c_norm", (n,), 0.1)]


def mapped(raw: dict, p: str) -> dict:
    """f32 {"conv_bias", "a_log", "dt_bias"} of layer prefix `p` from the
    draws: the conv bias 0.1 N(0, 1); A_log = log(1..N) in every channel;
    dt_bias = softplus^-1(v) with v log-uniform in [DT_MIN, DT_MAX], its
    uniform from the draw's normal through the normal CDF."""
    z = raw[p + "dt_bias"] - 1.0
    u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    v = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX) - math.log(DT_MIN)))
    di, n = raw[p + "dt_bias"].shape[0], raw[p + "b_norm"].shape[0]
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=z.device))
    return {"conv_bias": 0.1 * (raw[p + "conv_bias"] - 1.0),
            "a_log": a_log.expand(di, n).contiguous(),
            "dt_bias": v + torch.log(-torch.expm1(-v))}


def port_mixer(spec, cm, norm):
    return cm.Mamba1Config(
        in_projection_config=cm.LinearConfig(), x_projection_config=cm.LinearConfig(),
        dt_projection_config=cm.LinearConfig(), out_projection_config=cm.LinearConfig(),
        conv_config=cm.SeparableCausalConvConfig(has_biases=True),
        kernel_size=spec.conv_kernel, inner_dim=spec.inner, state_dim=spec.state,
        dt_rank=spec.dt_rank, dt_norm_config=norm(spec.norm_eps),
        b_norm_config=norm(spec.norm_eps), c_norm_config=norm(spec.norm_eps),
        activation=cm.SiLU(alpha=1.0))


def port_rope(spec, cm):
    return None


def port_params(raw, p, quantized):
    m = mapped(raw, p)
    return {"in": {"w": quantized(p + "in")}, "x": {"w": quantized(p + "x")},
            "dt": {"w": quantized(p + "dt")}, "out": {"w": quantized(p + "out")},
            "conv_w": raw[p + "conv"], "conv_b": m["conv_bias"], "a_log": m["a_log"],
            "dt_bias": m["dt_bias"], "skip_weight": raw[p + "D"],
            "dt_norm": raw[p + "dt_norm"], "b_norm": raw[p + "b_norm"],
            "c_norm": raw[p + "c_norm"]}


def scan_work(spec, rows: int, states: int):
    """(FLOPs, bytes) of one selective-scan call over `rows` real rows of
    `states` sequences: per row, channel and state 6 FLOPs (delta A, the
    decay's product and sum, delta B x, C h's product and sum; exp2 not
    counted); bytes read once and written once: x, dt, z and y bf16 (4 Di),
    B and C bf16 (2 N) a row, each sequence's f32 state in and out."""
    di, n = spec.inner, spec.state
    return 6.0 * rows * di * n, rows * (8.0 * di + 4.0 * n) + states * 8.0 * di * n


def prefill_work(spec, pos0: int, take: int):
    """A chunk's conv and scan: (FLOPs, bytes) of `take` rows of one
    sequence (the conv's 2 L FLOPs and the gate's 4 a channel besides)."""
    f, b = scan_work(spec, take, 1)
    return f + (2.0 * spec.conv_kernel + 4.0) * spec.inner * take, b


def decode_work(spec, lengths):
    """One decode step: a row of each live slot."""
    f, b = scan_work(spec, len(lengths), len(lengths))
    return f + (2.0 * spec.conv_kernel + 4.0) * spec.inner * len(lengths), b

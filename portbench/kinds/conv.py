"""LFM2 ShortConv: in projection rows [B | C | x], B*x through a depthwise
causal conv of L taps, times C, then the out projection. No RoPE."""

from __future__ import annotations


def linears(spec):
    d = spec.d
    return [("in", 3 * d, d), ("out", d, d)]


def vectors(spec):
    return [("conv", (spec.d, spec.conv_kernel), 0.5)]


def port_mixer(spec, cm, norm):
    return cm.ShortConvConfig(
        in_projection_config=cm.LinearConfig(),
        conv_config=cm.SeparableCausalConvConfig(has_biases=False),
        out_projection_config=cm.LinearConfig(), kernel_size=spec.conv_kernel)


def port_rope(spec, cm):
    return None


def port_params(raw, p, quantized):
    return {"in": {"w": quantized(p + "in")}, "out": {"w": quantized(p + "out")},
            "conv_w": raw[p + "conv"]}


def prefill_work(spec, pos0: int, take: int):
    """The gates and the conv: (FLOPs, bytes) of `take` rows."""
    return 2 * spec.conv_kernel * spec.d * take + 2 * spec.d * take, 0


def decode_work(spec, lengths):
    return prefill_work(spec, 0, len(lengths))

"""The slice's reduction on a synthetic timeline: busy and idle time,
kernels per decode step by launch time, kernel groups, the breakdown."""

import pytest

from portbench import harness, trace


def _ctx():
    # host spans: a step holding a prefill then a decode dispatch of 8 steps
    spans = [("step", 0.0, 1.0, None, None), ("prefill", 0.0, 0.2, (0, 100, 128), None),
             ("decode", 0.3, 0.9, (8, [10, 20]), None)]
    device = [  # (name, start, end, is_kernel, launch time)
        ("void (anonymous namespace)::flash_fwd<bf16, 64>(float const*)", 0.05, 0.25, True, 0.1),
        ("sm80_xmma_gemm_f32f32_tn", 0.25, 0.35, True, 0.15),
        ("void (anonymous namespace)::qmm_small<4>(int)", 0.4, 0.5, True, 0.35),
        ("void paged_decode<bf16>(int)", 0.6, 0.7, True, 0.55),
        ("Memcpy HtoD (Pageable -> Device)", 0.8, 0.85, False, None),
    ]
    ctx = harness.Context.__new__(harness.Context)
    ctx.slice = {"window_s": 1.0, "t0": 0.0, "t1": 1.0, "device": device}
    ctx.slice_spans = spans
    ctx.groups = trace.kernel_groups()
    ctx.busy = trace.busy_intervals(device)
    ctx.busy_s = sum(b - a for a, b in ctx.busy)
    ctx.window_s = 1.0
    return ctx


def test_busy_idle_and_kernels_per_step():
    ctx = _ctx()
    assert ctx.busy == [(0.05, 0.35), (0.4, 0.5), (0.6, 0.7), (0.8, 0.85)]
    assert ctx.busy_s == pytest.approx(0.55)
    assert ctx.decode_kernels() == (2, 8)
    assert ctx.group_seconds("linear") == pytest.approx(0.2)
    assert ctx.group_seconds("attention") == pytest.approx(0.3)


def test_breakdown():
    b = harness.breakdown(_ctx())
    assert b["device_ops"][0] == ["flash_fwd<bf16, 64>", pytest.approx(0.2)]
    idle = dict(b["idle_gaps"])
    assert set(idle) == {"host in prefill", "host in decode", "host in step"}
    assert sum(idle.values()) == pytest.approx(0.45)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_host_label_prefers_the_innermost_span():
    spans = _ctx().slice_spans
    assert trace.host_label(spans, 0.1) == "prefill"
    assert trace.host_label(spans, 0.95) == "step"
    assert trace.host_label(spans, 1.5) == "client"

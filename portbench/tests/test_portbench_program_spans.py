"""The readers of the program's own spans (`uzu_tpu_torch/tools/profile.py`)
on a synthetic timeline: each returns its hand-computed value, nothing
without a slice, and nothing from a program that records no spans."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_trace import _ctx
from uzu_tpu_torch.tools import profile

READERS = ["engine.decode_dispatch_host_ms", "engine.queue_depth",
           "device.idle_in_decode_dispatch"]


@pytest.fixture
def recorded(monkeypatch):
    """Program spans over the slice [0, 1] of `_ctx` (busy 0.05-0.35,
    0.4-0.5, 0.6-0.7, 0.8-0.85), with spans outside it that no reader may
    count."""
    rec = profile.SpanRecorder()
    rec.ring.extend([
        # (name, start, end, id, parent, request id, counts)
        ("engine.step", 0.0, 0.98, 1, -1, -1, {"queued": 3}),
        ("engine.queued", 0.2, 0.2, 2, -1, -1, {"value": 2}),
        ("engine.decode_dispatch", 0.3, 0.6, 3, 1, -1, {"steps": 8}),
        ("engine.queued", 0.5, 0.5, 5, -1, -1, {"value": 4}),
        ("engine.decode_dispatch", 0.86, 0.9, 8, 1, -1, {"steps": 0}),
        ("engine.decode_dispatch", 1.2, 1.3, 10, -1, -1, {"steps": 8}),  # past the slice
        ("engine.queued", 1.1, 1.1, 12, -1, -1, {"value": 30}),
    ])
    monkeypatch.setattr(profile, "SPANS", rec)
    return rec


@pytest.mark.parametrize("name, want", [
    ("engine.decode_dispatch_host_ms", 1e3 * (0.3 + 0.04) / 8),
    # 3 over [0, 0.2), 2 over [0.2, 0.5), 4 over [0.5, 1]
    ("engine.queue_depth", 3 * 0.2 + 2 * 0.3 + 4 * 0.5),
    # idle 0.35-0.4 and 0.5-0.6 inside the first dispatch, 0.86-0.9 in the second
    ("device.idle_in_decode_dispatch", 100.0 * (0.05 + 0.1 + 0.04)),
])
def test_reader_values(recorded, name, want):
    assert harness._metric_reader(name)(_ctx()) == pytest.approx(want)
    # a cell's qualified name reads the same quantity
    assert harness._metric_reader(name + ".long-doc")(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_slice(recorded, name):
    ctx = _ctx()
    ctx.slice = None
    assert harness._metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_from_a_program_without_spans(monkeypatch, name):
    """The benchmark runs these readers on an earlier program too, one whose
    profiling module has no `spans`: they return None and do not raise."""
    monkeypatch.delattr(profile, "spans")
    assert harness._metric_reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_from_an_empty_slice(monkeypatch, name):
    monkeypatch.setattr(profile, "SPANS", profile.SpanRecorder())
    assert harness._metric_reader(name)(_ctx()) is None

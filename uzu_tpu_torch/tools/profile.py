"""One-shot device profiling hooks.

Counterpart of `uzu_tpu/tools/profile.py`. The engine runs its prefill
chunks and decode chunks through `profiled(phase, fn, *args)`; the first
call of an armed phase runs under `torch.profiler.profile` (host activity,
and the card's kernels and copies where a card is present), the card is
synchronized before the profiler stops so that the call's kernels land in
the window, and the trace is written in Chrome's trace format to
`<dir>/<phase>_<unix time>/trace.json` (Perfetto and chrome://tracing read
it). The synchronization holds back the pipelining of that one chunk,
which profiling a single call cannot avoid.

Arming:
    UZU_TPU_PROFILE=prefill,decode   phases to capture (one-shot each)
    UZU_TPU_PROFILE_DIR=...          trace output root (default:
                                     .port_cache/traces in the checkout)

As in the JAX package, where the profiler cannot start or stop the call
runs unprofiled with a warning on stderr. On the card `chip_smoke.py`
fails a run whose prefill or decode trace is missing or holds no kernel of
the port, so a capture lost there does not go unnoticed.

Program spans. The batch engines (`engine/batch.py`, `engine/paged_batch.py`)
record spans while any `torch.profiler` session runs (a `profiled()`
capture, a benchmark's traced slice, an operator's own profiler), read by
`spans(t0, t1)`. A span is the tuple (name, start, end, span id, parent
span id, request id or -1, {counts}); times are `time.perf_counter()`
seconds, the clock of `Request.submitted_at`. The spans and what they
count are listed in `engine/batch.py`'s `BatchEngineBase`. A gauge sample is a span
with start == end, no parent and {"value": n}. Spans live in memory only,
in a ring of the last `SPAN_RING` of them. Each span site reads
`torch_profiler._is_profiler_enabled` (`torch.autograd.profiler`), the
flag torch sets while a session runs, and does nothing more while it is
off. The spans are not `record_function` ranges, so they add nothing to
the profiler's trace or to the card's timeline.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as torch_profiler

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".port_cache", "traces")
_armed: dict[str, bool] | None = None


def _load_armed() -> dict[str, bool]:
    global _armed
    if _armed is None:
        phases = os.environ.get("UZU_TPU_PROFILE", "")
        _armed = {p.strip(): True for p in phases.split(",") if p.strip()}
    return _armed


def trace_dir() -> str:
    return os.environ.get("UZU_TPU_PROFILE_DIR", _DEFAULT_DIR)


def reset() -> None:
    """Re-read the env and re-arm."""
    global _armed
    _armed = None


def profiled(phase: str, fn, *args):
    """Run fn(*args); if `phase` is armed, capture the call (host dispatch
    and device execution) into a one-shot profiler trace and disarm."""
    armed = _load_armed()
    if not armed.get(phase):
        return fn(*args)
    armed[phase] = False  # one-shot, even if the capture itself fails
    out_dir = os.path.join(trace_dir(), f"{phase}_{int(time.time())}")
    on_card = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # start/stop explicitly: fn must run EXACTLY once whether or not the
    # profiler works here (it updates the KV cache in place)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
        started = True
    except RuntimeError as e:
        print(f"uzu_tpu_torch: {phase} profile capture unavailable ({e}); running "
              "unprofiled", file=sys.stderr)
        started = False
    try:
        out = fn(*args)
        if on_card:
            torch.cuda.synchronize()  # the call's kernels land inside the window
    finally:
        if started:
            try:
                prof.stop()
                os.makedirs(out_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
                print(f"uzu_tpu_torch: captured first {phase} -> {out_dir}", file=sys.stderr)
            except (RuntimeError, OSError) as e:
                print(f"uzu_tpu_torch: {phase} profile capture failed ({e})", file=sys.stderr)
    return out


# -- program spans ---------------------------------------------------------------------

SPAN_RING = 1 << 15  # spans kept: far above a traced slice's (~10 a scheduler step)


class SpanRecorder:
    """The ring of finished spans, and each thread's stack of open ones (a
    span's parent is the innermost span open in its thread when it began).
    Call only while `torch_profiler._is_profiler_enabled`."""

    def __init__(self, capacity: int = SPAN_RING):
        self.ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def begin(self, name: str, request_id: int = -1, **info) -> list:
        """Open a span; returns its handle for `end`."""
        stack = self._stack()
        span = [name, time.perf_counter(), next(self._ids), stack[-1][2] if stack else -1,
                request_id, info]
        stack.append(span)
        return span

    def end(self, span: list, **info) -> None:
        """Close `span` (and any span opened inside it and left open by an
        exception), adding `info` to its counts."""
        t = time.perf_counter()
        stack = self._stack()
        while stack and stack.pop() is not span:
            pass
        span[5].update(info)
        self.ring.append((span[0], span[1], t, span[2], span[3], span[4], span[5]))

    def gauge(self, name: str, value) -> None:
        t = time.perf_counter()
        self.ring.append((name, t, t, next(self._ids), -1, -1, {"value": value}))


SPANS = SpanRecorder()


def spans(t0: float, t1: float) -> list:
    """The recorded spans and gauge samples that lie within [t0, t1]
    (perf_counter seconds), in the order they ended."""
    return [s for s in list(SPANS.ring) if s[1] >= t0 and s[2] <= t1]

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
"""

from __future__ import annotations

import os
import sys
import time

import torch

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

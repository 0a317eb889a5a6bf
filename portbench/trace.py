"""A `torch.profiler` slice of the window, read into device intervals.

The slice starts and ends at step boundaries, each after a device
synchronisation, so the work enqueued inside it runs inside it. Device
activities (kernels, copies, sets) come from the profiler's CUPTI trace;
each kernel is tied to the host time of its launch through the runtime
call's correlation id, and so to the benchmark's host spans. The trace is
read in memory; nothing is written to disk.
"""

from __future__ import annotations

import glob
import os
import re
import time

import torch

from .spec import HERE

_LAUNCH = re.compile(r"(cuda|cu)LaunchKernel")


def kernel_groups() -> dict[str, list]:
    """{group: [compiled pattern]} from kernel_groups/<group>/*.txt, one
    regular expression a line ('#' starts a comment)."""
    groups = {}
    for folder in sorted(glob.glob(os.path.join(HERE, "kernel_groups", "*"))):
        pats = []
        for path in sorted(glob.glob(os.path.join(folder, "*.txt"))):
            with open(path) as f:
                pats += [re.compile(line.strip()) for line in f
                         if line.strip() and not line.startswith("#")]
        groups[os.path.basename(folder)] = pats
    return groups


class Slice:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None  # perf_counter seconds
        self.offset_ns = None  # unix ns - perf_counter ns

    def start(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self) -> dict:
        """{"window_s", "device": [(name, start s, end s, is_kernel,
        launch s or None)]}, all on the perf_counter clock."""
        lo_ns = self.t0 * 1e9 + self.offset_ns
        hi_ns = self.t1 * 1e9 + self.offset_ns
        launches, device = {}, []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                device.append(e)
            elif _LAUNCH.search(e.name()):
                launches[e.correlation_id()] = e.start_ns()
        out = []
        for e in device:
            s, t = max(e.start_ns(), lo_ns), min(e.end_ns(), hi_ns)
            if t <= s:
                continue
            name = e.name()
            is_kernel = not (name.startswith("Memcpy") or name.startswith("Memset"))
            launch = launches.get(e.correlation_id())
            out.append((name, (s - self.offset_ns) / 1e9, (t - self.offset_ns) / 1e9, is_kernel,
                        None if launch is None else (launch - self.offset_ns) / 1e9))
        self.prof = None
        return {"window_s": self.t1 - self.t0, "t0": self.t0, "t1": self.t1, "device": out}


def busy_intervals(device: list) -> list[tuple[float, float]]:
    """The union of the device activities' intervals, sorted."""
    merged = []
    for _, s, t, _, _ in sorted(device, key=lambda d: d[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(a, b) for a, b in merged]


def idle_gaps(busy: list, t0: float, t1: float) -> list[tuple[float, float]]:
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def host_label(spans: list, t: float) -> str:
    """What the host was doing at time t: the innermost benchmark span
    covering it ("prefill", "decode", "read", else "step"), or "client"
    (the loop's own bookkeeping between steps)."""
    best = None
    for kind, a, b, _, _ in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (kind, b - a)
    return "client" if best is None else best[0]


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without "void", anonymous namespaces and its
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]

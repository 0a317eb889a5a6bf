"""Host/device telemetry: memory, CPU time, device memory in use.

Counterpart of `uzu_tpu/tools/telemetry.py`, with the same dataclasses and
`ResourceMeter` (the start/stop contract of a power meter; energy sensors
are not read, so a reading holds time, memory and CPU). Host RSS and peak
RSS come from /proc and getrusage; device memory is what PyTorch's CUDA
caching allocator holds for live tensors (`torch.cuda.memory_stats()`),
where the JAX package counts `jax.live_arrays()`. Without a card there is
no device reading (None).
"""

from __future__ import annotations

import dataclasses
import os
import resource
import time

import torch


@dataclasses.dataclass
class HostMemory:
    rss_bytes: int
    peak_rss_bytes: int


@dataclasses.dataclass
class DeviceMemory:
    live_buffer_bytes: int
    num_live_buffers: int


@dataclasses.dataclass
class TelemetrySample:
    wall_time: float
    cpu_seconds: float
    host: HostMemory
    device: DeviceMemory | None


def host_memory() -> HostMemory:
    rss = 0
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        pass
    # ru_maxrss is KiB on Linux
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return HostMemory(rss_bytes=rss, peak_rss_bytes=peak)


def device_memory() -> DeviceMemory | None:
    """Bytes and count of the allocations the CUDA caching allocator holds
    for live tensors on the current card; None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return DeviceMemory(
        live_buffer_bytes=int(stats.get("allocated_bytes.all.current", 0)),
        num_live_buffers=int(stats.get("allocation.all.current", 0)),
    )


def sample() -> TelemetrySample:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return TelemetrySample(
        wall_time=time.time(),
        cpu_seconds=ru.ru_utime + ru.ru_stime,
        host=host_memory(),
        device=device_memory(),
    )


@dataclasses.dataclass
class MeterReading:
    """Per-interval resource deltas."""

    duration_s: float
    cpu_seconds: float
    cpu_utilization: float
    rss_delta_bytes: int
    peak_rss_bytes: int
    device_buffer_delta_bytes: int


class ResourceMeter:
    """start() ... stop() -> MeterReading."""

    def __init__(self):
        self._t0: TelemetrySample | None = None
        self._wall0 = 0.0

    def start(self) -> None:
        self._wall0 = time.perf_counter()
        self._t0 = sample()

    def stop(self) -> MeterReading:
        if self._t0 is None:
            raise RuntimeError("meter not started")
        t0, self._t0 = self._t0, None
        t1 = sample()
        dur = time.perf_counter() - self._wall0
        dev0 = t0.device.live_buffer_bytes if t0.device else 0
        dev1 = t1.device.live_buffer_bytes if t1.device else 0
        cpu = t1.cpu_seconds - t0.cpu_seconds
        return MeterReading(
            duration_s=dur,
            cpu_seconds=cpu,
            cpu_utilization=cpu / dur if dur > 0 else 0.0,
            rss_delta_bytes=t1.host.rss_bytes - t0.host.rss_bytes,
            peak_rss_bytes=t1.host.peak_rss_bytes,
            device_buffer_delta_bytes=dev1 - dev0,
        )

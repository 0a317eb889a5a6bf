"""Single-stream decode measured against the device's memory rate.

The port's copy of what the JAX package's bench tools take from the
repo-root `bench.py`: `device_bandwidth` (`bench.py:140-147`, table
`:43-53`), `weight_bytes` (`:207-210`), `HbmProbe` (`:213-245`) and
`probe_interleaved_decode` (`:252-300`). The model benches beside it
(`bench8b`, `benchmoe`, `bench_qwen08`) build on it, and so does the
port's own bench when it comes.

A decode step of a weight-streaming model is bound by the bytes it reads:
`sol_tok_s` is the device's spec memory rate over the bytes a step
touches, `vs_baseline` the measured rate over it. `HbmProbe` measures the
rate the device delivers at the time (a bf16 reduction over a buffer far
larger than L2), read right after each decode run, so `vs_practical`
divides out what the spec sheet does not promise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..engine.engine import StreamMetrics, _tensors

# Spec memory rate (bytes/s) by card name (NVIDIA's data sheet). A card
# not listed raises: a bound taken from another card's figure would be
# wrong by that card's ratio.
HBM_BW = {
    "H100 80GB HBM3": 3.35e12,
}
# The host has no spec rate; this nominal figure (the JAX package's own
# for its CPU backend) only keeps vs_baseline a finite fraction there.
CPU_NOMINAL_BW = 100e9


def device_bandwidth(device=None) -> tuple[str, float]:
    """(device name, spec memory rate in bytes/s) of `device` (None: the
    card). A card without an entry in HBM_BW raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu", CPU_NOMINAL_BW
    kind = torch.cuda.get_device_name(dev)
    for key, bw in HBM_BW.items():
        if key in kind:
            return kind, bw
    raise ValueError(f"no spec memory rate is known for {kind!r}; add it to HBM_BW")


def weight_bytes(params) -> int:
    """Bytes of every tensor of a parameter tree (quantized codes and
    scales included)."""
    return sum(t.numel() * t.element_size() for t in _tensors(params))


class HbmProbe:
    """The memory rate (bytes/s) the device delivers now: eight fp32-sum
    reductions of a bf16 buffer (1 GiB on the card, 2^22 elements on the
    host) queued back to back, then one wait. A library reduction is the
    right tool here: the probe measures the device, not a kernel of the
    port. Stateful so the buffer is made once and each `measure()` is
    cheap enough to sit between the decode runs it normalizes."""

    READS = 8

    def __init__(self, device=None):
        dev = torch.device("cuda" if device is None else device)
        n = (1 << 29) if dev.type == "cuda" else (1 << 22)
        self._x = torch.ones(n, dtype=torch.bfloat16, device=dev)
        self._x.sum(dtype=torch.float32).cpu()  # allocate and warm

    def measure(self, reps: int = 1) -> float:
        nbytes = self._x.numel() * self._x.element_size()
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            acc = None
            for _ in range(self.READS):
                acc = self._x.sum(dtype=torch.float32)
            acc.cpu()
            rates.append(self.READS * nbytes / (time.perf_counter() - t0))
        return float(np.median(rates))


def probe_interleaved_decode(lm, prompt, gen_len, sampling, bytes_per_step,
                             *, runs=2, record_ttft=False, agg="max",
                             stage=None) -> dict:
    """Single-stream decode of `gen_len` tokens measured `runs` times, each
    followed by a probe reading on the model's device, so that a change of
    the device's rate between runs cancels pair by pair. Returns
    decode_tok_s (`agg`="max": the best run; "median"), sol_tok_s and
    vs_baseline against the device's spec rate over `bytes_per_step`,
    practical_bw_gbs and vs_practical against the probe, and ttft_s (the
    median prefill time) when `record_ttft`. The caller warms the model
    first. The JAX package's `notes` and `on_tpu` are gone: a probe that
    cannot start raises (no run leaves the practical keys out), and the
    probe runs on the model's device."""
    if stage is not None:
        stage("hbm probe warm")
    probe = HbmProbe(lm.device)
    out: dict = {}
    rates, ttfts, ratios, bws = [], [], [], []
    for _ in range(runs):
        metrics = StreamMetrics()
        toks = list(lm.generate(prompt, gen_len, sampling=sampling,
                                stop_token_ids=[], metrics=metrics))
        if len(toks) != gen_len:
            raise RuntimeError(f"expected {gen_len} tokens, got {len(toks)}")
        rates.append(metrics.decode_tokens_per_second)
        ttfts.append(metrics.prefill_seconds)
        bw_now = probe.measure()
        bws.append(bw_now)
        ratios.append(metrics.decode_tokens_per_second / (bw_now / bytes_per_step))
    pick = np.max if agg == "max" else np.median
    out["decode_tok_s"] = round(float(pick(rates)), 2)
    if record_ttft:
        out["ttft_s"] = round(float(np.median(ttfts)), 4)
    _, bw = device_bandwidth(lm.device)
    out["sol_tok_s"] = round(bw / bytes_per_step, 2)
    out["vs_baseline"] = round(out["decode_tok_s"] / out["sol_tok_s"], 4)
    out["practical_bw_gbs"] = round(float(np.median(bws)) / 1e9, 1)
    out["vs_practical"] = round(float(np.median(ratios)), 4)
    return out

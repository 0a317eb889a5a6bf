#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`uzu_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-only   # K3/K4's rows of phase 2 alone
    python3 chip_smoke.py --paged-only   # K5/K6's rows of phase 2 alone
    python3 chip_smoke.py --qmm-only     # K1/K2's rows with K7-K10's (shared headers)
    python3 chip_smoke.py --grouped-only # K7-K10's rows alone, BN / kw sweeps, ptxas, row check

Phases, each of which ends the run with a non-zero exit if it fails:

1. build: compile every CUDA kernel of the port from `uzu_tpu_torch/csrc/`
   (one nvcc per source, in parallel) while the four models are
   synthesized (one process each); print the card's name and power limit.
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (bf16 inputs or INT8 codes, f32
   accumulation), with its time, the plain version's time, one PyTorch
   library call as a yardstick, and the bound (bytes over the HBM rate or
   FLOPs over the bf16 peak); the kernel and the yardstick are timed twice,
   as the time between two events (`ms`) and as device time alone
   (`device_ms`, the timer's spin): K1/K2 quant matmul (each row with its
   launch plan; ptxas's registers and spills of every instantiation; and a
   row-consistency check: for M = 2, 4, 8 each row of the product is
   bitwise the M=1 product of that row, bits 4 and 8), K3/K4 flash
   attention (bf16 / INT8 cache; at the end of the cache, the main path's
   first chunk, the split-KV shapes S=16/64 over 4096 slots, Dh 128, f32 q;
   each row with its split count and the kernel's ptxas registers and
   spills), K5/K6 paged decode attention (bf16 / INT8 pools of 16-512-token
   pages, uniform and ragged lengths up to 4096, window, soft cap, sinks,
   the paged engine's 1536-token table, Dh 128, f32 q and pools; each row
   with its split count and ptxas registers and spills),
   K3/K5 again at gpt-oss's heads (8 per KV group, window 128, sinks),
   K7/K8 expert-gather GEMV, K9/K10 grouped expert matmul (each row at its
   launch plan's layout, bm and geometry, through the wrappers; with
   --grouped-only also tile rows timed at every BN and small rows at every kw;
   ptxas's registers and spills of every instantiation; and a row check:
   at bm 8 each routed row's K9 output is bitwise the same whether its
   tile holds 1 or 8 rows), and P1, the bisect probe's zero-padded
   scale-block copy (bitwise equal).
3. path INT4: the Llama-1B-shaped INT4 flagship (16 layers, d 2048, vocab
   128256, random weights from a seed) loaded with `LanguageModel.from_dir`
   on the card; greedy generation of 64 tokens after a 128-token prompt,
   twice, with identical tokens; launch counts of K1 and K3 on that run;
   then once more with the INT8 KV cache (`kv_quant=True`), through K4.
4. paged INT4: `PagedBatchEngine` (8 slots, 8-step fused chunks, 64 pages
   of 512 tokens) over the same model: 11 greedy requests of 17 to 700
   prompt tokens (four share a 600-token prefix), then a follow-up that
   extends a finished request's history (the automatic prefix cache);
   each stream, fed step by step through the single-stream path, has
   every token within MARGIN of that path's best logit (so it takes the
   greedy choice wherever the top-2 margin is at least MARGIN), and the
   run takes the greedy choice at GREEDY_FLOOR of its steps or more; K5
   launched 16 times per step.
5. path INT8: the same shape with INT8 linears at 2 layers; K2 launched.
6. paged INT8: the 2-layer INT8 model with INT8 page pools; streams equal
   the dense INT8-KV single stream under the same rule; K4 and K6
   launched.
7. gpt-oss INT4: gpt-oss-20b's widths (d 2880, 64 query heads over 8 KV
   groups, 32 experts of which 4 are active, vocab 201088, sliding and
   full attention alternating, sinks) at 4 layers, bf16 attention and
   embeddings, INT4 g32 experts: the MoE routing runs with no host sync;
   a 128-token prompt and 64 greedy tokens, twice, identical; K7, K9 and
   K3 launched. Then `PagedBatchEngine` over it (11 requests, 8 slots),
   K9 launched twice per layer per decode step, K5 once per layer. Its
   streams are held, under the rule of phase 4, to the single stream
   (K7 in decode) taking the paged engine's expert choices, and each
   choice the single stream would not have made must be a router near-tie
   (ROUTER_MARGIN); the readings against the free single stream are
   reported too.
8. gpt-oss INT8 experts: 2 layers, prefill buckets up to 1024, an
   1100-token prompt and 16 greedy tokens: K10 (the 1024-row chunk) and K8
   (decode) launched.
9. control: the stream check must fail the streams of the paged engine
   when its K5 call reads the next slot's page table, and when it drops
   each slot's newest token; the MoE check of phase 7 must fail when K9
   multiplies by the next expert's weights, and when the router's decode
   rows take the experts ranked K+1 to 2K.
10. whole-path checks: teacher-forced logits of a 32-token prompt through
    the 2-layer INT4 flagship and through the 4-layer INT4 gpt-oss model,
    on the card and on the host CPU (for gpt-oss, the CPU pass takes the
    card's expert choices, each a router near-tie where they differ).
11. tools (`uzu_tpu_torch/tools/`), on the INT4 flagship: a profiler
    capture of its first prefill and decode chunk (UZU_TPU_PROFILE; the
    traces go to `.port_cache/traces/`), which must hold K1 and, in
    prefill, K3 kernel events, read for the top device ops and the
    decode window's device-busy share; `kernel_micros` (every time
    positive, K5 launched); the step breakdown of a decode step (M=1) and
    a 256-row prefill chunk; teacher-forced NLL and per-layer activation
    traces of a 256-token corpus sequence through the first 2 layers, on
    the card and on the host CPU (|dNLL| <= 1e-2 nats, each trace within
    2e-2 relative L2); and the quant-matmul bisect probe (P1's block read
    exact, K1 at a small group count and with zero-padded scale rows
    within its limits).

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Full per-shape numbers also go to
`.port_cache/chip_smoke.json`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2  # max |kernel - plain| over RMS(plain): bf16 operands, f32 sums

FLAGSHIP = dict(num_layers=16, model_dim=2048, hidden_dim=8192, num_heads=32,
                num_groups=8, head_dim=64, vocab_size=128256, max_seq=8192,
                rope_base=500000.0, llama3_rope_scaling=True)
LINEAR_SHAPES = (("qkv", 3072, 2048), ("out", 2048, 2048),
                 ("up|gate", 16384, 2048), ("down", 2048, 8192),
                 ("readout", 128256, 2048))
# gpt-oss-20b's published widths; the depth is cut to 4 layers (2 for the
# INT8-expert model) so the models synthesize and load inside the run
GPTOSS = dict(model_dim=2880, num_heads=64, num_groups=8, head_dim=64, vocab_size=201088,
              num_experts=32, num_active=4, expert_hidden_dim=2880, sliding_window=128,
              max_seq=8192)
EXPERT_SHAPES = (("up", 5760, 2880), ("down", 2880, 2880))
GEN_PROMPT, GEN_TOKENS = 128, 64
REPS = 10
# a greedy step whose single-stream top-2 logit margin is below this may
# pick the other token on another path (bf16 activations, other summation
# order); no token of a stream may lie this far below the best logit of
# the single stream fed the same history (see check_streams) ...
MARGIN = 0.125
# ... and a run's streams take the single stream's greedy choice at no
# fewer than this share of their steps
GREEDY_FLOOR = 0.9
# An MoE router's choice flips at a near-tie: the two paths' router inputs
# differ by bf16 rounding that compounds layer by layer (a few 1e-3 of
# RMS by layer 3 of gpt-oss, router logits ~N(0, 1.07): their logits differ
# by ~1e-2), and one flipped expert moves the logits far past MARGIN. So
# the single stream that the MoE streams are held to takes the expert
# choices the paged engine took (see path_paged_gptoss), and each choice
# it did not make itself may lie at most this far below its own K-th
# router logit (check_routing).
ROUTER_MARGIN = 0.125
PAGED_TOKENS = 64
CONTROL_TOKENS = 16
NLL_TOL = 1e-2  # |NLL card - NLL host| in nats over a 256-token sequence
# the bisect probe's cells, each held to max abs error over RMS(oracle):
# the f32 GEMV at M=1 is f32 throughout; at M=64 the tile rounds x and the
# weight to bf16; the bf16-scale cell is held to an f32-scale oracle
BISECT_LIMITS = {"prod_kg16": 1e-4, "prod_pad128": 1e-4, "prod_pad64": 1e-4,
                 "prod_pad32": 1e-4, "pad128_m64": 2e-2, "pad128_bf16": 2e-2}
# kernel names (csrc/) that a profiler trace must hold, per phase
TRACE_KERNELS = {"prefill": {"K1": ("qmm_small", "qmm_tile"), "K3": ("flash_fwd",)},
                 "decode": {"K1": ("qmm_small",)}}
# kernel names whose launches and summed device ms each trace reports
TRACED_PORT_KERNELS = ("qmm_small", "qmm_tile", "qmm_split_sum", "flash_fwd",
                       "flash_combine")
# rows of the product that the row-consistency check holds to the M=1 rows
ROW_CHECK_M = (2, 4, 8)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median time of `fn` between two events over REPS launches, each
    after an L2 flush (the weights of a decode step do not stay in the 50 MB
    L2). Where the host takes longer to enqueue `fn` than the card takes to
    flush, the card waits between the events and that wait is counted. With
    `spin`, the card also spins SPIN_CYCLES after the flush, so the host has
    enqueued `fn` before the start event fires: device time alone."""

    SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS, spin: bool = False) -> float:
        torch = self.torch
        fn()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def both(self, fn) -> tuple[float, float]:
        """(ms, device ms) of `fn`: without and with the spin."""
        return self.ms(fn), self.ms(fn, spin=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def rel_err(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    return d, d / max(rms, 1e-30)


# -- phase 2: kernels --------------------------------------------------------


def check_quant_matmul(torch, timer, rows) -> None:
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.ops.cuda.quant_matmul import (
        plan_blocks,
        qmm_plan,
        quant_matmul,
        quant_matmul_plain,
    )
    from uzu_tpu_torch.quant.format import QuantizedTensor, dequantize

    gen = torch.Generator(device="cuda").manual_seed(1)
    g = 32
    for bits in (4, 8):
        for wname, n, k in LINEAR_SHAPES:
            codes = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8,
                                  device="cuda", generator=gen)
            scales = (torch.rand((n, k // g), device="cuda", generator=gen) * 0.01
                      + 0.001).to(torch.bfloat16)
            qbias = (torch.randn((n, k // g), device="cuda", generator=gen) * 0.01
                     ).to(torch.bfloat16)
            for variant in ("symmetric", "stored_qbias"):
                if variant == "symmetric":
                    w = QuantizedTensor(codes, scales, None, bits, g, -float(1 << (bits - 1)))
                else:
                    w = QuantizedTensor(codes, scales, qbias, bits, g)
                wd = dequantize(w, torch.bfloat16)
                # 1: single-stream decode; 8: a paged decode step of 8 slots;
                # 16/64/256: the prefill buckets
                for m in (1, 8, 16, 64, 256):
                    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
                    got = quant_matmul(w, x)
                    want = quant_matmul_plain(w, x)
                    torch.cuda.synchronize()
                    abs_err, err = rel_err(got, want)
                    if not (err <= TOL):
                        raise AssertionError(
                            f"quant_matmul int{bits} {wname} M={m} {variant}: "
                            f"error {err:.3e} of RMS > {TOL}")
                    nbytes = (m * k * 2 + codes.numel() + scales.numel() * 2
                              + (qbias.numel() * 2 if w.qbias is not None else 0)
                              + m * n * 4)
                    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
                    ms, dev_ms = timer.both(lambda: quant_matmul(w, x))
                    lib_ms, lib_dev_ms = timer.both(lambda: torch.matmul(x, wd.t()))
                    plan = qmm_plan(m, n, k, bits, num_sms(x.device))
                    row = dict(kernel=f"quant_matmul_int{bits}", weight=wname, N=n, K=k,
                               M=m, variant=variant, plan=plan._asdict(),
                               blocks=plan_blocks(plan, m, n), max_abs_err=abs_err,
                               err_over_rms=err,
                               tol=TOL, ms=ms, device_ms=dev_ms,
                               plain_ms=timer.ms(lambda: quant_matmul_plain(w, x), 3),
                               library_ms=lib_ms, library_device_ms=lib_dev_ms,
                               bound_ms=b_ms, bound_by=b_by)
                    rows.append(row)
                    log("KERNEL " + json.dumps(row))
                del wd


def check_qmm_rows(torch, info: dict) -> None:
    """K1/K2's small-M route sums every row as the one-row product does: for
    M in ROW_CHECK_M each row of the product equals, bit for bit, the M=1
    product of that row (up|gate and a ragged shape, bits 4 and 8, both
    qbias forms)."""
    from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul
    from uzu_tpu_torch.quant.format import QuantizedTensor

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for bits in (4, 8):
        for n, k in ((16384, 2048), (300, 2880)):
            codes = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8, device="cuda",
                                  generator=gen)
            scales = (torch.rand((n, k // 32), device="cuda", generator=gen) * 0.01
                      + 0.001).to(torch.bfloat16)
            qbias = (torch.randn((n, k // 32), device="cuda", generator=gen) * 0.01
                     ).to(torch.bfloat16)
            for w in (QuantizedTensor(codes, scales, None, bits, 32, -float(1 << (bits - 1))),
                      QuantizedTensor(codes, scales, qbias, bits, 32)):
                x = torch.randn((max(ROW_CHECK_M), k), device="cuda", generator=gen
                                ).to(torch.bfloat16)
                ones = torch.cat([quant_matmul(w, x[i:i + 1]) for i in range(x.shape[0])])
                for m in ROW_CHECK_M:
                    same = bool(torch.equal(quant_matmul(w, x[:m]), ones[:m]))
                    out.append(dict(bits=bits, N=n, K=k, M=m, stored_qbias=w.qbias is not None,
                                    bitwise=same))
    info["qmm_rows"] = out
    log("QMM_ROWS " + json.dumps(out))
    bad = [r for r in out if not r["bitwise"]]
    if bad:
        raise AssertionError(f"rows of an M-row product differ from the M=1 rows: {bad}")


def template_usage(log_text: str, stem: str) -> dict:
    """ptxas's registers and spills of each instantiation of the kernels
    named `stem`_* ("qmm_tile<4, bf16, 2, 2, 4>", "grouped_small<f32, bf16,
    1>", ...) from a build log."""
    import re

    out = {}
    for dem, use in demangled_usage(log_text).items():
        m = re.search(rf"({stem}_\w+)(<[^>]*>)?", dem)
        if m:
            name = m[1] + (m[2] or "")
            out[name.replace("__nv_bfloat16", "bf16").replace("float", "f32")] = use
    return out


FLASH_VARIANTS = ("plain", "window", "softcap", "sinks")


def flash_kwargs(variant: str, sinks) -> dict:
    return {"plain": {}, "window": {"sliding_window_size": 512},
            "softcap": {"logit_soft_cap": 30.0}, "sinks": {"sinks": sinks}}[variant]


def demangled_usage(log_text: str) -> dict:
    """ptxas's registers and spills per kernel from a build log, keyed by the
    demangled name (the mangled one where c++filt is missing)."""
    from uzu_tpu_torch.ops.cuda.build import ptxas_usage

    usage = ptxas_usage(log_text)
    names = list(usage)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    return {dem: usage[name] for name, dem in zip(names, plain)}


def kernel_usage(log: str, kernel: str) -> dict:
    """ptxas's registers and spills of each `kernel<TQ, TKV, DH>` (flash_fwd,
    paged_decode) and flash_combine instantiation ("bf16/int8/64",
    "combine/64", ...) from a build log."""
    import re

    short = {"__nv_bfloat16": "bf16", "float": "f32", "signed char": "int8"}
    out = {}
    for dem, use in demangled_usage(log).items():
        m = re.search(kernel + r"<([^,]+), ([^,]+), (\d+)>", dem)
        c = re.search(r"flash_combine<(\d+)>", dem)
        if m:
            out["/".join((short.get(m[1], m[1]), short.get(m[2], m[2]), m[3]))] = use
        elif c:
            out["combine/" + c[1]] = use
    return out


def flash_row(torch, timer, rows, usage, q, kc, vc, pos0: int, variant: str, kw: dict,
              library: bool = True) -> None:
    """One K3/K4 case (K4 where kw holds scales): the kernel against its
    plain version (err/RMS <= TOL), its time, the plain version's, masked
    SDPA over the same cache (dequantized, in q's type) as the yardstick
    where `library` and no sinks or soft cap, the bound, the split plan and
    the instantiation's registers and spills. The kernel and the yardstick
    are timed as every row is (`ms`, `library_ms`) and again with the
    timer's spin (`device_ms`, `library_device_ms`)."""
    import torch.nn.functional as F

    from uzu_tpu_torch.models.kv_cache import dequantize_rows
    from uzu_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_plain,
        split_plan,
    )

    s, h, dh = q.shape
    c, g, _ = kc.shape
    rep = h // g
    quant = "k_scales" in kw
    kernel = "flash_attention_int8" if quant else "flash_attention"
    qname = "bf16" if q.dtype == torch.bfloat16 else "f32"
    scale = dh ** -0.5
    qpos = torch.arange(s, device="cuda", dtype=torch.int32) + pos0
    got = flash_attention(q, kc, vc, qpos, scale=scale, **kw)
    want = flash_attention_plain(q, kc, vc, qpos, scale=scale, **kw)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    if not (err <= TOL):
        raise AssertionError(f"{kernel} S={s} H={h} Dh={dh} C={c} pos0={pos0} q {qname} "
                             f"{variant}: error {err:.3e} of RMS > {TOL}")
    # visible keys per query row: what this run's data needs
    window = kw.get("sliding_window_size")
    qp = pos0 + torch.arange(s)
    lo = (qp - window + 1).clamp(min=0) if window else torch.zeros_like(qp)
    visible = int((qp + 1 - lo).sum())
    kv_rows = int(qp[-1] + 1 - lo[0])
    # int8 codes + one f32 scale per (slot, group), for K and V
    row_bytes = g * (dh + 4) if quant else g * dh * kc.element_size()
    nbytes = q.numel() * q.element_size() + 2 * kv_rows * row_bytes + s * h * dh * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * h * dh)
    lib_ms = lib_dev_ms = None
    if library and "sinks" not in kw and "logit_soft_cap" not in kw:
        kpos = torch.arange(c, device="cuda")
        qpd = qpos.long()[:, None]
        mask = kpos[None, :] <= qpd
        if window:
            mask &= kpos[None, :] > qpd - window
        kt, vt = ((dequantize_rows(kc, kw["k_scales"]), dequantize_rows(vc, kw["v_scales"]))
                  if quant else (kc, vc))
        qt = q.transpose(0, 1)[None]
        kt = kt.to(q.dtype).transpose(0, 1)[None].repeat_interleave(rep, dim=1)
        vt = vt.to(q.dtype).transpose(0, 1)[None].repeat_interleave(rep, dim=1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, scale=scale)
        lib_ms, lib_dev_ms = timer.both(lib)
        del kt, vt, lib
    splits, _ = split_plan(s, h, g, c, torch.cuda.get_device_properties(0).multi_processor_count)
    kv_name = "int8" if quant else qname
    run = lambda: flash_attention(q, kc, vc, qpos, scale=scale, **kw)  # noqa: E731
    ms, dev_ms = timer.both(run)
    row = dict(kernel=kernel, S=s, H=h, G=g, Dh=dh, C=c, pos0=pos0, q=qname, variant=variant,
               splits=splits, ptxas=usage.get(f"{qname}/{kv_name}/{dh}"),
               max_abs_err=abs_err, err_over_rms=err, tol=TOL,
               ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: flash_attention_plain(
                   q, kc, vc, qpos, scale=scale, **kw), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


def check_flash_attention(torch, timer, rows, usage) -> None:
    """K3 at the flagship's heads (32 over 8 groups): S 16 and 256 over C
    1024 and 4096 at the end of the cache in every variant; the main path's
    first chunk (S=256 at pos0=0 over its 1024-slot context bucket); S=64
    at C=4096 (split route); Dh=128; f32 q, k and v."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, g = 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(s, c, pos0, variants, dh=64, dtype=torch.bfloat16):
        q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
        for variant in variants:
            flash_row(torch, timer, rows, usage, q, kc, vc, pos0, variant,
                      flash_kwargs(variant, sinks))

    for s in (16, 256):
        for c in (1024, 4096):
            case(s, c, c - s - 3, FLASH_VARIANTS)
    case(256, 1024, 0, ("plain",))
    case(64, 4096, 4096 - 67, ("plain", "window"))
    case(256, 1024, 765, ("plain", "sinks"), dh=128)
    case(16, 4096, 4096 - 19, ("plain", "sinks"), dh=128)
    case(256, 1024, 765, ("plain", "softcap"), dtype=torch.float32)


def check_flash_attention_int8(torch, timer, rows, usage) -> None:
    """K4 at the flagship's prefill shapes: S=256 over C 1024 and 4096 in
    every variant, the main path's first chunk, S=16 at C=4096 (split
    route), Dh=128, and f32 q."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(4)
    h, g = 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(s, c, pos0, variants, dh=64, dtype=torch.bfloat16):
        q = torch.randn((s, h, dh), device="cuda", generator=gen).to(dtype)
        kq, ks = quantize_rows(torch.randn((c, g, dh), device="cuda", generator=gen))
        vq, vs = quantize_rows(torch.randn((c, g, dh), device="cuda", generator=gen))
        for variant in variants:
            flash_row(torch, timer, rows, usage, q, kq, vq, pos0, variant,
                      dict(flash_kwargs(variant, sinks), k_scales=ks, v_scales=vs))

    for c in (1024, 4096):
        case(256, c, c - 256 - 3, FLASH_VARIANTS)
    case(256, 1024, 0, ("plain",))
    case(16, 4096, 4096 - 19, ("plain", "sinks"))
    case(256, 1024, 765, ("plain",), dh=128)
    case(256, 1024, 765, ("plain",), dtype=torch.float32)


def paged_row(torch, timer, rows, usage, q, k, v, table, lengths, lens_name: str,
              variant: str, kw: dict, splits: int | None = None) -> None:
    """One K5/K6 case (K6 where kw holds scales): the kernel against its
    plain version (err/RMS <= TOL), its time, the plain version's, the
    bound, the split plan and the instantiation's registers and spills.
    With `splits`, the kernel takes that many splits in place of the plan's
    (1: one launch, no combine).
    The yardstick, where there are no sinks or soft cap: SDPA over the
    pre-gathered (for K6 also pre-dequantized) cache, the gather not timed;
    cut to the live tokens where every slot holds the same number and no
    window, else over the table's width with a boolean mask of each slot's
    [max(0, length - window), length). The kernel and the yardstick are
    timed as every row is (`ms`, `library_ms`) and again with the timer's
    spin (`device_ms`, `library_device_ms`)."""
    from unittest import mock

    import torch.nn.functional as F

    from uzu_tpu_torch.models.kv_cache import dequantize_rows
    from uzu_tpu_torch.ops.cuda import paged_attention as pa
    from uzu_tpu_torch.ops.cuda.paged_attention import (
        paged_attention_plain,
        paged_decode_attention,
        paged_split_plan,
    )

    b, h, dh = q.shape
    g, _, page, _ = k.shape
    maxp = table.shape[1]
    quant = "k_scales" in kw
    kernel = "paged_attention_int8" if quant else "paged_attention"
    qname = "bf16" if q.dtype == torch.bfloat16 else "f32"
    kw = dict(kw, scale=dh ** -0.5)
    plan = paged_split_plan(b, g, maxp * page,
                            torch.cuda.get_device_properties(0).multi_processor_count)

    def run():
        return paged_decode_attention(q, k, v, table, lengths, **kw)

    if splits is not None:
        tiles = -(-maxp * page // pa.TILE)
        plan = (splits, -(-tiles // splits))
        forced = run

        def run():
            with mock.patch.object(pa, "paged_split_plan", lambda *_: plan):
                return forced()

    got = run()
    want = paged_attention_plain(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    if not (err <= TOL):
        raise AssertionError(f"{kernel} page={page} H={h} q {qname} {lens_name} {variant}: "
                             f"error {err:.3e} of RMS > {TOL}")
    lens = lengths.tolist()
    window = kw.get("sliding_window_size")
    live = sum(max(0, min(n, maxp * page) - (max(0, n - window) if window else 0))
               for n in lens)
    # each live token's K and V rows once (int8: codes + one f32 scale per
    # (token, group)), q, the output, the table and lengths
    per_tok = g * (dh + 4) * 2 if quant else g * dh * k.element_size() * 2
    nbytes = (q.numel() * q.element_size() + live * per_tok + b * h * dh * 4
              + table.numel() * 4 + b * 4)
    b_ms, b_by = bound(nbytes, 4.0 * live * h * dh)
    lib_ms = lib_dev_ms = None
    if "sinks" not in kw and "logit_soft_cap" not in kw:
        uniform = len(set(lens)) == 1 and not window
        n = lens[0] if uniform else maxp * page

        def gathered(pool, sc):
            t = pool[:, table.long()].transpose(0, 1).reshape(b, g, -1, dh)
            if sc is not None:
                s_ = sc[:, table.long()].transpose(0, 1).reshape(b, g, -1)
                t = dequantize_rows(t, s_).to(q.dtype)
            return t[:, :, :n].contiguous()

        kt = gathered(k, kw.get("k_scales"))
        vt = gathered(v, kw.get("v_scales"))
        qt = q[:, :, None, :]
        mask = None
        if not uniform:
            pos = torch.arange(n, device="cuda")[None, :]
            length = lengths.long()[:, None]
            keep = pos < length
            if window:
                keep &= pos >= length - window
            mask = keep[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True)
        lib_ms, lib_dev_ms = timer.both(lib)
        del kt, vt, mask, lib
    splits, per = plan
    kv_name = "int8" if quant else qname
    ms, dev_ms = timer.both(run)
    row = dict(kernel=kernel, B=b, H=h, G=g, Dh=dh, page=page, width=maxp * page, q=qname,
               lengths=lens_name, variant=variant, live_tokens=live, splits=splits,
               tiles_per_split=per, ptxas=usage.get(f"{qname}/{kv_name}/{dh}"),
               max_abs_err=abs_err, err_over_rms=err, tol=TOL,
               ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: paged_attention_plain(
                   q, k, v, table, lengths, **kw), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


PAGED_VARIANTS = ("plain", "window", "softcap", "sinks")


def check_paged_attention(torch, timer, rows, usage) -> None:
    """K5 (bf16 pools) and K6 (INT8 pools) against their plain version:
    8 slots of the flagship's heads, pages of 16 to 512 tokens, 8 x 1024
    live tokens (the timed main shape, with the yardstick) and ragged
    lengths up to 4096 with a repeated physical page list (a shared
    prefix), in every variant; the table the paged engine builds for 8
    slots of 1000 tokens at 512-token pages (its 1024-token context
    bucket's 2 pages and a trash column: 1536 tokens wide); at those two
    uniform shapes also with one split (one launch, no combine) beside the
    plan's; K5 with f32 q and pools; Dh 128."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, g = 8, 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(page, variants, dh=64, dtype=torch.bfloat16, quants=(False, True),
             engine=False):
        maxp = 4096 // page
        p_total = b * maxp + 1
        k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
        table = table.reshape(b, maxp).to(torch.int32)
        table[3] = table[0]
        q = torch.randn((b, h, dh), device="cuda", generator=gen).to(dtype)
        lens_cases = {"uniform1024": ([1024] * b, table),
                      "ragged": ([1, page, 777, 1024, 4096, 2 * page + 1, 3000, 4095], table)}
        if engine:
            lens_cases["uniform1000"] = ([1000] * b, table[:, :3].contiguous())
        for lens_name, (lens, tbl) in lens_cases.items():
            lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
            uniform = lens_name != "ragged"
            uniform_variants = ("plain", "one_split") if engine else ("plain",)
            for variant in (uniform_variants if uniform else variants):
                for quant in quants:
                    kw = {"plain": {}, "one_split": {}, "window": {"sliding_window_size": 512},
                          "softcap": {"logit_soft_cap": 30.0},
                          "sinks": {"sinks": sinks}}[variant]
                    if quant:
                        kw = dict(kw, k_scales=ks, v_scales=vs)
                    paged_row(torch, timer, rows, usage, q, kq if quant else k,
                              vq if quant else v, tbl, lengths, lens_name, variant, kw,
                              splits=1 if variant == "one_split" else None)
        del k, v, kq, vq, ks, vs

    for page in (16, 64, 256):
        case(page, PAGED_VARIANTS)
    case(512, PAGED_VARIANTS, engine=True)
    case(512, ("plain", "sinks"), dh=128)
    case(512, ("plain", "softcap"), dtype=torch.float32, quants=(False,))


def _routing(torch, gen, tokens: int, experts: int, active: int):
    """[tokens, active] distinct experts per token, as a router picks them."""
    return torch.stack([torch.randperm(experts, device="cuda", generator=gen)[:active]
                        for _ in range(tokens)])


def _random_stack(torch, gen, e: int, n: int, k: int, bits: int, g: int = 32):
    from uzu_tpu_torch.quant.format import StackedQuantized

    codes = torch.randint(0, 256, (e, n, k * bits // 8), dtype=torch.uint8, device="cuda",
                          generator=gen)
    scales = (torch.rand((e, n, k // g), device="cuda", generator=gen) * 0.01
              + 0.001).to(torch.bfloat16)
    return StackedQuantized(codes, scales, bits, g, -float(1 << (bits - 1)))


def check_moe_gemv(torch, timer, rows) -> None:
    """K7 (INT4) and K8 (INT8) at gpt-oss's expert shapes: P = 4 pairs (one
    token's 4 experts: single-stream decode) and P = 32 (8 slots)."""
    from uzu_tpu_torch.ops.cuda.moe_gemv import (
        gather_experts,
        moe_expert_gemv,
        moe_expert_gemv_plain,
    )
    from uzu_tpu_torch.quant.format import dequantize_stacked

    gen = torch.Generator(device="cuda").manual_seed(7)
    e, active = GPTOSS["num_experts"], GPTOSS["num_active"]
    for bits in (4, 8):
        for wname, n, k in EXPERT_SHAPES:
            sq = _random_stack(torch, gen, e, n, k, bits)
            plane_bytes = (sq.codes[0].numel() + sq.scales[0].numel() * 2)
            for p in (4, 32):
                ids = _routing(torch, gen, p // active, e, active).reshape(-1)
                x = torch.randn((p, k), device="cuda", generator=gen)
                got = moe_expert_gemv(sq, x, ids)
                want = moe_expert_gemv_plain(sq, x, ids)
                torch.cuda.synchronize()
                abs_err, err = rel_err(got, want)
                name = f"moe_gemv_int{bits}"
                if not (err <= TOL):
                    raise AssertionError(f"{name} {wname} P={p}: error {err:.3e} of RMS > {TOL}")
                distinct = len(set(ids.tolist()))
                nbytes = distinct * plane_bytes + p * k * 4 + p * 4 + p * n * 4
                b_ms, b_by = bound(nbytes, 2.0 * p * n * k)
                # yardstick: one bmm over the pairs' pre-gathered, pre-dequantized
                # bf16 planes (the gather not timed)
                wg = dequantize_stacked(gather_experts(sq, ids), torch.bfloat16)
                xb = x.to(torch.bfloat16)[:, None, :]
                ms, dev_ms = timer.both(lambda: moe_expert_gemv(sq, x, ids))
                lib_ms, lib_dev_ms = timer.both(lambda: torch.bmm(xb, wg.transpose(1, 2)))
                row = dict(kernel=name, weight=wname, N=n, K=k, E=e, P=p,
                           distinct_experts=distinct, max_abs_err=abs_err, err_over_rms=err,
                           tol=TOL, ms=ms, device_ms=dev_ms,
                           plain_ms=timer.ms(lambda: moe_expert_gemv_plain(sq, x, ids), 3),
                           library_ms=lib_ms, library_device_ms=lib_dev_ms,
                           bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                log("KERNEL " + json.dumps(row))
                del wg


# K9's rows: (T routed rows, bm) at the plan's layout of S = T / 4 rows (the
# paged step of 8 slots, the 16- and 32-row small chunks, the 64-, 256- and
# 1024-row prefill chunks), and T = 32 at bm 64, PR 3-7's layout of the
# paged step; K10's: the same prefill chunks at bm 64. Each T's routing and
# rows are drawn once and laid out at every bm of that T.
GROUPED_Q_CASES = ((32, 64), (32, 8), (64, 16), (128, 32), (256, 64), (1024, 64), (4096, 64))
GROUPED_DENSE_CASES = ((256, 64), (1024, 64), (4096, 64))


def check_grouped_matmul(torch, timer, rows, sweep: bool = False) -> None:
    """K9 over INT4 stacks and K10 over dense bf16 stacks at gpt-oss's
    expert shapes, at the routed rows of GROUPED_Q_CASES /
    GROUPED_DENSE_CASES, through the wrappers the main path calls, each row
    with the launch plan the wrapper launched (held to `launch_plan` of the
    layout's shapes). With `sweep`, tile rows also time every BN the route
    offers and small rows every kw (device ms). The yardstick is one bmm
    over the used tiles' pre-gathered bf16 planes and rows, at the same
    layout. Only the real rows are compared (rows of unused tiles are
    undefined)."""
    from uzu_tpu_torch.ops.cuda import grouped_matmul as gm
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.ops.cuda.moe_gemv import gather_experts
    from uzu_tpu_torch.quant.format import dequantize_stacked

    gen = torch.Generator(device="cuda").manual_seed(8)
    e, active = GPTOSS["num_experts"], GPTOSS["num_active"]
    sms = num_sms(torch.device("cuda"))
    cases = [("grouped_matmul_int4", t, bm) for t, bm in GROUPED_Q_CASES] + \
        [("grouped_matmul", t, bm) for t, bm in GROUPED_DENSE_CASES]
    routes = {t: _routing(torch, gen, t // active, e, active).reshape(-1)
              for t in sorted({t for _, t, _ in cases})}
    launched = []

    def spied(real):
        def launch(*args):
            launched.append(args[-1])
            return real(*args)
        return launch

    real_q, real_d = gm.launch_grouped_quant, gm.launch_grouped
    for wname, n, k in EXPERT_SHAPES:
        sq = _random_stack(torch, gen, e, n, k, 4)
        dense = dequantize_stacked(_random_stack(torch, gen, e, n, k, 8), torch.bfloat16)
        xs = {t: torch.randn((t, k), device="cuda", generator=gen) for t in routes}
        for name, t, bm in cases:
            quant = name == "grouped_matmul_int4"
            flat = routes[t]
            order, dst, te, used, _ = gm.route_layout(flat, e, bm)
            row_dtype = torch.float32 if quant else torch.bfloat16
            x_pad = torch.zeros((te.shape[0] * bm, k), dtype=row_dtype, device="cuda")
            x_pad[dst] = xs[t].to(row_dtype)
            plan = gm.launch_plan(te.shape[0], bm, e, n, k, 4 if quant else 16, sms)
            if quant:
                def run():
                    return gm.grouped_matmul_quant(x_pad, sq, te, used)

                def run_plan(p):
                    return real_q(x_pad, sq, te, used, p)

                def plain():
                    return gm.grouped_matmul_quant_plain(x_pad, sq, te, used, bm)
            else:
                def run():
                    return gm.grouped_matmul(x_pad, dense, te, used)

                def run_plan(p):
                    return real_d(x_pad, dense, te, used, p)

                def plain():
                    return gm.grouped_matmul_plain(x_pad, dense, te, used, bm)
            launched.clear()
            gm.launch_grouped_quant, gm.launch_grouped = spied(real_q), spied(real_d)
            try:
                got = run()
            finally:
                gm.launch_grouped_quant, gm.launch_grouped = real_q, real_d
            if launched != [plan]:
                raise AssertionError(f"{name} {wname} T={t} bm={bm}: the wrapper launched "
                                     f"{launched}, not launch_plan's {plan}")
            want = plain()
            torch.cuda.synchronize()
            abs_err, err = rel_err(got[dst], want[dst])
            if not (err <= TOL):
                raise AssertionError(f"{name} {wname} T={t} bm={bm} {plan}: error {err:.3e} "
                                     f"of RMS > {TOL}")
            n_used = int(used[0])
            distinct = len(set(flat.tolist()))
            plane = (sq.codes[0].numel() + sq.scales[0].numel() * 2) if quant \
                else dense[0].numel() * 2
            nbytes = distinct * plane + t * k * x_pad.element_size() + t * n * 4
            b_ms, b_by = bound(nbytes, 2.0 * t * n * k)
            # yardstick: one bmm over the used tiles' pre-gathered bf16 planes
            tiles = te[:n_used]
            wt = (dequantize_stacked(gather_experts(sq, tiles), torch.bfloat16) if quant
                  else dense[tiles.long()])
            xt = x_pad[: n_used * bm].to(torch.bfloat16).reshape(n_used, bm, k)
            ms, dev_ms = timer.both(run)
            lib_ms, lib_dev_ms = timer.both(lambda: torch.bmm(xt, wt.transpose(1, 2)))
            row = dict(kernel=name, weight=wname, N=n, K=k, E=e, T=t, bm=bm, Tp=x_pad.shape[0],
                       route=plan.route, kw=plan.kw, bn=plan.bn, used_tiles=n_used,
                       distinct_experts=distinct, max_abs_err=abs_err,
                       err_over_rms=err, tol=TOL, ms=ms, device_ms=dev_ms,
                       plain_ms=timer.ms(plain, 3), library_ms=lib_ms,
                       library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
            if sweep and plan.route == "tile":  # every BN of the route, the plan's included
                row["bn_device_ms"] = {
                    bn: timer.ms(functools.partial(run_plan, plan._replace(bn=bn)), spin=True)
                    for bn in gm.TILE_BNS[4 if quant else 16]}
            elif sweep:
                row["kw_device_ms"] = {
                    kw: timer.ms(functools.partial(run_plan, plan._replace(kw=kw)), spin=True)
                    for kw in (1, 2, 4, 8)}
            rows.append(row)
            log("KERNEL " + json.dumps(row))
            del wt, xt
        del dense


def check_grouped_rows(torch, info: dict) -> None:
    """K9's small route sums each routed row on its own: at bm = 8, the
    output of each of a token's 4 routed rows is bitwise the same in the
    layout of 8 tokens (expert 3 taken by all 8, so its tile holds 8 rows)
    as in the layout of that token alone (each tile 1 row); up and down."""
    from uzu_tpu_torch.ops.cuda.grouped_matmul import grouped_matmul_quant, route_layout

    gen = torch.Generator(device="cuda").manual_seed(10)
    e, active, bm = GPTOSS["num_experts"], GPTOSS["num_active"], 8
    out = []
    for wname, n, k in EXPERT_SHAPES:
        sq = _random_stack(torch, gen, e, n, k, 4)
        others = torch.stack([3 + 1 + torch.randperm(e - 1, device="cuda", generator=gen)
                              [:active - 1] for _ in range(8)]) % e
        ids = torch.cat([torch.full((8, 1), 3, device="cuda"), others], 1)
        x = torch.randn((8, k), device="cuda", generator=gen)

        def routed(tok):  # K9 over the tokens' layout -> [tokens, active, N]
            order, dst, te, used, _ = route_layout(ids[tok].reshape(-1), e, bm)
            x_pad = torch.zeros((te.shape[0] * bm, k), device="cuda")
            x_pad[dst] = x[tok][order // active]
            row_of_pair = torch.empty_like(dst)
            row_of_pair[order] = dst
            return grouped_matmul_quant(x_pad, sq, te, used)[row_of_pair].reshape(
                len(tok), active, n)

        together = routed(list(range(8)))
        alone = torch.cat([routed([j]) for j in range(8)])
        out.append(dict(weight=wname, N=n, K=k, bm=bm, rows_in_expert3_tile=8,
                        bitwise=bool(torch.equal(together, alone))))
    info["grouped_rows"] = out
    log("GROUPED_ROWS " + json.dumps(out))
    bad = [r for r in out if not r["bitwise"]]
    if bad:
        raise AssertionError(f"K9 rows at bm 8 depend on the other rows of their tile: {bad}")


GPTOSS_K3_CASES = ((16, 1024, ("gptoss_window_sinks", "gptoss_sinks")),
                   (256, 1024, ("gptoss_window_sinks", "gptoss_sinks")),
                   (16, 4096, ("gptoss_sinks", "plain")))


def gptoss_attention_inputs(torch):
    """The seeded inputs of the rows at gpt-oss's heads: (generator, sinks,
    [(S, C, variants, q, k, v)] of K3's cases), drawn in one order, so that
    K5's rows, which draw next from the same generator, see the same data
    whether or not K3's rows run."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    h, g, dh = GPTOSS["num_heads"], GPTOSS["num_groups"], GPTOSS["head_dim"]
    sinks = torch.randn((h,), device="cuda", generator=gen)
    cases = [(s, c, variants, *(torch.randn(shape, device="cuda", generator=gen)
                                .to(torch.bfloat16)
                                for shape in ((s, h, dh), (c, g, dh), (c, g, dh))))
             for s, c, variants in GPTOSS_K3_CASES]
    return gen, sinks, cases


def check_attention_gptoss(torch, timer, rows, usage) -> None:
    """K3 at gpt-oss's heads: 64 query heads over 8 KV groups (8 per group),
    Dh 64, its sliding window of 128 with sinks, and sinks alone (the
    full-attention layers); also at S=16 over C=4096 (split route), with a
    yardstick in its plain variant."""
    win = GPTOSS["sliding_window"]
    _, sinks, cases = gptoss_attention_inputs(torch)
    for s, c, variants, q, kc, vc in cases:
        for variant in variants:
            kw = {"gptoss_window_sinks": dict(sliding_window_size=win, sinks=sinks),
                  "gptoss_sinks": dict(sinks=sinks), "plain": {}}[variant]
            flash_row(torch, timer, rows, usage, q, kc, vc, c - s - 3, variant, kw)


def check_paged_gptoss(torch, timer, rows, usage) -> None:
    """K5 at gpt-oss's heads (8 per KV group, Dh 64, bf16 pools of 512-token
    pages): its window of 128 with sinks, and sinks alone, over 8 x 1024
    live tokens and ragged lengths."""
    h, g, dh = GPTOSS["num_heads"], GPTOSS["num_groups"], GPTOSS["head_dim"]
    win = GPTOSS["sliding_window"]
    gen, sinks, cases = gptoss_attention_inputs(torch)
    del cases
    b, page = 8, 512
    maxp = 4096 // page
    p_total = b * maxp + 1
    k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32)
    q = torch.randn((b, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    for lens_name, lens in (("uniform1024", [1024] * b),
                            ("ragged", [1, 100, 129, 777, 1024, 3000, 4095, 4096])):
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        for variant, kw in (("gptoss_window_sinks", dict(sliding_window_size=win, sinks=sinks)),
                            ("gptoss_sinks", dict(sinks=sinks))):
            paged_row(torch, timer, rows, usage, q, k, v, table, lengths, lens_name, variant,
                      kw)


def check_block_copy(torch, timer, rows) -> None:
    """P1 at the bisect probe's shape, [256, 16] -> [256, 128] f32; the
    copy must equal its plain version bit for bit."""
    import torch.nn.functional as F

    from uzu_tpu_torch.ops.cuda.block_copy import scale_block_copy, scale_block_copy_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    r, kg, width = 256, 16, 128
    s = torch.rand((r, kg), device="cuda", generator=gen) * 0.02 + 0.01
    got = scale_block_copy(s, width)
    want = scale_block_copy_plain(s, width)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("scale_block_copy differs from its plain version")
    abs_err, err = rel_err(got, want)
    b_ms, b_by = bound((r * kg + r * width) * 4, 0.0)
    ms, dev_ms = timer.both(lambda: scale_block_copy(s, width))
    lib_ms, lib_dev_ms = timer.both(lambda: F.pad(s, (0, width - kg)))
    row = dict(kernel="scale_block_copy", R=r, kg=kg, width=width, max_abs_err=abs_err,
               err_over_rms=err, tol=0.0, ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: scale_block_copy_plain(s, width), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


# -- phases 3-10: the port's main paths -----------------------------------------


def synth_model(name: str) -> str:
    """Synthesize one of the run's models into .port_cache/<name>, unless a
    finished one is there: the Llama-shaped flagships (16 layers with INT4
    linears, 2 with INT8; INT4 tied embedding; normal fill, seed 0) and
    gpt-oss at 4 layers with INT4 experts and at 2 with INT8 experts (bf16
    attention and untied embeddings; raw-bytes fill, seed 0)."""
    from uzu_tpu_torch.config.model import IntSpec, Layout
    from uzu_tpu_torch.tools.synth import gptoss_config, llama_config, synthesize

    out = os.path.join(REPO, ".port_cache", name)
    if os.path.exists(os.path.join(out, "model.safetensors")):
        return out

    def spec(bits):
        return IntSpec(bits=bits, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)

    if name.startswith("llama1b"):
        layers, bits = (16, 4) if name == "llama1b_int4" else (2, 8)
        synthesize(llama_config(**dict(FLAGSHIP, num_layers=layers)), out, seed=0,
                   linear_spec=spec(bits), embedding_spec=spec(4))
    else:
        layers, bits = (4, 4) if name == "gptoss_int4" else (2, 8)
        synthesize(gptoss_config(num_layers=layers, **GPTOSS), out, seed=0,
                   expert_spec=spec(bits), fill="fast")
    return out


MODELS = ("llama1b_int4", "llama1b_int8_2l", "gptoss_int4", "gptoss_int8_2l")


def prompt_tokens(n: int, vocab: int):
    import numpy as np

    return (np.arange(n) * 37 + 11) % vocab


def single_stream_run(torch, lm, vocab: int, key: str, kernels, info: dict) -> dict:
    """GEN_TOKENS greedy tokens after a GEN_PROMPT-token prompt, twice: the
    tokens must repeat, and each kernel in `kernels` must have launched."""
    from uzu_tpu_torch.engine.engine import StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    prompt = prompt_tokens(GEN_PROMPT, vocab)
    lm.generate_list(prompt[:16], 2, stop_token_ids=[])  # warm the allocator

    reset_launches()
    lm.prefill(lm.new_state(), prompt)
    torch.cuda.synchronize()
    per_prefill_chunk = dict(LAUNCHES)

    runs = []
    for _ in range(2):
        metrics = StreamMetrics()
        reset_launches()
        toks = lm.generate_list(prompt, GEN_TOKENS, stop_token_ids=[], metrics=metrics)
        torch.cuda.synchronize()
        runs.append((toks, metrics, dict(LAUNCHES)))
    (toks, metrics, launches), (toks2, metrics2, _) = runs
    if toks != toks2:
        raise AssertionError(f"{key}: greedy generation differs between runs:\n{toks}\n{toks2}")
    if len(toks) != GEN_TOKENS:
        raise AssertionError(f"{key}: expected {GEN_TOKENS} tokens, got {len(toks)}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {key} run")
    decode_steps = metrics.num_forward_passes - 1
    per_step = {n: (launches[n] - per_prefill_chunk[n]) / decode_steps for n in launches}
    info[key] = dict(
        prompt=GEN_PROMPT, generated=len(toks), tokens_head=toks[:16],
        prefill_tok_s=[m.prefill_tokens_per_second for _, m, _ in runs],
        decode_tok_s=[m.decode_tokens_per_second for _, m, _ in runs],
        launches=launches, launches_per_prefill_chunk=per_prefill_chunk,
        launches_per_decode_step=per_step, decode_steps=decode_steps)
    log(key.upper() + " " + json.dumps(info[key]))
    return launches


def path_int4(torch, model_dir: str, info: dict):
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    single_stream_run(torch, lm, FLAGSHIP["vocab_size"], "int4_path",
                      ("quant_matmul_int4", "flash_attention"), info)
    return lm


def path_int8(torch, model_dir: str, info: dict) -> dict:
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    prompt = prompt_tokens(64, FLAGSHIP["vocab_size"])
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt, 16, stop_token_ids=[], metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["quant_matmul_int8"] <= 0:
        raise AssertionError("kernel quant_matmul_int8 was not launched on the INT8 path")
    info["int8_path"] = dict(generated=len(toks), tokens_head=toks[:16], launches=launches,
                             prefill_tok_s=metrics.prefill_tokens_per_second,
                             decode_tok_s=metrics.decode_tokens_per_second)
    log("PATH_INT8 " + json.dumps(info["int8_path"]))
    return launches


def path_int4_kv_int8(torch, lm16, info: dict) -> dict:
    """The dense INT4 path once more with the INT8 KV cache: prefill
    attention goes through K4."""
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel(lm16.config, lm16.params, device="cuda", max_context=4096,
                       kv_quant=True)
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt_tokens(GEN_PROMPT, FLAGSHIP["vocab_size"]), 16,
                            stop_token_ids=[], metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["flash_attention_int8"] <= 0:
        raise AssertionError("kernel flash_attention_int8 was not launched on the INT8-KV path")
    info["int4_kv_int8_path"] = dict(generated=len(toks), tokens_head=toks[:16],
                                     launches=launches,
                                     prefill_tok_s=metrics.prefill_tokens_per_second,
                                     decode_tok_s=metrics.decode_tokens_per_second)
    log("PATH_INT4_KV_INT8 " + json.dumps(info["int4_kv_int8_path"]))
    return launches


def router_logits(params, x):
    """The MoE router's f32 logits for rows x, as `models.moe.router_topk`
    computes them."""
    logits = x.float() @ params["router"]["w"].float().t()
    return logits + params["router"]["b"].float() if "b" in params["router"] else logits


def pinned_router(torch, routes):
    """A stand-in for `models.moe.router_topk` that takes the expert ids
    `routes(x)` gives for the call's rows ([S, K]; None: its own choice),
    weights them as the router would, and records per row how far the
    lowest of them lies below its own K-th router logit (0 where the
    choices agree)."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.config.model import SoftmaxRouting

    real = moe.router_topk
    gaps = []

    def topk(cfg, params, x):
        ids = routes(x)
        if ids is None:
            return real(cfg, params, x)
        ids = ids.to(x.device).long().reshape(x.shape[0], -1)
        logits = router_logits(params, x)
        k = cfg.num_active_routed_experts
        kth = torch.sort(logits, dim=-1, descending=True).values[:, k - 1]
        vals = logits.gather(1, ids)
        gaps.append((kth - vals.min(-1).values).clamp(min=0))
        probs = torch.softmax(vals, -1) if isinstance(cfg.routing_function,
                                                      SoftmaxRouting) else vals
        return ids, probs

    return topk, gaps


def single_stream_along(torch, lm, prompt, tokens, routes=None):
    """The single-stream path of `lm` (prefill, then one decode step per
    token) fed `tokens`: per step the greedy choice, its top-2 logit margin,
    and how far the fed token's logit lies below the best one. `routes`
    ({position: ([layers, K] expert ids, [layers, D] MoE inputs)}) makes
    each decode step's MoE layers take those experts; the last two results
    are then, per routed layer and step, how far the lowest of them lies
    below the step's own K-th router logit (0 where the choices agree), and
    per layer the relative L2 distances of this path's MoE inputs from the
    given ones (empty without `routes`)."""
    import uzu_tpu_torch.models.moe as moe

    state = lm.new_state()
    logits, state = lm.prefill(state, prompt)
    at = {"pos": None, "layer": 0}
    x_dist = {}

    def current(x):
        got = routes.get(at["pos"]) if routes is not None and x.shape[0] == 1 else None
        layer = at["layer"]
        at["layer"] += 1
        if got is None:
            return None
        ids, x_other = got
        x_dist.setdefault(layer, []).append(
            (x[0].float() - x_other[layer]).norm() / x_other[layer].norm())
        return ids[layer]

    real = moe.router_topk
    moe.router_topk, router_gaps = pinned_router(torch, current)
    rows = []
    try:
        for i, tok in enumerate(tokens):
            top = torch.topk(logits, 2)
            rows.append(torch.stack([top.indices[0].float(), top.values[0] - top.values[1],
                                     top.values[0] - logits[tok]]))
            if i + 1 < len(tokens):
                at["pos"], at["layer"] = len(prompt) + i, 0
                logits, state, _ = lm._forward(torch.tensor([tok], device=logits.device),
                                               state, 1, lm._ctx_bucket(len(prompt) + i + 1))
    finally:
        moe.router_topk = real
    best, margin, gap = torch.stack(rows).cpu().double().T.tolist()
    rg = torch.cat(router_gaps).cpu().double().tolist() if router_gaps else []
    xd = {layer: torch.stack(d).cpu().double().tolist() for layer, d in x_dist.items()}
    return [int(t) for t in best], margin, gap, rg, xd


def stream_readings(torch, lm, prompts, streams, routes=None) -> list[dict]:
    """Each stream against the single-stream path of `lm` fed the stream's
    own history. Per stream: `compared`, the tokens before the first step
    whose single-stream top-2 logit margin is under MARGIN (up to there
    the stream is the single stream's greedy stream run alone);
    `clear_steps`, the steps whose margin is at least MARGIN;
    `greedy_choices`, the steps at which the stream takes the single
    stream's greedy choice; where it first leaves that choice, with the
    margin there; and `max_gap`, how far its worst token's logit lies below
    the best one. With `routes` (one per stream, see single_stream_along)
    the single stream takes the stream's expert choices, and the reading
    adds `routed_layers`, `router_flips` (choices it would not have made),
    `max_router_gap` and, per layer, the relative L2 distances of the two
    paths' MoE inputs (`moe_input_dist`)."""
    out = []
    for i, (prompt, got) in enumerate(zip(prompts, streams)):
        best, margin, gap, rg, xd = single_stream_along(
            torch, lm, prompt, got, None if routes is None else routes[i])
        part = next((j for j, (a, b) in enumerate(zip(got, best)) if a != b), None)
        r = dict(
            compared=next((j for j, m in enumerate(margin) if m < MARGIN), len(got)),
            clear_steps=sum(m >= MARGIN for m in margin),
            greedy_choices=sum(a == b for a, b in zip(got, best)), tokens=len(got),
            parted_at=part, margin_there=None if part is None else margin[part],
            max_gap=max(gap))
        if routes is not None:
            r.update(routed_layers=len(rg), router_flips=sum(g > 0 for g in rg),
                     max_router_gap=max(rg, default=0.0), moe_input_dist=xd)
        out.append(r)
    return out


def check_streams(readings) -> None:
    """On the same history the two paths' bf16 logits differ by a few bf16
    ulps (other summation orders in attention), so greedy may take the
    other side of a near-tie, and such a token's gap is at most twice that
    difference. A token MARGIN or more below the best logit fails; so, as
    a token that is not the greedy choice lies at least the margin below
    the best, does any step with a margin of at least MARGIN that chose
    otherwise (`compared` and `clear_steps` count those steps). A run whose
    streams take the greedy choice at fewer than GREEDY_FLOOR of their
    steps fails too."""
    for i, r in enumerate(readings):
        if r["max_gap"] >= MARGIN:
            raise AssertionError(f"request {i}: a token lies {r['max_gap']:.3e} below the "
                                 f"single stream's best logit (limit {MARGIN})")
    share = sum(r["greedy_choices"] for r in readings) / sum(r["tokens"] for r in readings)
    if share < GREEDY_FLOOR:
        raise AssertionError(f"the streams take the single stream's greedy choice at "
                             f"{share:.3f} of their steps (floor {GREEDY_FLOOR})")


def check_routing(readings) -> None:
    """Every expert the paged engine chose that the single stream would
    not have lies within ROUTER_MARGIN of the single stream's own K-th
    router logit: a near-tie, not a wrong route."""
    for i, r in enumerate(readings):
        if r["max_router_gap"] >= ROUTER_MARGIN:
            raise AssertionError(f"request {i}: an expert the paged engine chose lies "
                                 f"{r['max_router_gap']:.3e} below the single stream's K-th "
                                 f"router logit (limit {ROUTER_MARGIN})")


def stream_summary(readings) -> dict:
    out = dict(compared_tokens=[r["compared"] for r in readings],
               clear_steps=[r["clear_steps"] for r in readings],
               greedy_choices=[r["greedy_choices"] for r in readings],
               greedy_share=sum(r["greedy_choices"] for r in readings)
               / sum(r["tokens"] for r in readings),
               max_gaps=[r["max_gap"] for r in readings])
    if "router_flips" in readings[0]:
        dist = {}
        for r in readings:
            for layer, d in r["moe_input_dist"].items():
                dist.setdefault(layer, []).extend(d)
        out.update(routed_layers=sum(r["routed_layers"] for r in readings),
                   router_flips=[r["router_flips"] for r in readings],
                   max_router_gaps=[r["max_router_gap"] for r in readings],
                   moe_input_dist_median_max_per_layer=[
                       (statistics.median(dist[layer]), max(dist[layer]))
                       for layer in sorted(dist)])
    return out


def drive(torch, eng) -> tuple[float, list]:
    """Run the engine to idle; returns (seconds, [(seconds, decode-only)]
    per scheduler step)."""
    steps = []
    t0 = time.perf_counter()
    while True:
        before = dict(eng.stats)
        ts = time.perf_counter()
        busy = eng.step()
        steps.append((time.perf_counter() - ts,
                      eng.stats["prefill_chunks"] == before["prefill_chunks"]
                      and eng.stats["decode_chunks"] > before["decode_chunks"]))
        if not busy:
            break
    torch.cuda.synchronize()
    return time.perf_counter() - t0, steps


def paged_prompts(vocab: int):
    """11 prompts of 17 to 700 tokens; the last four share a 600-token
    prefix, a whole 512-token page of it."""
    import numpy as np

    out = [((np.arange(n) * (31 + 2 * i) + 101 * i + 7) % vocab).tolist()
           for i, n in enumerate((17, 700, 64, 300, 129, 450, 33))]
    shared = prompt_tokens(600, vocab).tolist()
    out += [shared + ((np.arange(n) * 7 + i) % vocab).tolist()
            for i, n in enumerate((5, 40, 90, 17))]
    return out


def path_paged_int4(torch, lm16, info: dict) -> dict:
    """PagedBatchEngine over the full-width INT4 flagship (bf16 pools)."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm16, batch_size=8, decode_chunk=8, num_pages=64,
                           stop_token_ids=[])
    pool_bytes = sum(t.numel() * t.element_size() for pk in eng.pools if pk for t in pk)
    prompts = paged_prompts(FLAGSHIP["vocab_size"])
    reset_launches()
    reqs = [eng.submit(p, PAGED_TOKENS) for p in prompts]
    seconds, steps = drive(torch, eng)
    skipped_before = eng.stats["shared_prefix_tokens"]
    # a follow-up turn extending a finished request's history: its first
    # page comes from the automatic prefix cache
    follow = prompts[7] + reqs[7].tokens + [11, 12, 13]
    prompts.append(follow)
    reqs.append(eng.submit(follow, PAGED_TOKENS))
    seconds2, steps2 = drive(torch, eng)
    launches = dict(LAUNCHES)
    apc_skipped = eng.stats["shared_prefix_tokens"] - skipped_before
    decode_steps = eng.stats["decode_chunks"] * eng.decode_chunk
    layers = len(lm16.params["layers"])
    if launches["paged_attention"] != decode_steps * layers:
        raise AssertionError(f"paged_attention launched {launches['paged_attention']} times, "
                             f"expected {decode_steps} steps x {layers} layers")
    if apc_skipped < eng.page_size:
        raise AssertionError("the follow-up request did not reuse the prefix cache's pages")
    if skipped_before < 3 * eng.page_size:
        raise AssertionError("the shared-prefix requests did not share their first page")
    if not all(r.finished and len(r.tokens) == PAGED_TOKENS for r in reqs):
        raise AssertionError("a paged request did not produce its tokens")
    eng._evict_retired(eng.pool.num_pages)
    if eng.pool.free_pages != eng.pool.num_pages:
        raise AssertionError(f"{eng.pool.num_pages - eng.pool.free_pages} pages leaked")
    t0 = time.perf_counter()
    readings = stream_readings(torch, lm16, prompts, [r.tokens for r in reqs])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)
    chunk_ms = [1e3 * t for t, decode_only in steps + steps2 if decode_only]
    generated = sum(len(r.tokens) for r in reqs)
    info["paged_int4"] = dict(
        requests=len(reqs), batch_size=8, decode_chunk=8, page_size=eng.page_size,
        num_pages=64, pool_gb=pool_bytes / 1e9, prompt_tokens=[len(p) for p in prompts],
        generated=generated, seconds=seconds + seconds2,
        aggregate_tok_s=generated / (seconds + seconds2),
        ms_per_chunk_median=statistics.median(chunk_ms), decode_only_chunks=len(chunk_ms),
        decode_tok_s_steady=8 * 8 / (statistics.median(chunk_ms) / 1e3),
        ttft_ms=[round(1e3 * r.ttft, 3) for r in reqs], decode_steps=decode_steps,
        prefill_chunks=eng.stats["prefill_chunks"], shared_prefix_tokens=skipped_before,
        prefix_cache_tokens=apc_skipped, **stream_summary(readings),
        compare_seconds=time.perf_counter() - t0, launches=launches,
        launches_per_decode_step={n: launches[n] / decode_steps for n in launches})
    log("PATH_PAGED_INT4 " + json.dumps(info["paged_int4"]))
    return launches


def path_paged_int8(torch, model_dir: str, info: dict) -> dict:
    """PagedBatchEngine with INT8 pools over the 2-layer INT8 flagship:
    prefill through K4, decode through K6."""
    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096, kv_quant=True)
    eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=64, stop_token_ids=[])
    prompts = paged_prompts(FLAGSHIP["vocab_size"])[:6]
    reset_launches()
    reqs = [eng.submit(p, 32) for p in prompts]
    seconds, _ = drive(torch, eng)
    launches = dict(LAUNCHES)
    for name in ("paged_attention_int8", "flash_attention_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the INT8 paged path")
    readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)
    info["paged_int8"] = dict(requests=len(reqs), generated=sum(len(r.tokens) for r in reqs),
                              seconds=seconds, **stream_summary(readings), launches=launches,
                              decode_steps=eng.stats["decode_chunks"] * eng.decode_chunk,
                              prefill_chunks=eng.stats["prefill_chunks"])
    log("PATH_PAGED_INT8 " + json.dumps(info["paged_int8"]))
    return launches


def moe_routing_has_no_host_sync(torch, lm) -> None:
    """Layer 0's MoE block at a single-stream decode step (1 row: K7) and a
    paged step of 8 slots (8 rows: K9) under the CUDA sync debug mode set
    to error: any call in the routing that waits for the device raises."""
    from uzu_tpu_torch.models.moe import moe_forward

    cfg = lm.decoder_config.transformer_config.layer_configs[0].mlp_config
    params = lm.params["layers"][0]["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    for s in (1, 8):
        x = torch.randn((s, GPTOSS["model_dim"]), device="cuda", generator=gen)
        x = x.to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_forward(cfg, params, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def path_gptoss_int4(torch, model_dir: str, info: dict):
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    moe_routing_has_no_host_sync(torch, lm)
    single_stream_run(torch, lm, GPTOSS["vocab_size"], "gptoss_int4",
                      ("moe_gemv_int4", "grouped_matmul_int4", "flash_attention"), info)
    return lm


def router_margins(torch, lm, prompt, tokens, step) -> list[float]:
    """Per layer, the gap between the K-th and the (K+1)-th router logit on
    the teacher-forced row that picks tokens[step]: how near the routing of
    that row is to a tie."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.models.decoder import decoder_forward

    seen = []
    real = moe.router_topk

    def spy(cfg, params, x):
        logits = router_logits(params, x[-1:])[0]
        top = torch.topk(logits, cfg.num_active_routed_experts + 1).values
        seen.append(top[-2] - top[-1])
        return real(cfg, params, x)

    seq = torch.as_tensor(list(prompt) + list(tokens[:step]), device="cuda")
    moe.router_topk = spy
    try:
        decoder_forward(lm.decoder_config, lm.params, seq, lm.new_state())
    finally:
        moe.router_topk = real
    return [float(m) for m in seen]


def recorded_routes(torch, eng):
    """Patch the paged engine's decode step so that each step records, for
    every occupied slot, the expert ids its MoE layers chose. Returns
    (restore, routes_of): routes_of(request) is that request's {position:
    ([layers, K] ids, [layers, D] MoE inputs)}, taken from the step that
    fed the token at each position (a halted slot repeats its last
    position; the first step at a position is the one that fed it)."""
    import uzu_tpu_torch.engine.paged_batch as pb
    import uzu_tpu_torch.models.moe as moe

    real_step = pb.paged_decode_step
    steps = []

    def step(cfg, params, pools, tokens, tables, positions):
        live = [(b, s.request) for b, s in enumerate(eng.slots) if not s.free]
        real_topk, ids, xs = moe.router_topk, [], []

        def topk(c, p, x):
            out = real_topk(c, p, x)
            ids.append(out[0])
            xs.append(x.float())
            return out

        moe.router_topk = topk
        try:
            logits = real_step(cfg, params, pools, tokens, tables, positions)
        finally:
            moe.router_topk = real_topk
        steps.append((live, positions, torch.stack(ids, 1), torch.stack(xs, 1)))
        return logits

    def restore():
        pb.paged_decode_step = real_step

    host = []  # each step's positions, read once after the run

    def routes_of(req):
        if not host:
            host.extend(torch.stack([pos for _, pos, _, _ in steps]).tolist())
        out = {}
        for (live, _, ids, xs), pos in zip(steps, host):
            for b, r in live:
                if r is req:
                    out.setdefault(pos[b], (ids[b], xs[b]))
        return out

    pb.paged_decode_step = step
    return restore, routes_of


def run_paged_routed(torch, eng, prompts, tokens: int):
    """Submit `prompts`, run the engine to idle while recording its expert
    choices; returns (requests, seconds, per-step times, routes per
    request)."""
    restore, routes_of = recorded_routes(torch, eng)
    try:
        reqs = [eng.submit(p, tokens) for p in prompts]
        seconds, steps = drive(torch, eng)
    finally:
        restore()
    if any(r.preempted for r in reqs):
        raise AssertionError("a request was preempted: its recorded routes would mix runs")
    return reqs, seconds, steps, [routes_of(r) for r in reqs]


def path_paged_gptoss(torch, lm, info: dict) -> dict:
    """PagedBatchEngine over the 4-layer INT4 gpt-oss model: admission
    chunks and decode steps both route their rows through K9. The streams
    are held to the single stream (K7 in decode) that takes the paged
    engine's expert choices, under check_streams and check_routing; the
    same streams against the free single stream are reported, with the
    router margins where the first one parts."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=64, stop_token_ids=[])
    prompts = paged_prompts(GPTOSS["vocab_size"])
    reset_launches()
    reqs, seconds, steps, routes = run_paged_routed(torch, eng, prompts, PAGED_TOKENS)
    launches = dict(LAUNCHES)
    decode_steps = eng.stats["decode_chunks"] * eng.decode_chunk
    chunks = eng.stats["prefill_chunks"]
    layers = len(lm.params["layers"])
    if launches["paged_attention"] != decode_steps * layers:
        raise AssertionError(f"paged_attention launched {launches['paged_attention']} times, "
                             f"expected {decode_steps} steps x {layers} layers")
    if launches["grouped_matmul_int4"] != 2 * layers * (decode_steps + chunks):
        raise AssertionError(f"grouped_matmul_int4 launched {launches['grouped_matmul_int4']} "
                             f"times, expected 2 x {layers} layers x ({decode_steps} decode "
                             f"steps + {chunks} prefill chunks)")
    if not all(r.finished and len(r.tokens) == PAGED_TOKENS for r in reqs):
        raise AssertionError("a paged gpt-oss request did not produce its tokens")
    eng._evict_retired(eng.pool.num_pages)
    if eng.pool.free_pages != eng.pool.num_pages:
        raise AssertionError(f"{eng.pool.num_pages - eng.pool.free_pages} pages leaked")
    streams = [r.tokens for r in reqs]
    free = stream_readings(torch, lm, prompts, streams)
    readings = stream_readings(torch, lm, prompts, streams, routes)
    log("COMPARED " + json.dumps([{k: v for k, v in r.items() if k != "moe_input_dist"}
                                  for r in readings]))
    i, r = next(((i, r) for i, r in enumerate(free) if r["parted_at"] is not None), (0, free[0]))
    step = r["parted_at"] or 0
    chunk_ms = [1e3 * t for t, decode_only in steps if decode_only]
    generated = sum(len(r.tokens) for r in reqs)
    info["paged_gptoss"] = dict(
        requests=len(reqs), batch_size=8, decode_chunk=8, page_size=eng.page_size,
        prompt_tokens=[len(p) for p in prompts], generated=generated, seconds=seconds,
        aggregate_tok_s=generated / seconds,
        ms_per_chunk_median=statistics.median(chunk_ms) if chunk_ms else None,
        decode_only_chunks=len(chunk_ms),
        decode_tok_s_steady=8 * 8 / (statistics.median(chunk_ms) / 1e3) if chunk_ms else None,
        ttft_ms=[round(1e3 * r.ttft, 3) for r in reqs], decode_steps=decode_steps,
        prefill_chunks=chunks, **stream_summary(readings),
        free_single_stream=dict(stream_summary(free), first_parted=dict(
            request=i, step=step, margin_there=r["margin_there"],
            router_kth_minus_next_per_layer=router_margins(
                torch, lm, prompts[i], streams[i], step))),
        launches=launches,
        grouped_matmul_int4_per_decode_step=(
            launches["grouped_matmul_int4"] - 2 * layers * chunks) / decode_steps,
        paged_attention_per_decode_step=launches["paged_attention"] / decode_steps)
    log("PATH_PAGED_GPTOSS " + json.dumps(info["paged_gptoss"]))
    check_streams(readings)
    check_routing(readings)
    return launches


def path_gptoss_int8(torch, model_dir: str, info: dict) -> dict:
    """The 2-layer INT8-expert gpt-oss model with a 1024-row prefill bucket:
    an 1100-token prompt takes one 1024-row chunk (dequantized stacks, K10)
    and one 256-row chunk (masked loop); decode takes K8."""
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096,
                                prefill_buckets=(16, 64, 256, 1024))
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt_tokens(1100, GPTOSS["vocab_size"]), 16, stop_token_ids=[],
                            metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name in ("grouped_matmul", "moe_gemv_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the INT8-expert path")
    if len(toks) != 16:
        raise AssertionError(f"expected 16 tokens, got {len(toks)}")
    info["gptoss_int8"] = dict(prompt=1100, generated=len(toks), tokens_head=toks,
                               launches=launches,
                               prefill_tok_s=metrics.prefill_tokens_per_second,
                               decode_tok_s=metrics.decode_tokens_per_second)
    log("GPTOSS_INT8 " + json.dumps(info["gptoss_int8"]))
    return launches


def control_planted_faults(torch, lm16, info: dict) -> None:
    """The stream check held to planted faults in the paged decode step,
    each wrapping the K5 wrapper where `models/paged_decode.py` calls it
    (the package is untouched): K5 sees the next slot's page table, or
    each slot's length minus one (the newest token dropped). Four requests
    of 2 to 129 prompt tokens make CONTROL_TOKENS tokens each per fault;
    each fault's streams must fail `check_streams`."""
    import uzu_tpu_torch.models.paged_decode as pd
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

    real = pd.paged_decode_attention
    faults = {
        "next_slot_table": lambda q, k, v, t, n, **kw: real(q, k, v, t.roll(-1, 0), n, **kw),
        "length_minus_one": lambda q, k, v, t, n, **kw: real(
            q, k, v, t, (n - 1).clamp(min=1), **kw),
    }
    prompts = [prompt_tokens(n, FLAGSHIP["vocab_size"]).tolist() for n in (2, 5, 17, 129)]
    out = {}
    for name, fault in faults.items():
        eng = PagedBatchEngine(lm16, batch_size=len(prompts), decode_chunk=8, num_pages=8,
                               stop_token_ids=[])
        pd.paged_decode_attention = fault
        try:
            reqs = [eng.submit(p, CONTROL_TOKENS) for p in prompts]
            eng.run()
        finally:
            pd.paged_decode_attention = real
        readings = stream_readings(torch, lm16, prompts, [r.tokens for r in reqs])
        try:
            check_streams(readings)
            caught = None
        except AssertionError as e:
            caught = str(e)
        out[name] = dict(stream_summary(readings), caught=caught)
        del eng
    info["control"] = dict(prompt_tokens=[len(p) for p in prompts], tokens=CONTROL_TOKENS,
                           faults=out)
    log("CONTROL " + json.dumps(info["control"]))
    missed = [name for name, r in out.items() if r["caught"] is None]
    if missed:
        raise AssertionError(f"the stream check passed planted faults: {missed}")


def control_moe_faults(torch, lm, info: dict) -> None:
    """The routed stream check of path_paged_gptoss held to planted faults
    in the paged engine's MoE blocks, each wrapped around a name that
    `models/moe.py` calls (the package is untouched): K9 multiplying each
    tile by the next expert's weights, and a router whose decode rows take
    the experts ranked K+1 to 2K. Four requests of 2 to 129 prompt tokens
    in 8 slots (so decode rows take K9) make CONTROL_TOKENS tokens each per
    fault; each fault's streams must fail check_streams or check_routing."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

    e = GPTOSS["num_experts"]
    real_k9, real_topk = moe.grouped_matmul_quant, moe.router_topk

    def next_ranked(cfg, params, x):
        if x.shape[0] != 8:
            return real_topk(cfg, params, x)
        k = cfg.num_active_routed_experts
        vals, ids = torch.sort(router_logits(params, x), dim=-1, descending=True, stable=True)
        return ids[:, k:2 * k], torch.softmax(vals[:, k:2 * k], -1)

    faults = {
        "k9_next_expert": ("grouped_matmul_quant",
                           lambda x, sq, te, used: real_k9(x, sq, (te + 1) % e, used)),
        "router_next_ranked": ("router_topk", next_ranked),
    }
    prompts = [prompt_tokens(n, GPTOSS["vocab_size"]).tolist() for n in (2, 5, 17, 129)]
    out = {}
    for name, (attr, fault) in faults.items():
        eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=8,
                               stop_token_ids=[])
        real = getattr(moe, attr)
        setattr(moe, attr, fault)
        try:
            reqs, _, _, routes = run_paged_routed(torch, eng, prompts, CONTROL_TOKENS)
        finally:
            setattr(moe, attr, real)
        readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs], routes)
        caught = []
        for check in (check_streams, check_routing):
            try:
                check(readings)
            except AssertionError as err:
                caught.append(str(err))
        out[name] = dict(stream_summary(readings), caught=caught)
        del eng
    info["control_moe"] = dict(prompt_tokens=[len(p) for p in prompts], tokens=CONTROL_TOKENS,
                               faults=out)
    log("CONTROL_MOE " + json.dumps(info["control_moe"]))
    missed = [name for name, r in out.items() if not r["caught"]]
    if missed:
        raise AssertionError(f"the routed stream check passed planted faults: {missed}")


def first_layers(lm, layers: int, device: str):
    """`lm` cut to its first `layers` layers, as a LanguageModel on
    `device` with 1024 slots of context (its parameters shared where the
    device is the same)."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    cfg = lm.config
    tcfg = cfg.decoder_config.transformer_config
    dcfg = dataclasses.replace(cfg.decoder_config, transformer_config=dataclasses.replace(
        tcfg, layer_configs=tcfg.layer_configs[:layers]))
    return LanguageModel(dataclasses.replace(cfg, decoder_config=dcfg),
                         dict(lm.params, layers=lm.params["layers"][:layers]),
                         device=device, max_context=1024)


def whole_path_check(torch, lm, layers: int, vocab: int, key: str, info: dict) -> None:
    """Teacher-forced logits of the first `layers` layers of `lm` for a
    32-token prompt, on the card and through the port's plain path on the
    host CPU. For an MoE model the CPU pass takes the card's expert
    choices (each a near-tie of its own router, check_routing; a flipped
    expert would move its row far past the tolerance), and the free CPU
    pass is reported beside it."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.models.decoder import decoder_forward

    toks = prompt_tokens(32, vocab)
    card_routes = []
    real = moe.router_topk

    def forward(dev, router):
        lm2 = first_layers(lm, layers, dev)
        t = torch.as_tensor(toks, dtype=torch.int64, device=dev)
        moe.router_topk = router
        try:
            out, _ = decoder_forward(lm2.decoder_config, lm2.params, t, lm2.new_state(),
                                     last_only=False)
        finally:
            moe.router_topk = real
        return out.float().cpu()

    def recording(c, p, x):
        out = real(c, p, x)
        card_routes.append(out[0].cpu())
        return out

    card = forward("cuda", recording)
    replay = iter(card_routes)
    pinned, gaps = pinned_router(torch, lambda x: next(replay))
    host = forward("cpu", pinned)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    info[key] = dict(tokens=len(toks), layers=layers, rel_l2=rel(card, host), tol=TOL,
                     finite=bool(torch.isfinite(card).all()))
    if card_routes:
        rg = torch.cat(gaps).double().tolist()
        info[key].update(routed_rows=len(rg), router_flips=sum(g > 0 for g in rg),
                         max_router_gap=max(rg),
                         rel_l2_free_host_routing=rel(card, forward("cpu", real)))
    log(key.upper() + " " + json.dumps(info[key]))
    if not (info[key]["rel_l2"] <= TOL) or not info[key]["finite"]:
        raise AssertionError(f"{key}: card vs CPU logits: relative L2 "
                             f"{info[key]['rel_l2']:.3e} > {TOL}")
    if card_routes:
        check_routing([dict(max_router_gap=info[key]["max_router_gap"])])


# -- phase 11: the measurement tools -----------------------------------------------


def trace_device_time(path: str) -> tuple[dict, float, float]:
    """Read a torch.profiler Chrome trace: ({kernel name: [launches, summed
    ms]}, device-busy ms (the union of the kernel, memcpy and memset
    intervals), window ms (from the first host op to the last event of the
    host or the device))."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    if not device or not host:
        raise AssertionError(f"{path}: {len(device)} device and {len(host)} host events")
    kernels: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    start = min(float(e["ts"]) for e in host)
    stop = max(float(e["ts"]) + e["dur"] for e in host + device)
    return kernels, busy / 1e3, (stop - start) / 1e3


def tools_profile(torch, lm16, info: dict) -> None:
    """One greedy generation of GEN_TOKENS after a GEN_PROMPT-token prompt
    with the prefill and decode captures armed: each phase must leave one
    trace that holds the kernels TRACE_KERNELS names."""
    import shutil

    from uzu_tpu_torch.tools import profile

    out_dir = os.path.join(REPO, ".port_cache", "traces")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.environ.update(UZU_TPU_PROFILE="prefill,decode", UZU_TPU_PROFILE_DIR=out_dir)
    profile.reset()
    try:
        lm16.generate_list(prompt_tokens(GEN_PROMPT, FLAGSHIP["vocab_size"]), GEN_TOKENS,
                           stop_token_ids=[])
    finally:
        del os.environ["UZU_TPU_PROFILE"], os.environ["UZU_TPU_PROFILE_DIR"]
        profile.reset()
    out = {}
    for phase, wanted in TRACE_KERNELS.items():
        found = [d for d in os.listdir(out_dir) if d.startswith(phase + "_")]
        if len(found) != 1:
            raise AssertionError(f"expected one {phase} trace in {out_dir}, found {found}")
        path = os.path.join(out_dir, found[0], "trace.json")
        kernels, busy_ms, window_ms = trace_device_time(path)
        for label, names in wanted.items():
            if not any(n in k for k in kernels for n in names):
                raise AssertionError(f"the {phase} trace holds no {label} kernel ({names})")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        out[phase] = dict(
            trace=os.path.relpath(path, REPO), trace_bytes=os.path.getsize(path),
            kernel_launches=sum(c for c, _ in kernels.values()),
            kernel_ms=sum(t for _, t in kernels.values()), device_busy_ms=busy_ms,
            window_ms=window_ms, device_busy_share=busy_ms / window_ms,
            top_device_ops=[dict(name=name[:100], launches=c, ms=t) for name, (c, t) in top],
            port_kernels={n: [sum(c for k, (c, _) in kernels.items() if n in k),
                              sum(t for k, (_, t) in kernels.items() if n in k)]
                          for n in TRACED_PORT_KERNELS})
    info["tools_profile"] = out
    log("TOOLS_PROFILE " + json.dumps(out))


def tools_microbench(torch, lm16, info: dict) -> None:
    """`kernel_micros` on the flagship: every time positive, K5 launched."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools.microbench import kernel_micros

    reset_launches()
    micros = kernel_micros(lm16)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    info["tools_microbench"] = dict(ms=micros, launches=launches)
    log("TOOLS_MICROBENCH " + json.dumps(info["tools_microbench"]))
    bad = [k for k, v in micros.items() if not v > 0]
    if bad:
        raise AssertionError(f"microbench probes without a positive time: {bad}")
    if not launches.get("paged_attention"):
        raise AssertionError("paged_attention_micro did not launch K5")


def tools_step_breakdown(torch, model_dir: str, info: dict) -> None:
    """The step breakdown of the flagship's decode step (M=1) and of a
    256-row prefill chunk."""
    from uzu_tpu_torch.tools import exp_step_breakdown as sb

    info["tools_step_breakdown"] = dict(decode=sb.main(model_dir, 1, "cuda"),
                                        prefill=sb.prefill_main(model_dir, 256, "cuda"))
    log("TOOLS_STEP_BREAKDOWN " + json.dumps(info["tools_step_breakdown"]))


def tools_quality(torch, lm16, info: dict) -> None:
    """Teacher-forced NLL and the activation trace of a 256-token corpus
    sequence through the flagship's first 2 layers, on the card and on the
    host CPU: |dNLL| <= NLL_TOL, every trace entry within TOL relative L2."""
    import numpy as np

    from uzu_tpu_torch.tools import corpus, quality

    toks = corpus.generate_tokens(256, seed=0)
    nll, traces = {}, {}
    for dev in ("cuda", "cpu"):
        lm = first_layers(lm16, 2, dev)
        nll[dev] = quality.sequence_nll(lm, toks)
        traces[dev] = quality.capture_trace(lm, toks)
        del lm
    rel = {k: float(np.linalg.norm(traces["cuda"][k] - v) / np.linalg.norm(v))
           for k, v in traces["cpu"].items()}
    finite = all(bool(np.isfinite(v).all()) for v in traces["cuda"].values())
    info["tools_quality"] = dict(tokens=len(toks), layers=2, nll=nll,
                                 nll_delta=nll["cuda"]["nll"] - nll["cpu"]["nll"],
                                 nll_tol=NLL_TOL, trace_rel_l2=rel, tol=TOL, finite=finite)
    log("TOOLS_QUALITY " + json.dumps(info["tools_quality"]))
    if not abs(info["tools_quality"]["nll_delta"]) <= NLL_TOL:
        raise AssertionError(f"NLL on the card and the host differ by "
                             f"{info['tools_quality']['nll_delta']:.3e} nats > {NLL_TOL}")
    bad = {k: v for k, v in rel.items() if not v <= TOL}
    if bad or not finite:
        raise AssertionError(f"activation traces, card against host: {bad} > {TOL} "
                             f"(finite: {finite})")


def tools_bisect(torch, info: dict) -> None:
    """The quant-matmul bisect probe on the card: P1's block read exact,
    each K1 cell within BISECT_LIMITS of RMS of its numpy oracle."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import exp_qmm_bisect

    reset_launches()
    cells = exp_qmm_bisect.main("cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    info["bisect"] = dict(cells=cells, limits=BISECT_LIMITS, launches=launches)
    log("TOOLS_BISECT " + json.dumps(info["bisect"]))
    if cells["blockread_kg16_err"]["value"] != 0.0:
        raise AssertionError(f"P1 read the scale block back with error "
                             f"{cells['blockread_kg16_err']['value']}")
    bad = {c: cells[c]["err_over_rms"] for c, lim in BISECT_LIMITS.items()
           if not cells[c]["err_over_rms"] <= lim}
    if bad:
        raise AssertionError(f"bisect cells past their limits {BISECT_LIMITS}: {bad}")
    if launches["scale_block_copy"] != 1 or launches["quant_matmul_int4"] != 6:
        raise AssertionError(f"the bisect probe launched {launches}, expected P1 once and "
                             "K1 six times")


def kernel_record(rows, info) -> list[dict]:
    """One entry per kernel at its main-path shape (the decode GEMV of the
    up|gate projection for K1/K2, a 256-row prefill chunk over a 1024-slot
    context for K3/K4, 8 slots x 1024 live tokens in 512-token pages for
    K5/K6, one token's 4 experts of gpt-oss's up projection for K7/K8, the
    paged step's 32 routed rows of it for K9, a 1024-row chunk's 4096 for
    K10, the bisect probe's [256, 16] block for P1), with the launches of
    the path that runs it; errors are the worst over every shape checked."""
    spec = {
        "quant_matmul_int4": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:183",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int4_path"),
        "quant_matmul_int8": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:247",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int8_path"),
        "flash_attention": ("uzu_tpu_torch/csrc/flash_attention.cu",
                            "uzu_tpu/ops/pallas/flash_attention.py:111",
                            dict(S=256, C=1024, pos0=765, Dh=64, q="bf16", variant="plain"),
                            "int4_path"),
        "flash_attention_int8": ("uzu_tpu_torch/csrc/flash_attention.cu",
                                 "uzu_tpu/ops/pallas/flash_attention.py:132",
                                 dict(S=256, C=1024, pos0=765, Dh=64, q="bf16",
                                      variant="plain"), "paged_int8"),
        "paged_attention": ("uzu_tpu_torch/csrc/paged_attention.cu",
                            "uzu_tpu/ops/pallas/paged_attention.py:76",
                            dict(page=512, H=32, Dh=64, q="bf16", lengths="uniform1024",
                                 variant="plain"), "paged_int4"),
        "paged_attention_int8": ("uzu_tpu_torch/csrc/paged_attention.cu",
                                 "uzu_tpu/ops/pallas/paged_attention.py:115",
                                 dict(page=512, Dh=64, q="bf16", lengths="uniform1024",
                                      variant="plain"), "paged_int8"),
        "moe_gemv_int4": ("uzu_tpu_torch/csrc/moe_gemv.cu",
                          "uzu_tpu/ops/pallas/moe_gemv.py:68",
                          dict(weight="up", P=4), "gptoss_int4"),
        "moe_gemv_int8": ("uzu_tpu_torch/csrc/moe_gemv.cu",
                          "uzu_tpu/ops/pallas/moe_gemv.py:123",
                          dict(weight="up", P=4), "gptoss_int8"),
        "grouped_matmul_int4": ("uzu_tpu_torch/csrc/grouped_matmul.cu",
                                "uzu_tpu/ops/pallas/grouped_matmul.py:165",
                                dict(weight="up", T=32, bm=8), "paged_gptoss"),
        "grouped_matmul": ("uzu_tpu_torch/csrc/grouped_matmul.cu",
                           "uzu_tpu/ops/pallas/grouped_matmul.py:67",
                           dict(weight="up", T=4096), "gptoss_int8"),
        "scale_block_copy": ("uzu_tpu_torch/csrc/block_copy.cu", "tools/exp_qmm_bisect.py:78",
                             dict(R=256, kg=16), "bisect"),
    }
    out = []
    for name, (src, replaces, where, path) in spec.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if all(r[k] == v for k, v in where.items()))
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=info[path]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            shape={k: rep[k] for k in rep if k in ("weight", "N", "K", "M", "S", "H", "G",
                                                    "Dh", "C", "pos0", "q", "splits", "variant",
                                                    "B", "page",
                                                    "lengths", "live_tokens", "E", "P", "T",
                                                    "Tp", "bm", "route", "kw", "bn",
                                                    "used_tiles", "distinct_experts",
                                                    "R", "kg", "width")}))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "uzu_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (uzu_tpu_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from uzu_tpu_torch.ops.cuda import build as kbuild

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "phase_seconds": {}}
    log(f"CARD {smi}")

    only = {"--flash-only": ("flash_attention",), "--paged-only": ("paged_attention",),
            "--qmm-only": ("quant_matmul", "moe_gemv", "grouped_matmul"),
            "--grouped-only": ("grouped_matmul", "moe_gemv")}
    for flag, sources in only.items():
        if flag not in sys.argv[1:]:
            continue
        # one kernel's rows of phase 2 alone; run it in two checkouts in
        # turns (A, B, B, A) to compare two versions of the kernel on one card
        source = sources[0]
        log(f"BUILD {', '.join(sources)} built in {kbuild.build(sources):.1f} s")
        timer, rows = Timer(torch), []
        if source == "quant_matmul":
            log("QMM_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get(source, ""), "qmm")))
            check_quant_matmul(torch, timer, rows)
            check_qmm_rows(torch, {})
            check_moe_gemv(torch, timer, rows)
            check_grouped_matmul(torch, timer, rows)
        elif source == "grouped_matmul":
            log("GROUPED_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get(source, ""),
                                                             "grouped")))
            check_moe_gemv(torch, timer, rows)
            check_grouped_matmul(torch, timer, rows, sweep=True)
            check_grouped_rows(torch, {})
        elif source == "flash_attention":
            usage = kernel_usage(kbuild.BUILD_LOGS.get(source, ""), "flash_fwd")
            log("FLASH_PTXAS " + json.dumps(usage))
            check_flash_attention(torch, timer, rows, usage)
            check_flash_attention_int8(torch, timer, rows, usage)
            check_attention_gptoss(torch, timer, rows, usage)
        else:
            usage = kernel_usage(kbuild.BUILD_LOGS.get(source, ""), "paged_decode")
            log("PAGED_PTXAS " + json.dumps(usage))
            check_paged_attention(torch, timer, rows, usage)
            check_paged_gptoss(torch, timer, rows, usage)
        log(f"{flag[2:].replace('-', '_').upper()} {len(rows)} rows")
        return 0

    # phase 1: build the kernels while the models are synthesized
    built: dict = {}

    def run_build():
        try:
            built["seconds"] = kbuild.build()
        except Exception as e:  # reported and re-raised by the main thread
            built["error"] = e

    th = threading.Thread(target=run_build)
    th.start()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(MODELS), mp_context=multiprocessing.get_context("spawn")) as ex:
        dirs = dict(zip(MODELS, ex.map(synth_model, MODELS)))
    info["phase_seconds"]["synthesize"] = time.perf_counter() - t0
    th.join()
    if "error" in built:
        raise built["error"]
    info["build_seconds"] = built["seconds"]
    log(f"BUILD kernels built in {built['seconds']:.1f} s "
        f"(synthesis {info['phase_seconds']['synthesize']:.1f} s alongside)")

    t0 = time.perf_counter()
    timer = Timer(torch)
    rows: list = []
    info["qmm_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("quant_matmul", ""), "qmm")
    log("QMM_PTXAS " + json.dumps(info["qmm_ptxas"]))
    check_quant_matmul(torch, timer, rows)
    check_qmm_rows(torch, info)
    usage = kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd")
    info["flash_ptxas"] = usage
    log("FLASH_PTXAS " + json.dumps(usage))
    check_flash_attention(torch, timer, rows, usage)
    check_flash_attention_int8(torch, timer, rows, usage)
    check_attention_gptoss(torch, timer, rows, usage)
    paged_usage = kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""), "paged_decode")
    info["paged_ptxas"] = paged_usage
    log("PAGED_PTXAS " + json.dumps(paged_usage))
    check_paged_attention(torch, timer, rows, paged_usage)
    check_paged_gptoss(torch, timer, rows, paged_usage)
    check_moe_gemv(torch, timer, rows)
    info["grouped_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("grouped_matmul", ""), "grouped")
    log("GROUPED_PTXAS " + json.dumps(info["grouped_ptxas"]))
    check_grouped_matmul(torch, timer, rows)
    check_grouped_rows(torch, info)
    check_block_copy(torch, timer, rows)
    del timer
    torch.cuda.empty_cache()
    info["phase_seconds"]["kernels"] = time.perf_counter() - t0

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        info["phase_seconds"][name] = time.perf_counter() - t
        return out

    lm16 = phase("path_int4", path_int4, torch, dirs["llama1b_int4"], info)
    phase("path_int4_kv_int8", path_int4_kv_int8, torch, lm16, info)
    phase("paged_int4", path_paged_int4, torch, lm16, info)
    phase("path_int8", path_int8, torch, dirs["llama1b_int8_2l"], info)
    phase("paged_int8", path_paged_int8, torch, dirs["llama1b_int8_2l"], info)
    lm_oss = phase("gptoss_int4", path_gptoss_int4, torch, dirs["gptoss_int4"], info)
    phase("paged_gptoss", path_paged_gptoss, torch, lm_oss, info)
    phase("gptoss_int8", path_gptoss_int8, torch, dirs["gptoss_int8_2l"], info)
    torch.cuda.empty_cache()
    phase("control", control_planted_faults, torch, lm16, info)
    phase("control_moe", control_moe_faults, torch, lm_oss, info)
    phase("whole_path", whole_path_check, torch, lm16, 2, FLAGSHIP["vocab_size"],
          "whole_path", info)
    phase("whole_path_gptoss", whole_path_check, torch, lm_oss, 4, GPTOSS["vocab_size"],
          "whole_path_gptoss", info)
    del lm_oss
    torch.cuda.empty_cache()
    phase("tools_profile", tools_profile, torch, lm16, info)
    phase("tools_microbench", tools_microbench, torch, lm16, info)
    phase("tools_step_breakdown", tools_step_breakdown, torch, dirs["llama1b_int4"], info)
    phase("tools_quality", tools_quality, torch, lm16, info)
    phase("tools_bisect", tools_bisect, torch, info)
    info["phase_seconds"]["total"] = time.perf_counter() - t_start
    log("PHASES " + json.dumps(info["phase_seconds"]))

    record = kernel_record(rows, info)
    os.makedirs(os.path.join(REPO, ".port_cache"), exist_ok=True)
    with open(os.path.join(REPO, ".port_cache", "chip_smoke.json"), "w") as f:
        json.dump(dict(info, kernel_rows=rows, kernels=record), f, indent=1)
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`uzu_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build: compile every CUDA kernel of the port from `uzu_tpu_torch/csrc/`
   (one nvcc per source, in parallel) while the flagship model is
   synthesized; print the card's name and power limit.
2. kernels: each kernel against its plain PyTorch version on the card at
   the flagship's shapes (bf16 inputs, f32 accumulation), with its time,
   the plain version's time, one PyTorch library call as a yardstick, and
   the bound (bytes over the HBM rate or FLOPs over the bf16 peak).
3. path INT4: the Llama-1B-shaped INT4 flagship (16 layers, d 2048, vocab
   128256, random weights from a seed) loaded with `LanguageModel.from_dir`
   on the card; greedy generation of 64 tokens after a 128-token prompt,
   twice, with identical tokens; launch counts of K1 and K3 on that run.
4. path INT8: the same shape with INT8 linears at 2 layers; K2 launched.
5. whole-path check: teacher-forced logits of a 32-token prompt through
   the 2-layer INT4 model on the card and on the host CPU.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Full per-shape numbers also go to
`.port_cache/chip_smoke.json`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time

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
GEN_PROMPT, GEN_TOKENS = 128, 64
REPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median device time of `fn` over REPS launches, each after an L2
    flush (the weights of a decode step do not stay in the 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def rel_err(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    return d, d / max(rms, 1e-30)


# -- phase 2: kernels --------------------------------------------------------


def check_quant_matmul(torch, timer, rows) -> None:
    from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
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
                for m in (1, 16, 256):
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
                    row = dict(kernel=f"quant_matmul_int{bits}", weight=wname, N=n, K=k,
                               M=m, variant=variant, max_abs_err=abs_err, err_over_rms=err,
                               tol=TOL, ms=timer.ms(lambda: quant_matmul(w, x)),
                               plain_ms=timer.ms(lambda: quant_matmul_plain(w, x), 3),
                               library_ms=timer.ms(lambda: torch.matmul(x, wd.t())),
                               bound_ms=b_ms, bound_by=b_by)
                    rows.append(row)
                    log("KERNEL " + json.dumps(row))
                del wd


def check_flash_attention(torch, timer, rows) -> None:
    import torch.nn.functional as F

    from uzu_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    h, g, dh = 32, 8, 64
    rep = h // g
    scale = dh ** -0.5
    for s in (16, 256):
        for c in (1024, 4096):
            pos0 = c - s - 3
            q = torch.randn((s, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
            kc = torch.randn((c, g, dh), device="cuda", generator=gen).to(torch.bfloat16)
            vc = torch.randn((c, g, dh), device="cuda", generator=gen).to(torch.bfloat16)
            qpos = torch.arange(s, device="cuda", dtype=torch.int32) + pos0
            sinks = torch.randn((h,), device="cuda", generator=gen)
            for variant in ("plain", "window", "softcap", "sinks"):
                kw = {}
                if variant == "window":
                    kw["sliding_window_size"] = 512
                elif variant == "softcap":
                    kw["logit_soft_cap"] = 30.0
                elif variant == "sinks":
                    kw["sinks"] = sinks
                got = flash_attention(q, kc, vc, qpos, scale=scale, **kw)
                want = flash_attention_plain(q, kc, vc, qpos, scale=scale, **kw)
                torch.cuda.synchronize()
                abs_err, err = rel_err(got, want)
                if not (err <= TOL):
                    raise AssertionError(f"flash_attention S={s} C={c} {variant}: "
                                         f"error {err:.3e} of RMS > {TOL}")
                # visible keys per query row: what this run's data needs
                qp = pos0 + torch.arange(s)
                lo = (qp - kw["sliding_window_size"] + 1).clamp(min=0) if variant == "window" \
                    else torch.zeros_like(qp)
                visible = int((qp + 1 - lo).sum())
                kv_rows = int(qp[-1] + 1 - lo[0])
                nbytes = q.numel() * 2 + 2 * kv_rows * g * dh * 2 + s * h * dh * 4
                b_ms, b_by = bound(nbytes, 4.0 * visible * h * dh)
                lib_ms = None
                if variant in ("plain", "window"):
                    kpos = torch.arange(c, device="cuda")
                    qpd = qpos.long()[:, None]
                    mask = kpos[None, :] <= qpd
                    if variant == "window":
                        mask &= kpos[None, :] > qpd - kw["sliding_window_size"]
                    qt = q.transpose(0, 1)[None]
                    kt = kc.transpose(0, 1)[None].repeat_interleave(rep, dim=1)
                    vt = vc.transpose(0, 1)[None].repeat_interleave(rep, dim=1)
                    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, scale=scale))
                row = dict(kernel="flash_attention", S=s, H=h, G=g, Dh=dh, C=c, pos0=pos0,
                           variant=variant, max_abs_err=abs_err, err_over_rms=err, tol=TOL,
                           ms=timer.ms(lambda: flash_attention(q, kc, vc, qpos, scale=scale, **kw)),
                           plain_ms=timer.ms(lambda: flash_attention_plain(
                               q, kc, vc, qpos, scale=scale, **kw), 3),
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                log("KERNEL " + json.dumps(row))


# -- phases 3-5: the port's main path -----------------------------------------


def synth_flagship(num_layers: int, bits: int, name: str) -> str:
    from uzu_tpu_torch.config.model import IntSpec, Layout
    from uzu_tpu_torch.tools.synth import llama_config, synthesize

    out = os.path.join(REPO, ".port_cache", name)
    if not os.path.exists(os.path.join(out, "model.safetensors")):
        dims = dict(FLAGSHIP, num_layers=num_layers)
        lin = IntSpec(bits=bits, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
        emb = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
        synthesize(llama_config(**dims), out, seed=0, linear_spec=lin, embedding_spec=emb)
    return out


def prompt_tokens(n: int, vocab: int):
    import numpy as np

    return (np.arange(n) * 37 + 11) % vocab


def path_int4(torch, model_dir: str, info: dict) -> tuple:
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    prompt = prompt_tokens(GEN_PROMPT, FLAGSHIP["vocab_size"])
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
        raise AssertionError(f"greedy generation differs between runs:\n{toks}\n{toks2}")
    if len(toks) != GEN_TOKENS:
        raise AssertionError(f"expected {GEN_TOKENS} tokens, got {len(toks)}")
    for name in ("quant_matmul_int4", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the INT4 path")
    decode_steps = metrics.num_forward_passes - 1
    per_step = {n: (launches[n] - per_prefill_chunk[n]) / decode_steps for n in launches}
    info["int4_path"] = dict(
        prompt=GEN_PROMPT, generated=len(toks), tokens_head=toks[:16],
        prefill_tok_s=[m.prefill_tokens_per_second for _, m, _ in runs],
        decode_tok_s=[m.decode_tokens_per_second for _, m, _ in runs],
        launches=launches, launches_per_prefill_chunk=per_prefill_chunk,
        launches_per_decode_step=per_step, decode_steps=decode_steps)
    log("PATH_INT4 " + json.dumps(info["int4_path"]))
    return lm, launches


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


def whole_path_check(torch, lm16, info: dict) -> None:
    """Teacher-forced logits of the first 2 layers of the INT4 flagship,
    on the card and through the port's plain path on the host CPU."""
    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.models.decoder import decoder_forward

    cfg = lm16.config
    tcfg = cfg.decoder_config.transformer_config
    dcfg = dataclasses.replace(cfg.decoder_config, transformer_config=dataclasses.replace(
        tcfg, layer_configs=tcfg.layer_configs[:2]))
    cfg2 = dataclasses.replace(cfg, decoder_config=dcfg)
    params2 = dict(lm16.params, layers=lm16.params["layers"][:2])
    toks = prompt_tokens(32, FLAGSHIP["vocab_size"])
    logits = {}
    for dev in ("cuda", "cpu"):
        lm = LanguageModel(cfg2, params2, device=dev, max_context=1024)
        t = torch.as_tensor(toks, dtype=torch.int64, device=dev)
        out, _ = decoder_forward(dcfg, lm.params, t, lm.new_state(), last_only=False)
        logits[dev] = out.float().cpu()
    rel = ((logits["cuda"] - logits["cpu"]).norm() / logits["cpu"].norm()).item()
    info["whole_path"] = dict(tokens=len(toks), layers=2, rel_l2=rel, tol=TOL,
                              finite=bool(torch.isfinite(logits["cuda"]).all()))
    log("WHOLE_PATH " + json.dumps(info["whole_path"]))
    if not (rel <= TOL) or not info["whole_path"]["finite"]:
        raise AssertionError(f"card vs CPU logits: relative L2 {rel:.3e} > {TOL}")


def kernel_record(rows, info) -> list[dict]:
    """One entry per kernel at its main-path shape (the decode GEMV of the
    up|gate projection for K1/K2, a 256-row prefill chunk over a 1024-slot
    context for K3); errors are the worst over every shape checked."""
    spec = {
        "quant_matmul_int4": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:183",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int4_path"),
        "quant_matmul_int8": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:247",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int8_path"),
        "flash_attention": ("uzu_tpu_torch/csrc/flash_attention.cu",
                            "uzu_tpu/ops/pallas/flash_attention.py:111",
                            dict(S=256, C=1024, variant="plain"), "int4_path"),
    }
    out = []
    for name, (src, replaces, where, path) in spec.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if all(r[k] == v for k, v in where.items()))
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=info[path]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=TOL,
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape={k: rep[k] for k in rep if k in ("weight", "N", "K", "M", "S", "H", "G",
                                                    "Dh", "C", "pos0", "variant")}))
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

    # phase 1: build the kernels while the flagship is synthesized
    built: dict = {}

    def run_build():
        try:
            built["seconds"] = kbuild.build()
        except Exception as e:  # reported and re-raised by the main thread
            built["error"] = e

    th = threading.Thread(target=run_build)
    th.start()
    t0 = time.perf_counter()
    dir16 = synth_flagship(16, 4, "llama1b_int4")
    dir8 = synth_flagship(2, 8, "llama1b_int8_2l")
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
    check_quant_matmul(torch, timer, rows)
    check_flash_attention(torch, timer, rows)
    del timer
    torch.cuda.empty_cache()
    info["phase_seconds"]["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lm16, _ = path_int4(torch, dir16, info)
    info["phase_seconds"]["path_int4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_int8(torch, dir8, info)
    info["phase_seconds"]["path_int8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole_path_check(torch, lm16, info)
    info["phase_seconds"]["whole_path"] = time.perf_counter() - t0
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

"""Decode-step and prefill-chunk time breakdown by linear shape.

Counterpart of `uzu_tpu/tools/exp_step_breakdown.py`. Times every distinct
linear of a model (layer 0's qkv, out, up|gate and down, and the readout)
with the microbench timing rule, sums them over the model's layers and
sets the sum against the measured step: the residual is attention, norms,
RoPE, sampling, the readout's glue and, in the port's eager execution,
every op's host dispatch that the kernels do not hide.

    python -m uzu_tpu_torch.tools.exp_step_breakdown MODEL_DIR [--m 1]
        [--prefill-chunk N] [--device cpu]

`main` gives the decode step (M rows per linear), `prefill_main` one
prefill chunk (M = chunk); both print and return the same keys as the
JAX tool.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from .microbench import scan_diff_ms


def _timeit(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _diff_ms(run_big, run_small, per: int, pairs: int = 5) -> float:
    """ms per unit of work: the median over interleaved pairs of the time
    of run_big minus that of run_small (each ends in a host read of its
    result), over the `per` units run_big does more."""
    diffs = [_timeit(run_big) - _timeit(run_small) for _ in range(pairs)]
    ms = statistics.median(diffs) / per * 1e3
    if not ms > 0:
        raise RuntimeError(f"differential time {ms:.3e} ms is not positive")
    return ms


def time_shape(lm, w, m: int, k_small: int = 32, k_big: int = 160,
               pairs: int = 5) -> float:
    """ms per call of `linear_apply` on weight `w` with bf16 [m, K] inputs
    (each repetition's input scaled slightly apart), by the differential
    loop timing of `microbench.scan_diff_ms`."""
    from ..ops.linear import linear_apply

    kdim = w.shape[1]  # dense tensors and QuantizedTensor both expose .shape
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((m, kdim))).to(
        lm.device, torch.bfloat16)

    def inputs(reps: int):
        scales_i = 1.0 + 1e-3 * torch.arange(reps, dtype=torch.float32, device=lm.device)
        return (x0[None].float() * scales_i[:, None, None]).to(torch.bfloat16)

    def one(w, xv):
        return linear_apply(w, xv).float().sum()

    return scan_diff_ms(one, w, inputs, k_small=k_small, k_big=k_big, pairs=pairs)


def weight_nbytes(w) -> int:
    """Bytes of a dense weight or of a quantized one's codes and scales."""
    parts = [w] if isinstance(w, torch.Tensor) else [
        getattr(w, f.name) for f in dataclasses.fields(w)]
    return sum(t.numel() * t.element_size() for t in parts if isinstance(t, torch.Tensor))


def _layer0_probes(lm) -> dict:
    l0 = lm.params["layers"][0]
    return {
        "qkv": l0["mixer"]["qkv"]["w"],
        "out": l0["mixer"]["out"]["w"],
        "up|gate": l0["mlp"]["up"]["w"],
        "down": l0["mlp"]["down"]["w"],
    }


def _sync(t: torch.Tensor) -> None:
    t.reshape(-1)[:1].tolist()  # one host read waits for the work before it


def prefill_main(model_dir: str, chunk: int = 512, device=None) -> dict:
    """Prefill-chunk breakdown: per-shape probes at M=chunk against the
    chunk's time, the difference between a 3-chunk and a 1-chunk prompt
    over 2 (what each prompt pays once cancels)."""
    from ..engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device=device, max_context=4 * chunk,
                                prefill_buckets=(chunk,))
    n_layers = len(lm.decoder_config.transformer_config.layer_configs)
    rows = {}
    per_layer_ms = 0.0
    for name, w in _layer0_probes(lm).items():
        ms = time_shape(lm, w, chunk)
        rows[name] = {"ms": round(ms, 4), "mb": round(weight_nbytes(w) / 1e6, 1)}
        per_layer_ms += ms
    matmul_total = per_layer_ms * n_layers

    prompt1 = (np.arange(chunk) * 13) % 128
    prompt3 = (np.arange(3 * chunk) * 13) % 128

    def run(p):
        logits, _ = lm.prefill(lm.new_state(), p)
        _sync(logits)

    run(prompt1)  # warm both lengths
    run(prompt3)
    chunk_ms = _diff_ms(lambda: run(prompt3), lambda: run(prompt1), 2)
    out = {
        "per_shape": rows,
        "matmul_sum_ms": round(matmul_total, 3),
        "prefill_chunk_ms": round(chunk_ms, 3),
        "residual_ms": round(chunk_ms - matmul_total, 3),
        "residual_pct": round(100 * (chunk_ms - matmul_total) / chunk_ms, 1),
    }
    print(json.dumps(out, indent=1))
    return out


def main(model_dir: str, m: int = 1, device=None) -> dict:
    """Decode-step breakdown: per-shape probes at M=m (the readout at M=1)
    against the fused step, the difference between a 48-step and a 16-step
    decode chunk through `LanguageModel._decode_chunk` over 32."""
    from ..engine.engine import LanguageModel
    from ..engine.sampling import SamplingParams

    lm = LanguageModel.from_dir(model_dir, device=device, max_context=1024,
                                prefill_buckets=(64,))
    n_layers = len(lm.decoder_config.transformer_config.layer_configs)
    emb = lm.params["embedding"].get("tied", lm.params["embedding"].get("output"))

    rows = {}
    per_layer_ms = 0.0
    for name, w in _layer0_probes(lm).items():
        ms = time_shape(lm, w, m)
        nb = weight_nbytes(w)
        rows[name] = {"ms": round(ms, 4), "mb": round(nb / 1e6, 1),
                      "gbs": round(nb / ms / 1e6, 1)}
        per_layer_ms += ms
    ms_read = time_shape(lm, emb, 1)
    nb_read = weight_nbytes(emb)
    rows["readout"] = {"ms": round(ms_read, 4), "mb": round(nb_read / 1e6, 1),
                       "gbs": round(nb_read / ms_read / 1e6, 1)}
    matmul_total = per_layer_ms * n_layers + ms_read

    # the fused step (single stream, greedy, from position 48): each run
    # continues the state, 48 + 6 x 64 steps stay inside max_context
    dev = lm.device
    _, state = lm.prefill(lm.new_state(), (np.arange(48) * 13) % 128)
    token = torch.tensor(7, device=dev)
    halted = torch.zeros((), dtype=torch.bool, device=dev)
    budget = torch.tensor(1 << 30, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    k_s, k_b = 16, 48

    def run(k):
        nonlocal state
        state, emitted, _ = lm._decode_chunk(state, token, halted, budget, k,
                                             SamplingParams(), None, None, gen)
        _sync(emitted)

    run(k_s)  # warm both lengths
    run(k_b)
    step_ms = _diff_ms(lambda: run(k_b), lambda: run(k_s), k_b - k_s)

    out = {
        "per_shape": rows,
        "n_layers": n_layers,
        "matmul_sum_ms": round(matmul_total, 3),
        "step_ms": round(step_ms, 3),
        "residual_ms": round(step_ms - matmul_total, 3),
        "residual_pct": round(100 * (step_ms - matmul_total) / step_ms, 1),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir")
    ap.add_argument("--m", type=int, default=1, help="rows per linear of the decode step")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="break down one prefill chunk of this many rows instead")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    a = ap.parse_args()
    if a.prefill_chunk:
        prefill_main(a.model_dir, a.prefill_chunk, a.device)
    else:
        main(a.model_dir, a.m, a.device)

"""One run of one cell: set-up, the measured window, the check, the line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (all of it counts in `setup_s`): the card check, the kernels' build
(the first run in a checkout compiles, into `.build/` inside it), the
weights made on the card from the seed, the port's model and engine, one
request per prefill bucket the mix reaches, then the closed loop of
clients until `warm_completions` requests have ended. The window then
opens at a step boundary and closes at the first one `--seconds` later.
With `--trace 1` a profiler slice of a few seconds in mid-window gives the
per-layer metrics (`metrics/<name>.py`); otherwise the line carries the
end-to-end metrics. After the window the engine is freed and the sample
is checked against the plain reference (`check.py`).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from . import check, traffic
from .loop import ClosedLoop, Spans, percentile, window_metrics
from .spec import HERE, find, load_json, model_spec

ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "uzu_tpu")
SLICE_S = 4.0  # profiler slice length, at least
SLICE_MAX_S = 20.0
KERNEL_LIBRARIES = ("quant_matmul", "flash_attention", "paged_attention")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (`uzu_tpu_torch` is another name)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, centry["file"]))
    config["name"] = centry["name"]

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "config": config, "mix": load_json(find("traffic", cell["traffic"])),
            "limits": load_json(find("limits", name)),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def card_info(torch) -> dict:
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[:1]
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"unavailable: {e}"
    return info


def quantity(name: str, known) -> str:
    """The quantity a metric reports: its name, or, for a name that a cell
    qualifies to get bounds of its own (`output_tok_s.long-doc`), the name
    without its last dotted part."""
    return name if name in known or "." not in name else name.rsplit(".", 1)[0]


def _metric_reader(name: str):
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    path = os.path.join(HERE, "metrics", quantity(name, files) + ".py")
    mod_spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(
        ".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What the per-layer readers read: the window's spans with their
    stream times, and the profiler slice with its work."""

    def __init__(self, spec, pk, adapter, spans_rows, t_open, t_end, sliced):
        from .trace import busy_intervals, kernel_groups
        from .work import Work

        self.spec, self.peaks = spec, pk
        in_window = [r for r in spans_rows if r[1] >= t_open and r[2] <= t_end]
        self.prefill_ms = [r[4][0].elapsed_time(r[4][1]) for r in in_window
                           if r[0] == "prefill" and r[4] is not None]
        # (stream ms, steps) of each decode chunk
        self.decode_chunks = [(r[4][0].elapsed_time(r[4][1]), r[3][0]) for r in in_window
                              if r[0] == "decode" and r[4] is not None and r[3][0]]
        self.slice = sliced
        self.work = None
        self.groups = kernel_groups()
        if sliced is None:
            return
        self.slice_spans = [r for r in spans_rows if r[1] >= sliced["t0"] and r[2] <= sliced["t1"]]
        self.work = Work(spec, pk, adapter.DECODE_ATTENTION_GROUP)
        for kind, _, _, info, _ in self.slice_spans:
            if kind == "prefill":
                self.work.prefill(info[0], info[1])
            elif kind == "decode":
                self.work.decode(info[0], info[1])
        self.busy = busy_intervals(sliced["device"])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.window_s = sliced["window_s"]

    def group_seconds(self, group: str) -> float:
        pats = self.groups.get(group, [])
        return sum(t - s for name, s, t, k, _ in self.slice["device"]
                   if k and any(p.search(name) for p in pats))

    def decode_kernels(self) -> tuple[int, int]:
        """(kernels launched inside the slice's decode dispatches, by the
        host time of each launch call; the steps of those dispatches)."""
        spans = [r for r in self.slice_spans if r[0] == "decode"]
        launches = sorted(l for _, _, _, k, l in self.slice["device"] if k and l is not None)
        count = sum(int(np.searchsorted(launches, b, "right") - np.searchsorted(launches, a))
                    for _, a, b, _, _ in spans)
        return count, sum(r[3][0] for r in spans)


def kernel_table(ctx, top: int = 40) -> list:
    """[name, device seconds, launches, groups] of the slice's busiest
    device activities: what a new kernel group's patterns are written from."""
    rows: dict[str, list] = {}
    for name, s, t, _, _ in ctx.slice["device"]:
        row = rows.setdefault(name, [0.0, 0])
        row[0] += t - s
        row[1] += 1
    out = sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]
    return [[n[:160], v[0], v[1], [g for g, pats in ctx.groups.items()
                                   if any(p.search(n) for p in pats)]] for n, v in out]


def breakdown(ctx) -> dict:
    from .trace import host_label, idle_gaps, short_name

    totals: dict[str, float] = {}
    for name, s, t, _, _ in ctx.slice["device"]:
        key = short_name(name)
        totals[key] = totals.get(key, 0.0) + (t - s)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    idle: dict[str, float] = {}
    for a, b in idle_gaps(ctx.busy, ctx.slice["t0"], ctx.slice["t1"]):
        label = host_label(ctx.slice_spans, (a + b) / 2)
        idle[label] = idle.get(label, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"host in {k}", v] for k, v in gaps]}


def run_cell(loaded: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, control: bool = False, log=None) -> dict:
    """Run one cell; returns {"result": the line's object or None,
    "checks": [(name, value, limit)], "info": {...}, "control": ...}."""
    import torch

    from uzu_tpu_torch.ops.cuda import autotune, build as cuda_build

    from . import model as model_mod
    from .weights import make_raw

    log = log or (lambda **kw: print(json.dumps({"info": kw}), flush=True))
    config, mix, cell = loaded["config"], loaded["mix"], loaded["cell"]
    ecfg = config["engine"]
    adapter = importlib.import_module(f"portbench.engines.{ecfg['kind']}")
    spec = model_spec(config)
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a measurement never falls back to the CPU")
    info = {"cell": cell["name"], "seed": seed, "device": device}
    if on_card:
        info.update(card_info(torch))
        info["tile_table"] = autotune.table_in_use()
        t = time.perf_counter()
        info["build_s"] = cuda_build.build(KERNEL_LIBRARIES)
        info["build_wall_s"] = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
    log(**info)

    raw = make_raw(spec, seed, device)
    lm = model_mod.language_model(spec, raw, ecfg, device)
    engine = adapter.build(lm, ecfg)
    spans = Spans(engine, adapter, lm, events=trace)
    stream = traffic.Stream(mix, seed, spec.vocab)
    loop = ClosedLoop(engine, stream)

    # one request per prefill bucket the mix reaches, so that every shape
    # of the window has run once before it
    buckets = sorted(ecfg["prefill_buckets"])
    top = buckets[-1]
    rng = np.random.default_rng([int(seed), 5])
    for b in traffic.buckets_used(mix, buckets):
        n = min(top + b if b < top else top, ecfg["max_context"] - 4 * ecfg["decode_chunk"])
        engine.submit(rng.integers(0, spec.vocab, n).tolist(), 2 * ecfg["decode_chunk"])
    engine.run()
    cuda_build.reset_launches()
    t_warm = time.perf_counter()
    loop.start()
    t_open = loop.run_until(mix["warm_completions"])
    setup_s = t_open - t_process

    if trace:
        from .trace import Slice

        sl = Slice() if on_card else None
        mid = t_open + max(0.0, seconds / 2 - SLICE_S / 2)

        def hook(now):
            if sl is None:
                return
            if sl.t0 is None and now >= mid:
                sl.start()
            elif sl.t0 is not None and sl.t1 is None:
                rows = spans.between(sl.t0, now)
                kinds = {r[0] for r in rows}
                if (now - sl.t0 >= SLICE_S and {"prefill", "decode"} <= kinds) or \
                        now - sl.t0 >= SLICE_MAX_S:
                    sl.stop()
    else:
        hook = None
    t_end = loop.run_window(seconds, t_open, hook)
    if trace and on_card and sl.t0 is not None and sl.t1 is None:
        sl.stop()
    if on_card:
        torch.cuda.synchronize()
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return {"result": None, "checks": [], "info": info, "forbidden": found}

    wm = window_metrics(loop, t_open, t_end)
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    info2 = {"window_s": wm["seconds"], "warm_s": t_open - t_warm, "setup_s": setup_s,
             "requests_ended": len(wm["ended"]), "tokens": wm["tokens"],
             "ttft_n": len(wm["ttft_s"]), "tpot_n": len(wm["tpot_s"]),
             "memory_peak_bytes": mem_peak, "stats": dict(engine.stats),
             "launches": {k: v for k, v in cuda_build.LAUNCHES.items() if v}}
    ctx = None
    if trace:
        from .work import peaks

        pk = peaks(torch.cuda.get_device_name(0)) if on_card else None
        slice_read = sl.read() if (on_card and sl.t0 is not None) else None
        ctx = Context(spec, pk, adapter, spans.rows, t_open, t_end, slice_read)
        if slice_read is not None:
            info2["slice_s"] = ctx.window_s
            info2["slice_busy_s"] = ctx.busy_s
            info2["slice_prefill_rows"] = ctx.work.prefill_rows
            info2["slice_decode_steps"] = ctx.work.decode_steps
            info2["slice_kernels"] = kernel_table(ctx)
    log(**info2)

    picks = check.draw_sample(wm["ended"], seed, mix["sample_tokens"])
    wrong = check.wrong_lengths(wm["ended"])
    spans.restore()
    del engine, lm, loop, stream, spans
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    gaps, ref = check.served_gaps(spec, raw, picks) if picks else ([], [])
    max_gap = max((max(g) for g in gaps if g), default=None)
    info3 = {"sample_requests": len(picks), "sample_tokens": sum(len(g) for g in gaps),
             "sample_longest_prompt": max((r["n_prompt"] for r in picks), default=0),
             "reference_s": time.perf_counter() - t}
    out = {"info": info, "control": None}
    if control:
        t = time.perf_counter()
        ctl = check.control_gaps(spec, raw, picks, ref)
        out["control"] = {"program_max_gap": max_gap,
                          "control_max_gap": max((max(g) for g in ctl if g), default=None),
                          "control_s": time.perf_counter() - t}
        info3.update(out["control"])
    log(**info3)

    limit = loaded["limits"]["max_logit_gap"]["limit"]
    checks = [("max_logit_gap", max_gap, limit), ("wrong_lengths", wrong, 0)]
    correct = max_gap is not None and max_gap <= limit and wrong == 0

    metrics = {}
    if not trace:
        values = {"output_tok_s": wm["tokens"] / wm["seconds"],
                  "ttft_p90_ms": _ms(percentile(wm["ttft_s"], 90)),
                  "tpot_p90_ms": _ms(percentile(wm["tpot_s"], 90)),
                  "setup_s": setup_s}
        for m in loaded["end_to_end"]:
            v = values.get(quantity(m["name"], values))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in loaded["per_layer"]:
            v = _metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": mem_peak}
    if trace and ctx is not None and ctx.slice is not None:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
    result = {"correct": correct, "attempted": len(wm["ended"]), "failed": wrong,
              "metrics": metrics, "device": dev}
    if trace and ctx is not None and ctx.slice is not None:
        result["breakdown"] = breakdown(ctx)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    out.update(result=result, checks=checks)
    return out


def _ms(s):
    return None if s is None else 1e3 * s


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also run the control (the reference at fp8) on the sample")
    args = ap.parse_args(argv)
    loaded = load_cell(args.workload)
    os.environ.pop("UZU_TPU_PROFILE", None)
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".build", sub)
    import torch

    chips = loaded["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(loaded, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_process=t_process, control=bool(args.control))
    if out["result"] is None:
        return 3
    for name, value, limit in out["checks"]:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0

"""Bench comparison: flag regressions between two or more bench records.

Counterpart of `uzu_tpu/tools/compare_bench.py` (a copy: it imports only
the standard library). Its records are the JSON lines the port's bench
tools print (`tools/bench8b.py`, `tools/benchmoe.py`,
`tools/bench_qwen08.py`: a "metric" key and flat numbers), a wrapper
holding one under "parsed", or a log whose last such line is the record;
the counters are the flat numbers and those one level down (a "micro"
section of per-kernel times).

A card shared with other work, or a host that dispatches slower, moves
every throughput number between runs. So for throughput metrics the tool
also reports a *bandwidth-normalized* delta when both records carry
``practical_bw_gbs`` (the memory rate the probe of
`tools/decode_probe.py` read during the run): value / practical_bw is
invariant to the device's delivered rate for anything weight-stream
bound. Regressions are flagged on the normalized delta when available,
on the raw delta otherwise.

Usage:
    python -m uzu_tpu_torch.tools.compare_bench a.json b.json
    python -m uzu_tpu_torch.tools.compare_bench --threshold 0.15 a.json b.json
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

# Metric direction: True = higher is better. Metrics not listed are
# matched by suffix rules below.
_HIGHER = {"value", "vs_baseline", "vs_practical", "sol_tok_s",
           "practical_bw_gbs", "selfspec_acceptance"}
_LOWER = {"ttft_s", "load_s", "weight_bytes"}
# Throughput metrics that scale with the in-window HBM stream and are
# meaningfully normalized by practical_bw_gbs.
_BW_BOUND_SUFFIXES = ("_tok_s", "_gbs")
_BW_BOUND_EXTRA = ("decode_step_ms", "quant_matmul_up_ms", "value")


def _higher_is_better(name: str) -> bool:
    if name in _HIGHER:
        return True
    if name in _LOWER:
        return False
    if name.endswith("_tok_s") or name.endswith("_gbs"):
        return True
    if name.endswith("_ms") or name.endswith("_s"):
        return False
    return True


def _flatten(parsed: dict) -> dict[str, float]:
    out: dict[str, float] = {}
    for k, v in parsed.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                if isinstance(vv, (int, float)) and not isinstance(vv, bool):
                    out[f"{k}.{kk}"] = float(vv)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v)
    return out


def load_record(path: str) -> dict[str, float]:
    """Accept a wrapper holding the record under "parsed", a raw bench
    JSON object, or a log whose last JSON-looking line is the bench
    record."""
    with open(path) as f:
        text = f.read()
    def _unwrap(o):
        if isinstance(o, dict) and isinstance(o.get("parsed"), dict):
            o = o["parsed"]
        return o if isinstance(o, dict) and "metric" in o else None

    try:
        obj = _unwrap(json.loads(text))
        if obj is None:
            raise ValueError(f"{path}: not a bench record (missing 'metric')")
    except ValueError as whole_err:
        if "not a bench record" in str(whole_err):
            raise
        # log file: scan from the end for the last line that IS a bench
        # record (trailing non-bench JSON like stage markers must not mask
        # an earlier valid record)
        obj = None
        for line in reversed(text.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    obj = _unwrap(json.loads(line))
                except ValueError:
                    continue
                if obj is not None:
                    break
        if obj is None:
            raise ValueError(f"{path}: no bench JSON record found")
    return _flatten(obj)


@dataclass
class Row:
    name: str
    a: float
    b: float
    delta: float            # signed relative change, + = improvement
    norm_delta: float | None  # bandwidth-normalized, when applicable
    regression: bool


def _is_bw_bound(name: str) -> bool:
    base = name.split(".")[-1]
    return base.endswith(_BW_BOUND_SUFFIXES) or base in _BW_BOUND_EXTRA


def build_comparison(a: dict[str, float], b: dict[str, float],
                     threshold: float = 0.2) -> list[Row]:
    """Rows for metrics present in BOTH records, worst movers first.

    delta is oriented so positive = better (throughput up, latency down).
    A row regresses when the normalized delta (or raw delta when
    normalization does not apply) is below -threshold.
    """
    bw_a, bw_b = a.get("practical_bw_gbs"), b.get("practical_bw_gbs")
    rows: list[Row] = []
    for name in sorted(set(a) & set(b)):
        if name == "practical_bw_gbs":
            continue  # window property, not a code metric
        va, vb = a[name], b[name]
        if va == 0:
            continue
        hib = _higher_is_better(name.split(".")[-1])
        raw = (vb - va) / abs(va)
        if not hib:
            raw = -raw
        norm = None
        if bw_a and bw_b and _is_bw_bound(name):
            # The window-invariant quantity for a bw-bound THROUGHPUT is
            # value/bw; for a bw-bound LATENCY it is value*bw (a slower
            # window raises latency AND lowers bw — dividing would amplify
            # the noise ~quadratically instead of cancelling it).
            if hib:
                na, nb = va / bw_a, vb / bw_b
                norm = (nb - na) / abs(na)
            else:
                na, nb = va * bw_a, vb * bw_b
                norm = -(nb - na) / abs(na)
        gate = norm if norm is not None else raw
        rows.append(Row(name, va, vb, raw, norm, gate < -threshold))
    rows.sort(key=lambda r: (r.norm_delta if r.norm_delta is not None
                             else r.delta))
    return rows


def format_table(rows: list[Row], label_a: str, label_b: str) -> str:
    w = max([len(r.name) for r in rows] + [6])
    lines = [f"{'metric':<{w}}  {label_a:>12}  {label_b:>12}  "
             f"{'delta':>8}  {'bw-norm':>8}  flag"]
    for r in rows:
        nd = f"{r.norm_delta:+7.1%}" if r.norm_delta is not None else "      —"
        flag = "REGRESSION" if r.regression else ""
        lines.append(f"{r.name:<{w}}  {r.a:>12.4g}  {r.b:>12.4g}  "
                     f"{r.delta:+7.1%}  {nd}  {flag}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("records", nargs="+",
                   help="two or more bench records, oldest first")
    p.add_argument("--threshold", type=float, default=0.2,
                   help="relative drop that counts as a regression "
                        "(default 0.2)")
    args = p.parse_args(argv)
    if len(args.records) < 2:
        p.error("need at least two records")
    recs = [(path, load_record(path)) for path in args.records]
    any_reg = False
    for (pa, a), (pb, b) in zip(recs, recs[1:]):
        rows = build_comparison(a, b, args.threshold)
        print(f"\n== {pa} -> {pb} ==")
        print(format_table(rows, pa.rsplit("/", 1)[-1][:12],
                           pb.rsplit("/", 1)[-1][:12]))
        any_reg |= any(r.regression for r in rows)
    return 1 if any_reg else 0


if __name__ == "__main__":
    sys.exit(main())

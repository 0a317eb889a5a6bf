"""Compare two versions of a kernel from `chip_smoke.py` logs taken in turns.

    python -m uzu_tpu_torch.tools.kernel_ab A1.log B1.log B2.log A2.log [--dh 64,128,256]

Each log is the output of one `chip_smoke.py --flash-only` / `--paged-only`
(or full) run; its `KERNEL {...}` lines are the rows. Runs named first and
last are version A (the parent), the middle ones version B (the change),
as the A, B, B, A order of one chip call takes them. A row is keyed by its
kernel and shape (every field but the measured ones); for each key present
in every log, B's device time over A's is the ratio of the medians of each
version's runs. Prints one JSON object: per kernel and head dim the count
of rows and the median, least and largest ratio, and the same over all.
"""

from __future__ import annotations

import argparse
import json
import statistics

MEASURED = ("max_abs_err", "err_over_rms", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "ptxas", "tol")


def rows(path: str) -> dict[str, dict]:
    """{row key: row} of one log's KERNEL lines."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("KERNEL "):
                row = json.loads(line[len("KERNEL "):])
                key = json.dumps({k: v for k, v in row.items() if k not in MEASURED},
                                 sort_keys=True)
                out[key] = row
    return out


def compare(logs_a: list[dict], logs_b: list[dict], head_dims=None) -> dict:
    """Per (kernel, Dh) and over all rows: n and the median, least and
    largest of B's median device time over A's."""
    keys = set.intersection(*(set(r) for r in logs_a + logs_b))
    groups: dict[str, list[float]] = {}
    for key in sorted(keys):
        row = logs_a[0][key]
        if head_dims is not None and row.get("Dh") not in head_dims:
            continue
        a = statistics.median(r[key]["device_ms"] for r in logs_a)
        b = statistics.median(r[key]["device_ms"] for r in logs_b)
        for g in (f"{row['kernel']}/Dh{row.get('Dh')}", "all"):
            groups.setdefault(g, []).append(b / a)
    return {g: dict(rows=len(v), median=statistics.median(v), min=min(v), max=max(v))
            for g, v in sorted(groups.items())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+", help="A, B, ..., B, A: first and last are A")
    ap.add_argument("--dh", default=None, help="comma-separated head dims to keep")
    args = ap.parse_args(argv)
    if len(args.logs) < 3:
        raise SystemExit("give at least A, B, A")
    parsed = [rows(p) for p in args.logs]
    dims = None if args.dh is None else {int(x) for x in args.dh.split(",")}
    print(json.dumps(compare([parsed[0], parsed[-1]], parsed[1:-1], dims), indent=1))


if __name__ == "__main__":
    main()

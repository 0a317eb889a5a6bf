"""The bound time of the slice's selective-scan calls (one per Mamba-1
layer of every prefill chunk and decode step, from `kinds/mamba1.py`'s
FLOPs and bytes over the real rows the spans recorded) over the device
time of the `ssm_scan` kernel group. None where the model has no Mamba-1
layer or the slice ran no such kernel."""

from portbench.kinds.mamba1 import scan_work
from portbench.work import bound_s


def read(ctx):
    if ctx.slice is None:
        return None
    layers = ctx.spec.count("mamba1")
    t = ctx.group_seconds("ssm_scan")
    if not layers or not t:
        return None
    total = 0.0
    for kind, _, _, info, _ in ctx.slice_spans:
        if kind == "prefill":
            total += layers * bound_s(*scan_work(ctx.spec, info[1], 1), ctx.peaks)
        elif kind == "decode" and info[1]:
            rows = len(info[1])
            total += info[0] * layers * bound_s(*scan_work(ctx.spec, rows, rows), ctx.peaks)
    return 100.0 * total / t if total else None

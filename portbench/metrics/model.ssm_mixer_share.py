"""The share of the slice's busy device time spent in kernels launched
inside the program's `model.ssm_mixer` spans (every Mamba-1 mixer call:
its projections, conv, norms and scan), by the host time of each launch.
None where the program records no such span."""

import bisect


def read(ctx):
    if ctx.slice is None or not ctx.busy_s:
        return None
    try:
        from uzu_tpu_torch.tools.profile import spans
    except ImportError:
        return None
    t0, t1 = ctx.slice["t0"], ctx.slice["t1"]
    mixer = sorted((s[1], s[2]) for s in spans(t0, t1) if s[0] == "model.ssm_mixer")
    if not mixer:
        return None
    starts = [a for a, _ in mixer]
    inside = 0.0
    for _, s, t, is_kernel, launch in ctx.slice["device"]:
        if not is_kernel or launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= mixer[i][1]:
            inside += t - s
    return 100.0 * inside / ctx.busy_s

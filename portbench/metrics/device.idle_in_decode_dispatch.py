"""The share of the slice in which nothing ran on the card while the host
was inside the program's `engine.decode_dispatch` spans: the slice's idle
gaps intersected with those spans, over the slice's seconds. The part of
`device.idle_share` that the host's decode enqueue leaves. None where the
program records no spans."""

from portbench.trace import idle_gaps


def read(ctx):
    if ctx.slice is None or not ctx.window_s:
        return None
    try:
        from uzu_tpu_torch.tools.profile import spans
    except ImportError:
        return None
    t0, t1 = ctx.slice["t0"], ctx.slice["t1"]
    dispatch = sorted((s[1], s[2]) for s in spans(t0, t1) if s[0] == "engine.decode_dispatch")
    if not dispatch:
        return None
    gaps = idle_gaps(ctx.busy, t0, t1)
    # both lists are sorted and disjoint within themselves: one merge pass
    idle, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(dispatch):
        (a, b), (c, d) = gaps[i], dispatch[j]
        idle += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return 100.0 * idle / ctx.window_s

"""Host time inside the program's `engine.decode_dispatch` spans of the
slice (the engine's own enqueue of each decode chunk: page reservation,
tables, the K steps' launches) over the steps those spans dispatched.
It includes the time the host is blocked in a launch because the launch
queue is full, which a device-bound decode also shows: read it with
`device.idle_in_decode_dispatch`, and decode waits on the host only
where the card is idle for a good part of these spans. None where the
program records no spans."""


def read(ctx):
    if ctx.slice is None:
        return None
    try:
        from uzu_tpu_torch.tools.profile import spans
    except ImportError:
        return None
    rows = [s for s in spans(ctx.slice["t0"], ctx.slice["t1"])
            if s[0] == "engine.decode_dispatch"]
    steps = sum(s[6]["steps"] for s in rows)
    return 1e3 * sum(s[2] - s[1] for s in rows) / steps if steps else None

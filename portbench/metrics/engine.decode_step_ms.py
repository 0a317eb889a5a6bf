"""Stream time of the window's decode chunks over their steps: CUDA events
around each call of the engine's decode dispatch, summed, over the steps
summed. A chunk queued behind a prefill runs at the device's pace, one
dispatched to an idle card at the host's, so a chunk's own time has two
modes; the ratio of sums weighs them as the window did."""


def read(ctx):
    ms = sum(m for m, _ in ctx.decode_chunks)
    steps = sum(k for _, k in ctx.decode_chunks)
    return ms / steps if steps else None

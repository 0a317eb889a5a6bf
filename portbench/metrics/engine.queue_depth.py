"""Requests waiting in the engine's queue, time-weighted over the slice:
the `engine.queued` gauge, sampled at every change of the queue's length,
held from each sample to the next. Each `engine.step` span's `queued`
(the length at the step's start) is a sample too; the first one gives the
length from the slice's start, which the harness opens at a step
boundary. None where the program records no spans."""


def read(ctx):
    if ctx.slice is None:
        return None
    try:
        from uzu_tpu_torch.tools.profile import spans
    except ImportError:
        return None
    t0, t1 = ctx.slice["t0"], ctx.slice["t1"]
    rows = spans(t0, t1)
    samples = sorted([(s[1], s[6]["value"]) for s in rows if s[0] == "engine.queued"]
                     + [(s[1], s[6]["queued"]) for s in rows if s[0] == "engine.step"])
    if not samples or t1 <= t0:
        return None
    total = samples[0][1] * (samples[0][0] - t0)
    for (a, n), (b, _) in zip(samples, samples[1:] + [(t1, None)]):
        total += n * (b - a)
    return total / (t1 - t0)

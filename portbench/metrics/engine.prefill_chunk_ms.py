"""Median stream time of a prefill chunk in the window: CUDA events
recorded before and after each call of the engine's prefill function."""

import statistics


def read(ctx):
    return statistics.median(ctx.prefill_ms) if ctx.prefill_ms else None

"""The share of the slice in which nothing ran on the card."""


def read(ctx):
    if ctx.slice is None or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

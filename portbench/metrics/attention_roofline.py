"""The bound time of the attention calls that the `attention` kernel group
serves (prefill chunks; decode steps where the engine's decode attention
is a hand kernel) over that group's device time."""


def read(ctx):
    if ctx.slice is None:
        return None
    t = ctx.group_seconds("attention")
    return 100.0 * ctx.work.attention_bound_s / t if t and ctx.work.attention_bound_s else None

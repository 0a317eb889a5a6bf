"""The bound time of every quantized linear of the slice (max of bytes over
the memory rate and FLOPs over the bf16 peak, per call) over the device
time of the `linear` kernel group."""


def read(ctx):
    if ctx.slice is None:
        return None
    t = ctx.group_seconds("linear")
    return 100.0 * ctx.work.linear_bound_s / t if t and ctx.work.linear_bound_s else None

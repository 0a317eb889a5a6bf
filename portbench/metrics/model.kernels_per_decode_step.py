"""Device kernels launched inside the slice's decode chunks (by the host
time of each kernel's launch call) over the decode steps of those chunks."""


def read(ctx):
    if ctx.slice is None:
        return None
    kernels, steps = ctx.decode_kernels()
    return kernels / steps if steps and kernels else None

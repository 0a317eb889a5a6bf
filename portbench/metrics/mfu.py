"""The whole step's share of the card's bf16 peak: the model FLOPs of the
slice (every linear over its real rows, the readout's rows, attention over
the live context, the conv gates) over the slice's seconds times the peak."""


def read(ctx):
    if ctx.slice is None or not ctx.work.model_flops:
        return None
    return 100.0 * ctx.work.model_flops / (ctx.window_s * ctx.peaks["bf16_flops"])

"""The whole step's share of the card's published peak: the model
operations of the traced steps (the family's count from the shapes) over
the device's span of them (first kernel's start to last kernel's end)
times the peak of the served dtype."""


def read(ctx):
    peak = ctx.peak_flops()
    span = ctx.trace.span_ns() if ctx.trace is not None else 0
    if peak is None or span <= 0:
        return None
    ops = ctx.model_flops * len(ctx.trace.steps)
    return 100.0 * ops / (span / 1e9 * peak)

"""The device's idle share of the traced steps: their span (first
kernel's start to last kernel's end) less the union of their kernels'
intervals, over the span."""


def read(ctx):
    span = ctx.trace.span_ns() if ctx.trace is not None else 0
    if span <= 0:
        return None
    return 100.0 * (span - ctx.trace.busy_ns()) / span

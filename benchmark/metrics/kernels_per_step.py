"""Device kernels (with copies and fills) launched by a step: the median
over the traced steps of each step's count, which repeats exactly while
the profiler loses no record."""

import statistics
from collections import Counter


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    per_step = Counter(k.step for k in ctx.trace.kernels)
    counts = [per_step.get(i, 0) for i in range(len(ctx.trace.steps))]
    return float(statistics.median(counts))

"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.proj`` ranges: the q, k and v projections of every
layer with their reshapes, and the o projection with its residual add.
The union of their intervals in each traced step, the mean over the
steps (:func:`benchmark.spans.ms_per_step`); None when no kernel is
filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "proj")

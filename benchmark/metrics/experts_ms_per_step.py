"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.experts`` ranges: every routed expert's gate and up
products, SiLU, their product and the down product, over the rows routed
to it.  The union of their intervals in each traced step, the mean over
the steps (:func:`benchmark.spans.ms_per_step`); None when no kernel is
filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "experts")

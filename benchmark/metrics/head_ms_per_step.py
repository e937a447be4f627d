"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.head`` ranges: the tied output projection onto the
vocabulary.  The union of their intervals in each traced step, the mean
over the steps (:func:`benchmark.spans.ms_per_step`); None when no
kernel is filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "head")

"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.norm`` ranges: each RMSNorm of the decoder (the
attention's and the MLP's of every layer, and the final one): its float
casts, the mean of squares, the reciprocal root and the weight product.
The union of their intervals in each traced step, the mean over the
steps (:func:`benchmark.spans.ms_per_step`); None when no kernel is
filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "norm")

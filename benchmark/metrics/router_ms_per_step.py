"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.router`` ranges: each expert layer's float32 router
product, softmax and top-k, the sort of its tokens into expert order, the
read of the per-expert counts, the gather of the tokens, and the weighted
combine of the experts' outputs back into token order.  The union of
their intervals in each traced step, the mean over the steps
(:func:`benchmark.spans.ms_per_step`); None when no kernel is filed under
the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "router")

"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.mlp`` ranges: the SwiGLU MLP of every layer: the
gate and up projections, the SiLU and the product, the down projection
and the residual add.  The union of their intervals in each traced step,
the mean over the steps (:func:`benchmark.spans.ms_per_step`); None when
no kernel is filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "mlp")

"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.attention`` ranges: the attention of every layer:
``repeat_kv`` of the keys and values, the scores product, the scale, the
causal ``where`` with its mask, the float casts around the softmax, the
softmax and the PV product.  The union of their intervals in each traced
step, the mean over the steps (:func:`benchmark.spans.ms_per_step`);
None when no kernel is filed under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "attention")

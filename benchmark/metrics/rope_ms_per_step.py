"""Device milliseconds a step of the kernels launched inside the program's
``tpusim_torch.llama.rope`` ranges: the rotary embedding of every layer:
its cos and sin tables, rebuilt in each layer, and the rotation of the
queries and the keys with their float casts.  The union of their
intervals in each traced step, the mean over the steps
(:func:`benchmark.spans.ms_per_step`); None when no kernel is filed
under the range."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx.trace, "rope")

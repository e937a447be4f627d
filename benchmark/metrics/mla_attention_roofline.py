"""The latent attention's share of its roofline: the least time the card
could take for the step's causal attention over its traced device time.

The kernels are those launched by the op ``tpusim_torch::causal_attention``
(the port's causal kernel at head dims 192 / 128, one launch a layer).
Their operations are the step's model operations less those of its weight
products (``ctx.model_flops`` less the operations of ``ctx.gemms``), which
is the family's attention count, ``b * h * s * (s + 1) * (d_qk + d_v)`` a
layer, since the harness's context holds no shapes.  The bound is those
operations over the peak rate of the served dtype: at a 16k-token step the
kernel does about 4,100 operations a byte it must move, against the
card's 295 in bf16, so its bytes never bind."""

from benchmark import roofline

OP = "tpusim_torch::causal_attention"


def read(ctx):
    peak = ctx.peak_flops()
    if ctx.trace is None or peak is None:
        return None
    ns = sum(k.end - k.start for k in ctx.trace.kernels if k.op == OP)
    if ns <= 0:
        return None
    ops = ctx.model_flops - sum(roofline.gemm_ops(m, n, k) * c
                                for m, n, k, c in ctx.gemms)
    return 100.0 * ops / peak * len(ctx.trace.steps) / (ns / 1e9)

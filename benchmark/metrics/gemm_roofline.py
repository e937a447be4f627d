"""The weight products' share of their roofline: the least time the card
could take for the step's q, k, v, o, gate, up, down and output
projections (the larger of operations over the peak rate and bytes over
the peak bandwidth, call by call) over the device time of the kernels
launched by the ATen ops of ``kernel_ops/gemm/``, each counted once."""

from benchmark import roofline


def read(ctx):
    peak, bw = ctx.peak_flops(), ctx.peak_bytes_s()
    if ctx.trace is None or peak is None or bw is None:
        return None
    ops = ctx.op_class("gemm")
    ns = sum(k.end - k.start for k in ctx.trace.kernels if k.op in ops)
    if ns <= 0:
        return None
    bound, _, _ = roofline.gemm_bound_s(ctx.gemms, ctx.element_size, peak,
                                        bw)
    return 100.0 * bound * len(ctx.trace.steps) / (ns / 1e9)

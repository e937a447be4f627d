"""Pipeline parallelism — port of ``pipeline_pp4`` from
``tpusim/models/pipeline.py``: GPipe-style microbatches streaming over a
``collective-permute`` chain.

Each device holds one stage's weights.  The schedule runs ``M + pp - 1``
ticks through the ``scan`` higher-order op (one ``while`` in the trace,
as ``lax.scan`` gives): at each tick stage 0 injects microbatch ``t``
(read with :func:`dynamic_index`, a ``dynamic-slice`` as XLA writes
``x_mb[min(t, m - 1)]``), every stage applies its layers, the last stage
writes the microbatch that emerges into its output slab with
:func:`~tpusim_torch.models.decode.dynamic_update_slice`, and the
activations move one stage on with a ``collective-permute``.  The stage
is the ``partition-id`` read through :func:`~tpusim_torch.spmd.axis_index`;
``psum(1)`` is the constant ``pp``.

Outside the ``shard_map``, the reference slices the last stage's slab out
of the stacked ``[pp * M, mb, d]`` output.  GSPMD writes that slice,
whose result is sharded over ``pp`` again, as ``pp - 1`` collective
permutes, each sending one block of the last stage's slab to the device
that holds it, and a ``partition-id`` select; the port writes the same.
"""

from __future__ import annotations

import torch

from tpusim_torch.models.decode import dynamic_update_slice
from tpusim_torch.models.registry import (
    register,
    resolve_device,
    torch_dtype,
)
from tpusim_torch.spmd import Mesh, P, SpmdModule, axis_index, ppermute

__all__ = ["PipelineStages", "dynamic_index", "reference_forward",
           "stage_fn"]


@torch.library.custom_op("tpusim_torch::dynamic_index", mutates_args=())
def _dynamic_index(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    i = index.clamp(0, x.shape[0] - 1).to(torch.int64)
    return x.index_select(0, i.reshape(1))[0].clone()


@_dynamic_index.register_fake
def _(x, index):
    return x.new_empty(x.shape[1:])


def _dynamic_index_vmap(info, in_dims, x, index):
    n = info.batch_size
    xr = x.movedim(in_dims[0], 0) if in_dims[0] is not None else \
        x.expand(n, *x.shape)
    ir = index.movedim(in_dims[1], 0) if in_dims[1] is not None else \
        index.expand(n)
    i = ir.reshape(n).clamp(0, xr.shape[1] - 1).to(torch.int64)
    return xr[torch.arange(n, device=xr.device), i], 0


torch.library.register_vmap(_dynamic_index, _dynamic_index_vmap)


def dynamic_index(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0 at a 0-d int32 tensor ``index`` (clamped
    into range, XLA's semantics) — one ``dynamic-slice`` in the trace."""
    return torch.ops.tpusim_torch.dynamic_index(x, index)


def stage_fn(w1, b1, w2, b2, h):
    """One stage: ``tanh(relu(h @ w1 + b1) @ w2 + b2)``."""
    h = torch.relu(h @ w1 + b1)
    return torch.tanh(h @ w2 + b2)


class PipelineStages(SpmdModule):
    """``(w1, b1, w2, b2, x_mb) -> out``: per-stage weights stacked on a
    leading ``pp`` dim and sharded over it, the microbatch stream ``[M,
    mb, d]`` replicated; the output ``[M, mb, d]`` (the last stage's) is
    sharded over ``pp`` by microbatch."""

    def __init__(self, pp: int):
        super().__init__()
        self.pp = pp
        self.mesh = Mesh((pp,), ("pp",))
        self.in_specs = (P("pp"),) * 4 + (P(None),)
        self.out_specs = P("pp")

    def forward(self, w1, b1, w2, b2, x_mb):
        from torch._higher_order_ops.scan import scan

        mesh, pp = self.mesh, self.pp
        m, mb, d = x_mb.shape
        stage = axis_index(w1, mesh, "pp")
        first, last = stage == 0, stage == pp - 1
        params = (w1[0], b1[0], w2[0], b2[0])
        perm = [(i, (i + 1) % pp) for i in range(pp)]

        def tick(carry, t):
            incoming, outputs = carry
            # stage 0 injects microbatch t; the others take the activation
            # the previous stage handed over
            inject = torch.where(
                t < m, dynamic_index(x_mb, t.clamp(max=m - 1)), 0.0)
            h_out = stage_fn(*params, torch.where(first, inject, incoming))
            # the last stage records microbatch t - pp + 1 as it emerges
            out_idx = t - (pp - 1)
            written = dynamic_update_slice(
                outputs, h_out[None], out_idx.clamp(min=0), 0)
            outputs = torch.where(last & (out_idx >= 0), written, outputs)
            return (ppermute(h_out, mesh, "pp", perm), outputs), t.clone()

        ticks = torch.arange(m + pp - 1, dtype=torch.int32,
                             device=x_mb.device)
        # zeros of each rank's own (a value the ranks share would not
        # vary over them)
        zero = (w1[0, :1, :1] * 0).reshape(())
        init = (zero.expand(mb, d).to(x_mb.dtype) + 0,
                zero.expand(m, mb, d).to(x_mb.dtype) + 0)
        (_, outputs), _ = scan(tick, init, ticks)
        # the slice of the last stage's slab, re-sharded over pp: block j
        # of it goes to device j
        blk = m // pp
        blocks = outputs.reshape(pp, blk, mb, d)
        out = blocks[pp - 1]
        for j in range(pp - 1):
            moved = ppermute(blocks[j], mesh, "pp", [(pp - 1, j)])
            out = torch.where(stage == j, moved, out)
        return out


def reference_forward(w1, b1, w2, b2, x_mb) -> torch.Tensor:
    """The same network run sequentially (no pipeline): every stage in
    order on every microbatch — the plain version of
    :class:`PipelineStages`."""
    h = x_mb
    for s in range(w1.shape[0]):
        h = stage_fn(w1[s], b1[s], w2[s], b2[s], h)
    return h


def _build_pipeline(microbatches: int, microbatch: int, d_model: int,
                    pp: int, dtype: str, device=None):
    if microbatches % pp:
        raise ValueError(f"{microbatches} microbatches do not split over "
                         f"{pp} stages")
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dt) * scale

    x = randn((microbatches, microbatch, d_model), 1.0)
    params = (
        randn((pp, d_model, 4 * d_model), d_model ** -0.5),
        torch.zeros((pp, 4 * d_model), dtype=dt, device=dev),
        randn((pp, 4 * d_model, d_model), (4 * d_model) ** -0.5),
        torch.zeros((pp, d_model), dtype=dt, device=dev),
    )
    return PipelineStages(pp), (*params, x)


@register(
    "pipeline_pp4",
    description="GPipe-style 4-stage pipeline: microbatches stream through "
    "a ppermute chain inside a scan (PP capability slot)",
    suite="models",
    num_devices=4,
    microbatches=8, microbatch=64, d_model=512, pp=4, dtype="float32",
)
def build_pipeline_pp4(device=None, **kw):
    return _build_pipeline(device=device, **kw)

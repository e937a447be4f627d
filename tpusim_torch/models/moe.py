"""Mixture-of-Experts layer with expert parallelism — port of ``moe_ep4``
and ``moe_ep8_train`` from ``tpusim/models/moe.py``.

Two all-to-alls bracket the expert FFN matmuls: the first sends each
expert's tokens to the device that holds the expert, the second brings
the results back.  Routing is the reference's deterministic round robin
(token ``t`` to expert ``t // cap``) with a learned gate weighting; the
gate is a float32 product ``x.float() @ wg.float()``, a genuine f32 dot
in the trace.

The train step (:class:`MoeTrainStep`) learns the gate and the experts
on ``((out - roll(x, 1, -1)) ** 2).mean()`` with SGD at lr 0.05.  Its
backward holds one more all-to-all, the transpose of the combine (the
dispatch's transpose feeds only ``x``, which takes no gradient), and one
all-reduce over ``ep``: the loss and the replicated gate's gradient in
one tuple, as the JAX capture's combiner makes them.
"""

from __future__ import annotations

import torch

from tpusim_torch.models.registry import register, resolve_device, torch_dtype
from tpusim_torch.spmd import (Mesh, P, SpmdModule, all_to_all, psum_coalesced,
                                run_ranks)

__all__ = ["moe_ffn", "MoeEP", "MoeTrainStep", "round_robin_moe"]


def moe_ffn(x, wg, w1, w2, mesh: Mesh | None, axis: str = "ep"):
    """One device's expert-parallel MoE FFN (``mesh`` None: all experts on
    one device, the unsharded layer).

    x: [n_loc, D] local tokens; wg: [D, E] gate; w1: [E_loc, D, H],
    w2: [E_loc, H, D] this device's expert slices (E = ep * E_loc)."""
    ep = mesh.size if mesh is not None else 1
    e_loc = w1.shape[0]
    n_experts = ep * e_loc
    n_loc, d = x.shape
    cap = n_loc // n_experts
    if cap <= 0:
        raise ValueError("need at least one token per expert")
    used = cap * n_experts

    gates = torch.softmax(x.float() @ wg.float(), dim=-1)    # [n_loc, E]
    xr = x[:used].reshape(n_experts, cap, d)
    # dispatch: the expert dim scattered over the devices, their token
    # slices gathered -> [e_loc, ep * cap, d]
    xs = all_to_all(xr, mesh, axis, 0, 1) if ep > 1 else xr
    h = torch.relu(torch.einsum("ecd,edh->ech", xs, w1))
    ys = torch.einsum("ech,ehd->ecd", h, w2)
    # combine: back to [E, cap, d] of this device's tokens
    yr = all_to_all(ys, mesh, axis, 1, 0) if ep > 1 else ys
    # each token weighted by its own expert's gate, times E
    gsel = gates[:used].reshape(n_experts, cap, n_experts)
    idx = torch.arange(n_experts, dtype=torch.int32, device=x.device)
    own = idx[:, None, None] == idx[None, None, :]
    w = torch.where(own, gsel, 0.0).sum(dim=-1) * n_experts   # [E, cap]
    out = (yr * w[..., None].to(yr.dtype)).reshape(used, d)
    if used < n_loc:
        out = torch.cat([out, x[used:]], dim=0)
    return out


class MoeEP(SpmdModule):
    """``(x, wg, w1, w2) -> out``: tokens and experts sharded over ``ep``,
    the gate replicated."""

    def __init__(self, ep: int):
        super().__init__()
        self.mesh = Mesh((ep,), ("ep",))
        self.in_specs = (P("ep"), P(None), P("ep"), P("ep"))
        self.out_specs = P("ep")

    def forward(self, x, wg, w1, w2):
        return moe_ffn(x, wg, w1, w2, self.mesh)


class MoeTrainStep(SpmdModule):
    """The reference's MoE ``train_step``: ``(wg, w1, w2, x, y) -> (loss,
    wg', w1', w2')``, one SGD step (lr 0.05) on the mean squared error of
    the layer's output against ``y``.  ``ep`` 1 is the unsharded step
    over the whole batch (:func:`round_robin_moe`'s layer per token
    shard of ``shards`` tokens)."""

    #: capture traces the step with ``make_fx``
    train_step = True

    def __init__(self, ep: int, tokens: int, lr: float = 0.05,
                 shards: int | None = None):
        super().__init__()
        self.ep, self.tokens, self.lr = ep, tokens, lr
        self.shards = shards or ep
        self.mesh = Mesh((ep,), ("ep",))
        data = P("ep")
        self.in_specs = (P(None), P("ep"), P("ep"), data, data)
        self.out_specs = (P(), P(None), P("ep"), P("ep"))

    def loss_and_grads(self, wg, w1, w2, x, y) -> tuple[torch.Tensor, ...]:
        """One rank's ``(loss, g_wg, g_w1, g_w2)``: the loss over the
        global batch, and the gate's gradient summed over ``ep`` (in one
        all-reduce with the loss)."""
        count = self.tokens * x.shape[-1]
        mesh = self.mesh if self.ep > 1 else None

        def loss_fn(ps):
            if mesh is None:
                out = torch.cat([moe_ffn(xs, *ps, None) for xs in
                                 x.chunk(self.shards, dim=0)], dim=0)
            else:
                out = moe_ffn(x, *ps, mesh)
            return ((out - y).float() ** 2).sum() / count

        grads, loss = torch.func.grad_and_value(loss_fn)((wg, w1, w2))
        g_wg, g_w1, g_w2 = grads
        if mesh is not None:
            loss, g_wg = psum_coalesced([loss, g_wg], self.mesh, "ep")
        return loss, g_wg, g_w1, g_w2

    def forward(self, wg, w1, w2, x, y) -> tuple[torch.Tensor, ...]:
        loss, *grads = self.loss_and_grads(wg, w1, w2, x, y)
        new = [p - self.lr * g.to(p.dtype)
               for p, g in zip((wg, w1, w2), grads)]
        return (loss, *new)

    def grads(self, *global_args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(loss, *grads)`` of the whole step over global arrays."""
        return run_ranks(self.loss_and_grads, self.mesh, *global_args,
                         in_specs=self.in_specs, out_specs=self.out_specs)


def round_robin_moe(x, wg, w1, w2, ep: int) -> torch.Tensor:
    """The unsharded computation of :class:`MoeEP` on the whole batch:
    each of the ``ep`` token shards through the round-robin layer with
    every expert on one device."""
    return torch.cat([moe_ffn(xs, wg, w1, w2, None)
                      for xs in x.chunk(ep, dim=0)], dim=0)


def _build_moe(tokens: int, d_model: int, d_hidden: int, n_experts: int,
               ep: int, dtype: str, train: bool, device=None):
    if n_experts % ep:
        raise ValueError("experts must divide evenly across devices")
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    x = randn(tokens, d_model)
    wg = randn(d_model, n_experts, dtype=torch.float32) * 0.02
    w1 = randn(n_experts, d_model, d_hidden) * (d_model ** -0.5)
    w2 = randn(n_experts, d_hidden, d_model) * (d_hidden ** -0.5)
    if not train:
        return MoeEP(ep), (x, wg, w1, w2)
    # the target: a fixed rotation of the input, learnable (reference)
    y = torch.roll(x, 1, dims=-1)
    return MoeTrainStep(ep, tokens), (wg, w1, w2, x, y)


@register(
    "moe_ep4",
    description="expert-parallel MoE FFN: all-to-all dispatch/combine over "
    "4 devices (EP capability slot)",
    suite="models",
    num_devices=4,
    tokens=2048, d_model=512, d_hidden=2048, n_experts=8, ep=4,
    dtype="bfloat16", train=False,
)
def build_moe_ep4(device=None, **kw):
    return _build_moe(device=device, **kw)


@register(
    "moe_ep8_train",
    description="EP-8 MoE train step (gating + experts learned; "
    "all-to-all in fwd and bwd)",
    suite="models",
    num_devices=8,
    tokens=4096, d_model=512, d_hidden=2048, n_experts=16, ep=8,
    dtype="float32", train=True,
)
def build_moe_ep8(device=None, **kw):
    return _build_moe(device=device, **kw)

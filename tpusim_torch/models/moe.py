"""Mixture-of-Experts layer with expert parallelism — port of ``moe_ep4``
from ``tpusim/models/moe.py``.

Two all-to-alls bracket the expert FFN matmuls: the first sends each
expert's tokens to the device that holds the expert, the second brings
the results back.  Routing is the reference's deterministic round robin
(token ``t`` to expert ``t // cap``) with a learned gate weighting; the
gate is a float32 product ``x.float() @ wg.float()``, a genuine f32 dot
in the trace.  ``moe_ep8_train`` (all-to-all in the backward) is not
ported yet (ROADMAP A5 a).
"""

from __future__ import annotations

import torch

from tpusim_torch.models.registry import register, resolve_device, torch_dtype
from tpusim_torch.spmd import Mesh, P, SpmdModule, all_to_all

__all__ = ["moe_ffn", "MoeEP", "round_robin_moe"]


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


def round_robin_moe(x, wg, w1, w2, ep: int) -> torch.Tensor:
    """The unsharded computation of :class:`MoeEP` on the whole batch:
    each of the ``ep`` token shards through the round-robin layer with
    every expert on one device."""
    return torch.cat([moe_ffn(xs, wg, w1, w2, None)
                      for xs in x.chunk(ep, dim=0)], dim=0)


def _build_moe(tokens: int, d_model: int, d_hidden: int, n_experts: int,
               ep: int, dtype: str, train: bool, device=None):
    if train:
        raise ValueError("the MoE train step (moe_ep8_train) is not ported")
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
    return MoeEP(ep), (x, wg, w1, w2)


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

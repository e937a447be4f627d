"""Autoregressive KV-cache decode — port of ``decode_step`` from
``tpusim/models/decode.py``.

One decoded token through every layer: stacked per-layer weights and
caches go through the ``scan`` higher-order op (one ``while`` in the
trace, as ``lax.scan`` gives), the new key and value rows are written at
the tensor position ``pos`` with :func:`dynamic_update_slice` (the
``dynamic-update-slice`` the reference's trace holds, priced in place),
and scores past ``pos`` are masked to ``-inf``.

``decode_step_tp8`` shards the heads and their caches over a ``tp`` mesh
(:mod:`tpusim_torch.spmd`): each device projects, caches and
attends over its heads, and the partial output projections meet in one
all-reduce per layer, inside the scan's body (Megatron's g).
"""

from __future__ import annotations

import torch
from torch import nn

from tpusim_torch.models.registry import (
    register,
    resolve_device,
    tensor_from_numpy,
    torch_dtype,
)
from tpusim_torch.spmd import Mesh, P, SpmdModule, psum

__all__ = ["DecodeStep", "DecodeStepTP", "build_decode_step",
           "dynamic_update_slice"]


@torch.library.custom_op("tpusim_torch::dynamic_update_slice",
                         mutates_args=())
def _dus_op(operand: torch.Tensor, update: torch.Tensor,
            index: torch.Tensor, dim: int) -> torch.Tensor:
    # XLA's semantics: the start is clamped so the update fits
    n = update.shape[dim]
    start = index.clamp(0, operand.shape[dim] - n).to(torch.int64)
    rows = start.reshape(1) + torch.arange(n, device=operand.device)
    return operand.index_copy(dim, rows, update)


@_dus_op.register_fake
def _(operand, update, index, dim):
    return torch.empty_like(operand)


def _dus_vmap(info, in_dims, operand, update, index, dim):
    """Each rank of ``run_ranks`` writes at its own (clamped) index."""
    n = info.batch_size

    def ranked(x, d):
        return x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)

    op, up = ranked(operand, in_dims[0]), ranked(update, in_dims[1])
    idx = ranked(index, in_dims[2]).reshape(n)
    d = dim % (op.dim() - 1) + 1
    rows = up.shape[d]
    start = idx.clamp(0, op.shape[d] - rows).to(torch.int64)
    pos = start[:, None] + torch.arange(rows, device=op.device)
    shape = [n] + [1] * (op.dim() - 1)
    shape[d] = rows
    return op.scatter(d, pos.view(shape).expand(up.shape), up), 0


torch.library.register_vmap(_dus_op, _dus_vmap)


def dynamic_update_slice(operand: torch.Tensor, update: torch.Tensor,
                         index: torch.Tensor, dim: int) -> torch.Tensor:
    """``operand`` with ``update`` written from position ``index`` (a 0-d
    int32 tensor) along ``dim`` and from 0 along every other dim —
    ``jax.lax.dynamic_update_slice(operand, update, (0, .., index, .., 0))``.
    Kept as one graph node so the capture lowers it to one
    ``dynamic-update-slice``."""
    return torch.ops.tpusim_torch.dynamic_update_slice(
        operand, update, index, dim)


def _decode(hidden, cache_k, cache_v, pos, wq, wk, wv, wo, *,
            seq_cache: int, heads: int, head_dim: int, reduce=None):
    """Every layer for one token: ``heads`` are the heads this device
    holds; ``reduce`` sums the partial output projections across devices
    (None on one device)."""
    from torch._higher_order_ops.scan import scan

    batch = hidden.shape[0]
    d_loc = heads * head_dim

    def layer(h, xs):
        lwq, lwk, lwv, lwo, kc, vc = xs
        q = (h @ lwq).reshape(batch, heads, head_dim)
        k = (h @ lwk).reshape(batch, heads, head_dim)
        v = (h @ lwv).reshape(batch, heads, head_dim)
        # cache append at the current position
        kc = dynamic_update_slice(kc, k[:, None].to(kc.dtype), pos, 1)
        vc = dynamic_update_slice(vc, v[:, None].to(vc.dtype), pos, 1)
        scores = torch.einsum(
            "bhd,bshd->bhs", q, kc
        ).float() * (head_dim ** -0.5)
        valid = torch.arange(seq_cache, dtype=torch.int32,
                             device=h.device) <= pos
        scores = torch.where(valid[None, None, :], scores, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        attn = torch.einsum("bhs,bshd->bhd", probs, vc)
        out = attn.reshape(batch, d_loc) @ lwo
        h = h + (out if reduce is None else reduce(out))
        return h, (kc, vc)

    hidden, (cache_k, cache_v) = scan(
        layer, hidden, (wq, wk, wv, wo, cache_k, cache_v)
    )
    return hidden, cache_k, cache_v, pos + 1


class DecodeStep(nn.Module):
    """``(hidden, cache_k, cache_v, pos, wq, wk, wv, wo) -> (hidden',
    cache_k', cache_v', pos + 1)``, the reference's signature."""

    def __init__(self, batch: int, seq_cache: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.batch, self.seq_cache = batch, seq_cache
        self.heads, self.head_dim = heads, head_dim

    def forward(self, hidden, cache_k, cache_v, pos, wq, wk, wv, wo):
        return _decode(hidden, cache_k, cache_v, pos, wq, wk, wv, wo,
                       seq_cache=self.seq_cache, heads=self.heads,
                       head_dim=self.head_dim)

    @staticmethod
    def from_numpy(hidden, cache_k, cache_v, pos, wq, wk, wv, wo, *,
                   device=None) -> tuple[torch.Tensor, ...]:
        dev = resolve_device(device)
        return tuple(
            tensor_from_numpy(a, dev)
            for a in (hidden, cache_k, cache_v, pos, wq, wk, wv, wo)
        )


class DecodeStepTP(SpmdModule):
    """The reference's ``decode_step_tp8`` program: the same signature as
    :class:`DecodeStep`, with the heads (the Q/K/V projections' columns,
    the caches' head dim, the output projection's rows) sharded over
    ``tp``."""

    def __init__(self, seq_cache: int, heads: int, head_dim: int, tp: int):
        super().__init__()
        if heads % tp:
            raise ValueError(f"heads={heads} must divide by tp={tp}")
        self.seq_cache, self.heads, self.head_dim = seq_cache, heads, head_dim
        self.mesh = Mesh((tp,), ("tp",))
        cache, proj = P(None, None, None, "tp"), P(None, None, "tp")
        self.in_specs = (P(), cache, cache, P(), proj, proj, proj,
                         P(None, "tp"))
        self.out_specs = (P(), cache, cache, P())

    def forward(self, hidden, cache_k, cache_v, pos, wq, wk, wv, wo):
        return _decode(hidden, cache_k, cache_v, pos, wq, wk, wv, wo,
                       seq_cache=self.seq_cache,
                       heads=self.heads // self.mesh.size,
                       head_dim=self.head_dim,
                       reduce=lambda x: psum(x, self.mesh, "tp"))


@register(
    "decode_step",
    description="autoregressive KV-cache decode step (batch-small "
    "matmuls + HBM-bound cache attention + in-place DUS appends — the "
    "inference serving slot)",
    suite="ubench",
    batch=8, seq_cache=2048, heads=16, head_dim=128, layers=4,
    dtype="bfloat16", pos=1024,
)
def build_decode_step(batch: int, seq_cache: int, heads: int, head_dim: int,
                      layers: int, dtype: str, pos: int, device=None):
    return DecodeStep(batch, seq_cache, heads, head_dim), _decode_args(
        batch, seq_cache, heads, head_dim, layers, dtype, pos, device)


def _decode_args(batch: int, seq_cache: int, heads: int, head_dim: int,
                 layers: int, dtype: str, pos: int, device):
    if not 0 <= pos < seq_cache:
        # a clamped write plus an all-true mask would silently return
        # wrong attention at the cache-full boundary
        raise ValueError(
            f"pos={pos} must be in [0, seq_cache={seq_cache}) — the cache "
            f"append writes at pos and the mask validates [0, pos]"
        )
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_model = heads * head_dim
    scale = d_model ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    wq, wk, wv, wo = (randn(layers, d_model, d_model) * scale
                      for _ in range(4))
    cache_k = randn(layers, batch, seq_cache, heads, head_dim)
    cache_v = randn(layers, batch, seq_cache, heads, head_dim)
    hidden = randn(batch, d_model)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    return hidden, cache_k, cache_v, pos_t, wq, wk, wv, wo


@register(
    "decode_step_tp8",
    description="tensor-parallel KV-cache decode over 8 chips (heads + "
    "cache sharded, one psum per layer — multi-chip serving latency)",
    suite="models",
    num_devices=8,
    batch=8, seq_cache=4096, heads=16, head_dim=128, layers=4,
    dtype="bfloat16", pos=2048, tp=8,
)
def build_decode_step_tp(batch: int, seq_cache: int, heads: int,
                         head_dim: int, layers: int, dtype: str, pos: int,
                         tp: int, device=None):
    module = DecodeStepTP(seq_cache, heads, head_dim, tp)
    return module, _decode_args(batch, seq_cache, heads, head_dim, layers,
                                dtype, pos, device)

"""Attention — port of ``tpusim/models/attention.py``: the single-chip
``attention_1chip`` and the sequence-parallel ``ring_attention_sp8`` and
``ulysses_attention_sp8``.

softmax(Q Kᵀ / √D) V over ``[B, S, H, D]`` tensors, the scores taken to
float32 before the softmax and the probabilities back to the input dtype
before the second product, as in the reference.

The sequence-parallel workloads shard Q, K and V over the sequence on an
``sp`` mesh (:mod:`tpusim_torch.spmd`):

* Ulysses: an all-to-all turns the sequence shards into head shards,
  each device runs full-sequence attention over its heads, and a second
  all-to-all turns the heads back into sequence shards;
* ring: the K/V blocks travel around the ring (two ``ppermute`` ops per
  step) while a flash-style running softmax accumulates, over ``sp``
  steps of the ``scan`` op, one ``while`` with a known trip count in the
  trace, as the reference's ``fori_loop`` gives.
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
from tpusim_torch.spmd import Mesh, P, SpmdModule, all_to_all, ppermute

__all__ = ["attention", "Attention1Chip", "build_attention_1chip",
           "UlyssesAttention", "RingAttention"]


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(Q Kᵀ / √D) V over ``[B, S, H, D]``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


class Attention1Chip(nn.Module):
    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return attention(q, k, v)

    @staticmethod
    def from_numpy(q, k, v, *, device=None) -> tuple[torch.Tensor, ...]:
        dev = resolve_device(device)
        return tuple(tensor_from_numpy(a, dev) for a in (q, k, v))


@register(
    "attention_1chip",
    description="single-chip multi-head self-attention (softmax(QK^T)V — "
    "the MXU+VPU mixed workload for silicon correlation)",
    suite="ubench",
    batch=4, seq=1024, heads=8, head_dim=128, dtype="bfloat16",
)
def build_attention_1chip(batch: int, seq: int, heads: int, head_dim: int,
                          dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v = (
        torch.randn(shape, generator=gen, device=dev, dtype=dt)
        for _ in range(3)
    )
    return Attention1Chip(), (q, k, v)


class _SequenceParallel(SpmdModule):
    """``(q, k, v) -> out``, each ``[B, S, H, D]`` sharded over the
    sequence on a 1-D ``sp`` mesh."""

    def __init__(self, sp: int):
        super().__init__()
        self.mesh = Mesh((sp,), ("sp",))
        self.in_specs = (P(None, "sp"),) * 3
        self.out_specs = P(None, "sp")


class UlyssesAttention(_SequenceParallel):
    """The reference's ``ulysses_attention``: all-to-all seq→head
    reshard, local attention, and back; H must divide by ``sp``."""

    def forward(self, q, k, v):
        def seq_to_heads(x):
            # [B, S/n, H, D] -> [B, S, H/n, D]
            return all_to_all(x, self.mesh, "sp", 2, 1)

        out = attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
        return all_to_all(out, self.mesh, "sp", 1, 2)


class RingAttention(_SequenceParallel):
    """The reference's ``ring_attention``: non-causal, each step one
    blockwise-softmax accumulation, then the K/V blocks move one step
    round the ring."""

    def forward(self, q, k, v):
        from tpusim_torch.models.loop import scan

        n = self.mesh.size
        scale = 1.0 / (q.shape[-1] ** 0.5)
        perm = [(j, (j + 1) % n) for j in range(n)]
        # running max, normaliser and output, [B, H, S_local(, D)] f32
        # (taken from q so each rank holds its own)
        ref = q.permute(0, 2, 1, 3).float()
        m = torch.full_like(ref[..., 0], float("-inf"))
        l = torch.zeros_like(ref[..., 0])
        acc = torch.zeros_like(ref)

        def body(carry, step):
            k_blk, v_blk, m, l, acc = carry
            s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m - m_new)
            l_new = l * correction + p.sum(dim=-1)
            acc = acc * correction[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v_blk.float())
            k_nxt = ppermute(k_blk, self.mesh, "sp", perm)
            v_nxt = ppermute(v_blk, self.mesh, "sp", perm)
            return (k_nxt, v_nxt, m_new, l_new, acc), step.clone()

        steps = torch.arange(n, dtype=torch.int32, device=q.device)
        (_, _, m, l, acc), _ = scan(body, (k, v, m, l, acc), steps)
        out = acc / l[..., None]
        return out.permute(0, 2, 1, 3).to(q.dtype)


def _build_sp(cls, batch: int, seq: int, heads: int, head_dim: int,
              sp: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
               for _ in range(3))
    return cls(sp), (q, k, v)


_SP_KINDS = {"ring": RingAttention, "ulysses": UlyssesAttention}


@register(
    "ring_attention_sp8",
    description="ring attention over an 8-way sequence-parallel ring "
    "(ppermute chain — long-context capability)",
    suite="models",
    num_devices=8,
    kind="ring", batch=1, seq=8 * 2048, heads=16, head_dim=128, sp=8,
    dtype="bfloat16",
)
def build_ring_attention(kind: str, device=None, **kw):
    return _build_sp(_SP_KINDS[kind], device=device, **kw)


@register(
    "ulysses_attention_sp8",
    description="Ulysses all-to-all head-parallel attention over 8 chips",
    suite="models",
    num_devices=8,
    kind="ulysses", batch=1, seq=8 * 2048, heads=16, head_dim=128, sp=8,
    dtype="bfloat16",
)
def build_ulysses_attention(kind: str, device=None, **kw):
    return _build_sp(_SP_KINDS[kind], device=device, **kw)

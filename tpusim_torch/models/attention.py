"""Single-chip attention — port of ``attention_1chip`` from
``tpusim/models/attention.py``.

softmax(Q Kᵀ / √D) V over ``[B, S, H, D]`` tensors, the scores taken to
float32 before the softmax and the probabilities back to the input dtype
before the second product, as in the reference.  The ring and Ulysses
workloads of that module run over a mesh of chips and wait for the
multi-device part of the capture (ROADMAP A5).
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

__all__ = ["Attention1Chip", "build_attention_1chip"]


class Attention1Chip(nn.Module):
    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        scale = 1.0 / (q.shape[-1] ** 0.5)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)

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

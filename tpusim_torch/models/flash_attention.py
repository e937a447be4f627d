"""Flash attention — the workload that carries the port's one kernel.

Counterpart of ``tpusim/models/pallas_attention.py``: the same function
(softmax(Q Kᵀ / √D) V over ``[BH, S, D]``, f32 accumulation), the same
signature and layout, and the same registered workload
``flash_attention_pallas`` (batch 4, seq 1024, heads 8, head_dim 128,
float32), so both CLIs take the same name.  The TPU kernel becomes the
hand-written CUDA kernel in ``tpusim_torch/csrc/flash_attention.cu``.

The call is the custom op ``tpusim_torch::flash_attention`` so that
``torch.export`` keeps it as one node, the way ``pallas_call`` stays one
Mosaic custom-call in a TPU capture; its fake implementation returns
``empty_like(q)`` and never runs the kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpusim_torch.kernels.flash_attention import (
    check_inputs,
    flash_attention_fwd,
    flash_attention_reference,
)
from tpusim_torch.models.registry import (
    register,
    resolve_device,
    tensor_from_numpy,
    torch_dtype,
)

__all__ = ["flash_attention", "flash_attention_reference", "FlashAttention",
           "build_flash_attention", "from_numpy", "resolve_device"]


@torch.library.custom_op("tpusim_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int) -> torch.Tensor:
    return flash_attention_fwd(q, k, v, block_q)


@_flash_attention_op.register_fake
def _(q, k, v, block_q):
    check_inputs(q, k, v, block_q)
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128) -> torch.Tensor:
    """Blockwise attention.  q, k, v: ``[BH, S, D]``, float32 or bfloat16.

    Raises ``ValueError`` when S is not a multiple of ``min(block_q, S)``
    (the TPU kernel would leave the tail rows unwritten)."""
    return torch.ops.tpusim_torch.flash_attention(q, k, v, block_q)


class FlashAttention(nn.Module):
    """The workload's forward, as a module ``torch.export`` can take."""

    def __init__(self, block_q: int = 128):
        super().__init__()
        self.block_q = block_q

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return flash_attention(q, k, v, block_q=self.block_q)


def from_numpy(q: np.ndarray, k: np.ndarray, v: np.ndarray, *,
               device: str | torch.device | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port's tensors for inputs a caller made with numpy (the JAX
    side takes the same arrays through ``jnp.asarray``)."""
    dev = resolve_device(device)
    return tuple(tensor_from_numpy(a, dev) for a in (q, k, v))


@register(
    "flash_attention_pallas",
    description="blockwise flash attention as a hand-written CUDA kernel "
    "(custom op tpusim_torch::flash_attention; plain torch on the CPU)",
    suite="ubench",
    batch=4, seq=1024, heads=8, head_dim=128, dtype="float32",
)
def build_flash_attention(batch: int, seq: int, heads: int, head_dim: int,
                          dtype: str, device: str | torch.device | None = None,
                          ) -> tuple[nn.Module, tuple[torch.Tensor, ...]]:
    """(module, (q, k, v)) on ``device`` (default cuda), inputs drawn from
    a ``torch.Generator`` seeded 0.  The numbers differ from the JAX
    builder's ``PRNGKey(0)``; pricing depends only on shapes."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch * heads, seq, head_dim)
    q, k, v = (
        torch.randn(shape, generator=gen, device=dev,
                    dtype=dt)
        for _ in range(3)
    )
    return FlashAttention(), (q, k, v)

"""Microbenchmark workloads — port of the single-chip entries of
``tpusim/models/microbench.py`` that have committed silicon traces
(``reports/silicon/manifest.json``).

Each workload is registered under the reference's name with the
reference's parameters, suite and description, so both CLIs take the
same ``--set`` overrides.  Each is an ``nn.Module`` whose ``forward`` is
the reference function, written so that its exported graph lowers to the
HLO the reference's capture holds (:mod:`tpusim_torch.tracer.lower`):

* ``matmul_chain`` uses ``gelu(approximate="tanh")`` — ``jax.nn.gelu``'s
  default;
* ``conv2d`` keeps the reference's NHWC input and HWIO kernel and reaches
  ``F.conv2d`` through ``permute``, which the lowering folds into the
  convolution's ``dim_labels`` (``b01f_01io->b01f``);
* ``embedding_lookup`` takes ``int32`` ids, as the reference does;
* ``mlp_train_step`` returns ``(loss, *new_params)`` with the backward
  taken by ``torch.autograd.grad``; capture traces it with ``make_fx``
  (:attr:`MlpTrainStep.train_step`);
* ``lstm_layer`` runs its cell through the ``scan`` higher-order op,
  which lowers to one ``while``, as ``lax.scan`` does;
* ``ici_allreduce`` is one psum over every device of a 1-D mesh
  (:mod:`tpusim_torch.spmd`); the reference takes "all visible
  devices", the port a ``world`` build override (not a registered
  parameter) that defaults to the visible card count.

Builders draw from a ``torch.Generator`` seeded 0 on the asked device
(default ``cuda``); the numbers differ from the JAX builders' PRNG keys,
and pricing depends only on shapes.  Each module's ``from_numpy`` turns
the JAX builder's arguments, as numpy arrays, into the module's arguments
in its order, so the two packages can run on the same numbers.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusim_torch.models.registry import (
    register,
    resolve_device,
    tensor_from_numpy,
    torch_dtype,
)
from tpusim_torch.spmd import Mesh, P, SpmdModule, psum

__all__ = ["ElementwiseStream", "Transcendental", "Reduction", "MatmulChain",
           "Conv2d", "EmbeddingLookup", "MlpTrainStep", "LstmLayer",
           "IciAllreduce"]


def _arrays(arrays: Sequence[Any], device) -> tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    return tuple(tensor_from_numpy(a, dev) for a in arrays)


def _randn(gen: torch.Generator, shape, dt: torch.dtype,
           dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev, dtype=dt)


class ElementwiseStream(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * 1.5 + 2.0

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class Transcendental(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(torch.exp(x * 0.1))

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class Reduction(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=1)

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class MatmulChain(nn.Module):
    """``x ← gelu(x @ w)`` for each ``w``; the weights follow ``x`` as
    separate arguments (the reference's ``ws`` list, flattened)."""

    def forward(self, x: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
        for w in ws:
            x = F.gelu(x @ w, approximate="tanh")
        return x

    @staticmethod
    def from_numpy(x, ws, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x, *ws], device)


class Conv2d(nn.Module):
    """'SAME' stride-1 convolution of an NHWC input with an HWIO kernel."""

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                       padding="same")
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def from_numpy(x, w, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x, w], device)


class EmbeddingLookup(nn.Module):
    def forward(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return torch.index_select(table, 0, ids).sum(dim=0)

    @staticmethod
    def from_numpy(table, ids, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([table, ids], device)


class MlpTrainStep(nn.Module):
    """One SGD step of a ReLU MLP on a squared-error loss.

    Arguments are the reference's ``(params, x, y)`` flattened:
    ``w0, b0, w1, b1, ..., x, y``; the result is ``(loss, w0', b0', ...)``,
    the reference's ``(loss, new_params)`` flattened the same way."""

    #: capture traces the step with ``make_fx`` (``torch.export`` does not
    #: take ``torch.autograd.grad``)
    train_step = True

    def __init__(self, lr: float):
        super().__init__()
        self.lr = lr

    @staticmethod
    def loss_fn(params: Sequence[torch.Tensor], x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(0, len(params) - 2, 2):
            h = torch.relu(h @ params[i] + params[i + 1])
        logits = h @ params[-2] + params[-1]
        return torch.mean((logits - y) ** 2)

    def forward(self, *flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
        params, x, y = flat[:-2], flat[-2], flat[-1]
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in params]
            loss = self.loss_fn(leaves, x, y)
            grads = torch.autograd.grad(loss, leaves)
        new_params = [p - self.lr * g for p, g in zip(params, grads)]
        return (loss.detach(), *new_params)

    @staticmethod
    def from_numpy(params, x, y, *, device=None) -> tuple[torch.Tensor, ...]:
        flat = [a for pair in params for a in pair]
        return _arrays([*flat, x, y], device)


class LstmLayer(nn.Module):
    """An LSTM layer over ``xs`` [seq, batch, hidden]; returns every step's
    hidden state, [seq, batch, hidden]."""

    def forward(self, xs: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
        from torch._higher_order_ops.scan import scan

        def cell(carry, x):
            h, c = carry
            z = x @ w + h @ u + b
            i, f, g, o = torch.split(z, z.shape[-1] // 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            # the scan op refuses an output that aliases the carry
            return (h, c), h.clone()

        h0 = torch.zeros(xs.shape[1], w.shape[0], dtype=xs.dtype,
                         device=xs.device)
        c0 = torch.zeros_like(h0)
        _, hs = scan(cell, (h0, c0), xs)
        return hs

    @staticmethod
    def from_numpy(xs, w, u, b, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([xs, w, u, b], device)


class IciAllreduce(SpmdModule):
    """``x`` sharded over a 1-D mesh ``d``: every shard becomes the mean
    of all shards (``psum(x) / n``)."""

    def __init__(self, world: int):
        super().__init__()
        self.mesh = Mesh((world,), ("d",))
        self.in_specs = (P("d"),)
        self.out_specs = P("d")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.mesh, "d") * (1.0 / self.world)


# ---------------------------------------------------------------------------
# Registration (names, parameters and descriptions are the reference's)
# ---------------------------------------------------------------------------


@register(
    "matmul_chain",
    description="chain of matmuls with elementwise epilogues (fusion cost)",
    suite="ubench",
    m=2048, k=2048, depth=4, dtype="bfloat16",
)
def build_matmul_chain(m: int, k: int, depth: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (m, k), dt, dev)
    ws = [_randn(gen, (k, k), dt, dev) for _ in range(depth)]
    return MatmulChain(), (x, *ws)


@register(
    "conv2d",
    description="ResNet-ish 3x3 convolution (MXU via implicit matmul)",
    suite="ubench",
    batch=32, hw=56, cin=128, cout=128, ksize=3, dtype="bfloat16",
)
def build_conv2d(batch: int, hw: int, cin: int, cout: int, ksize: int,
                 dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (batch, hw, hw, cin), dt, dev)
    w = _randn(gen, (ksize, ksize, cin, cout), dt, dev)
    return Conv2d(), (x, w)


@register(
    "elementwise_stream",
    description="HBM-bound elementwise op over a large buffer",
    suite="ubench",
    elems=64 * 1024 * 1024, dtype="float32",
)
def build_elementwise(elems: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    return ElementwiseStream(), (_randn(gen, (elems,), dt, dev),)


@register(
    "transcendental",
    description="VPU transcendental throughput (exp/tanh mix)",
    suite="ubench",
    elems=8 * 1024 * 1024, dtype="float32",
)
def build_transcendental(elems: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    return Transcendental(), (_randn(gen, (elems,), dt, dev),)


@register(
    "reduction",
    description="large reduction (VPU + HBM)",
    suite="ubench",
    rows=8192, cols=8192, dtype="float32",
)
def build_reduction(rows: int, cols: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    return Reduction(), (_randn(gen, (rows, cols), dt, dev),)


@register(
    "mlp_train_step",
    description="small MLP forward+backward+SGD (single chip end-to-end)",
    suite="ubench",
    batch=512, width=2048, depth=3, dtype="bfloat16", lr=1e-2,
)
def build_mlp_train(batch: int, width: int, depth: int, dtype: str,
                    lr: float, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params: list[torch.Tensor] = []
    for _ in range(depth):
        params.append(_randn(gen, (width, width), dt, dev) * (1.0 / width ** 0.5))
        params.append(torch.zeros(width, dtype=dt, device=dev))
    x = _randn(gen, (batch, width), dt, dev)
    # a learnable target: a fixed random linear map of x (so the loss is
    # reducible — this workload doubles as a training self-check)
    target_map = _randn(gen, (width, width), dt, dev) * (1.0 / width ** 0.5)
    y = x @ target_map
    return MlpTrainStep(lr), (*params, x, y)


@register(
    "embedding_lookup",
    description="large embedding-table gather + reduce (HBM random access)",
    suite="ubench",
    vocab=262144, dim=1024, lookups=16384, dtype="bfloat16",
)
def build_embedding_lookup(vocab: int, dim: int, lookups: int, dtype: str,
                           device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = _randn(gen, (vocab, dim), dt, dev)
    ids = torch.randint(0, vocab, (lookups,), generator=gen, device=dev,
                        dtype=torch.int32)
    return EmbeddingLookup(), (table, ids)


@register(
    "lstm_layer",
    description="LSTM layer over a sequence (scan of gate matmuls — the "
    "DeepBench RNN slot)",
    suite="ubench",
    batch=64, hidden=1024, seq=128, dtype="bfloat16",
)
def build_lstm_layer(batch: int, hidden: int, seq: int, dtype: str,
                     device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = _randn(gen, (seq, batch, hidden), dt, dev)
    w = _randn(gen, (hidden, 4 * hidden), dt, dev) * (hidden ** -0.5)
    u = _randn(gen, (hidden, 4 * hidden), dt, dev) * (hidden ** -0.5)
    b = torch.zeros(4 * hidden, dtype=dt, device=dev)
    return LstmLayer(), (xs, w, u, b)


@register(
    "ici_allreduce",
    description="psum over all local devices (ICI bandwidth/latency fit "
    "on multi-chip hosts)",
    suite="ubench",
    num_devices=0,  # uses all available
    elems=8 * 1024 * 1024, dtype="float32",
)
def build_ici_allreduce(elems: int, dtype: str, device=None,
                        world: int | None = None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    if world is None:
        world = max(torch.cuda.device_count(), 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    return IciAllreduce(world), (_randn(gen, (world * elems,), dt, dev),)

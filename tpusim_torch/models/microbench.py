"""Microbenchmark workloads — port of ``tpusim/models/microbench.py``,
all eighteen of its entries.

Each workload is registered under the reference's name with the
reference's parameters, suite and description, in the reference's
order, so both CLIs take the same ``--set`` overrides.  Each is an
``nn.Module`` whose ``forward`` is the reference function, written so
that its exported graph lowers to the HLO the reference's capture holds
(:mod:`tpusim_torch.tracer.lower`):

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
* ``dynamic_loop`` runs its Babylonian square root through the
  ``while_loop`` higher-order op: one ``while`` with no known trip
  count, as ``lax.while_loop`` gives;
* ``matmul_int8`` is ``torch._int_mm`` (``s8 × s8 → s32``, the
  reference's ``preferred_element_type=int32`` dot);
* ``softmax_narrow``, ``reduce_lane_wide`` and ``reduce_major_acc`` widen
  their bf16 input to f32 and narrow the result, as the reference's
  ``astype`` and ``jnp.sum`` do; ``relayout_copy`` writes ``x.T + 1``
  out transposed;
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
           "IciAllreduce", "Matmul", "SmallMatmulChain", "OpOverheadChain",
           "DynamicLoop", "SoftmaxNarrow", "RelayoutCopy", "MatmulInt8",
           "ReduceSum"]


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


class Matmul(nn.Module):
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    @staticmethod
    def from_numpy(a, b, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([a, b], device)


class SmallMatmulChain(nn.Module):
    """``x ← x @ x``, ``depth`` times."""

    def __init__(self, depth: int):
        super().__init__()
        self.depth = depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.depth):
            x = x @ x
        return x

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class OpOverheadChain(nn.Module):
    """``depth`` dependent tiny ops, ``* 1.0001`` and ``+ 1e-7`` in turn
    (one kLoop fusion after lowering, as XLA's)."""

    def __init__(self, depth: int):
        super().__init__()
        self.depth = depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = x * 1.0001 if i % 2 == 0 else x + 1e-7
        return x

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class DynamicLoop(nn.Module):
    """Babylonian square root of ``a`` until ``max|x² − a| ≤ tol``, through
    the ``while_loop`` higher-order op: one ``while`` with no known trip
    count, ``a`` riding in its carry, as ``lax.while_loop`` writes it."""

    def __init__(self, tol: float):
        super().__init__()
        self.tol = tol

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        from torch._higher_order_ops.while_loop import while_loop

        tol = self.tol

        def cond(x, err):
            return err > tol

        def body(x, err):
            x = 0.5 * (x + a / x)
            return x, (x * x - a).abs().amax()

        x0 = torch.ones_like(a)
        err0 = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
        x, _ = while_loop(cond, body, (x0, err0))
        return x

    @staticmethod
    def from_numpy(a, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([a], device)


class SoftmaxNarrow(nn.Module):
    """Softmax over dim 1 of ``[batch, seq, heads]``, computed in f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x.float(), dim=1).to(x.dtype)

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class RelayoutCopy(nn.Module):
    """``x.T + 1``, written out transposed (a physical transpose)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.t() + 1.0).contiguous()

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


class MatmulInt8(nn.Module):
    """``s8 × s8 → s32`` (``torch._int_mm``)."""

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch._int_mm(a, b)

    @staticmethod
    def from_numpy(a, b, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([a, b], device)


class ReduceSum(nn.Module):
    """Sum over ``dim`` of a bf16 array, accumulated in f32 as
    ``jnp.sum`` does."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float().sum(dim=self.dim).to(x.dtype)

    @staticmethod
    def from_numpy(x, *, device=None) -> tuple[torch.Tensor, ...]:
        return _arrays([x], device)


# ---------------------------------------------------------------------------
# Registration (names, parameters and descriptions are the reference's)
# ---------------------------------------------------------------------------


@register(
    "matmul",
    description="single large bf16 matmul (MXU peak)",
    suite="ubench",
    m=4096, n=4096, k=4096, dtype="bfloat16",
)
def build_matmul(m: int, n: int, k: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = _randn(gen, (m, k), dt, dev)
    b = _randn(gen, (k, n), dt, dev)
    return Matmul(), (a, b)


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
    "small_matmul_chain",
    description="chain of MXU-tile-sized matmuls (fill/drain overhead fit)",
    suite="ubench",
    size=128, depth=64, dtype="bfloat16",
)
def build_small_matmul_chain(size: int, depth: int, dtype: str, device=None):
    dev, dt = resolve_device(device), torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (size, size), dt, dev) * (size ** -0.5)
    return SmallMatmulChain(depth), (x,)


@register(
    "op_overhead_chain",
    description="long chain of dependent tiny ops (per-op dispatch "
    "overhead fit)",
    suite="ubench",
    depth=256,
)
def build_op_overhead_chain(depth: int, device=None):
    dev = resolve_device(device)
    return OpOverheadChain(depth), (
        torch.ones(8, 128, dtype=torch.float32, device=dev),)


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
    "dynamic_loop",
    description="data-dependent while loop (Newton sqrt to convergence) — "
    "trip count NOT statically known; exercises the engine's "
    "default_loop_trip_count fallback and its unknown_trip_loops flag",
    suite="ubench",
    elems=256 * 1024, tol=1e-4,
)
def build_dynamic_loop(elems: int, tol: float, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((elems,), generator=gen, device=dev,
                   dtype=torch.float32) * 3.5 + 0.5
    return DynamicLoop(tol), (a,)


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
    "softmax_narrow",
    description="softmax over a NARROW minor dim (8 in the 128-lane "
    "position) — validates the VPU lane-occupancy model the decode "
    "fixture exposed (round-4 calibration #12)",
    suite="ubench",
    batch=8, seq=1024, heads=8,
)
def build_softmax_narrow(batch: int, seq: int, heads: int, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return SoftmaxNarrow(), (
        _randn(gen, (batch, seq, heads), torch.bfloat16, dev),)


@register(
    "relayout_copy",
    description="layout-changing device copy (transposed output layout) — "
    "validates the relayout-vs-stream copy pricing (round-4 "
    "calibration #6)",
    suite="ubench",
    rows=4096, cols=4096,
)
def build_relayout_copy(rows: int, cols: int, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return RelayoutCopy(), (_randn(gen, (rows, cols), torch.bfloat16, dev),)


@register(
    "matmul_int8",
    description="int8 matmul with s32 accumulation — validates the "
    "quantized-serving dtype_mult table entry (s8 nominally 2x bf16 "
    "MACs/cycle, never silicon-measured before)",
    suite="ubench",
    m=4096, n=4096, k=4096,
)
def build_matmul_int8(m: int, n: int, k: int, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-127, 127, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 127, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    return MatmulInt8(), (a, b)


@register(
    "reduce_lane_wide",
    description="bf16 reduce over a WIDE minor (lane) dim — extent 1024 "
    "crosses 8 lane tiles; pins the tree-combine factor of the "
    "lane-cross reduce model (currently an extrapolation: the decode "
    "fixture only exercises extent 128)",
    suite="ubench",
    rows=65536, cols=1024,
)
def build_reduce_lane_wide(rows: int, cols: int, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return ReduceSum(-1), (_randn(gen, (rows, cols), torch.bfloat16, dev),)


@register(
    "reduce_major_acc",
    description="bf16 accumulate over the MAJOR dim (decode fusion.52 "
    "regime: serial tile accumulation, no lane crossing) — the decode "
    "fixture's context-reduce reads -56% and no committed ubench "
    "isolates the serial-accumulate rate",
    suite="ubench",
    rows=1024, cols=8192,
)
def build_reduce_major_acc(rows: int, cols: int, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return ReduceSum(0), (_randn(gen, (rows, cols), torch.bfloat16, dev),)

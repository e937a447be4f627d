"""SPMD on one device: the port's counterpart of ``shard_map``,
``lax.psum``, ``all_gather``, ``psum_scatter``, ``all_to_all``,
``ppermute`` and ``axis_index``.

A multi-device workload is written as one rank's program over its local
shards, as a ``shard_map`` body is.  Its collectives are custom ops
(``tpusim_torch::all_reduce`` and the rest), each taking its group as a
mesh shape plus the mesh axes it spans, so one op over a ``(dp, tp)``
mesh reads like ``P("tp")`` or ``P("dp")``:

* traced over fake tensors (capture), each collective stays one graph
  node, which :mod:`tpusim_torch.tracer.lower` turns into an HLO
  collective with ``replica_groups`` and a ``channel_id``;
* run, :func:`run_ranks` stacks every rank's shards along a leading rank
  dim and runs the program once under ``torch.func.vmap``: each op's vmap
  rule computes the collective over that dim.  All ranks run on one
  device, in one thread, with no process group.  The memory is the
  world size times one rank's working set.

Outside ``run_ranks`` a collective has no ranks to talk to and raises.

Autograd follows the ``shard_map`` typing of JAX (and Megatron's f/g):
:func:`psum`'s output is the same on every rank of its group, so its
backward passes the cotangent through unchanged, while :func:`pvary`
(identity forward; Megatron's f) all-reduces its cotangent, summing the
partial gradients of a replicated value consumed by rank-varying ops.
The data-movement ops transpose to each other: ``all_gather`` ↔
``psum_scatter``, ``all_to_all`` to itself with the dims swapped,
``ppermute`` to the inverse permutation.  A train step differentiates
with ``torch.func.grad_and_value`` (functorch refuses
``torch.autograd.grad`` inside a vmap).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
from torch.library import custom_op, register_vmap

__all__ = ["Mesh", "P", "groups", "psum", "pmax", "psum_coalesced", "pvary",
           "pvary_coalesced", "psum_plain",
           "all_gather", "psum_scatter", "all_to_all", "ppermute",
           "axis_index", "local_shard", "global_shape", "shard", "unshard",
           "run_ranks", "SpmdModule"]


# ---------------------------------------------------------------------------
# Mesh and partition specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape`` over named axes; rank ``r`` sits at
    the row-major coordinates of ``r`` (``jax.sharding.Mesh`` over
    ``np.array(devices).reshape(shape)``)."""

    shape: tuple[int, ...]
    names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axes(self, axis: str | Sequence[str]) -> tuple[int, ...]:
        """Mesh dims of one axis name or several, in the order given."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        try:
            return tuple(self.names.index(a) for a in names)
        except ValueError:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{self.names}") from None

    def coords(self, rank: int) -> tuple[int, ...]:
        return _coords(self.shape, rank)


def P(*entries: Any) -> tuple:
    """A partition spec: per tensor dim, ``None`` (replicated), an axis
    name, or a tuple of axis names (``jax.sharding.PartitionSpec``)."""
    return tuple(entries)


def _coords(shape: Sequence[int], rank: int) -> tuple[int, ...]:
    out = []
    for d in reversed(shape):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _rank(shape: Sequence[int], coords: Sequence[int]) -> int:
    r = 0
    for d, c in zip(shape, coords):
        r = r * d + c
    return r


def groups(shape: Sequence[int], axes: Sequence[int]) -> list[list[int]]:
    """The replica groups of a collective over mesh dims ``axes``: ranks
    that share every other coordinate, each group ordered by the linear
    index over ``axes`` in the order given; groups ordered by their
    first member."""
    shape, axes = tuple(shape), tuple(axes)
    rest = [i for i in range(len(shape)) if i not in axes]
    out = []
    for o in range(math.prod(shape[i] for i in rest)):
        oc = _coords([shape[i] for i in rest], o)
        grp = []
        for g in range(math.prod(shape[a] for a in axes)):
            gc = _coords([shape[a] for a in axes], g)
            c = [0] * len(shape)
            for i, v in zip(rest, oc):
                c[i] = v
            for a, v in zip(axes, gc):
                c[a] = v
            grp.append(_rank(shape, c))
        out.append(grp)
    return sorted(out, key=lambda g: g[0])


def _tables(shape, axes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(members [N, G], pos [N])``: the ranks of each rank's group and
    its position in it."""
    n = math.prod(shape)
    members = [None] * n
    pos = [0] * n
    for grp in groups(shape, axes):
        for i, r in enumerate(grp):
            members[r] = grp
            pos[r] = i
    return (torch.tensor(members, dtype=torch.long, device=device),
            torch.tensor(pos, dtype=torch.long, device=device))


# ---------------------------------------------------------------------------
# The custom ops: fake impls, vmap rules over the rank dim
# ---------------------------------------------------------------------------


def _outside(name: str):
    raise RuntimeError(
        f"tpusim_torch::{name} called outside run_ranks: a collective needs "
        f"the ranks of its group (run the program through "
        f"tpusim_torch.spmd.run_ranks)")


def _ranked(info, in_dim, x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` with its rank dim leading (expanded when it has none)."""
    n = math.prod(shape)
    if info.batch_size != n:
        raise RuntimeError(f"collective over a mesh of {n} ranks run "
                           f"with {info.batch_size} ranks")
    if in_dim is None:
        return x.expand(n, *x.shape)
    return x.movedim(in_dim, 0)


def _group_reduce(xr: torch.Tensor, shape, axes, op: str) -> torch.Tensor:
    """Reduce ``xr`` [N, ...] over each rank's group, broadcast back."""
    local = xr.shape[1:]
    x = xr.reshape(*shape, *local)
    dims = tuple(sorted(axes))
    acc = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    if op == "sum":
        red = acc.sum(dim=dims, keepdim=True)
    elif op == "max":
        red = acc.amax(dim=dims, keepdim=True)
    else:
        raise ValueError(f"all_reduce op {op!r} (sum, max)")
    return red.to(x.dtype).expand(x.shape).reshape(xr.shape).contiguous()


@custom_op("tpusim_torch::all_reduce", mutates_args=())
def _all_reduce(x: torch.Tensor, mesh: list[int], axes: list[int],
                op: str) -> torch.Tensor:
    _outside("all_reduce")


@_all_reduce.register_fake
def _(x, mesh, axes, op):
    return torch.empty_like(x)


def _all_reduce_vmap(info, in_dims, x, mesh, axes, op):
    return _group_reduce(_ranked(info, in_dims[0], x, mesh), mesh, axes,
                         op), 0


register_vmap(_all_reduce, _all_reduce_vmap)


@custom_op("tpusim_torch::all_reduce_coalesced", mutates_args=())
def _all_reduce_coalesced(xs: list[torch.Tensor], mesh: list[int],
                          axes: list[int]) -> list[torch.Tensor]:
    _outside("all_reduce_coalesced")


@_all_reduce_coalesced.register_fake
def _(xs, mesh, axes):
    return [torch.empty_like(x) for x in xs]


def _all_reduce_coalesced_vmap(info, in_dims, xs, mesh, axes):
    outs = [_group_reduce(_ranked(info, d, x, mesh), mesh, axes, "sum")
            for x, d in zip(xs, in_dims[0])]
    return outs, [0] * len(outs)


register_vmap(_all_reduce_coalesced, _all_reduce_coalesced_vmap)


@custom_op("tpusim_torch::all_gather", mutates_args=())
def _all_gather(x: torch.Tensor, mesh: list[int], axes: list[int],
                dim: int) -> torch.Tensor:
    _outside("all_gather")


@_all_gather.register_fake
def _(x, mesh, axes, dim):
    g = math.prod(mesh[a] for a in axes)
    shape = list(x.shape)
    shape[dim] *= g
    return x.new_empty(shape)


def _all_gather_vmap(info, in_dims, x, mesh, axes, dim):
    xr = _ranked(info, in_dims[0], x, mesh)
    members, _ = _tables(mesh, axes, xr.device)
    xg = xr[members]                               # [N, G, *local]
    n, g = members.shape
    local = list(xr.shape[1:])
    out = xg.movedim(1, 1 + dim)                   # G just before dim
    local[dim] *= g
    return out.reshape(n, *local), 0


register_vmap(_all_gather, _all_gather_vmap)


@custom_op("tpusim_torch::reduce_scatter", mutates_args=())
def _reduce_scatter(x: torch.Tensor, mesh: list[int], axes: list[int],
                    dim: int) -> torch.Tensor:
    _outside("reduce_scatter")


@_reduce_scatter.register_fake
def _(x, mesh, axes, dim):
    g = math.prod(mesh[a] for a in axes)
    shape = list(x.shape)
    if shape[dim] % g:
        raise ValueError(f"reduce_scatter: dim {dim} of size {shape[dim]} "
                         f"does not split {g} ways")
    shape[dim] //= g
    return x.new_empty(shape)


def _chunk_at(xr: torch.Tensor, dim: int, g: int,
              pos: torch.Tensor) -> torch.Tensor:
    """Per rank r, chunk ``pos[r]`` of ``g`` along local ``dim``."""
    n, local = xr.shape[0], list(xr.shape[1:])
    split = xr.reshape(n, *local[:dim], g, local[dim] // g, *local[dim + 1:])
    moved = split.movedim(1 + dim, 1)              # [N, g, ...]
    return moved[torch.arange(n, device=xr.device), pos]


def _reduce_scatter_vmap(info, in_dims, x, mesh, axes, dim):
    xr = _ranked(info, in_dims[0], x, mesh)
    _, pos = _tables(mesh, axes, xr.device)
    g = math.prod(mesh[a] for a in axes)
    red = _group_reduce(xr, mesh, axes, "sum")
    return _chunk_at(red, dim, g, pos).contiguous(), 0


register_vmap(_reduce_scatter, _reduce_scatter_vmap)


@custom_op("tpusim_torch::all_to_all", mutates_args=())
def _all_to_all(x: torch.Tensor, mesh: list[int], axes: list[int],
                split_dim: int, concat_dim: int) -> torch.Tensor:
    _outside("all_to_all")


@_all_to_all.register_fake
def _(x, mesh, axes, split_dim, concat_dim):
    g = math.prod(mesh[a] for a in axes)
    shape = list(x.shape)
    if shape[split_dim] % g:
        raise ValueError(f"all_to_all: split dim {split_dim} of size "
                         f"{shape[split_dim]} does not split {g} ways")
    shape[split_dim] //= g
    shape[concat_dim] *= g
    return x.new_empty(shape)


def _all_to_all_vmap(info, in_dims, x, mesh, axes, split_dim, concat_dim):
    """Rank r receives, from the j-th member of its group, that member's
    chunk ``pos(r)`` along ``split_dim``, and concatenates the chunks in
    member order along ``concat_dim`` (``lax.all_to_all(tiled=True)``)."""
    xr = _ranked(info, in_dims[0], x, mesh)
    members, pos = _tables(mesh, axes, xr.device)
    n, g = members.shape
    xg = xr[members]                               # [N, G(j), *local]
    local = list(xr.shape[1:])
    s = split_dim
    split = xg.reshape(n, g, *local[:s], g, local[s] // g, *local[s + 1:])
    moved = split.movedim(2 + s, 2)                # [N, G(j), G(chunk), ...]
    idx = pos.view(n, 1).expand(n, g)
    picked = moved[torch.arange(n, device=xr.device).view(n, 1),
                   torch.arange(g, device=xr.device).view(1, g), idx]
    out_local = list(local)
    out_local[s] //= g
    c = concat_dim
    out = picked.movedim(1, 1 + c)                 # G(j) just before dim c
    out_local[c] *= g
    return out.reshape(n, *out_local), 0


register_vmap(_all_to_all, _all_to_all_vmap)


@custom_op("tpusim_torch::collective_permute", mutates_args=())
def _collective_permute(x: torch.Tensor, mesh: list[int], axes: list[int],
                        pairs: list[int]) -> torch.Tensor:
    _outside("collective_permute")


@_collective_permute.register_fake
def _(x, mesh, axes, pairs):
    return torch.empty_like(x)


def _permute_sources(mesh, axes, pairs) -> list[int]:
    """Per rank, the rank it receives from (-1: none).  ``pairs`` is the
    flat ``[src0, dst0, src1, dst1, ...]`` over group positions."""
    src = [-1] * math.prod(mesh)
    for grp in groups(mesh, axes):
        for s, d in zip(pairs[0::2], pairs[1::2]):
            src[grp[d]] = grp[s]
    return src


def _collective_permute_vmap(info, in_dims, x, mesh, axes, pairs):
    xr = _ranked(info, in_dims[0], x, mesh)
    src = torch.tensor(_permute_sources(mesh, axes, pairs),
                       device=xr.device)
    out = xr[src.clamp(min=0)]
    keep = (src >= 0).view(-1, *([1] * (xr.dim() - 1)))
    return torch.where(keep, out, torch.zeros_like(out)), 0


register_vmap(_collective_permute, _collective_permute_vmap)


@custom_op("tpusim_torch::axis_index", mutates_args=())
def _axis_index(anchor: torch.Tensor, mesh: list[int],
                axes: list[int]) -> torch.Tensor:
    _outside("axis_index")


@_axis_index.register_fake
def _(anchor, mesh, axes):
    return anchor.new_empty((), dtype=torch.int32)


def _axis_index_vmap(info, in_dims, anchor, mesh, axes):
    if in_dims[0] is None:
        raise RuntimeError("axis_index needs an anchor that varies over "
                           "the ranks (one of the program's inputs)")
    _ranked(info, in_dims[0], anchor, mesh)
    _, pos = _tables(mesh, axes, anchor.device)
    return pos.to(torch.int32), 0


register_vmap(_axis_index, _axis_index_vmap)

# ---------------------------------------------------------------------------
# Differentiable wrappers
# ---------------------------------------------------------------------------


def _group(mesh: Mesh, axis) -> tuple[list[int], list[int]]:
    return list(mesh.shape), list(mesh.axes(axis))


class _Psum(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes):
        return _all_reduce(x, shape, axes, "sum")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, *ctx.group), None, None


class _PvaryCoalesced(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(shape, axes, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[:2]

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_PsumCoalesced.apply(*ctx.group, *gs))


class _PsumCoalesced(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(shape, axes, *xs):
        return tuple(_all_reduce_coalesced(list(xs), shape, axes))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


class _AllGather(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes, dim):
        return _all_gather(x, shape, axes, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _PsumScatter.apply(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes, dim):
        return _reduce_scatter(x, shape, axes, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes, split_dim, concat_dim):
        return _all_to_all(x, shape, axes, split_dim, concat_dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        shape, axes, split_dim, concat_dim = ctx.args
        return (_AllToAll.apply(g, shape, axes, concat_dim, split_dim),
                None, None, None, None)


class _Ppermute(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, shape, axes, pairs):
        return _collective_permute(x, shape, axes, pairs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        shape, axes, pairs = ctx.args
        inverse = [v for s, d in zip(pairs[0::2], pairs[1::2])
                   for v in (d, s)]
        return _Ppermute.apply(g, shape, axes, inverse), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum over the group, on every member
    (an ``all-reduce``).  Backward: the cotangent unchanged (Megatron's
    g)."""
    return _Psum.apply(x, *_group(mesh, axis))


def pmax(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """``lax.pmax`` on a value that takes no gradient (the max a stable
    softmax subtracts, as ``jax.nn.log_softmax`` stops its gradient)."""
    shape, axes = _group(mesh, axis)
    return _all_reduce(x.detach(), shape, axes, "max")


def psum_coalesced(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axis) -> tuple[torch.Tensor, ...]:
    """One all-reduce of several arrays (XLA's combined all-reduce, a
    tuple-shaped ``all-reduce`` in the trace), e.g. a data-parallel
    gradient all-reduce."""
    shape, axes = _group(mesh, axis)
    return _PsumCoalesced.apply(shape, axes, *xs)


def pvary(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Identity on a value replicated over the group that rank-varying ops
    consume (Megatron's f); backward: the all-reduce of the partial
    cotangents."""
    return _Pvary.apply(x, *_group(mesh, axis))


def psum_plain(xs: Sequence[torch.Tensor], mesh: Mesh,
               axis) -> list[torch.Tensor]:
    """:func:`psum` of one array or :func:`psum_coalesced` of several, as
    the bare custom op: for a program that takes no gradient through it
    (a hand-written backward inside a ``scan`` body, where the autograd
    wrappers do not trace)."""
    shape, axes = _group(mesh, axis)
    if len(xs) == 1:
        return [_all_reduce(xs[0], shape, axes, "sum")]
    return list(_all_reduce_coalesced(list(xs), shape, axes))


def pvary_coalesced(xs: Sequence[torch.Tensor], mesh: Mesh,
                    axis) -> tuple[torch.Tensor, ...]:
    """:func:`pvary` of several values at once; backward: one all-reduce
    of their partial cotangents (a tuple, as XLA's combiner makes
    independent ones)."""
    shape, axes = _group(mesh, axis)
    return _PvaryCoalesced.apply(shape, axes, *xs)


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, *_group(mesh, axis), dim % x.dim())


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``
    (a ``reduce-scatter``)."""
    return _PsumScatter.apply(x, *_group(mesh, axis), dim % x.dim())


def all_to_all(x: torch.Tensor, mesh: Mesh, axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``."""
    return _AllToAll.apply(x, *_group(mesh, axis), split_dim % x.dim(),
                           concat_dim % x.dim())


def ppermute(x: torch.Tensor, mesh: Mesh, axis,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: pairs ``(source, target)`` of
    positions in the group; a rank no pair targets receives zeros."""
    flat = [int(v) for pair in perm for v in pair]
    return _Ppermute.apply(x, *_group(mesh, axis), flat)


def axis_index(anchor: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """``lax.axis_index(axis)`` as a 0-d int32 tensor.  ``anchor`` is any
    tensor that varies over the ranks (an input of the program): under
    ``run_ranks`` it carries the rank dim the index is read from."""
    return _axis_index(anchor.detach(), *_group(mesh, axis))


# ---------------------------------------------------------------------------
# Shards and the rank runner
# ---------------------------------------------------------------------------


def _dim_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh: Mesh, spec: tuple, shape: Sequence[int],
           rank: int) -> tuple[slice, ...]:
    """The slices of a global array of ``shape`` that ``rank`` holds."""
    coords = mesh.coords(rank)
    out = []
    for d, size in enumerate(shape):
        names = _dim_axes(spec[d] if d < len(spec) else None)
        if not names:
            out.append(slice(None))
            continue
        dims = mesh.axes(names)
        parts = math.prod(mesh.shape[a] for a in dims)
        if size % parts:
            raise ValueError(f"dim {d} of size {size} does not split "
                             f"{parts} ways over {names}")
        idx = _rank([mesh.shape[a] for a in dims], [coords[a] for a in dims])
        step = size // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shard(x: torch.Tensor, mesh: Mesh, spec: tuple,
                rank: int) -> torch.Tensor:
    """The shard of a global array one rank holds (a view)."""
    if x.dim() == 0:
        return x
    return x[_block(mesh, spec, x.shape, rank)]


def shard(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """A global array as its ranks' shards, stacked: ``[N, *local]``."""
    return torch.stack([local_shard(x, mesh, spec, r)
                        for r in range(mesh.size)])


def global_shape(local: Sequence[int], mesh: Mesh,
                 spec: tuple) -> list[int]:
    """The shape of the global array one rank holds a ``local`` shard of."""
    shape = list(local)
    for d in range(len(shape)):
        names = _dim_axes(spec[d] if d < len(spec) else None)
        if names:
            shape[d] *= math.prod(mesh.shape[a] for a in mesh.axes(names))
    return shape


def unshard(stacked: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """The global array from its ranks' shards ``[N, *local]``.  A value
    replicated over a mesh axis is read from coordinate 0 of that axis,
    and every other replica must equal it (``shard_map``'s replication
    check): a rank that disagrees raises."""
    spec_axes = {a for e in spec for a in mesh.axes(_dim_axes(e))}
    shape = global_shape(stacked.shape[1:], mesh, spec)
    out = stacked.new_empty(shape)
    kept = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        block = _block(mesh, spec, shape, r)
        key = tuple((s.start, s.stop) for s in block)
        if key not in kept:
            kept[key] = r
            out[block] = stacked[r]
        elif not torch.equal(stacked[r], stacked[kept[key]]):
            over = [n for a, n in enumerate(mesh.names)
                    if a not in spec_axes]
            raise RuntimeError(
                f"rank {r} (mesh coordinates {c}) disagrees with rank "
                f"{kept[key]} on an output replicated over {over}")
    return out


def run_ranks(fn: Callable, mesh: Mesh, *global_args: torch.Tensor,
              in_specs: Sequence[tuple], out_specs) -> Any:
    """Run the per-rank program ``fn`` on every rank of ``mesh`` at once,
    on the arguments' device: split each global argument by its in-spec
    into a ``[N, *local]`` stack, ``torch.func.vmap`` ``fn`` over the
    rank dim (the collectives' vmap rules exchange the data), and
    reassemble the outputs by ``out_specs`` (one spec, or a tuple of
    specs for a tuple of outputs).  The counterpart of calling a
    ``shard_map``-ed function on global arrays."""
    if len(in_specs) != len(global_args):
        raise ValueError(f"{len(global_args)} arguments, "
                         f"{len(in_specs)} in_specs")
    stacked = [shard(a, mesh, s) for a, s in zip(global_args, in_specs)]
    outs = torch.func.vmap(fn, in_dims=0, out_dims=0,
                           randomness="error")(*stacked)
    if isinstance(outs, (tuple, list)):
        if len(outs) != len(out_specs):
            raise ValueError(f"{len(outs)} outputs, {len(out_specs)} "
                             f"out_specs")
        return tuple(unshard(o, mesh, s) for o, s in zip(outs, out_specs))
    return unshard(outs, mesh, out_specs)


class SpmdModule(torch.nn.Module):
    """A multi-device workload: ``forward`` is one rank's program over its
    local shards; :meth:`run` is the whole SPMD step over global arrays
    (:func:`run_ranks`).  Subclasses set ``mesh``, ``in_specs`` and
    ``out_specs``."""

    mesh: Mesh
    in_specs: tuple
    out_specs: Any

    @property
    def world(self) -> int:
        return self.mesh.size

    def local_args(self, *global_args: torch.Tensor,
                   rank: int = 0) -> tuple[torch.Tensor, ...]:
        """One rank's shards of the global arguments, each dense, as a
        device holds it."""
        return tuple(local_shard(a, self.mesh, s, rank).clone(
                         memory_format=torch.contiguous_format)
                     for a, s in zip(global_args, self.in_specs))

    def run(self, *global_args: torch.Tensor) -> Any:
        return run_ranks(self, self.mesh, *global_args,
                         in_specs=self.in_specs, out_specs=self.out_specs)

"""Core ATen → HLO lowering.

The port's counterpart of XLA's lowering, which the JAX package gets from
``jax.jit(...).lower().compile()`` (``tpusim/tracer/capture.py``).  It
turns an FX graph of core ATen ops — ``torch.export(...)
.run_decompositions()`` of a forward module, or ``make_fx`` of a train
step — into an :class:`~tpusim_torch.tracer.hlo_ir.HloModule`:

* ``mm`` / ``bmm`` / ``addmm`` → ``dot``; ``convolution`` → ``convolution``
  with ``window`` and ``dim_labels``; ``convolution_backward`` → the
  input-gradient convolution (``lhs_dilate`` by the stride, the kernel
  ``reverse``-d, its feature dims swapped) and the weight-gradient one
  (the output gradient as the window, ``rhs_dilate`` by the stride,
  batch and feature swapped), as XLA writes ``conv_general_dilated``'s
  transpose;
* ``constant_pad_nd`` → ``pad``, folded into the window ``pad`` of each
  convolution, ``reduce-window`` or ``select-and-scatter`` that reads it
  (XLA's fold; a reader outside those keeps the ``pad``), and a crop that
  undoes a pad → the pad's operand; ``max_pool2d_with_indices`` →
  ``reduce-window`` with a ``maximum`` region (the indices dropped), its
  backward → ``select-and-scatter`` (``GE`` select, ``add`` scatter);
* elementwise arithmetic, ``exp``, ``tanh``, ``sigmoid`` (``logistic``),
  ``relu`` (``maximum``), ``pow`` by a scalar, ``where`` (``select``),
  comparisons, ``gelu`` and ``_softmax`` (as the ops ``jax.nn`` emits) and
  dtype casts (``convert``);
* ``sum`` / ``mean`` / ``amax`` → ``reduce`` with a ``to_apply`` region;
  ``var.correction``, ``_log_softmax`` and its backward as the ops
  ``jnp.var`` and ``jax.nn.log_softmax`` write; ``clamp`` →
  ``maximum`` / ``minimum``;
* views → ``bitcast`` (every array is dense row-major), ``permute`` →
  ``transpose``, ``expand`` → ``broadcast``;
* ``full`` / ``scalar_tensor`` / ``arange`` → ``constant`` / ``broadcast``
  / ``iota``; ``index_select`` / ``embedding`` → ``gather``; ``gather``
  (``take_along_axis``) → ``gather`` and ``scatter_add`` → ``scatter``
  over full start indices; ``slice`` / ``split`` → ``slice``;
  ``slice_scatter`` → ``dynamic-update-slice``; ``cat`` →
  ``concatenate``;
* the custom ops ``tpusim_torch::dynamic_update_slice`` →
  ``dynamic-update-slice`` and ``tpusim_torch::dynamic_index`` →
  ``dynamic-slice``; ``tpusim_torch::flash_attention`` → one
  ``custom-call`` with ``custom_call_target="tpu_custom_call"`` and no
  ``cost_estimate`` (what a TPU capture of the Pallas kernel holds);
* the ``higher_order.scan`` node → ``while`` with a ``tuple`` carry led by
  an ``s32`` induction variable, a condition ``compare(iv, N)`` and
  ``backend_config={"known_trip_count":{"n":"N"}}``, the scanned inputs
  read with ``dynamic-slice`` and the stacked outputs written with
  ``dynamic-update-slice``, as XLA lowers ``lax.scan``; a reversed scan
  (torch's ``flip`` of its inputs and outputs) reads and writes at
  ``n-1-iv`` with no copy, and any other ``flip`` → ``reverse``;
* the ``higher_order.while_loop`` node → ``while`` over the tuple of its
  carried values and the tensors its functions close over, with the
  condition and body computations and no ``known_trip_count``, as XLA
  lowers ``lax.while_loop``;
* ``_int_mm`` → an ``s32`` ``dot`` of two ``s8`` operands;
* the collectives of :mod:`tpusim_torch.spmd` → ``all-reduce``
  (with an add or max region; a tuple for ``all_reduce_coalesced``),
  ``all-gather``, ``reduce-scatter``, ``all-to-all`` (the TPU's one-array
  form over the split dim, then a transpose to the concat dim) and
  ``collective-permute``, each with a fresh ``channel_id`` and XLA's
  iota ``replica_groups``; ``axis_index`` → ``partition-id`` and the
  integer arithmetic that reads an axis's coordinate out of it; the
  header then carries ``num_partitions``;
* ``tpusim_torch::scatter_add_rows`` (an embedding's gradient) →
  ``scatter`` with an add region; ``cos`` / ``sin``, the logical ops and
  a scalar base to a tensor power.

Types are ``f32``, ``bf16``, ``s32``, ``s8`` and ``pred`` (and the ``u32`` of
``partition-id``); an int64 value inside the graph (torch's index type
for ``gather`` and ``scatter_add``) narrows to the ``s32`` JAX writes,
and an int64 input is refused.  Any node outside the table raises
``NotImplementedError`` naming it: nothing is skipped but the export's
metadata asserts, which compute nothing.

After lowering, transposes fold into the dots and convolutions that read
them (XLA's transpose folding; a dot keeps its batch dims leading, the
form XLA's dot canonicalisation gives), and :mod:`tpusim_torch.tracer.fuse`
fuses what XLA's fusion would.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Sequence

import torch

from tpusim_torch.spmd import groups
from tpusim_torch.tracer.hlo_ir import Array, Computation, HloModule, Instr

__all__ = ["lower_graph", "hlo_dtype", "LoweringError"]

_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int32: "s32", torch.int8: "s8", torch.bool: "pred",
               # int64 indices (torch's default for gather and
               # scatter_add) narrow to the s32 JAX writes
               torch.int64: "s32"}

#: ops that only check metadata and compute nothing
_ASSERT_OPS = frozenset({
    "aten._assert_tensor_metadata.default", "aten._assert_async.default",
    "aten._assert_async.msg", "aten._assert_scalar.default",
})


class LoweringError(NotImplementedError):
    """A graph node the lowering's op table does not hold."""


def hlo_dtype(dtype: torch.dtype) -> str:
    try:
        return _HLO_DTYPES[dtype]
    except KeyError:
        raise LoweringError(
            f"no HLO type for torch dtype {dtype} (the lowering knows "
            f"{', '.join(str(d) for d in _HLO_DTYPES)})"
        ) from None


def _array(val: Any) -> Array:
    return Array(hlo_dtype(val.dtype), tuple(int(d) for d in val.shape))


def _ints(xs: Sequence[int]) -> str:
    return "{" + ",".join(str(int(x)) for x in xs) + "}"


def _literal(dtype: str, value: Any) -> str:
    if dtype == "pred":
        return "true" if value else "false"
    if dtype in ("s32", "s8"):
        return str(int(value))
    v = float(value)
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return repr(v)


class _Builder:
    """Emits instructions into one computation."""

    def __init__(self, module: HloModule, comp: Computation,
                 registry: list | None = None):
        self.module = module
        self.comp = comp
        #: every builder of the module (the entry's and the loop bodies')
        self.registry = registry if registry is not None else []
        self.registry.append(self)
        self.shapes: dict[str, Any] = {}
        self.by_name: dict[str, Instr] = {}
        #: (lhs_batch, lhs_contracting, rhs_batch, rhs_contracting) per dot
        self.dots: dict[str, tuple] = {}
        #: permutation of each transpose emitted here
        self.perms: dict[str, list[int]] = {}
        #: each ``pad`` emitted here: (operand, lo per dim, hi per dim,
        #: padding value)
        self.pads: dict[str, tuple[str, list[int], list[int], Any]] = {}
        #: a reversed scan's stacked outputs, which torch flips back
        self.unflipped: set[str] = set()
        self._consts: dict[tuple[str, str], str] = {}
        #: the qualified name of the FX node being lowered: what
        #: :meth:`emit` records as each instruction's origin (None in the
        #: shared reduce regions)
        self.node: str | None = None

    def emit(self, base: str, shape, opcode: str,
             operands: Sequence[str] = (), attrs: Sequence[str] = (),
             arg: str | None = None) -> str:
        name = self.module.fresh(base)
        instr = Instr(name, shape, opcode, list(operands), list(attrs), arg)
        self.comp.add(instr)
        if self.node is not None:
            self.module.origins[name] = self.node
        self.shapes[name] = shape
        self.by_name[name] = instr
        return name

    def shape(self, name: str) -> Array:
        return self.shapes[name]

    def defining(self, name: str) -> Instr | None:
        return self.by_name.get(name)

    def strip_bitcasts(self, name: str) -> str:
        while True:
            d = self.defining(name)
            if d is None or d.opcode != "bitcast":
                return name
            name = d.operands[0]

    def transpose(self, name: str, perm: Sequence[int]) -> str:
        dims = self.shape(name).dims
        t = self.emit("transpose", Array(self.shape(name).dtype,
                                         tuple(dims[p] for p in perm)),
                      "transpose", [name], [f"dimensions={_ints(perm)}"])
        self.perms[t] = list(perm)
        return t

    # -- helpers -----------------------------------------------------------

    def const(self, dtype: str, value: Any) -> str:
        lit = _literal(dtype, value)
        key = (dtype, lit)
        if key not in self._consts:
            self._consts[key] = self.emit("constant", Array(dtype, ()),
                                          "constant", arg=lit)
        return self._consts[key]

    def bitcast(self, name: str, dims: Sequence[int]) -> str:
        src = self.shape(name)
        dims = tuple(int(d) for d in dims)
        if src.dims == dims:
            return name
        if math.prod(dims) != math.prod(src.dims):
            raise LoweringError(f"reshape {src.dims} -> {dims}")
        return self.emit(f"{name}.bitcast", Array(src.dtype, dims),
                         "bitcast", [name])

    def convert(self, name: str, dtype: str) -> str:
        src = self.shape(name)
        if src.dtype == dtype:
            return name
        return self.emit(f"{name}.convert", Array(dtype, src.dims),
                         "convert", [name])

    def broadcast_to(self, name: str, dims: Sequence[int]) -> str:
        """numpy-style broadcast of ``name`` to ``dims``."""
        src = self.shape(name)
        dims = tuple(int(d) for d in dims)
        if src.dims == dims:
            return name
        offset = len(dims) - src.rank
        if offset < 0:
            raise LoweringError(f"broadcast {src.dims} -> {dims}")
        kept = [i for i, d in enumerate(src.dims) if d == dims[i + offset]]
        for i, d in enumerate(src.dims):
            if d != dims[i + offset] and d != 1:
                raise LoweringError(f"broadcast {src.dims} -> {dims}")
        squeezed = self.bitcast(name, [src.dims[i] for i in kept])
        return self.emit(f"{name}.broadcast", Array(src.dtype, dims),
                         "broadcast", [squeezed],
                         [f"dimensions={_ints(i + offset for i in kept)}"])

    def splat(self, dtype: str, value: Any, dims: Sequence[int]) -> str:
        c = self.const(dtype, value)
        dims = tuple(int(d) for d in dims)
        if not dims:
            return c
        return self.emit("broadcast", Array(dtype, dims), "broadcast", [c],
                         ["dimensions={}"])

    def region(self, kind: str, dtype: str) -> str:
        """The ``to_apply`` computation of a reduce (one per kind/dtype)."""
        key = f"{kind}.{dtype}"
        cache = self.module.regions
        if key not in cache:
            comp = self.module.new_computation(f"region_{kind}_{dtype}")
            b = _Builder(self.module, comp)
            s = Array(dtype, ())
            a = b.emit("lhs", s, "parameter", arg="0")
            c = b.emit("rhs", s, "parameter", arg="1")
            comp.root = b.emit(kind, s, kind, [a, c])
            cache[key] = comp.name
        return cache[key]

    def compare_region(self, direction: str, dtype: str) -> str:
        """A ``select`` region of a ``select-and-scatter``: ``compare(lhs,
        rhs)`` in ``direction``."""
        key = f"compare_{direction}.{dtype}"
        cache = self.module.regions
        if key not in cache:
            comp = self.module.new_computation(
                f"region_{direction.lower()}_{dtype}")
            b = _Builder(self.module, comp)
            s = Array(dtype, ())
            a = b.emit("lhs", s, "parameter", arg="0")
            c = b.emit("rhs", s, "parameter", arg="1")
            comp.root = b.emit("compare", Array("pred", ()), "compare",
                               [a, c], [f"direction={direction}"])
            cache[key] = comp.name
        return cache[key]

    def pad(self, name: str, lo: Sequence[int], hi: Sequence[int],
            value: Any) -> str:
        """``name`` padded by ``lo`` / ``hi`` per dim with ``value``."""
        src = self.shape(name)
        lo, hi = [int(v) for v in lo], [int(v) for v in hi]
        if not any(lo) and not any(hi):
            return name
        dims = tuple(d + a + z for d, a, z in zip(src.dims, lo, hi))
        out = self.emit("pad", Array(src.dtype, dims), "pad",
                        [name, self.const(src.dtype, value)],
                        ["padding=" + "x".join(f"{a}_{z}"
                                               for a, z in zip(lo, hi))])
        self.pads[out] = (name, lo, hi, value)
        return out

    def unpad(self, name: str, value: Any) -> tuple[str, list[int],
                                                     list[int]]:
        """``(operand, lo, hi)`` of a non-negative ``pad`` by ``value``
        that produced ``name``, else ``(name, 0s, 0s)``: what a window
        folds (XLA folds a pad into the window of the convolution or
        reduce-window that reads it)."""
        rank = self.shape(name).rank
        info = self.pads.get(name)
        if info is not None:
            src, lo, hi, v = info
            if (min(lo + hi) >= 0 and
                    _literal(self.shape(name).dtype, v)
                    == _literal(self.shape(name).dtype, value)):
                return src, list(lo), list(hi)
        return name, [0] * rank, [0] * rank

    def reduce(self, name: str, dims: Sequence[int], kind: str,
               init: Any, dtype: str | None = None) -> str:
        src = self.shape(name)
        dt = dtype or src.dtype
        x = self.convert(name, dt)
        dims = sorted({d % src.rank for d in dims}) if src.rank else []
        out = tuple(d for i, d in enumerate(src.dims) if i not in dims)
        return self.emit("reduce", Array(dt, out), "reduce",
                         [x, self.const(dt, init)],
                         [f"dimensions={_ints(dims)}",
                          f"to_apply=%{self.region(kind, dt)}"])


# ---------------------------------------------------------------------------
# Graph lowering
# ---------------------------------------------------------------------------

_BINARY = {
    "add": "add", "sub": "subtract", "mul": "multiply", "div": "divide",
    "maximum": "maximum", "minimum": "minimum",
}
_COMPARE = {"eq": "EQ", "ne": "NE", "lt": "LT", "le": "LE", "gt": "GT",
            "ge": "GE"}
_UNARY = {
    "exp": "exponential", "tanh": "tanh", "sigmoid": "logistic",
    "neg": "negate", "abs": "abs", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "log": "log", "cos": "cosine", "sin": "sine",
    "bitwise_not": "not", "logical_not": "not",
}
_LOGICAL = {"bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
            "logical_or": "or"}
_IDENTITY = frozenset({"alias", "clone", "detach"})
_VIEWS = frozenset({"view", "_unsafe_view", "reshape", "squeeze",
                    "unsqueeze"})


def _packet(node) -> str:
    """``aten.add.Tensor`` → ``add``; ``tpusim_torch.x.default`` → the
    qualified ``tpusim_torch::x``."""
    target = node.target
    name = getattr(target, "name", None)
    if callable(name):
        qual = name()            # e.g. "aten::add.Tensor"
        ns, _, rest = qual.partition("::")
        base = rest.split(".")[0]
        return base if ns == "aten" else f"{ns}::{base}"
    return str(target)


def _target_text(node) -> str:
    return f"{node.op} {node.target}"


class _GraphLowering:
    """Lowers one FX graph into one computation's builder."""

    def __init__(self, builder: _Builder, gm: torch.fx.GraphModule):
        self.b = builder
        self.gm = gm
        self.env: dict[Any, Any] = {}
        #: qualifies this graph's node names in the origins (a loop
        #: body's: ``<loop node>/``)
        self.prefix = ""

    def nested(self, b, gm: torch.fx.GraphModule,
               suffix: str = "/") -> "_GraphLowering":
        """The lowering of a loop's body (or condition) graph into the
        emitter ``b``, its nodes qualified under the loop node being
        lowered."""
        inner = _GraphLowering(b, gm)
        inner.prefix = f"{self.b.node}{suffix}"
        return inner

    # -- values ------------------------------------------------------------

    def val(self, a: Any) -> Any:
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self.val(x) for x in a)
        return a

    def run(self, inputs: Sequence[Any]) -> list[Any]:
        placeholders = [n for n in self.gm.graph.nodes
                        if n.op == "placeholder"]
        if len(placeholders) != len(inputs):
            raise LoweringError(
                f"graph takes {len(placeholders)} inputs, got {len(inputs)}")
        for n, v in zip(placeholders, inputs):
            self.env[n] = v
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "output":
                outs = node.args[0]
                outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
                return [self.val(o) for o in outs]
            if node.op == "get_attr":
                self.env[node] = getattr(self.gm, node.target)
                continue
            if node.op != "call_function":
                raise LoweringError(
                    f"graph node {_target_text(node)} is not in the "
                    f"lowering's op table (ROADMAP A5)")
            if str(node.target) in _ASSERT_OPS:
                continue
            outer, self.b.node = self.b.node, self.prefix + node.name
            try:
                self.env[node] = self.call(node)
            finally:
                self.b.node = outer
        raise LoweringError("graph has no output node")

    def out_array(self, node) -> Array:
        return _array(node.meta["val"])

    def call(self, node) -> Any:
        if node.target is operator.getitem:
            seq, i = node.args
            return self.val(seq)[i]
        if isinstance(node.target, torch._ops.HigherOrderOperator):
            if node.target.name() == "scan":
                return self.lower_scan(node)
            if node.target.name() == "while_loop":
                return self.lower_while(node)
        p = _packet(node)
        args = [self.val(a) for a in node.args]
        kwargs = {k: self.val(v) for k, v in node.kwargs.items()}
        handler = _HANDLERS.get(p)
        if handler is not None:
            return handler(self, node, args, kwargs)
        if p in _BINARY:
            return self.binary(node, _BINARY[p], args, kwargs)
        if p in _COMPARE:
            return self.compare(node, _COMPARE[p], args)
        if p in _LOGICAL:
            return self.binary(node, _LOGICAL[p], args, kwargs)
        if p in _UNARY:
            out = self.out_array(node)
            return self.b.emit(node.name, out, _UNARY[p],
                               [self.b.convert(args[0], out.dtype)])
        if p in _IDENTITY:
            return args[0]
        if p in _VIEWS:
            return self.b.bitcast(args[0], self.out_array(node).dims)
        raise LoweringError(
            f"graph node {node.name}: {node.target} is not in the "
            f"lowering's op table (ROADMAP A5)")

    # -- elementwise -------------------------------------------------------

    def operand(self, a: Any, dtype: str, dims: Sequence[int]) -> str:
        """A tensor value or python scalar as an array of ``dtype`` and
        ``dims``."""
        if isinstance(a, str):
            return self.b.broadcast_to(self.b.convert(a, dtype), dims)
        if isinstance(a, (bool, int, float)):
            return self.b.splat(dtype, a, dims)
        raise LoweringError(f"operand {a!r} of type {type(a).__name__}")

    def binary(self, node, opcode: str, args, kwargs) -> str:
        out = self.out_array(node)
        x, y = args[0], args[1]
        alpha = kwargs.get("alpha", 1)
        if alpha != 1:
            y = self.binary_value("multiply", y, alpha, out)
        return self.b.emit(node.name, out, opcode,
                           [self.operand(x, out.dtype, out.dims),
                            self.operand(y, out.dtype, out.dims)])

    def binary_value(self, opcode: str, x, y, out: Array) -> str:
        return self.b.emit(opcode, out, opcode,
                           [self.operand(x, out.dtype, out.dims),
                            self.operand(y, out.dtype, out.dims)])

    def compare(self, node, direction: str, args) -> str:
        out = self.out_array(node)
        vals = [a.meta["val"] if isinstance(a, torch.fx.Node) else a
                for a in node.args[:2]]
        dt = hlo_dtype(torch.result_type(*vals))
        return self.b.emit(node.name, out, "compare",
                           [self.operand(a, dt, out.dims) for a in args[:2]],
                           [f"direction={direction}"])

    # -- transposes --------------------------------------------------------

    def transpose(self, name: str, perm: Sequence[int]) -> str:
        """``permute``: drop the unit dims, compose with a transpose that
        produced the operand, and emit a bitcast when the non-unit dims
        keep their order."""
        b = self.b
        src = b.shape(name)
        perm = [p % src.rank for p in perm] if src.rank else []
        out_dims = tuple(src.dims[p] for p in perm)
        big = [i for i, d in enumerate(src.dims) if d != 1]
        big_dims = tuple(src.dims[i] for i in big)
        # source dims (as indices into the non-unit dims) in output order
        sq_perm = [big.index(p) for p in perm if src.dims[p] != 1]
        inner = b.defining(b.strip_bitcasts(name))
        if (inner is not None and inner.opcode == "transpose"
                and inner.shape.dims == big_dims):
            p1 = b.perms[inner.name]
            sq_perm = [p1[p] for p in sq_perm]
            base = inner.operands[0]
        else:
            base = b.bitcast(name, big_dims)
        if sq_perm == sorted(sq_perm):
            return b.bitcast(base, out_dims)
        return b.bitcast(b.transpose(base, sq_perm), out_dims)


# ---------------------------------------------------------------------------
# The op table: handlers by ATen op name
# ---------------------------------------------------------------------------


def _dims_arg(dims, rank: int) -> list[int]:
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return sorted({int(d) % rank for d in dims}) if rank else []


def _h_where(L: _GraphLowering, node, args, kwargs):
    out = L.out_array(node)
    pred = L.operand(args[0], "pred", out.dims)
    return L.b.emit(node.name, out, "select",
                    [pred, L.operand(args[1], out.dtype, out.dims),
                     L.operand(args[2], out.dtype, out.dims)])


def _h_pow(L, node, args, kwargs):
    out = L.out_array(node)
    if isinstance(args[0], (int, float)):
        # a scalar base to a tensor power
        return L.b.emit(node.name, out, "power",
                        [L.b.splat(out.dtype, args[0], out.dims),
                         L.b.convert(args[1], out.dtype)])
    x, e = L.b.convert(args[0], out.dtype), args[1]
    if not isinstance(e, (int, float)):
        return L.binary(node, "power", args, kwargs)
    if e == 1:
        return x
    if e in (2, 3):
        # jax's integer_pow: repeated multiplies
        y = L.b.emit(node.name, out, "multiply", [x, x])
        return y if e == 2 else L.b.emit(node.name, out, "multiply", [y, x])
    if e == 0.5:
        return L.b.emit(node.name, out, "sqrt", [x])
    return L.b.emit(node.name, out, "power",
                    [x, L.b.splat(out.dtype, e, out.dims)])


def _h_relu(L, node, args, kwargs):
    out = L.out_array(node)
    return L.b.emit(node.name, out, "maximum",
                    [args[0], L.b.splat(out.dtype, 0, out.dims)])


def _h_gelu(L, node, args, kwargs):
    """``jax.nn.gelu``'s ops: the tanh form
    ``x · ½(1 + tanh(√(2/π)(x + 0.044715 x³)))`` or the exact
    ``x · ½(1 + erf(x/√2))``."""
    out = L.out_array(node)
    b, x = L.b, args[0]

    def c(v):
        return b.splat(out.dtype, v, out.dims)

    if kwargs.get("approximate", "none") == "tanh":
        x3 = b.emit("integer_pow", out, "multiply",
                    [b.emit("integer_pow", out, "multiply", [x, x]), x])
        inner = b.emit("add", out, "add",
                       [x, b.emit("mul", out, "multiply", [x3, c(0.044715)])])
        t = b.emit("tanh", out, "tanh",
                   [b.emit("mul", out, "multiply",
                           [inner, c(math.sqrt(2.0 / math.pi))])])
    else:
        t = b.emit("erf", out, "erf",
                   [b.emit("mul", out, "multiply",
                           [x, c(1.0 / math.sqrt(2.0))])])
    cdf = b.emit("mul", out, "multiply",
                 [b.emit("add", out, "add", [t, c(1.0)]), c(0.5)])
    return b.emit(node.name, out, "multiply", [x, cdf])


def _h_softmax(L, node, args, kwargs):
    """``exp(x - max) / sum(exp(x - max))`` along one dim."""
    out = L.out_array(node)
    b = L.b
    x = b.convert(args[0], out.dtype)
    dim = int(args[1]) % out.rank
    kept = [d for i, d in enumerate(out.dims) if i != dim]
    bdims = [f"dimensions={_ints(i for i in range(out.rank) if i != dim)}"]
    m = b.reduce(x, [dim], "maximum", float("-inf"))
    e = b.emit("exp", out, "exponential",
               [b.emit("sub", out, "subtract",
                       [x, b.emit("broadcast", out, "broadcast", [m], bdims)])])
    s = b.reduce(e, [dim], "add", 0.0)
    assert b.shape(s).dims == tuple(kept)
    return b.emit(node.name, out, "divide",
                  [e, b.emit("broadcast", out, "broadcast", [s], bdims)])


def _h_clamp(L, node, args, kwargs):
    """``clamp`` by scalar bounds: a ``maximum`` then a ``minimum``."""
    out = L.out_array(node)
    lo = args[1] if len(args) > 1 else kwargs.get("min")
    hi = args[2] if len(args) > 2 else kwargs.get("max")
    x = L.b.convert(args[0], out.dtype)
    if lo is not None:
        x = L.binary_value("maximum", x, lo, out)
    if hi is not None:
        x = L.binary_value("minimum", x, hi, out)
    return x


def _h_to_copy(L, node, args, kwargs):
    return L.b.convert(args[0], L.out_array(node).dtype)


def _reduction(kind: str, init: float):
    def handler(L, node, args, kwargs):
        out = L.out_array(node)
        src = L.b.shape(args[0])
        dims = _dims_arg(args[1] if len(args) > 1 else kwargs.get("dim"),
                         src.rank)
        r = L.b.reduce(args[0], dims, kind, init, out.dtype)
        return L.b.bitcast(r, out.dims)     # keepdim
    return handler


def _h_mean(L, node, args, kwargs):
    out = L.out_array(node)
    src = L.b.shape(args[0])
    dims = _dims_arg(args[1] if len(args) > 1 else kwargs.get("dim"),
                     src.rank)
    count = math.prod(src.dims[d] for d in dims)
    r = L.b.reduce(args[0], dims, "add", 0.0, out.dtype)
    r = L.b.emit(node.name, L.b.shape(r), "divide",
                 [r, L.b.splat(out.dtype, count, L.b.shape(r).dims)])
    return L.b.bitcast(r, out.dims)


def _h_permute(L, node, args, kwargs):
    return L.transpose(args[0], args[1])


def _h_t(L, node, args, kwargs):
    rank = L.b.shape(args[0]).rank
    return args[0] if rank < 2 else L.transpose(args[0], [1, 0])


def _h_transpose(L, node, args, kwargs):
    rank = L.b.shape(args[0]).rank
    perm = list(range(rank))
    i, j = int(args[1]) % rank, int(args[2]) % rank
    perm[i], perm[j] = perm[j], perm[i]
    return L.transpose(args[0], perm)


def _h_expand(L, node, args, kwargs):
    return L.b.broadcast_to(args[0], L.out_array(node).dims)


def _h_full(L, node, args, kwargs):
    out = L.out_array(node)
    return L.b.splat(out.dtype, args[1], out.dims)


def _h_scalar_tensor(L, node, args, kwargs):
    return L.b.const(L.out_array(node).dtype, args[0])


def _h_arange(L, node, args, kwargs):
    out = L.out_array(node)
    p = str(node.target)
    if p.endswith(".default"):
        start, step = 0, 1
    else:
        start = args[0]
        step = args[2] if len(args) > 2 else kwargs.get("step", 1)
    r = L.b.emit(node.name, out, "iota", [], ["iota_dimension=0"])
    if step != 1:
        r = L.b.emit("mul", out, "multiply",
                     [r, L.b.splat(out.dtype, step, out.dims)])
    if start != 0:
        r = L.b.emit("add", out, "add",
                     [r, L.b.splat(out.dtype, start, out.dims)])
    return r


def _gather(L, node, table: str, dim: int, ids: str) -> str:
    out = L.out_array(node)
    tshape = L.b.shape(table)
    ishape = L.b.shape(ids)
    if ishape.dtype != "s32":
        raise LoweringError(f"{node.name}: indices of type {ishape.dtype}")
    dim %= tshape.rank
    batch = list(range(dim, dim + ishape.rank))
    offset = [i for i in range(out.rank) if i not in batch]
    sizes = [1 if i == dim else d for i, d in enumerate(tshape.dims)]
    return L.b.emit(node.name, out, "gather", [table, ids], [
        f"offset_dims={_ints(offset)}", f"collapsed_slice_dims={{{dim}}}",
        f"start_index_map={{{dim}}}", f"index_vector_dim={ishape.rank}",
        f"slice_sizes={_ints(sizes)}",
    ])


def _h_index_select(L, node, args, kwargs):
    return _gather(L, node, args[0], int(args[1]), args[2])


def _h_embedding(L, node, args, kwargs):
    return _gather(L, node, args[0], 0, args[1])


def _slice(L, name: str, dim: int, start: int, end: int, step: int = 1,
           base: str = "slice") -> str:
    src = L.b.shape(name)
    dim %= src.rank
    n = src.dims[dim]
    start = max(0, min(n, start + n if start < 0 else start))
    end = max(start, min(n, end + n if end < 0 else end))
    if (start, end, step) == (0, n, 1):
        return name
    spec = []
    for i, d in enumerate(src.dims):
        if i == dim:
            spec.append(f"[{start}:{end}]" if step == 1
                        else f"[{start}:{end}:{step}]")
        else:
            spec.append(f"[0:{d}]")
    dims = list(src.dims)
    dims[dim] = -(-(end - start) // step)
    return L.b.emit(base, Array(src.dtype, tuple(dims)), "slice", [name],
                    ["slice={" + ", ".join(spec) + "}"])


def _h_slice(L, node, args, kwargs):
    dim = args[1] if len(args) > 1 else 0
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    end = args[3] if len(args) > 3 and args[3] is not None else 2 ** 62
    step = args[4] if len(args) > 4 else 1
    return _slice(L, args[0], dim, start, end, step, node.name)


def _h_select(L, node, args, kwargs):
    dim, i = int(args[1]), int(args[2])
    s = _slice(L, args[0], dim, i, i + 1 if i != -1 else 2 ** 62)
    return L.b.bitcast(s, L.out_array(node).dims)


def _split(L, name: str, sizes: Sequence[int], dim: int) -> list[str]:
    out, at = [], 0
    for n in sizes:
        out.append(_slice(L, name, dim, at, at + n))
        at += n
    return out


def _h_split_with_sizes(L, node, args, kwargs):
    dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    return _split(L, args[0], args[1], dim)


def _h_split(L, node, args, kwargs):
    src = L.b.shape(args[0])
    dim = (args[2] if len(args) > 2 else kwargs.get("dim", 0)) % src.rank
    n, size = src.dims[dim], int(args[1])
    return _split(L, args[0], [min(size, n - i) for i in range(0, n, size)],
                  dim)


def _h_cat(L, node, args, kwargs):
    out = L.out_array(node)
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % out.rank
    parts = [L.b.convert(t, out.dtype) for t in args[0]
             if L.b.shape(t).dims[dim] > 0]
    if len(parts) == 1:
        return parts[0]
    return L.b.emit(node.name, out, "concatenate", parts,
                    [f"dimensions={{{dim}}}"])


def _dot_attrs(lb, lc, rb, rc) -> list[str]:
    attrs = []
    if lb:
        attrs.append(f"lhs_batch_dims={_ints(lb)}")
    attrs.append(f"lhs_contracting_dims={_ints(lc)}")
    if rb:
        attrs.append(f"rhs_batch_dims={_ints(rb)}")
    attrs.append(f"rhs_contracting_dims={_ints(rc)}")
    return attrs


def _dot(L, name: str, out: Array, lhs: str, rhs: str, lb, lc, rb, rc):
    d = L.b.emit(name, out, "dot", [lhs, rhs], _dot_attrs(lb, lc, rb, rc))
    L.b.dots[d] = (list(lb), list(lc), list(rb), list(rc))
    return d


def _h_mm(L, node, args, kwargs):
    return _dot(L, node.name, L.out_array(node), args[0], args[1],
                [], [1], [], [0])


def _h_bmm(L, node, args, kwargs):
    return _dot(L, node.name, L.out_array(node), args[0], args[1],
                [0], [2], [0], [1])


def _h_addmm(L, node, args, kwargs):
    out = L.out_array(node)
    beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
    d = _dot(L, f"{node.name}.dot", out, args[1], args[2], [], [1], [], [0])
    if alpha != 1:
        d = L.binary_value("multiply", d, alpha, out)
    bias = L.operand(args[0], out.dtype, out.dims)
    if beta != 1:
        bias = L.binary_value("multiply", bias, beta, out)
    return L.b.emit(node.name, out, "add", [d, bias])


def _window(size, stride=None, lo=None, hi=None, lhs_dilate=None,
            rhs_dilate=None) -> str:
    """XLA's ``window={...}`` text; fields at their defaults are left
    out, as XLA prints them."""
    n = len(size)
    stride = stride or [1] * n
    lo, hi = lo or [0] * n, hi or [0] * n
    parts = [f"size={'x'.join(str(int(k)) for k in size)}"]
    if any(v != 1 for v in stride):
        parts.append(f"stride={'x'.join(str(int(v)) for v in stride)}")
    if any(lo) or any(hi):
        parts.append("pad=" + "x".join(f"{int(a)}_{int(z)}"
                                       for a, z in zip(lo, hi)))
    if lhs_dilate and any(v != 1 for v in lhs_dilate):
        parts.append(f"lhs_dilate={'x'.join(str(int(v)) for v in lhs_dilate)}")
    if rhs_dilate and any(v != 1 for v in rhs_dilate):
        parts.append(f"rhs_dilate={'x'.join(str(int(v)) for v in rhs_dilate)}")
    return "window={" + " ".join(parts) + "}"


def _conv_input(L, x: str, padding) -> tuple[str, list[int], list[int]]:
    """A convolution's input with a zero ``pad`` that produced it folded
    away: ``(operand, lo, hi)`` over the spatial dims, the conv's own
    symmetric ``padding`` added."""
    inner, lo, hi = L.b.unpad(x, 0)
    if lo[:2] != [0, 0] or hi[:2] != [0, 0]:
        inner, lo, hi = x, [0] * len(lo), [0] * len(hi)
    lo = [a + int(p) for a, p in zip(lo[2:], padding)]
    hi = [a + int(p) for a, p in zip(hi[2:], padding)]
    return inner, lo, hi


def _h_convolution(L, node, args, kwargs):
    x, w, bias, stride, padding, dilation, transposed, _, groups = args[:9]
    if transposed:
        raise LoweringError(f"{node.name}: transposed convolution")
    out = L.out_array(node)
    nsp = len(stride)
    sp = "".join(str(i) for i in range(nsp))
    x, lo, hi = _conv_input(L, x, padding)
    attrs = [_window(L.b.shape(w).dims[2:], stride, lo, hi,
                     rhs_dilate=dilation),
             f"dim_labels=bf{sp}_oi{sp}->bf{sp}"]
    if groups != 1:
        attrs.append(f"feature_group_count={groups}")
    c = L.b.emit(node.name if bias is None else f"{node.name}.conv", out,
                 "convolution", [x, w], attrs)
    if bias is None:
        return c
    return L.b.emit(node.name, out, "add",
                    [c, L.b.emit("broadcast", out, "broadcast", [bias],
                                 ["dimensions={1}"])])


def _h_convolution_backward(L, node, args, kwargs):
    """The input and weight gradients XLA writes for the transpose of
    ``conv_general_dilated``: the input gradient a convolution of the
    output gradient, dilated by the stride (``lhs_dilate``), with the
    reversed kernel and its feature dims swapped; the weight gradient a
    convolution of the input with the output gradient as its window,
    dilated by the stride (``rhs_dilate``), batch and feature swapped on
    both sides.  A zero pad in front of the forward convolution is
    folded into both windows, and the input gradient of the padded
    operand is re-padded, so the pad's own backward (a crop) cancels."""
    (grad, x, w, bias_sizes, stride, padding, dilation, transposed,
     _, groups, mask) = args[:11]
    if transposed or groups != 1:
        raise LoweringError(f"{node.name}: transposed or grouped "
                            f"convolution backward")
    b = L.b
    nsp = len(stride)
    sp = "".join(str(i) for i in range(nsp))
    x_in, lo, hi = _conv_input(L, x, padding)
    xs, ws, gs = b.shape(x_in), b.shape(w), b.shape(grad)
    k, n_in, n_out = ws.dims[2:], xs.dims[2:], gs.dims[2:]
    outs: list[Any] = [None, None, None]
    if mask[0]:
        eff = [d * (kk - 1) + 1 for d, kk in zip(dilation, k)]
        lo_i = [e - 1 - a for e, a in zip(eff, lo)]
        hi_i = [n + e - 2 - (m - 1) * s - a for n, e, m, s, a in
                zip(n_in, eff, n_out, stride, lo_i)]
        rev = b.emit("reverse", ws, "reverse", [w],
                     [f"dimensions={_ints(range(2, 2 + nsp))}"])
        gi = b.emit(f"{node.name}.input", xs, "convolution", [grad, rev], [
            _window(k, None, lo_i, hi_i, lhs_dilate=stride,
                    rhs_dilate=dilation),
            f"dim_labels=bf{sp}_io{sp}->bf{sp}"])
        if x_in != x:
            _, plo, phi = b.unpad(x, 0)
            gi = b.pad(gi, plo, phi, 0)
        outs[0] = gi
    if mask[1]:
        hi_w = [(kk - 1) * d + (m - 1) * s + 1 - n - a for kk, d, m, s, n, a
                in zip(k, dilation, n_out, stride, n_in, lo)]
        outs[1] = b.emit(f"{node.name}.weight", ws, "convolution",
                         [x_in, grad], [
            _window(n_out, dilation, lo, hi_w, rhs_dilate=stride),
            f"dim_labels=fb{sp}_io{sp}->fb{sp}"])
    if mask[2]:
        outs[2] = b.reduce(grad, [0, *range(2, 2 + nsp)], "add", 0.0)
    return outs


def _max_pool_window(L, x: str, kernel, stride, padding, dilation,
                     ceil_mode) -> tuple[str, str]:
    """``(operand, window)`` of a 2-d max pool over an NCHW operand, a
    ``-inf`` pad in front of it folded into the window."""
    if ceil_mode or any(d != 1 for d in dilation or [1]):
        raise LoweringError("max pool with ceil_mode or dilation")
    k = list(kernel) * (2 // len(kernel))
    s = list(stride or k) * (2 // len(stride or k))
    p = list(padding or [0]) * (2 // len(padding or [0]))
    inner, lo, hi = L.b.unpad(x, float("-inf"))
    return inner, _window([1, 1, *k], [1, 1, *s],
                          [lo[0], lo[1], lo[2] + p[0], lo[3] + p[1]],
                          [hi[0], hi[1], hi[2] + p[0], hi[3] + p[1]])


def _h_max_pool2d_with_indices(L, node, args, kwargs):
    """``reduce-window`` with a ``maximum`` region; the indices output is
    dropped (its one reader, the backward, takes the operand instead)."""
    x, kernel = args[0], args[1]
    rest = list(args[2:]) + [None] * (5 - len(args[2:]))
    operand, window = _max_pool_window(L, x, kernel, *rest[:4])
    out = _array(node.meta["val"][0])
    b = L.b
    rw = b.emit(node.name, out, "reduce-window",
                [operand, b.const(out.dtype, float("-inf"))],
                [window, f"to_apply=%{b.region('maximum', out.dtype)}"])
    return [rw, None]


def _h_max_pool2d_with_indices_backward(L, node, args, kwargs):
    """``select-and-scatter``: each window's maximum (a ``GE`` select)
    receives the output gradient, summed (an ``add`` scatter)."""
    grad, x, kernel, stride, padding, dilation, ceil_mode = args[:7]
    operand, window = _max_pool_window(L, x, kernel, stride, padding,
                                       dilation, ceil_mode)
    b = L.b
    out = b.shape(operand)
    sas = b.emit(node.name, out, "select-and-scatter",
                 [operand, b.convert(grad, out.dtype),
                  b.const(out.dtype, 0.0)],
                 [window,
                  f"select=%{b.compare_region('GE', out.dtype)}",
                  f"scatter=%{b.region('add', out.dtype)}"])
    if operand != x:
        _, lo, hi = b.unpad(x, float("-inf"))
        sas = b.pad(sas, lo, hi, 0)
    return sas


def _h_constant_pad_nd(L, node, args, kwargs):
    """A pad (a crop where negative): ``pad`` pairs from the last dim
    backwards.  A crop that undoes a ``pad`` returns the pad's operand."""
    x = args[0]
    pads = list(args[1])
    value = args[2] if len(args) > 2 else kwargs.get("value", 0.0)
    b = L.b
    rank = b.shape(x).rank
    lo, hi = [0] * rank, [0] * rank
    for i in range(len(pads) // 2):
        d = rank - 1 - i
        lo[d], hi[d] = int(pads[2 * i]), int(pads[2 * i + 1])
    if max(lo + hi) <= 0:
        info = b.pads.get(x)
        if info is not None and info[1] == [-v for v in lo] and \
                info[2] == [-v for v in hi]:
            return info[0]
        dims = b.shape(x).dims
        for d in range(rank):
            if lo[d] or hi[d]:
                x = _slice(L, x, d, -lo[d], dims[d] + hi[d])
        return x
    if min(lo + hi) < 0:
        raise LoweringError(f"{node.name}: a pad that crops and pads")
    return b.pad(x, lo, hi, value)


def _h_slice_scatter(L, node, args, kwargs):
    """``input`` with ``src`` written over a slice of one dim: ``src``
    itself when it covers the dim, else a ``dynamic-update-slice`` at a
    constant start (steps of 1)."""
    x, src = args[0], args[1]
    dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    start = args[3] if len(args) > 3 else kwargs.get("start")
    step = args[5] if len(args) > 5 else kwargs.get("step", 1)
    out = L.out_array(node)
    dim %= out.rank
    start = 0 if start is None else int(start)
    start = start + out.dims[dim] if start < 0 else start
    if step != 1:
        raise LoweringError(f"{node.name}: slice_scatter with step {step}")
    if L.b.shape(src).dims == out.dims:
        return L.b.convert(src, out.dtype)
    zero = L.b.const("s32", 0)
    starts = [L.b.const("s32", start) if i == dim else zero
              for i in range(out.rank)]
    return L.b.emit(node.name, out, "dynamic-update-slice",
                    [x, L.b.convert(src, out.dtype), *starts])


def _h_var(L, node, args, kwargs):
    """``var.correction``: the mean of the squared deviations from the
    mean (``jnp.var``'s ops), over ``n - correction``."""
    out = L.out_array(node)
    b = L.b
    x = b.convert(args[0], out.dtype)
    src = b.shape(x)
    dims = _dims_arg(args[1] if len(args) > 1 else kwargs.get("dim"),
                     src.rank)
    correction = kwargs.get("correction", 1)
    correction = 1 if correction is None else correction
    n = math.prod(src.dims[d] for d in dims)
    kept = [i for i in range(src.rank) if i not in dims]
    bdims = [f"dimensions={_ints(kept)}"]
    m = b.reduce(x, dims, "add", 0.0)
    m = b.emit("divide", b.shape(m), "divide",
               [m, b.splat(out.dtype, n, b.shape(m).dims)])
    c = b.emit("subtract", src, "subtract",
               [x, b.emit("broadcast", src, "broadcast", [m], bdims)])
    sq = b.reduce(b.emit("multiply", src, "multiply", [c, c]), dims, "add",
                  0.0)
    v = b.emit(node.name, b.shape(sq), "divide",
               [sq, b.splat(out.dtype, n - correction, b.shape(sq).dims)])
    return b.bitcast(v, out.dims)


def _h_log_softmax(L, node, args, kwargs):
    """``x - max - log(sum(exp(x - max)))`` along one dim, as
    ``jax.nn.log_softmax`` writes it."""
    out = L.out_array(node)
    b = L.b
    x = b.convert(args[0], out.dtype)
    dim = int(args[1]) % out.rank
    bdims = [f"dimensions={_ints(i for i in range(out.rank) if i != dim)}"]
    m = b.reduce(x, [dim], "maximum", float("-inf"))
    shifted = b.emit("sub", out, "subtract",
                     [x, b.emit("broadcast", out, "broadcast", [m], bdims)])
    s = b.reduce(b.emit("exp", out, "exponential", [shifted]), [dim], "add",
                 0.0)
    lse = b.emit("log", b.shape(s), "log", [s])
    return b.emit(node.name, out, "subtract",
                  [shifted, b.emit("broadcast", out, "broadcast", [lse],
                                   bdims)])


def _h_log_softmax_backward(L, node, args, kwargs):
    """``g - exp(out) * sum(g)`` along the dim."""
    g, y, dim = args[0], args[1], int(args[2])
    out = L.out_array(node)
    b = L.b
    g, y = b.convert(g, out.dtype), b.convert(y, out.dtype)
    dim %= out.rank
    bdims = [f"dimensions={_ints(i for i in range(out.rank) if i != dim)}"]
    s = b.reduce(g, [dim], "add", 0.0)
    e = b.emit("exp", out, "exponential", [y])
    return b.emit(node.name, out, "subtract", [g, b.emit(
        "mul", out, "multiply",
        [e, b.emit("broadcast", out, "broadcast", [s], bdims)])])


def _full_indices(L, ids: str, dim: int) -> str:
    """``[..., rank]`` start indices of every element of ``ids`` (one per
    operand dim): an ``iota`` over each dim but ``dim``, which takes
    ``ids`` — the gather/scatter indices ``take_along_axis`` writes."""
    b = L.b
    shape = b.shape(ids)
    rank = shape.rank
    col = Array("s32", (*shape.dims, 1))
    parts = []
    for d in range(rank):
        if d == dim:
            parts.append(b.bitcast(b.convert(ids, "s32"), col.dims))
        else:
            parts.append(b.emit("iota", col, "iota", [],
                                [f"iota_dimension={d}"]))
    return b.emit("concatenate", Array("s32", (*shape.dims, rank)),
                  "concatenate", parts, [f"dimensions={{{rank}}}"])


def _h_gather(L, node, args, kwargs):
    """``aten.gather`` (``take_along_axis``): one element per index."""
    x, dim, ids = args[0], int(args[1]), args[2]
    out = L.out_array(node)
    rank = out.rank
    dim %= rank
    starts = _full_indices(L, ids, dim)
    every = _ints(range(rank))
    return L.b.emit(node.name, out, "gather", [x, starts], [
        "offset_dims={}", f"collapsed_slice_dims={every}",
        f"start_index_map={every}", f"index_vector_dim={rank}",
        f"slice_sizes={_ints([1] * rank)}"])


def _h_scatter_add(L, node, args, kwargs):
    """``aten.scatter_add`` (the gradient of ``take_along_axis``): one
    ``scatter`` with an add region."""
    x, dim, ids, src = args[0], int(args[1]), args[2], args[3]
    out = L.out_array(node)
    rank = out.rank
    dim %= rank
    starts = _full_indices(L, ids, dim)
    every = _ints(range(rank))
    b = L.b
    return b.emit(node.name, out, "scatter",
                  [b.convert(x, out.dtype), starts,
                   b.convert(src, out.dtype)], [
                      "update_window_dims={}",
                      f"inserted_window_dims={every}",
                      f"scatter_dims_to_operand_dims={every}",
                      f"index_vector_dim={rank}",
                      f"to_apply=%{b.region('add', out.dtype)}"])


def _h_flash_attention(L, node, args, kwargs):
    tensors = [a for a in args if isinstance(a, str)]
    return L.b.emit(node.name, L.out_array(node), "custom-call", tensors,
                    ['custom_call_target="tpu_custom_call"'])


def _h_dynamic_update_slice(L, node, args, kwargs):
    operand, update, index, dim = args
    out = L.out_array(node)
    zero = L.b.const("s32", 0)
    starts = [index if i == dim % out.rank else zero
              for i in range(out.rank)]
    return L.b.emit(node.name, out, "dynamic-update-slice",
                    [operand, L.b.convert(update, out.dtype), *starts])


def _h_dynamic_index(L, node, args, kwargs):
    """``tpusim_torch::dynamic_index``: a ``dynamic-slice`` of one row of
    dim 0 at a tensor index, bitcast to the row."""
    x, index = args
    b = L.b
    src = b.shape(x)
    sizes = (1, *src.dims[1:])
    zero = b.const("s32", 0)
    ds = b.emit(node.name, Array(src.dtype, sizes), "dynamic-slice",
                [x, b.convert(index, "s32")] + [zero] * (src.rank - 1),
                [f"dynamic_slice_sizes={_ints(sizes)}"])
    return b.bitcast(ds, src.dims[1:])


def _h_flip(L, node, args, kwargs):
    """``flip`` → ``reverse``; a no-op on a reversed scan's outputs."""
    x, dims = args[0], [int(d) % L.b.shape(args[0]).rank for d in args[1]]
    if dims == [0] and x in L.b.unflipped:
        return x
    return L.b.emit(node.name, L.out_array(node), "reverse", [x],
                    [f"dimensions={_ints(sorted(dims))}"])


def _h_scatter_add_rows(L, node, args, kwargs):
    """``tpusim_torch::scatter_add_rows``: a zero table with the update
    rows added at the ids — one ``scatter`` with an add region."""
    grad, ids, rows = args
    out = L.out_array(node)
    b = L.b
    ishape = b.shape(ids)
    zero = b.splat(out.dtype, 0, out.dims)
    return b.emit(node.name, out, "scatter",
                  [zero, ids, b.convert(grad, out.dtype)], [
                      f"update_window_dims={{{ishape.rank}}}",
                      "inserted_window_dims={0}",
                      "scatter_dims_to_operand_dims={0}",
                      f"index_vector_dim={ishape.rank}",
                      f"to_apply=%{b.region('add', out.dtype)}"])


# -- collectives (tpusim_torch.spmd) -----------------------------------------


def _replica_groups(mesh: Sequence[int], axes: Sequence[int]) -> str:
    """XLA's iota form: ``[G,S]<=[N]`` when the group's axes are the mesh's
    minor axes in order, else ``[G,S]<=[m0,m1,..]T(perm)`` with the other
    axes first (e.g. ``[2,2]<=[2,2]T(1,0)``, the strided groups of the
    major axis of a ``(dp, tp)`` mesh)."""
    rest = [i for i in range(len(mesh)) if i not in axes]
    perm = rest + list(axes)
    g = math.prod(mesh[i] for i in rest)
    s = math.prod(mesh[a] for a in axes)
    if perm == sorted(perm):
        return f"replica_groups=[{g},{s}]<=[{math.prod(mesh)}]"
    return (f"replica_groups=[{g},{s}]<=[{','.join(map(str, mesh))}]"
            f"T({','.join(map(str, perm))})")


def _spmd_module(L: _GraphLowering, mesh: Sequence[int]) -> HloModule:
    module = L.b.module
    n = math.prod(mesh)
    if module.num_partitions not in (1, n):
        raise LoweringError(f"collectives over {n} and "
                            f"{module.num_partitions} devices in one module")
    module.num_partitions = n
    return module


def _h_all_reduce(L, node, args, kwargs):
    x, mesh, axes, op = args
    module = _spmd_module(L, mesh)
    out = L.b.shape(x)
    kind = {"sum": "add", "max": "maximum"}[op]
    return L.b.emit(node.name, out, "all-reduce", [x], [
        f"channel_id={module.channel()}", _replica_groups(mesh, axes),
        "use_global_device_ids=true",
        f"to_apply=%{L.b.region(kind, out.dtype)}"])


def _h_all_reduce_coalesced(L, node, args, kwargs):
    xs, mesh, axes = args
    module = _spmd_module(L, mesh)
    shapes = tuple(L.b.shape(x) for x in xs)
    dtypes = {s.dtype for s in shapes}
    if len(dtypes) != 1:
        raise LoweringError(f"{node.name}: one all-reduce over dtypes "
                            f"{sorted(dtypes)}")
    t = L.b.emit(node.name, shapes, "all-reduce", list(xs), [
        f"channel_id={module.channel()}", _replica_groups(mesh, axes),
        "use_global_device_ids=true",
        f"to_apply=%{L.b.region('add', dtypes.pop())}"])
    return [L.b.emit("get-tuple-element", s, "get-tuple-element", [t],
                     [f"index={i}"]) for i, s in enumerate(shapes)]


def _h_all_gather(L, node, args, kwargs):
    x, mesh, axes, dim = args
    module = _spmd_module(L, mesh)
    return L.b.emit(node.name, L.out_array(node), "all-gather", [x], [
        f"channel_id={module.channel()}", _replica_groups(mesh, axes),
        f"dimensions={{{dim}}}", "use_global_device_ids=true"])


def _h_reduce_scatter(L, node, args, kwargs):
    x, mesh, axes, dim = args
    module = _spmd_module(L, mesh)
    out = L.out_array(node)
    return L.b.emit(node.name, out, "reduce-scatter", [x], [
        f"channel_id={module.channel()}", _replica_groups(mesh, axes),
        "use_global_device_ids=true", f"dimensions={{{dim}}}",
        f"to_apply=%{L.b.region('add', out.dtype)}"])


def _h_all_to_all(L, node, args, kwargs):
    """The TPU's array ``all-to-all`` over the split dim (chunk j of the
    split dim goes to the group's j-th member, and the received chunks
    take their places in member order), then the received chunks move
    from the split dim to the concat dim: a bitcast when they are the
    same dim, else a transpose between two bitcasts."""
    x, mesh, axes, split, concat = args
    module = _spmd_module(L, mesh)
    b = L.b
    src = b.shape(x)
    a2a = b.emit(node.name, src, "all-to-all", [x], [
        f"channel_id={module.channel()}", _replica_groups(mesh, axes),
        f"dimensions={{{split}}}"])
    if split == concat:
        return a2a
    g = math.prod(mesh[a] for a in axes)
    dims = list(src.dims)
    parts = dims[:split] + [g, dims[split] // g] + dims[split + 1:]
    # the member dim sits at `split`; move it to just before the concat
    # dim (whose index in `parts` shifts by one when it follows split)
    c = concat + 1 if concat > split else concat
    order = [i for i in range(len(parts)) if i != split]
    at = order.index(c)
    order.insert(at, split)
    moved = L.transpose(b.bitcast(a2a, parts), order)
    return b.bitcast(moved, L.out_array(node).dims)


def _h_collective_permute(L, node, args, kwargs):
    x, mesh, axes, pairs = args
    module = _spmd_module(L, mesh)
    flat = [(grp[s], grp[d]) for grp in groups(mesh, axes)
            for s, d in zip(pairs[0::2], pairs[1::2])]
    text = ",".join(f"{{{s},{d}}}" for s, d in flat)
    return L.b.emit(node.name, L.b.shape(x), "collective-permute", [x], [
        f"channel_id={module.channel()}",
        f"source_target_pairs={{{text}}}"])


def _h_axis_index(L, node, args, kwargs):
    """``partition-id`` and the arithmetic that reads one axis's
    coordinate (or the linear index over several) out of it."""
    _, mesh, axes = args
    _spmd_module(L, mesh)
    b = L.b
    s32 = Array("s32", ())
    pid = b.convert(b.emit("partition-id", Array("u32", ()),
                           "partition-id"), "s32")
    n = math.prod(mesh)
    lin = None
    for a in axes:
        stride = math.prod(mesh[a + 1:])
        c = pid
        if stride > 1:
            c = b.emit("divide", s32, "divide", [c, b.const("s32", stride)])
        if stride * mesh[a] < n:
            c = b.emit("remainder", s32, "remainder",
                       [c, b.const("s32", mesh[a])])
        if lin is None:
            lin = c
        else:
            lin = b.emit("add", s32, "add", [
                b.emit("multiply", s32, "multiply",
                       [lin, b.const("s32", mesh[a])]), c])
    return lin


_HANDLERS = {
    "tpusim_torch::all_reduce": _h_all_reduce,
    "tpusim_torch::all_reduce_coalesced": _h_all_reduce_coalesced,
    "tpusim_torch::all_gather": _h_all_gather,
    "tpusim_torch::reduce_scatter": _h_reduce_scatter,
    "tpusim_torch::all_to_all": _h_all_to_all,
    "tpusim_torch::collective_permute": _h_collective_permute,
    "tpusim_torch::axis_index": _h_axis_index,
    "tpusim_torch::scatter_add_rows": _h_scatter_add_rows,
    "where": _h_where, "pow": _h_pow, "relu": _h_relu, "gelu": _h_gelu,
    "_softmax": _h_softmax, "_to_copy": _h_to_copy, "clamp": _h_clamp,
    "sum": _reduction("add", 0.0), "amax": _reduction("maximum",
                                                      float("-inf")),
    "mean": _h_mean,
    "permute": _h_permute, "t": _h_t, "transpose": _h_transpose,
    "expand": _h_expand, "full": _h_full, "full_like": _h_full,
    "scalar_tensor": _h_scalar_tensor, "arange": _h_arange,
    "index_select": _h_index_select, "embedding": _h_embedding,
    "slice": _h_slice, "select": _h_select,
    "split_with_sizes": _h_split_with_sizes, "split": _h_split,
    "cat": _h_cat, "mm": _h_mm, "_int_mm": _h_mm, "bmm": _h_bmm,
    "addmm": _h_addmm,
    "convolution": _h_convolution,
    "convolution_backward": _h_convolution_backward,
    "max_pool2d_with_indices": _h_max_pool2d_with_indices,
    "max_pool2d_with_indices_backward": _h_max_pool2d_with_indices_backward,
    "constant_pad_nd": _h_constant_pad_nd, "slice_scatter": _h_slice_scatter,
    "var": _h_var, "_log_softmax": _h_log_softmax,
    "_log_softmax_backward_data": _h_log_softmax_backward,
    "gather": _h_gather, "scatter_add": _h_scatter_add,
    "tpusim_torch::flash_attention": _h_flash_attention,
    "tpusim_torch::dynamic_update_slice": _h_dynamic_update_slice,
    "tpusim_torch::dynamic_index": _h_dynamic_index, "flip": _h_flip,
}


# ---------------------------------------------------------------------------
# scan → while
# ---------------------------------------------------------------------------


def _flipped(a) -> Any:
    """The operand of an ``aten.flip(x, [0])`` node, else None."""
    if (isinstance(a, torch.fx.Node) and a.op == "call_function"
            and str(a.target) == "aten.flip.default"
            and list(a.args[1]) in ([0], [-a.args[0].meta["val"].dim()])):
        return a.args[0]
    return None


def _lower_scan(L: _GraphLowering, node) -> list[str]:
    combine, init, xs, additional = node.args[:4]
    if len(node.args) > 4 or node.kwargs:
        raise LoweringError(f"{node.name}: scan with extra arguments")
    gm = L.val(combine)
    init_v = [L.val(a) for a in init]
    # a reversed scan (torch flips its inputs along dim 0, scans, and
    # flips its outputs back): one while reading and writing at n-1-iv,
    # as XLA's transpose of lax.scan does, with no copy of either
    reverse = bool(xs) and all(_flipped(a) is not None for a in xs)
    if reverse:
        xs = [_flipped(a) for a in xs]
    xs_v = [L.val(a) for a in xs]
    add_all = [L.val(a) for a in additional]
    # scalars a scan body closes over (python numbers) stay constants of
    # the body; tensors ride in the carry
    add_v = [a for a in add_all if isinstance(a, str)]
    b, module = L.b, L.b.module
    nc = len(init_v)
    if not xs_v:
        raise LoweringError(f"{node.name}: scan over no inputs")
    n = b.shape(xs_v[0]).dims[0]
    ys_shapes = [_array(v) for v in node.meta["val"][nc:]]
    s32 = Array("s32", ())
    carry = (s32, *(b.shape(v) for v in init_v), *ys_shapes,
             *(b.shape(v) for v in xs_v), *(b.shape(v) for v in add_v))

    # the body: slice the inputs at the induction variable, run the
    # combine graph, write its outputs into the stacked buffers
    body = module.new_computation(f"{node.name}_body")
    body.fusible = True
    bb = _Builder(module, body, b.registry)
    bb.node = b.node
    arg = bb.emit("arg_tuple", carry, "parameter", arg="0")
    gtes = [bb.emit("get-tuple-element", s, "get-tuple-element", [arg],
                    [f"index={i}"]) for i, s in enumerate(carry)]
    iv = gtes[0]
    at = (bb.emit("subtract", s32, "subtract", [bb.const("s32", n - 1), iv])
          if reverse else iv)
    carries = gtes[1:1 + nc]
    bufs = gtes[1 + nc:1 + nc + len(ys_shapes)]
    xs_b = gtes[1 + nc + len(ys_shapes):1 + nc + len(ys_shapes) + len(xs_v)]
    add_b = gtes[1 + nc + len(ys_shapes) + len(xs_v):]
    zero = bb.const("s32", 0)
    slices = []
    for x in xs_b:
        s = bb.shape(x)
        sizes = (1, *s.dims[1:])
        ds = bb.emit("dynamic-slice", Array(s.dtype, sizes), "dynamic-slice",
                     [x, at] + [zero] * (s.rank - 1),
                     [f"dynamic_slice_sizes={_ints(sizes)}"])
        slices.append(bb.bitcast(ds, s.dims[1:]))
    it = iter(add_b)
    add_in = [next(it) if isinstance(a, str) else a for a in add_all]
    outs = L.nested(bb, gm).run([*carries, *slices, *add_in])
    new_bufs = []
    for buf, y in zip(bufs, outs[nc:]):
        s = bb.shape(buf)
        y1 = bb.bitcast(bb.convert(y, s.dtype), (1, *s.dims[1:]))
        new_bufs.append(bb.emit("dynamic-update-slice", s,
                                "dynamic-update-slice",
                                [buf, y1, at] + [zero] * (s.rank - 1)))
    nxt = bb.emit("add", s32, "add", [iv, bb.const("s32", 1)])
    body.root = bb.emit("tuple", carry, "tuple",
                        [nxt, *outs[:nc], *new_bufs, *xs_b, *add_b])

    # the condition: iv < n
    cond = module.new_computation(f"{node.name}_cond")
    cb = _Builder(module, cond)
    cb.node = b.node
    carg = cb.emit("arg_tuple", carry, "parameter", arg="0")
    civ = cb.emit("get-tuple-element", s32, "get-tuple-element", [carg],
                  ["index=0"])
    cond.root = cb.emit("lt", Array("pred", ()), "compare",
                        [civ, cb.const("s32", n)], ["direction=LT"])

    bufs0 = [b.splat(s.dtype, 0, s.dims) for s in ys_shapes]
    init_t = b.emit("tuple", carry, "tuple",
                    [b.const("s32", 0), *init_v, *bufs0, *xs_v, *add_v])
    w = b.emit("while", carry, "while", [init_t], [
        f"condition=%{cond.name}", f"body=%{body.name}",
        'backend_config={"known_trip_count":{"n":"%d"}}' % n,
    ])
    outs = [b.emit("get-tuple-element", carry[1 + i], "get-tuple-element",
                   [w], [f"index={1 + i}"])
            for i in range(nc + len(ys_shapes))]
    if reverse:
        # already in order: the flips torch puts after the scan are no-ops
        b.unflipped.update(outs[nc:])
    return outs


_GraphLowering.lower_scan = _lower_scan


def _lower_while(L: _GraphLowering, node) -> list[str]:
    """``while_loop(cond_fn, body_fn, carried, additional)`` → one
    ``while`` over the tuple ``(*carried, *additional)`` with no
    ``known_trip_count``, as XLA lowers ``lax.while_loop``: the tensors
    the functions close over ride in the carry, unchanged by the body."""
    cond_fn, body_fn, carried, additional = node.args[:4]
    if len(node.args) > 4 or node.kwargs:
        raise LoweringError(f"{node.name}: while_loop with extra arguments")
    cond_gm, body_gm = L.val(cond_fn), L.val(body_fn)
    init_v = [L.val(a) for a in carried]
    add_all = [L.val(a) for a in additional]
    add_v = [a for a in add_all if isinstance(a, str)]
    b, module = L.b, L.b.module
    nc = len(init_v)
    carry = tuple(b.shape(v) for v in (*init_v, *add_v))

    def unpack(bld: _Builder) -> tuple[list[str], list[Any]]:
        arg = bld.emit("arg_tuple", carry, "parameter", arg="0")
        gtes = [bld.emit("get-tuple-element", s, "get-tuple-element", [arg],
                         [f"index={i}"]) for i, s in enumerate(carry)]
        it = iter(gtes[nc:])
        add_in = [next(it) if isinstance(a, str) else a for a in add_all]
        return gtes, [*gtes[:nc], *add_in]

    body = module.new_computation(f"{node.name}_body")
    body.fusible = True
    bb = _Builder(module, body, b.registry)
    bb.node = b.node
    gtes, ins = unpack(bb)
    outs = L.nested(bb, body_gm).run(ins)
    outs = [bb.convert(o, s.dtype) for o, s in zip(outs, carry)]
    body.root = bb.emit("tuple", carry, "tuple", [*outs, *gtes[nc:]])

    cond = module.new_computation(f"{node.name}_cond")
    cond.fusible = True
    cb = _Builder(module, cond, b.registry)
    cb.node = b.node
    _, ins = unpack(cb)
    (pred,) = L.nested(cb, cond_gm, "/cond/").run(ins)
    cond.root = cb.bitcast(pred, ())

    init_t = b.emit("tuple", carry, "tuple", [*init_v, *add_v])
    w = b.emit("while", carry, "while", [init_t], [
        f"condition=%{cond.name}", f"body=%{body.name}"])
    return [b.emit("get-tuple-element", carry[i], "get-tuple-element",
                   [w], [f"index={i}"]) for i in range(nc)]


_GraphLowering.lower_while = _lower_while


# ---------------------------------------------------------------------------
# Transpose folding
# ---------------------------------------------------------------------------


def _rename(comp: Computation, old: str, new: str) -> None:
    for i in comp.instrs:
        i.operands = [new if o == old else o for o in i.operands]
    if comp.root == old:
        comp.root = new


def _fold_transposes(b: _Builder) -> None:
    """Fold transposes into the dots and convolutions that read them, and
    a convolution's lone transposing user into its output labels."""
    comp = b.comp
    # a convolution's users are read before its own turn: the folds done
    # so far touched only instructions ahead of it, none of them its user
    users = comp.users()
    for instr in list(comp.instrs):
        if instr.opcode == "dot":
            lb, lc, rb, rc = b.dots[instr.name]
            dims = [[lb, lc], [rb, rc]]
            for side in (0, 1):
                t = b.defining(instr.operands[side])
                if t is None or t.opcode != "transpose":
                    continue
                perm = b.perms[t.name]
                batch, contr = dims[side]
                free = [i for i in range(len(perm))
                        if i not in batch and i not in contr]
                nb = [perm[i] for i in batch]
                mapped_free = [perm[i] for i in free]
                # keep batch dims leading and free dims in order, or the
                # dot's output order would change
                if nb != list(range(len(nb))) or mapped_free != sorted(
                        mapped_free):
                    continue
                dims[side] = [nb, [perm[i] for i in contr]]
                instr.operands[side] = t.operands[0]
            (lb, lc), (rb, rc) = dims
            b.dots[instr.name] = (lb, lc, rb, rc)
            instr.attrs = _dot_attrs(lb, lc, rb, rc)
        elif instr.opcode == "convolution":
            k = next(j for j, a in enumerate(instr.attrs)
                     if a.startswith("dim_labels="))
            lhs_l, rest = instr.attrs[k][len("dim_labels="):].split("_", 1)
            rhs_l, out_l = rest.split("->")
            labels = [lhs_l, rhs_l]
            for side in (0, 1):
                t = b.defining(instr.operands[side])
                if t is None or t.opcode != "transpose":
                    continue
                perm = b.perms[t.name]
                new = [""] * len(perm)
                for i, p in enumerate(perm):
                    new[p] = labels[side][i]
                labels[side] = "".join(new)
                instr.operands[side] = t.operands[0]
            mine = users[instr.name]
            if len(mine) == 1 and comp.root != instr.name:
                u = b.defining(mine[0])
                if u.opcode == "transpose":
                    perm = b.perms[u.name]
                    out_l = "".join(out_l[p] for p in perm)
                    instr.shape = u.shape
                    _rename(comp, u.name, instr.name)
                    u.operands = []
            instr.attrs[k] = f"dim_labels={labels[0]}_{labels[1]}->{out_l}"
    comp.remove_dead()


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def lower_graph(gm: torch.fx.GraphModule, name: str,
                num_partitions: int = 1) -> tuple[HloModule, list[Any]]:
    """Lower ``gm`` (core ATen ops; placeholders are the module's inputs
    in order) to a fused HLO module.  Returns the module and the graph's
    output values (fake tensors) in order.  ``num_partitions``: the
    devices of an SPMD program, whose collectives must span as many."""
    from tpusim_torch.tracer.fuse import fuse_module

    module = HloModule(name)
    module.num_partitions = num_partitions
    entry = module.new_computation("main", is_entry=True)
    b = _Builder(module, entry)
    params = []
    for i, n in enumerate(x for x in gm.graph.nodes if x.op == "placeholder"):
        val = n.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise LoweringError(f"input {n.name} is not a tensor ({val!r})")
        if val.dtype == torch.int64:
            # an input's memcpy bytes are its own: int64 would not be the
            # s32 the reference's inputs hold
            raise LoweringError(f"input {n.name} is int64; pass int32 "
                                f"indices, as JAX does")
        b.node = n.name
        params.append(b.emit(n.name, _array(val), "parameter", arg=str(i)))
    b.node = None
    outs = _GraphLowering(b, gm).run(params)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    b.node = out_node.name
    leaves = out_node.args[0]
    leaves = list(leaves) if isinstance(leaves, (list, tuple)) else [leaves]
    out_vals = [n.meta["val"] for n in leaves]
    if len(outs) == 1:
        root = outs[0]
        if b.defining(root).opcode == "parameter":
            root = b.emit(f"{root}.copy", b.shape(root), "copy", [root])
        entry.root = root
    else:
        entry.root = b.emit("tuple", tuple(b.shape(o) for o in outs),
                            "tuple", outs)
    for comp in module.computations:
        comp.remove_dead()
    for bld in b.registry:
        if bld.comp.fusible:
            _fold_transposes(bld)
    fuse_module(module)
    return module, out_vals

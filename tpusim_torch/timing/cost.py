"""Per-op / per-fusion cost model.

Port of ``tpusim/timing/cost.py``, the whole ``CostModel``.

The TPU rebuild of the reference's opcode→unit/latency machinery: the
``ISA_Def`` opcode maps (``volta_opcode.h``), the ``trace.config`` latency
tables (``trace_config::set_latency``, ``trace_driven.cc:385-480``), and the
memory coalescer (``warp_inst_t::generate_mem_accesses``,
``abstract_hardware_model.cc:284``).  Where the reference routes each SASS
opcode to SP/DP/INT/SFU/TENSOR pipelines with fixed latencies, we route each
HLO op to MXU/VPU/scalar/transpose/DMA/ICI and compute a roofline time from
its actual shapes:

    cycles = overhead + max(compute_cycles, hbm_bytes / hbm_bytes_per_cycle)

MXU compute time uses a systolic-pass model (fill/drain + streamed rows,
tiles distributed over the MXUs); fusions are costed by walking their called
computations — the analogue of the per-fusion problem called out as the
"hard part" in SURVEY.md §7.
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass, field

from tpusim_torch.ir import (
    Computation,
    FREE_OPCODES,
    ModuleTrace,
    TensorSpec,
    TraceOp,
    Unit,
    dtype_bytes,
    leaves_of,
)
from tpusim_torch.timing.config import ArchConfig

__all__ = ["OpCost", "CostModel", "classify_bound", "dot_dims", "conv_dims",
           "shape_memory_bytes", "while_trip_count"]


# ---------------------------------------------------------------------------
# Opcode categories (the ISA_Def tables)
# ---------------------------------------------------------------------------

TRANSCENDENTAL_OPS = frozenset({
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "sqrt", "rsqrt", "cbrt", "power", "sine", "cosine", "tan", "atan2",
    "erf", "logistic", "divide", "remainder",
})

ELEMENTWISE_OPS = frozenset({
    "add", "subtract", "multiply", "maximum", "minimum", "and", "or", "xor",
    "not", "negate", "abs", "sign", "compare", "select", "clamp", "floor",
    "ceil", "round-nearest-afz", "round-nearest-even", "convert",
    "is-finite", "shift-left", "shift-right-arithmetic",
    "shift-right-logical", "popcnt", "count-leading-zeros", "stochastic-convert",
    "real", "imag", "complex", "map", "reduce-precision",
})

DATA_MOVEMENT_OPS = frozenset({
    "copy", "reshape", "slice", "dynamic-slice", "dynamic-update-slice",
    "concatenate", "pad", "reverse", "broadcast", "iota", "gather",
    "scatter", "set-dimension-size",
})

REDUCE_OPS = frozenset({"reduce", "reduce-window", "select-and-scatter"})

#: XLA:TPU internal custom-calls that are aliasing views or compiler
#: hints — zero device time (all three observed at ~0ns on v5e silicon;
#: the model was charging launch overhead + a full memory roofline)
FREE_CUSTOM_CALL_TARGETS = frozenset({
    "ConcatBitcast", "AllocateBuffer", "AssumeGatherIndicesInBound",
    "Sharding", "SPMDFullToShardShape", "SPMDShardToFullShape",
})

#: ops whose cost is set by the moved region, not the full buffers
_REGION_OPS = frozenset({
    "slice", "dynamic-slice", "dynamic-update-slice", "gather", "scatter",
})

_TRIP_COUNT_RE = re.compile(r'known_trip_count[^0-9]*?(\d+)')
_INDUCTION_RE = re.compile(r'known_induction_variable')

# Mosaic/Pallas custom-call cost estimates in backend_config:
# {"custom_call_config": {"cost_estimate": {"flops": N,
#  "transcendentals": N, "bytes_accessed": N}}}
_CE_FLOPS_RE = re.compile(r'"flops"\s*:\s*"?([0-9.eE+]+)')
_CE_TRANS_RE = re.compile(r'"transcendentals"\s*:\s*"?([0-9.eE+]+)')
_CE_BYTES_RE = re.compile(r'"bytes_accessed"\s*:\s*"?([0-9.eE+]+)')


def _parse_cost_estimate(
    backend_config: str,
) -> tuple[float, float, float] | None:
    """(flops, transcendentals, bytes_accessed) from a Mosaic/Pallas
    ``cost_estimate``, or None when absent."""
    if "cost_estimate" not in backend_config:
        return None
    f = _CE_FLOPS_RE.search(backend_config)
    t = _CE_TRANS_RE.search(backend_config)
    b = _CE_BYTES_RE.search(backend_config)
    if not (f or t or b):
        return None
    return (
        float(f.group(1)) if f else 0.0,
        float(t.group(1)) if t else 0.0,
        float(b.group(1)) if b else 0.0,
    )


# ---------------------------------------------------------------------------
# Structured attr helpers
# ---------------------------------------------------------------------------


def _int_set(attrs: dict[str, str], key: str) -> tuple[int, ...]:
    val = attrs.get(key, "")
    val = val.strip().strip("{}")
    return tuple(int(x) for x in val.split(",") if x.strip())


def dot_dims(
    op: TraceOp, comp: Computation
) -> tuple[int, int, int, int, str]:
    """(batch, M, N, K, dtype) of a dot, from its operand shapes + dims."""
    lhs = _leaf_shape(comp, op.operands[0])
    rhs = _leaf_shape(comp, op.operands[1])
    lc = _int_set(op.attrs, "lhs_contracting_dims")
    rc = _int_set(op.attrs, "rhs_contracting_dims")
    lb = _int_set(op.attrs, "lhs_batch_dims")
    rb = _int_set(op.attrs, "rhs_batch_dims")
    b = math.prod(lhs.shape[i] for i in lb) if lb else 1
    k = math.prod(lhs.shape[i] for i in lc) if lc else 1
    m = math.prod(
        d for i, d in enumerate(lhs.shape) if i not in lc and i not in lb
    ) if lhs.shape else 1
    n = math.prod(
        d for i, d in enumerate(rhs.shape) if i not in rc and i not in rb
    ) if rhs.shape else 1
    return b, m, n, k, lhs.dtype


_WINDOW_FIELD_RES = {
    "size": re.compile(r"size=([0-9x]+)"),
    "stride": re.compile(r"stride=([0-9x]+)"),
    "pad": re.compile(r"pad=([0-9_x\-]+)"),
    "lhs_dilate": re.compile(r"lhs_dilate=([0-9x]+)"),
    "rhs_dilate": re.compile(r"rhs_dilate=([0-9x]+)"),
}


def _parse_window(window: str, ndims: int) -> dict[str, list]:
    """Per-spatial-dim window fields with XLA defaults filled in."""
    out: dict[str, list] = {}
    for key, rx in _WINDOW_FIELD_RES.items():
        m = rx.search(window)
        if not m:
            continue
        if key == "pad":
            pairs = []
            for part in m.group(1).split("x"):
                lo, _, hi = part.partition("_")
                pairs.append((int(lo or 0), int(hi or 0)))
            out[key] = pairs
        else:
            out[key] = [int(d) for d in m.group(1).split("x")]
    n = len(out.get("size", [])) or ndims
    out.setdefault("size", [1] * n)
    out.setdefault("stride", [1] * n)
    out.setdefault("pad", [(0, 0)] * n)
    out.setdefault("lhs_dilate", [1] * n)
    out.setdefault("rhs_dilate", [1] * n)
    return out


def _avg_real_taps(
    in_size: int, out_size: int, k: int, stride: int,
    pad_low: int, lhs_dil: int, rhs_dil: int,
) -> float:
    """Average number of kernel taps per output position that land on a
    *real* input element — i.e. in bounds and not on a dilation hole.

    XLA:TPU lowers batched matmuls to ``convolution-base-dilated`` with
    stride/dilation chosen so each output position touches exactly one real
    element per spatial dim (observed: ``size=4x8 stride=4x8 pad=3_3x7_7
    lhs_dilate=3x7`` on a [4,...,8,...] batch grid).  Charging the full
    ``prod(size)`` kernel there overstates FLOPs 32× (round-3 silicon,
    attention +3169%).  Exact counting prices both true convs (where edge
    padding trims a little) and these degenerate matmul encodings."""
    if k <= 1 or in_size <= 0 or out_size <= 0:
        return 1.0
    if (
        lhs_dil <= 1 and rhs_dil <= 1 and pad_low == 0
        and (out_size - 1) * stride + k <= in_size
    ):
        return float(k)  # interior-only fast path: every tap is real
    # sample output positions when the grid is large; tap pattern is
    # periodic in stride/dilate so a prefix is representative
    sample = range(out_size) if out_size <= 4096 else range(4096)
    total = 0
    for j in sample:
        base = j * stride - pad_low
        for p in range(k):
            pos = base + p * rhs_dil
            if pos < 0:
                continue
            if pos % lhs_dil:
                continue
            if pos // lhs_dil >= in_size:
                continue
            total += 1
    return max(total / len(sample), 1e-6)


def conv_dims(
    op: TraceOp, comp: Computation
) -> tuple[int, int, int, int, str]:
    """Convolution as an implicit matmul: (batch=1, M, N, K, dtype) with
    M = output spatial positions × batch, N = output features,
    K = effective real kernel taps × input features / feature_groups.

    "Effective real taps" counts only kernel positions that hit in-bounds,
    non-dilation-hole input elements (see :func:`_avg_real_taps`) — this is
    what makes XLA's matmul-as-dilated-conv lowering price like the matmul
    it is."""
    rhs = _leaf_shape(comp, op.operands[1])
    lhs = _leaf_shape(comp, op.operands[0])
    out = leaves_of(op.result)[0]
    dim_labels = op.attrs.get("dim_labels", "")
    fgc = int(op.attrs.get("feature_group_count", "1") or 1)
    bgc = int(op.attrs.get("batch_group_count", "1") or 1)

    in_feat = out_feat = None
    lhs_spatial: dict[int, int] = {}
    out_spatial: dict[int, int] = {}
    if "_" in dim_labels and "->" in dim_labels:
        lhs_labels, rest = dim_labels.split("_", 1)
        rhs_labels, out_labels = rest.split("->", 1)
        for pos, ch in enumerate(rhs_labels):
            if ch == "i" and pos < len(rhs.shape):
                in_feat = rhs.shape[pos]
            elif ch == "o" and pos < len(rhs.shape):
                out_feat = rhs.shape[pos]
        for pos, ch in enumerate(lhs_labels):
            if ch.isdigit() and pos < len(lhs.shape):
                lhs_spatial[int(ch)] = lhs.shape[pos]
        for pos, ch in enumerate(out_labels):
            if ch.isdigit() and pos < len(out.shape):
                out_spatial[int(ch)] = out.shape[pos]
    if out_feat is None:
        out_feat = out.shape[-1] if out.shape else 1
    if in_feat is None:
        in_feat = rhs.shape[-2] if len(rhs.shape) >= 2 else 1

    w = _parse_window(op.attrs.get("window", ""), len(lhs_spatial))
    taps = 1.0
    for d, k_sz in enumerate(w["size"]):
        if d not in lhs_spatial or d not in out_spatial:
            # unparseable dim_labels: charge the full kernel extent (the
            # conservative pre-round-4 behavior) rather than collapsing
            # the spatial factor to 1
            taps *= max(float(k_sz), 1.0)
            continue
        taps *= _avg_real_taps(
            lhs_spatial[d], out_spatial[d], k_sz,
            w["stride"][d] if d < len(w["stride"]) else 1,
            w["pad"][d][0] if d < len(w["pad"]) else 0,
            w["lhs_dilate"][d] if d < len(w["lhs_dilate"]) else 1,
            w["rhs_dilate"][d] if d < len(w["rhs_dilate"]) else 1,
        )
    m = max(out.elems // max(out_feat, 1), 1)
    k = max(int(round(taps * in_feat)) // max(fgc * bgc, 1), 1)
    return 1, m, out_feat, k, lhs.dtype


def while_trip_count(op: TraceOp, default: int = 1) -> int:
    """Trip count of a while op, from XLA's ``known_trip_count`` backend
    config when present (lax.scan/fori_loop produce it)."""
    bc = op.attrs.get("backend_config", "")
    m = _TRIP_COUNT_RE.search(bc)
    if m:
        return int(m.group(1))
    return default


def _is_free_custom_call(op: TraceOp) -> bool:
    """XLA:TPU marker custom-calls (aliasing views / compiler hints) —
    zero device time, no memory traffic."""
    return (
        op.base == "custom-call"
        and op.attrs.get("custom_call_target", "").strip('"')
        in FREE_CUSTOM_CALL_TARGETS
    )


def _result_leaf(op: TraceOp) -> TensorSpec | None:
    """Largest leaf of an op's result (the shape a VPU op iterates)."""
    leaves = leaves_of(op.result)
    if not leaves:
        return None
    return max(leaves, key=lambda l: l.nbytes)


def _leaf_shape(comp: Computation, operand: str) -> TensorSpec:
    """Resolve an operand name to its (first leaf) TensorSpec."""
    if comp.has_op(operand):
        leaves = leaves_of(comp.op(operand).result)
        if leaves:
            return leaves[0]
    return TensorSpec("f32", ())


def _operand_bytes(comp: Computation, op: TraceOp) -> int:
    total = 0
    seen = set()
    for name in op.operands:
        if name in seen:
            continue
        seen.add(name)
        if comp.has_op(name):
            total += comp.op(name).result.nbytes
    return total


def _region_bytes(comp: Computation, op: TraceOp) -> float:
    """Bytes actually moved by a slice-like op: read + write of the
    region.  For dynamic-update-slice the region is the update operand;
    for the others it's the result."""
    if op.base == "dynamic-update-slice" and len(op.operands) >= 2:
        region = _leaf_shape(comp, op.operands[1]).nbytes
    else:
        region = sum(l.nbytes for l in leaves_of(op.result))
    return 2.0 * region


def _fusion_param_region_bytes(
    called: Computation,
) -> dict[int, float]:
    """For a fused computation, map parameter index → bytes actually read,
    for parameters consumed ONLY through slice-like ops.  Scanned loop
    bodies fuse ``dynamic-slice(stacked_weights, iv)`` — charging the full
    stacked tensor would overstate a per-layer read by the layer count."""
    consumers: dict[str, list[TraceOp]] = {}
    for inner in called.ops:
        for o in inner.operands:
            consumers.setdefault(o, []).append(inner)
    out: dict[int, float] = {}
    for pop in called.ops:
        if pop.opcode != "parameter":
            continue
        try:
            idx = int(pop.attrs.get("param_index", ""))
        except ValueError:
            continue
        cons = consumers.get(pop.name, [])
        if cons and all(c.base in _REGION_OPS for c in cons):
            # _region_bytes counts read+write of the moved region; the
            # parameter side contributes the read half
            out[idx] = float(sum(
                _region_bytes(called, c) / 2.0 for c in cons
            ))
    return out


_CHASE_THROUGH = ("bitcast", "bitcast-convert", "copy", "convert", "reshape")


def _is_relayout(src: TensorSpec | None, dst: TensorSpec | None) -> bool:
    """True when a copy physically rearranges data.  A missing layout
    annotation means default minor-to-major, so ``None`` must compare
    equal to the explicit default (and an unannotated tiling must not
    make a plain copy look like a transpose)."""
    if src is None or dst is None:
        return False
    default = tuple(range(len(src.shape) - 1, -1, -1))
    src_layout = src.layout if src.layout is not None else default
    dst_layout = dst.layout if dst.layout is not None else (
        tuple(range(len(dst.shape) - 1, -1, -1))
    )
    if src_layout != dst_layout:
        return True
    if src.tiling is None or dst.tiling is None:
        return False
    return src.tiling != dst.tiling


def _minor_dim_size(spec: TensorSpec) -> int:
    """Size of the minor-most (lane) dimension under the buffer's layout
    (layout tuples are minor-to-major; absent layout = default)."""
    if not spec.shape:
        return 0
    minor = spec.layout[0] if spec.layout else len(spec.shape) - 1
    if 0 <= minor < len(spec.shape):
        return int(spec.shape[minor])
    return 0


def _is_lane_preserving_relayout(
    src: TensorSpec | None, dst: TensorSpec | None,
) -> bool:
    """A relayout whose minor dims are dense multiples of the 128-lane
    tile on BOTH sides only reorders whole tiles (contiguous 256B+ runs
    for bf16) — it streams near plain-copy rate, unlike a sub-lane
    shuffle that gathers at element granularity.  A tiling (packing)
    change shuffles elements WITHIN sublanes regardless of dim sizes —
    always the slow class."""
    if src is None or dst is None:
        return False
    if src.tiling != dst.tiling:
        return False
    s, d = _minor_dim_size(src), _minor_dim_size(dst)
    return s > 0 and d > 0 and s % 128 == 0 and d % 128 == 0


def _is_movement_fusion(module: ModuleTrace, comp_name: str) -> bool:
    """True when a fused computation contains only data-movement ops
    (slice/DUS/concat/copy/...) — it is a DMA-style move, not compute."""
    if comp_name not in module.computations:
        return False
    comp = module.computation(comp_name)
    cached = getattr(comp, "_is_movement_cache", None)
    if cached is not None:
        return cached
    ok = True
    for inner in comp.ops:
        if inner.opcode in FREE_OPCODES or inner.base in FREE_OPCODES:
            continue
        if inner.base not in DATA_MOVEMENT_OPS:
            ok = False
            break
    try:
        comp._is_movement_cache = ok
    except (AttributeError, TypeError):
        pass
    return ok


def _fusion_dus_views(
    called: Computation,
) -> tuple[float | None, dict[int, float]]:
    """One walk over a fused computation's root elements producing both
    DUS-aliasing views:

    * a RESULT write cap — if any output is a dynamic-update-slice into a
      carried buffer (the activation-stash pattern in scanned training
      loops), the written bytes are the update region, siblings in a
      mixed tuple (the lstm cell's ``(stash, h, c)``) their own full
      size, and parameter pass-throughs zero.  ``None`` when no DUS (and
      not all-aliased): no cap applies — EXCEPT the all-passthrough case
      (every element a parameter alias), which caps at 0.0 exactly as it
      did before DUS handling existed.
    * PARAM read caps — XLA aliases a DUS's destination operand onto the
      output: the kernel reads the update region (tile-granular RMW),
      not the whole carried buffer (lstm: a 128KB update into an 8.4MB
      carry read +219% before).  A parameter is only capped when ALL its
      consumers are on the DUS-destination chase chain — a sibling op
      reading the full buffer (e.g. ``(dus(p0, upd), reduce(p0))``)
      keeps the full charge."""
    root = called.root
    elements = [root]
    if root.base == "tuple":
        elements = [
            called.op(o) for o in root.operands if called.has_op(o)
        ]

    consumers: dict[str, set[str]] = {}
    for inner in called.ops:
        for o in inner.operands:
            consumers.setdefault(o, set()).add(inner.name)

    total = 0.0
    found_dus = False
    found_other = False
    param_caps: dict[int, float] = {}
    for el in elements:
        seen = 0
        while el.base in _CHASE_THROUGH and el.operands and seen < 8:
            if not called.has_op(el.operands[0]):
                break
            el = called.op(el.operands[0])
            seen += 1
        if el.base == "dynamic-update-slice" and len(el.operands) >= 2:
            region = float(_leaf_shape(called, el.operands[1]).nbytes)
            total += region
            found_dus = True
            # chase the DUS destination back to the fusion parameter it
            # aliases (possibly through bitcasts), remembering the chain
            chain = {el.name}
            dest = el.operands[0]
            hops = 0
            while called.has_op(dest) and hops < 8:
                dop = called.op(dest)
                if dop.opcode == "parameter":
                    try:
                        idx = int(dop.attrs.get("param_index", ""))
                    except ValueError:
                        break
                    if consumers.get(dop.name, set()) <= chain:
                        param_caps[idx] = min(
                            param_caps.get(idx, float("inf")), region
                        )
                    break
                if dop.base in _CHASE_THROUGH and dop.operands:
                    # every intermediate view on the chase chain must be
                    # consumed only by the chain itself: a bitcast that
                    # also feeds a sibling (e.g. ``reduce(bitcast(p0))``)
                    # means the kernel reads the FULL buffer through that
                    # sibling, and capping the parameter at the update
                    # region would hide the traffic
                    if not consumers.get(dop.name, set()) <= chain:
                        break
                    chain.add(dop.name)
                    dest = dop.operands[0]
                    hops += 1
                else:
                    break
        elif el.opcode == "parameter":
            continue  # pass-through alias, no write
        else:
            # computed output: its own full size (caps to identity when
            # it stands beside a DUS in a mixed tuple)
            total += float(sum(l.nbytes for l in leaves_of(el.result)))
            found_other = True
    if found_dus or not found_other:
        return total, param_caps
    return None, param_caps


#: a "small" standalone kernel: moved region up to 32KB — eight (8,128)
#: f32 tiles — or a (near-)scalar result.  (The 2x factor at the use
#: site mirrors the read+write doubling ``_region_bytes`` applies, so
#: the cutoff is on the ONE-SIDED region.)  The fixture evidence
#: brackets the band rather than sampling inside it: [1,1] slices ran
#: 229-567ns and the lstm 8KB loop copies 1.57us on v5e — all
#: launch/latency-dominated — and even a 32KB-region move at stream
#: rate (~64KB of traffic / ~1100 B/cy ~= 60 cycles) sits far below the
#: ~700-cycle dispatch floor, so the floor is the binding price through
#: the whole band; the ``max`` in the floor application keeps genuinely
#: streaming-bound kernels roofline-priced.  No committed fixture row
#: falls between 8KB and 32KB to discriminate further — revisit when
#: one lands.
_SMALL_KERNEL_REGION_BYTES = 32 * 1024
_SMALL_KERNEL_RESULT_BYTES = 1024


def _is_small_standalone_kernel(op: TraceOp, comp: Computation) -> bool:
    """Sub-tile data movement (bare slice/DS/DUS) or a (near-)scalar
    reduce/fusion: kernels whose device duration is dominated by the
    fixed dispatch floor, not the roofline (v5e: [1,1] slices 229-567ns,
    scalar reduce-fusion 329ns, one-row DUS 594ns vs a ~5ns roofline)."""
    if op.base in ("slice", "dynamic-slice", "dynamic-update-slice"):
        return _region_bytes(comp, op) <= 2.0 * _SMALL_KERNEL_REGION_BYTES
    if op.base in ("fusion", "reduce"):
        return (
            sum(l.nbytes for l in leaves_of(op.result))
            <= _SMALL_KERNEL_RESULT_BYTES
        )
    return False


def _memory_bytes(
    comp: Computation,
    op: TraceOp,
    module: ModuleTrace | None = None,
) -> tuple[float, float]:
    """(hbm_bytes, vmem_bytes) touched by one op: operands + result, split
    by the layout's memory space.  XLA:TPU marks vmem-pinned buffers with
    ``S(1)`` in the layout (observed on loop carries XLA keeps resident in
    the 128MB vmem); default space 0 is HBM.  For fusions, parameters that
    are only sliced inside are charged at the sliced size."""
    hbm = 0.0
    vmem = 0.0
    seen = set()

    region_by_index: dict[int, float] = {}
    result_cap: float | None = None
    if op.base == "fusion" and op.called and module is not None:
        if op.called[0] in module.computations:
            called = module.computation(op.called[0])
            region_by_index = _fusion_param_region_bytes(called)
            result_cap, dus_caps = _fusion_dus_views(called)
            for idx, cap in dus_caps.items():
                prev = region_by_index.get(idx)
                region_by_index[idx] = (
                    cap if prev is None else min(prev, cap)
                )

    def account(spec, cap: float | None = None) -> None:
        nonlocal hbm, vmem
        total = sum(l.nbytes for l in leaves_of(spec))
        scale = 1.0
        if cap is not None and total > 0:
            scale = min(cap / total, 1.0)
        for leaf in leaves_of(spec):
            if leaf.memory_space != 0:
                vmem += leaf.nbytes * scale
            else:
                hbm += leaf.nbytes * scale

    for i, name in enumerate(op.operands):
        if name in seen or not comp.has_op(name):
            continue
        seen.add(name)
        account(comp.op(name).result, region_by_index.get(i))
    account(op.result, result_cap)
    return hbm, vmem


def shape_memory_bytes(
    comp: Computation,
    op: TraceOp,
    module: ModuleTrace | None = None,
) -> tuple[float, float]:
    """Public view of the operand+result byte accounting: the
    ``(hbm_bytes, vmem_bytes)`` an op's *shapes* imply, before any
    kernel-declared ``cost_estimate`` override or region capping.  The
    perf analyzer (:mod:`tpusim_torch.analysis.critpath`) compares this
    shape-derived traffic against the priced traffic to catch kernels
    whose own accounting contradicts their roofline (TL503)."""
    return _memory_bytes(comp, op, module)


# ---------------------------------------------------------------------------
# Cost record
# ---------------------------------------------------------------------------


@dataclass
class OpCost:
    """Timing + accounting for one scheduled op."""

    cycles: float = 0.0
    compute_cycles: float = 0.0
    mem_cycles: float = 0.0
    unit: Unit = Unit.NONE
    flops: float = 0.0
    mxu_flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    vmem_bytes: float = 0.0
    ici_bytes: float = 0.0
    is_async: bool = False
    #: achieved-rate scale factors per memory port (copies/relayouts/
    #: movement fusions run below the streaming roofline); every
    #: mem_cycles computation — including the engine's spill and
    #: contention repricing — must honor them
    hbm_rate_scale: float = 1.0
    vmem_rate_scale: float = 1.0
    #: bytes_accessed from a kernel's own cost estimate (-1 = none)
    est_bytes: float = -1.0
    #: True when a recursion-depth cutoff clipped part of this total —
    #: such totals are incomplete and must not be memoized
    truncated: bool = False

    def add_compute(self, other: "OpCost") -> None:
        self.compute_cycles += other.compute_cycles
        self.flops += other.flops
        self.mxu_flops += other.mxu_flops
        self.transcendentals += other.transcendentals
        self.truncated = self.truncated or other.truncated


def classify_bound(cost: OpCost, arch: ArchConfig) -> str:
    """Roofline classification of one priced op from the cost model's own
    term breakdown: which resource pins the op's cycles.

    Returns one of ``"ici"`` (collective), ``"none"`` (free), ``"hbm"`` /
    ``"vmem"`` (memory-bound, split by which port's stream time won the
    roofline max), ``"mxu"`` / ``"vpu"`` (compute-bound, split by unit),
    or ``"overhead"`` (issue overhead dominates both terms).  This is the
    term arithmetic the engine itself prices with — the perf analyzer's
    TL503 roofline check must not re-derive it differently."""
    if cost.unit is Unit.ICI:
        return "ici"
    if cost.cycles <= 0:
        return "none"
    if cost.mem_cycles > cost.compute_cycles:
        hbm_t = cost.hbm_bytes / (
            arch.hbm_bytes_per_cycle * max(cost.hbm_rate_scale, 1e-6)
        )
        vmem_t = cost.vmem_bytes / (
            arch.vmem_bytes_per_cycle * max(cost.vmem_rate_scale, 1e-6)
        )
        return "hbm" if hbm_t >= vmem_t else "vmem"
    if cost.compute_cycles > 0:
        return "mxu" if (cost.mxu_flops > 0 or cost.unit is Unit.MXU) else "vpu"
    return "overhead"


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@dataclass
class CostModel:
    arch: ArchConfig
    #: per-custom-call-target achieved-FLOP/s override (e.g. pallas kernels)
    custom_call_flops: dict[str, float] = field(default_factory=dict)
    #: unique, never-reused token for this model instance — fusion-cost
    #: cache keys use it so entries can't alias across models with
    #: different arch parameters (an id() would be reusable after GC).
    #: init=False/compare=False: dataclasses.replace/copy must mint a
    #: fresh token, and tokens must not break CostModel equality
    _cache_token: int = field(
        default_factory=itertools.count().__next__,
        init=False, compare=False, repr=False,
    )

    # -- MXU systolic-pass model ------------------------------------------

    def _normalize_matmul_dtype(
        self, dt: str, module: "ModuleTrace | None",
    ) -> str:
        """Undo the capture backend's float normalization for MXU pricing.

        AOT capture on the CPU mesh (the only option for ahead-of-silicon
        multi-chip graphs) runs XLA:CPU's FloatNormalization pass, which
        upcasts every bf16 dot/conv to f32 — pricing those at the f32
        multi-pass rate (0.25x) read a Llama-7B train step at 3.5% MFU.
        On TPU the same program keeps bf16 MXU operands with f32
        accumulation at full rate.  When a CPU-captured module's entry
        parameters are predominantly sub-f32 (the model's declared
        compute dtype) and a matmul reads f32, price it at the
        parameter dtype.  Gated on the capture platform: a TPU-captured
        trace's f32 dot is a genuine precision choice (e.g. an f32
        logits matmul) and keeps the f32 multi-pass rate."""
        if dt != "f32" or module is None:
            return dt
        if module.meta.get("platform") not in ("cpu", "interpreter"):
            return dt
        cached = getattr(module, "_param_dtype_cache", None)
        if cached is None:
            by_dtype: dict[str, float] = {}
            entry = module.entry if module.entry_name else None
            if entry is not None:
                for op in entry.ops:
                    if op.opcode != "parameter":
                        continue
                    for leaf in leaves_of(op.result):
                        by_dtype[leaf.dtype] = (
                            by_dtype.get(leaf.dtype, 0.0) + leaf.nbytes
                        )
            total = sum(by_dtype.values())
            major = max(by_dtype, key=by_dtype.get) if by_dtype else ""
            cached = (
                major
                if total > 0 and by_dtype.get(major, 0) > 0.5 * total
                else ""
            )
            try:
                module._param_dtype_cache = cached
            except (AttributeError, TypeError):
                pass
        if cached in ("bf16", "f16", "bfloat16", "float16"):
            return cached
        return dt

    def mxu_cycles(self, b: int, m: int, n: int, k: int, dtype: str) -> float:
        """Cycles for a (possibly batched) matmul on the MXU array.

        The K dimension maps to the systolic rows, N to the columns, M rows
        stream through; tiles are distributed across the ``mxu_count``
        arrays.  Weight tiles double-buffer: pass i+1's weights load while
        pass i streams, so consecutive passes pipeline and the fill/drain
        latency is paid once per op, not once per pass — charging it per
        pass overstated small-m matmuls 2.4x (lstm_layer round-3 silicon,
        +138%).  What survives per pass is the weight-load floor: a pass
        cannot retire faster than its successor's tile loads
        (``mxu_weight_stall_cycles``) — this is what makes small matmuls
        MXU-inefficient, the analogue of the reference's tensor-core
        initiation intervals (``trace.config`` tensor 2,2)."""
        a = self.arch
        passes = b * math.ceil(k / a.mxu_rows) * math.ceil(n / a.mxu_cols)
        m_pad = max(8, math.ceil(m / 8) * 8)
        # two ways to spread the work over the arrays; XLA picks per shape:
        # (a) whole passes to different MXUs — best when passes >> count
        #     and m is small (each MXU loads a fraction of the tiles);
        # (b) split the streamed rows — every MXU runs all passes on an
        #     m/count chunk, which avoids the ceil(passes/count)
        #     quantization that overstated a 5-pass conv on 4 MXUs by 1.6x
        serial_a = math.ceil(passes / a.mxu_count) * max(
            m_pad, a.mxu_weight_stall_cycles
        )
        m_chunk = max(8, math.ceil(m_pad / a.mxu_count / 8) * 8)
        serial_b = passes * max(m_chunk, a.mxu_weight_stall_cycles)
        serial = min(serial_a, serial_b)
        return (serial + a.mxu_fill_cycles) / max(
            a.mxu_dtype_mult(dtype) * a.mxu_efficiency, 1e-6
        )

    def _vpu_cycles(
        self, elem_ops: float, transcendentals: float, util: float = 1.0,
    ) -> float:
        a = self.arch
        util = max(util, 1e-3)
        return (
            elem_ops / (a.vpu_flops_per_cycle * util)
            + transcendentals / (a.vpu_transcendental_per_cycle * util)
        )

    def _vpu_util(self, spec: TensorSpec | None) -> float:
        """Lane/sublane occupancy of a VPU op on this operand/result shape.

        The (8,128) vector registers map the two minor-most dims to
        (sublane, lane); a narrow minor dim strands lanes — decode's
        [8,1024,8] softmax stages run at ~1/16 throughput on silicon
        because dim 8 sits in the 128-lane position.  Bulk shapes
        (minor >= 128) are unaffected."""
        if spec is None or not spec.shape:
            return 1.0
        order = (
            spec.layout if spec.layout is not None
            else tuple(range(spec.rank - 1, -1, -1))
        )
        if not order:
            return 1.0
        lanes = float(self.arch.vpu_lanes)
        subl = float(self.arch.vpu_sublanes)
        if order[0] >= spec.rank:
            return 1.0  # malformed layout: stay neutral, don't penalize
        util = min(1.0, spec.shape[order[0]] / lanes)
        if len(order) > 1 and order[1] < spec.rank:
            util *= min(1.0, spec.shape[order[1]] / subl)
        return util

    # -- per-op compute cost (no memory term) ------------------------------

    def _compute_cost(self, op: TraceOp, comp: Computation,
                      module: ModuleTrace, depth: int = 0) -> OpCost:
        c = OpCost()
        base = op.base
        out_elems = op.result.elems

        if base in FREE_OPCODES or op.opcode in FREE_OPCODES:
            return c

        if base == "dot":
            b, m, n, k, dt = dot_dims(op, comp)
            dt = self._normalize_matmul_dtype(dt, module)
            c.compute_cycles = self.mxu_cycles(b, m, n, k, dt)
            c.flops = c.mxu_flops = 2.0 * b * m * n * k
            c.unit = Unit.MXU
        elif base == "convolution":
            b, m, n, k, dt = conv_dims(op, comp)
            dt = self._normalize_matmul_dtype(dt, module)
            c.compute_cycles = self.mxu_cycles(b, m, n, k, dt)
            w = _parse_window(op.attrs.get("window", ""), 0)
            if any(s > 1 for s in w["size"]) and not any(
                d > 1 for d in w["lhs_dilate"]
            ):
                # a true spatial conv (not XLA's matmul-as-dilated-conv
                # encoding) pays the window emitter's im2col overhead
                c.compute_cycles /= max(
                    self.arch.mxu_conv_tap_efficiency, 1e-6
                )
            c.flops = c.mxu_flops = 2.0 * b * m * n * k
            c.unit = Unit.MXU
        elif base == "fusion" and op.called:
            inner = self.fused_compute_cost(module, op.called[0], depth + 1)
            c.add_compute(inner)
            c.unit = Unit.MXU if inner.mxu_flops > 0 else Unit.VPU
        elif base in TRANSCENDENTAL_OPS:
            c.transcendentals = float(out_elems)
            c.flops = float(out_elems)
            c.compute_cycles = self._vpu_cycles(
                0, c.transcendentals, self._vpu_util(_result_leaf(op)),
            )
            c.unit = Unit.VPU
        elif base in ELEMENTWISE_OPS:
            c.flops = float(out_elems)
            c.compute_cycles = self._vpu_cycles(
                c.flops, 0, self._vpu_util(_result_leaf(op)),
            )
            c.unit = Unit.VPU
        elif base in REDUCE_OPS:
            in_elems = sum(
                _leaf_shape(comp, o).elems for o in op.operands[:1]
            )
            if base == "reduce-window":
                # a windowed reduction streams in O(max(in, out)) work —
                # hardware/XLA keep running extrema/sums; charging
                # in_elems × window_elems priced a 1024-wide softmax max
                # at ~17M fictitious cycles (round-3 silicon, VERDICT #3a)
                c.flops = float(max(in_elems, out_elems))
                slowdown = 1.0
            else:
                c.flops = float(in_elems)
                # the VPU accumulates packed words, so the per-element
                # reduce cost scales with dtype width (v5e silicon:
                # f32 2D-sum at 9.2x elementwise rate, bf16 row-sum at
                # 4.6x); reducing the minor (lane) dimension additionally
                # pays a per-output lane-shuffle tail (decode fixture:
                # a [.,128]->[.] GEMV-style reduce at ~0.7 cy/output)
                spec = (
                    _leaf_shape(comp, op.operands[0]) if op.operands
                    else op.result if isinstance(op.result, TensorSpec)
                    else None
                )
                dt_scale = (
                    dtype_bytes(spec.dtype) / 4.0
                    if spec is not None and spec.dtype else 1.0
                )
                slowdown = self.arch.vpu_reduce_slowdown * dt_scale
                dims = _int_set(op.attrs, "dimensions")
                if dims and spec is not None:
                    minor = (
                        spec.layout[0] if spec.layout
                        else max(spec.rank - 1, 0)
                    )
                    if minor in dims:
                        # lane-dim reduce: within-tile lane shuffle
                        # (decode fixture, extent 128: ~0.7 cy/output),
                        # plus one tree-combine step per doubling of the
                        # lane TILES crossed.  The tree term is the
                        # standard reduction-tree extrapolation — no
                        # committed fixture row exercises extent > 128
                        # yet; the reduce_lane_wide ubench exists to pin
                        # it on the next live run
                        lanes = max(int(self.arch.vpu_lanes), 1)
                        extent = (
                            spec.shape[minor]
                            if minor < len(spec.shape) else lanes
                        )
                        tiles = max(1, -(-int(extent) // lanes))
                        factor = 1.0 + math.ceil(math.log2(tiles))
                        c.compute_cycles += (
                            out_elems
                            * self.arch.vpu_lane_cross_cycles
                            * factor
                        )
            util = self._vpu_util(
                _leaf_shape(comp, op.operands[0]) if op.operands else None
            )
            c.compute_cycles += self._vpu_cycles(c.flops * slowdown, 0, util)
            c.unit = Unit.VPU
        elif base == "transpose":
            c.unit = Unit.TRANSPOSE
            # handled by memory term; transpose unit streams at vector rate
            c.compute_cycles = out_elems / self.arch.vpu_flops_per_cycle
        elif base in DATA_MOVEMENT_OPS:
            c.unit = Unit.DMA
            if base == "gather":
                # gathered rows pay a per-descriptor cost the streaming
                # roofline can't see; recorded as compute so the charge
                # survives fusion aggregation (the gather usually lives
                # inside a fusion whose memory term is operand-level)
                slice_elems = 1
                for d in _int_set(op.attrs, "slice_sizes"):
                    slice_elems *= max(d, 1)
                if slice_elems > 0 and out_elems > 0:
                    rows = max(out_elems // slice_elems, 1)
                    c.compute_cycles = (
                        rows * float(self.arch.gather_row_overhead_cycles)
                    )
            elif base == "scatter" and len(op.operands) >= 2:
                # a scatter's row count is its INDEX count — the result
                # is the whole table, and pricing a descriptor per table
                # element made a llama-7b embedding-gradient scatter
                # read 271ms (should be ~1ms: 16K rows, not 16M elems).
                # Operand order is (op_0..op_{N-1}, indices,
                # upd_0..upd_{N-1}), so the indices sit at the midpoint
                # for ANY variadic arity; verify by integer dtype
                idx_pos = (len(op.operands) - 1) // 2
                idx = _leaf_shape(comp, op.operands[idx_pos])
                if not idx.dtype.startswith(("s", "u")):
                    for o in op.operands:
                        cand = _leaf_shape(comp, o)
                        if cand.dtype.startswith(("s", "u")):
                            idx = cand
                            break
                rows = 1
                for d in idx.shape:
                    rows *= max(int(d), 1)
                # the index-vector dim enumerates COORDINATES of one row,
                # not rows: divide it out.  HLO records it explicitly
                # (``index_vector_dim=K``); K == rank means every element
                # is a scalar row index and nothing is divided out.  Only
                # when the attr is absent fall back to assuming the
                # trailing dim is the coordinate vector.
                try:
                    ivd = int(op.attrs.get("index_vector_dim", ""))
                except ValueError:
                    ivd = -1 if idx.rank >= 2 else None
                if ivd is not None and -idx.rank <= ivd < idx.rank:
                    rows //= max(int(idx.shape[ivd]), 1)
                c.compute_cycles = (
                    max(rows, 1)
                    * float(self.arch.gather_row_overhead_cycles)
                )
        elif base == "sort":
            n_el = float(max(out_elems, 2))
            c.flops = n_el * math.log2(n_el) * 4.0
            c.compute_cycles = self._vpu_cycles(c.flops, 0)
            c.unit = Unit.VPU
        elif base in ("rng", "rng-bit-generator", "rng-get-and-update-state"):
            c.flops = float(out_elems) * 8.0
            c.compute_cycles = self._vpu_cycles(c.flops, 0)
            c.unit = Unit.VPU
        elif base == "custom-call":
            if _is_free_custom_call(op):
                return c
            target = op.attrs.get("custom_call_target", "").strip('"')
            rate = self.custom_call_flops.get(target)
            est = _parse_cost_estimate(op.attrs.get("backend_config", ""))
            if rate and rate > 0:
                # caller recorded achieved FLOP/s for this kernel target
                c.flops = float(out_elems)
                c.compute_cycles = (
                    c.flops / rate * self.arch.clock_hz
                )
                c.unit = Unit.VPU
            elif est is not None:
                # Mosaic/Pallas kernels publish their own cost estimate;
                # price flops on the MXU (pallas matmul kernels are the
                # common case) and transcendentals on the VPU
                flops, trans, est_bytes = est
                c.flops = flops
                c.mxu_flops = flops
                c.transcendentals = trans
                c.compute_cycles = (
                    flops / self.arch.mxu_flops_per_cycle
                    + self._vpu_cycles(0, trans)
                )
                c.est_bytes = est_bytes
                c.unit = Unit.MXU if flops > 0 else Unit.VPU
            else:
                c.unit = Unit.VPU
        elif base in ("infeed", "outfeed", "send", "recv"):
            c.unit = Unit.DMA
        else:
            # unknown compute op: elementwise-cost fallback
            c.flops = float(out_elems)
            c.compute_cycles = self._vpu_cycles(c.flops, 0)
            c.unit = Unit.VPU
        return c

    def fused_compute_cost(
        self, module: ModuleTrace, comp_name: str, depth: int = 0
    ) -> OpCost:
        """Aggregate compute cost of a fused computation (recursive,
        memoized per module+computation — callers only read the result
        via :meth:`OpCost.add_compute`)."""
        if depth > 16:
            return OpCost(truncated=True)
        # cache lives ON the module (unhashable dataclass; the cache dies
        # with the object), keyed by this model's unique token so two
        # CostModels with different configs never share entries
        per_module = getattr(module, "_fusion_cost_cache", None)
        if per_module is None:
            per_module = {}
            try:
                module._fusion_cost_cache = per_module
            except (AttributeError, TypeError):
                per_module = None
        key = (self._cache_token, comp_name)
        if per_module is not None and key in per_module:
            return per_module[key]
        total = OpCost()
        if comp_name not in module.computations:
            return total
        comp = module.computation(comp_name)
        for op in comp.ops:
            inner = self._compute_cost(op, comp, module, depth)
            total.add_compute(inner)
        if per_module is not None and not total.truncated:
            # a depth-clipped subtree total is partial; caching it would
            # serve the undercount to shallow-depth callers forever
            per_module[key] = total
        return total

    # -- full op cost ------------------------------------------------------

    def op_cost(
        self, op: TraceOp, comp: Computation, module: ModuleTrace
    ) -> OpCost:
        """Roofline cost of one scheduled (entry-level) op.  Collectives get
        ``ici_bytes`` filled but no time here — the engine prices them on
        the ICI via the collective model; ``while``/``conditional``/``call``
        get no time here — the engine recurses into their bodies."""
        a = self.arch
        base = op.base

        if base in FREE_OPCODES or op.opcode in FREE_OPCODES:
            return OpCost(unit=Unit.NONE)

        if op.is_collective:
            c = OpCost(unit=Unit.ICI, is_async=op.is_async_start)
            c.ici_bytes = self.collective_payload_bytes(op, comp)
            return c
        if op.is_async_done or base in ("while", "conditional", "call"):
            return OpCost(unit=Unit.NONE)
        if _is_free_custom_call(op):
            return OpCost(unit=Unit.NONE)

        c = self._compute_cost(op, comp, module)
        # roofline over operands + outputs (the standard fusion assumption,
        # SURVEY.md §7), split by memory space: vmem-resident buffers
        # stream at vmem bandwidth, everything else at achieved HBM rate
        c.hbm_bytes, c.vmem_bytes = _memory_bytes(comp, op, module)
        if c.est_bytes >= 0:
            # the kernel's own accounting (Mosaic cost_estimate) supersedes
            # the operand/result approximation
            c.hbm_bytes = c.est_bytes
        if base in _REGION_OPS:
            # slice-like ops touch only the moved region; XLA aliases the
            # untouched remainder in place (a full-buffer charge made a
            # 1-element dynamic-update-slice cost a 64MB stream)
            region = _region_bytes(comp, op)
            c.hbm_bytes = min(c.hbm_bytes, region)
            c.vmem_bytes = min(c.vmem_bytes, region)
        if base == "fusion" and op.called and module is not None:
            if _is_movement_fusion(module, op.called[0]):
                # a fusion that only slices/concats/copies is a DMA-style
                # move: its VMEM side streams at port rate, not at the
                # banked operand-read bandwidth the roofline assumes (the
                # HBM side already has its own achieved-rate derate)
                c.vmem_rate_scale = a.vmem_slice_efficiency
        if base == "copy":
            # a copy moves its payload once; async copy-start results are
            # (src, dst, ctx) tuples, so operand+result charging counts the
            # payload up to 3x.  Cross-port (HBM<->vmem) transfers stream
            # the payload once through each port; same-port copies read and
            # write through the one port (2x payload on it).
            src_leaf = None
            for o in op.operands[:1]:
                if comp.has_op(o):
                    leaves = leaves_of(comp.op(o).result)
                    if leaves:
                        # tuple copies: the biggest leaf is the payload
                        src_leaf = max(leaves, key=lambda l: l.nbytes)
            dst_leaves = leaves_of(op.result)
            dst_leaf = (
                max(dst_leaves, key=lambda l: l.nbytes)
                if dst_leaves else None
            )
            payload = float(
                src_leaf.nbytes if src_leaf is not None
                else (dst_leaf.nbytes if dst_leaf is not None else 0)
            )
            touches_hbm = c.hbm_bytes > 0
            touches_vmem = c.vmem_bytes > 0
            if touches_hbm and touches_vmem:
                c.hbm_bytes = payload
                c.vmem_bytes = payload
            elif touches_vmem:
                c.hbm_bytes = 0.0
                c.vmem_bytes = 2.0 * payload
                # vmem->vmem copies stream through the load/store ports,
                # not the full banked operand-read bandwidth
                c.vmem_rate_scale = a.vmem_copy_efficiency
            else:
                c.hbm_bytes = 2.0 * payload
                c.vmem_bytes = 0.0
            if _is_relayout(src_leaf, dst_leaf):
                # layout change = physical relayout.  Lane-preserving
                # relayouts reorder whole tiles at near-stream rate
                # (decode fixture: 0.66x); sub-lane shuffles gather at
                # element granularity (conv2d fixture: 0.42x)
                eff = (
                    a.relayout_lane_efficiency
                    if _is_lane_preserving_relayout(src_leaf, dst_leaf)
                    else a.relayout_efficiency
                )
                c.hbm_rate_scale = min(c.hbm_rate_scale, eff)
                c.vmem_rate_scale = min(c.vmem_rate_scale, eff)
        c.hbm_rate_scale = max(c.hbm_rate_scale, 1e-6)
        c.vmem_rate_scale = max(c.vmem_rate_scale, 1e-6)
        c.mem_cycles = max(
            c.hbm_bytes / (a.hbm_bytes_per_cycle * c.hbm_rate_scale),
            c.vmem_bytes / (a.vmem_bytes_per_cycle * c.vmem_rate_scale),
        )
        c.cycles = a.op_overhead_cycles + max(c.compute_cycles, c.mem_cycles)
        if (
            a.small_kernel_floor_cycles > 0
            and not op.is_async_start
            and _is_small_standalone_kernel(op, comp)
        ):
            # sub-tile standalone kernels pay dispatch + sublane
            # addressing + scalar writeback regardless of bytes moved
            c.cycles = max(c.cycles, float(a.small_kernel_floor_cycles))
        c.is_async = op.is_async_start
        if op.opcode in ("copy-start",):
            c.unit = Unit.DMA
        return c

    # -- collectives -------------------------------------------------------

    def collective_payload_bytes(self, op: TraceOp, comp: Computation) -> float:
        """Per-participant payload: input bytes for reduce-ish ops, full
        gathered bytes for all-gather (its cost formula expects the output
        size)."""
        base = op.base
        if base in ("all-gather", "collective-broadcast"):
            leaves = leaves_of(op.result)
            return float(max((l.nbytes for l in leaves), default=0))
        inb = _operand_bytes(comp, op)
        if inb:
            return float(inb)
        leaves = leaves_of(op.result)
        return float(max((l.nbytes for l in leaves), default=0))

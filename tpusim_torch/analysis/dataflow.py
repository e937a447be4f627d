"""Whole-trace dataflow engine: def-use chains, schedule checks, and
per-space buffer-liveness intervals.

Port of ``tpusim/analysis/dataflow.py``, whole.  ``lint``'s trace and
memory passes, the served requests' memory pre-flight and the advisor's
``hbm_resident_gib`` column read it.

One pass over each computation of an :class:`~tpusim_torch.ir.ModuleTrace`
produces everything the semantic passes consume:

* **def-use chains** — for every value: its definition index and every
  use index, plus the two defect lists the TL001/TL002 trace passes
  report from (operands never defined; operands used before their
  schedule position — the topological-schedule check);
* **buffer-liveness intervals** — per memory space (``hbm`` = layout
  space 0, ``vmem`` = ``S(1)``), aliasing-aware: the exact alias rules
  the engine's capacity model uses (``while``/``conditional``/``call``
  results alias their carried values, ``*-done`` halves alias their
  ``*-start`` buffers, ``copy-start`` allocates only its destination
  leaf, async starts carry an (alias, result) pair of which one buffer
  is new, non-entry ``dynamic-update-slice`` updates in place);
* **peaks** — per-computation allocation totals and peak
  *concurrently-live* bytes, composed over the call graph into module
  peaks.  The vmem numbers are pinned byte-equal to the engine's own
  ``_vmem_resident_bytes`` / ``_vmem_peak_live_bytes`` walk by test,
  so the TL4xx memory passes, advise's HBM-fit column, and the
  engine's spill model can never disagree about what a module needs.

The builder is **incremental**: :meth:`ModuleDataflowBuilder.feed`
consumes one computation at a time and retains only an O(#ops-free)
summary, so the streaming lint path analyzes a multi-GB module within
the streaming RSS bound (the full :class:`CompDataflow` — intervals
included — is returned to the caller, who may drop it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpusim_torch.ir import (
    FREE_OPCODES,
    Computation,
    ModuleTrace,
    TraceOp,
    leaves_of,
)

__all__ = [
    "SPACES",
    "CompDataflow",
    "LiveInterval",
    "ModuleDataflow",
    "ModuleDataflowBuilder",
    "alloc_bytes_by_space",
    "analyze_module",
]

#: the two buffer spaces the capacity model distinguishes: layout
#: memory space 0 (HBM, the default) and S(n>0) (on-chip vmem)
SPACES = ("hbm", "vmem")

#: recursion guard for the call-graph peak composition (mirrors the
#: engine's depth cap so the two walks agree even on cyclic damage)
_MAX_CALL_DEPTH = 16


def _space_of(leaf) -> str:
    return "vmem" if leaf.memory_space != 0 else "hbm"


def _leaf_bytes_by_space(leaves) -> dict[str, float]:
    out = {"hbm": 0.0, "vmem": 0.0}
    for leaf in leaves:
        out[_space_of(leaf)] += leaf.nbytes
    return out


def alloc_bytes_by_space(op: TraceOp, is_entry: bool) -> dict[str, float]:
    """Bytes newly allocated by one op, per space, under the alias rules
    of the engine's ``_alloc_vmem_bytes`` (generalized: the vmem
    component of this dict is byte-equal to that function's result,
    pinned by test)."""
    zero = {"hbm": 0.0, "vmem": 0.0}
    if op.opcode in FREE_OPCODES or op.base in FREE_OPCODES:
        if not (is_entry and op.opcode == "parameter"):
            return zero
    if op.base in ("while", "conditional", "call") or op.is_async_done:
        # results alias their init/branch/callee-root values — the
        # callee's own walk already counts the allocation
        return zero
    if not is_entry and op.base == "dynamic-update-slice":
        return zero
    leaves = leaves_of(op.result)
    if op.is_async_start and op.base == "copy":
        # result is (dst, src-alias, ctx): only the leading dst leaf is
        # a new allocation, in whichever space it lives
        out = dict(zero)
        if leaves:
            out[_space_of(leaves[0])] = float(leaves[0].nbytes)
        return out
    if op.is_async_start:
        # collective starts carry (operand-alias, result, ...): one
        # buffer per space, not the alias pair
        out = dict(zero)
        for space in SPACES:
            out[space] = float(max(
                (l.nbytes for l in leaves if _space_of(l) == space),
                default=0.0,
            ))
        return out
    out = dict(zero)
    for leaf in leaves:
        out[_space_of(leaf)] += float(leaf.nbytes)
    return out


@dataclass(frozen=True)
class LiveInterval:
    """One buffer's lifetime: allocated at schedule index ``start``,
    dead after index ``end`` (inclusive of the last use)."""

    name: str
    space: str
    nbytes: float
    start: int
    end: int


@dataclass
class _CallSite:
    """A while/conditional/call at ``index``: the caller's live bytes
    the instant before it, the carried operand bytes the callee's
    parameters re-count, and the callee names."""

    index: int
    live: dict[str, float]
    carried: dict[str, float]
    callees: tuple[str, ...]


@dataclass
class CompSummary:
    """The O(1)-per-callsite residue of one computation's analysis —
    everything the module-level peak composition needs, nothing the
    streaming path cannot afford to keep."""

    name: str
    is_entry: bool
    #: allocation totals per space (every buffer counted as if
    #: simultaneous — the engine's conservative residency sum)
    alloc: dict[str, float] = field(
        default_factory=lambda: {s: 0.0 for s in SPACES}
    )
    #: peak concurrently-live bytes from local allocations alone
    local_peak: dict[str, float] = field(
        default_factory=lambda: {s: 0.0 for s in SPACES}
    )
    call_sites: list[_CallSite] = field(default_factory=list)
    _peak_cache: dict[str, float] = field(default_factory=dict)


@dataclass
class CompDataflow:
    """Full per-computation dataflow: def-use chains + liveness
    intervals + the defects the schedule check found."""

    name: str
    is_entry: bool
    #: value name -> schedule (definition) index
    defs: dict[str, int]
    #: value name -> indices of every op that reads it
    uses: dict[str, list[int]]
    #: (use index, operand) pairs never defined in this computation
    undefined: list[tuple[int, str]]
    #: (use index, operand, def index) pairs where the definition sits
    #: at or after the use — the schedule-order (topological) defects
    misordered: list[tuple[int, str, int]]
    #: per-space liveness intervals, in allocation order
    intervals: list[LiveInterval]
    summary: CompSummary

    @property
    def schedule_ok(self) -> bool:
        return not self.undefined and not self.misordered


class ModuleDataflowBuilder:
    """Feed computations one at a time; finish into a
    :class:`ModuleDataflow` holding only summaries."""

    def __init__(self) -> None:
        self._summaries: dict[str, CompSummary] = {}
        self._entry_name: str | None = None

    def feed(self, comp: Computation, is_entry: bool) -> CompDataflow:
        cdf = _analyze_computation(comp, is_entry)
        self._summaries[comp.name] = cdf.summary
        if is_entry:
            self._entry_name = comp.name
        return cdf

    def finish(self, entry_name: str | None = None) -> "ModuleDataflow":
        return ModuleDataflow(
            entry_name=(
                entry_name if entry_name is not None else self._entry_name
            ),
            summaries=self._summaries,
        )


@dataclass
class ModuleDataflow:
    """Module-level dataflow result: per-computation summaries plus the
    call-graph-composed peaks the memory passes and advise consume."""

    entry_name: str | None
    summaries: dict[str, CompSummary]

    def _comp_peak(self, cname: str, space: str, depth: int) -> float:
        s = self.summaries.get(cname)
        if s is None or depth > _MAX_CALL_DEPTH:
            return 0.0
        cached = s._peak_cache.get(space)
        if cached is not None:
            return cached
        peak = s.local_peak[space]
        for site in s.call_sites:
            inner = max(
                (
                    self._comp_peak(callee, space, depth + 1)
                    for callee in site.callees
                ),
                default=0.0,
            )
            peak = max(
                peak,
                site.live[space] + max(inner - site.carried[space], 0.0),
            )
        s._peak_cache[space] = peak
        return peak

    def peak_live(self, space: str) -> float:
        """Peak concurrently-live bytes in ``space``, call-graph-aware
        (rooted at the entry; without one, the max over computations —
        the engine's exact composition rule)."""
        if self.entry_name is not None and \
                self.entry_name in self.summaries:
            return self._comp_peak(self.entry_name, space, 0)
        return max(
            (
                self._comp_peak(cname, space, 0)
                for cname in list(self.summaries)
            ),
            default=0.0,
        )

    def alloc_total(self, space: str) -> float:
        """Conservative residency sum over every computation (the
        engine's ``_vmem_resident_bytes`` counting rule)."""
        return sum(s.alloc[space] for s in self.summaries.values())

    def peaks(self) -> dict[str, float]:
        return {space: self.peak_live(space) for space in SPACES}


def _analyze_computation(comp: Computation, is_entry: bool) -> CompDataflow:
    """The one pass: def-use chains, schedule check, and the liveness
    walk (the engine's ``_vmem_peak_live_bytes`` inner loop generalized
    per space — branch-for-branch, so the vmem numbers stay
    byte-equal)."""
    ops = comp.ops
    n = len(ops)
    defs = {op.name: i for i, op in enumerate(ops)}

    uses: dict[str, list[int]] = {}
    undefined: list[tuple[int, str]] = []
    misordered: list[tuple[int, str, int]] = []
    last_use: dict[str, int] = {}
    for i, op in enumerate(ops):
        for operand in op.operands:
            uses.setdefault(operand, []).append(i)
            last_use[operand] = max(last_use.get(operand, i), i)
            j = defs.get(operand)
            if j is None:
                undefined.append((i, operand))
            elif j >= i:
                misordered.append((i, operand, j))

    # alias lifetime extension: the underlying buffer lives until the
    # alias's own last use (reverse order, so an alias's extended
    # lifetime is final before its operands are visited)
    ext: dict[str, int] = {}
    for i in range(n - 1, -1, -1):
        op = ops[i]
        is_alias = (
            op.opcode in FREE_OPCODES or op.base in FREE_OPCODES
            or op.is_async_done
            or op.base in ("while", "conditional", "call")
            or (not is_entry and op.base == "dynamic-update-slice")
        )
        if not is_alias:
            continue
        eff = max(last_use.get(op.name, i), ext.get(op.name, i))
        for operand in op.operands:
            ext[operand] = max(ext.get(operand, 0), eff)

    summary = CompSummary(name=comp.name, is_entry=is_entry)
    intervals: list[LiveInterval] = []
    live = {s: 0.0 for s in SPACES}
    frees: dict[int, dict[str, float]] = {}
    for i, op in enumerate(ops):
        if op.base in ("while", "conditional", "call") and op.called:
            carried = {s: 0.0 for s in SPACES}
            for operand in op.operands:
                j = defs.get(operand)
                if j is None:
                    continue
                for leaf in leaves_of(ops[j].result):
                    carried[_space_of(leaf)] += leaf.nbytes
            summary.call_sites.append(_CallSite(
                index=i, live=dict(live), carried=carried,
                callees=tuple(op.called),
            ))
        # two accumulations, the engine's exact split: the residency
        # SUM counts allocations only (non-entry parameters alias
        # caller buffers — 0), while the peak walk counts non-entry
        # parameters as live-throughout carried state
        alloc_nb = alloc_bytes_by_space(op, is_entry)
        for space in SPACES:
            summary.alloc[space] += alloc_nb[space]
        if op.opcode == "parameter" and not is_entry:
            nbytes = _leaf_bytes_by_space(leaves_of(op.result))
        else:
            nbytes = alloc_nb
        for space in SPACES:
            b = nbytes[space]
            if b <= 0:
                continue
            live[space] += b
            if live[space] > summary.local_peak[space]:
                summary.local_peak[space] = live[space]
            if op.opcode == "parameter" and not is_entry:
                die = n  # carried state stays live for the whole body
            else:
                die = max(last_use.get(op.name, n), ext.get(op.name, 0))
            frees.setdefault(die, {s: 0.0 for s in SPACES})[space] += b
            intervals.append(LiveInterval(
                name=op.name, space=space, nbytes=b, start=i, end=die,
            ))
        freed = frees.pop(i, None)
        if freed is not None:
            for space in SPACES:
                live[space] -= freed[space]

    return CompDataflow(
        name=comp.name,
        is_entry=is_entry,
        defs=defs,
        uses=uses,
        undefined=undefined,
        misordered=misordered,
        intervals=intervals,
        summary=summary,
    )


def analyze_module(module: ModuleTrace) -> ModuleDataflow:
    """Whole-module dataflow, memoized on the module object (modules
    are parse-once-immutable; a serve pod re-analyzed per request must
    pay the walk once).  Lazy/streaming modules are iterated one
    computation at a time — bounded-retention parse caps hold."""
    cached = getattr(module, "_dataflow_cache", None)
    if cached is not None:
        return cached
    entry_name = module.entry_name
    builder = ModuleDataflowBuilder()
    for cname in list(module.computations.keys()):
        comp = module.computations[cname]
        builder.feed(comp, is_entry=cname == entry_name)
    df = builder.finish(entry_name)
    try:
        module._dataflow_cache = df
    except (AttributeError, TypeError):
        pass
    return df

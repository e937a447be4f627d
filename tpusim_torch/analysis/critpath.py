"""Critical-path & exposed-communication analyzer (the perf pass core).

Port of ``tpusim/analysis/critpath.py``, whole.  In the port ``lint
--perf``, ``perf-report`` and the advisor's ``exposed_comm_frac``
column read it.

Static performance verdicts over one traced module, derived WITHOUT
running the event engine but byte-pinned against it: from the schedule
order the engine honors (``Engine._run_computation``'s serial walk) and
the same per-op nominal costs (``timing.cost`` priced with the same
composed :class:`SimConfig`), build the weighted dependency DAG per
computation and compute

* the **critical path** — a provable LOWER bound on the engine's priced
  cycles (data edges + channel-serialization chains + async transfer
  spans, composed through while/conditional/call exactly as the engine
  recurses, depth-capped at the same limit),
* the **serial cost sum** — a provable UPPER bound on the engine's
  priced cycles (every op's worst-case contribution to the serial core
  clock, including the HBM-contention allowance and the DMA issue
  latency),
* per-op **slack** against the critical path,
* **exposed-communication accounting** — for each collective, how many
  of its priced cycles are covered by independently schedulable core
  work inside its start→done issue window (``exposed_collective_cycles``
  as a first-class number, never exceeding the collective's priced
  cycles by construction), and
* a **roofline classification** per op from the cost model's own term
  breakdown (:func:`tpusim_torch.timing.cost.classify_bound`).

The load-bearing invariant, CI-pinned across the fixture+silicon corpus
(``ci/check_golden.py --perf-lint-smoke``) and by
``tests/test_critpath.py``::

    critical_path_cycles  <=  EngineResult.cycles  <=  serial_cycles

per module per arch, for un-degraded full runs (no fault injection, no
``resume_op``/``checkpoint_op`` slicing — those change WHAT the engine
walks, not how this analyzer models it).

Spill repricing is replicated exactly (same ``_residency_of`` /
``_peak_live_of`` scalars the engine uses); HBM contention is modeled
only in the upper bound (it can only ever increase engine durations).

Two feed modes, mirroring the dataflow engine:

* **full module** — :func:`analyze_module_perf`; recursion through the
  call graph with the engine's depth cap, fusion pricing through the
  real :meth:`CostModel.op_cost`.
* **streaming** — :meth:`CritBuilder.feed` one computation at a time
  (deferred big-trace modules; callees precede callers in XLA dump
  order).  Fusions are priced from retained per-computation aggregate
  compute costs so no full module needs to stay resident; retention per
  computation is O(1) (top-K slack table + capped chain), keeping the
  lint RSS bound intact.  Streaming mode resolves callees flat (no
  entry-depth knowledge), so the depth-cap lower-bound guarantee is
  formal only for call graphs shallower than the cap — every real dump,
  and all the engine ever fully prices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from tpusim_torch.ir import (
    Computation,
    ModuleTrace,
    TraceOp,
    Unit,
)
from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.cost import (
    CostModel,
    OpCost,
    classify_bound,
    shape_memory_bytes,
    while_trip_count,
)
from tpusim_torch.timing.cost import (
    _is_small_standalone_kernel as _small_kernel,
)

__all__ = [
    "BadCost",
    "Bubble",
    "CompPerf",
    "CritBuilder",
    "Exposure",
    "ModulePerf",
    "OpPerf",
    "RooflineSuspect",
    "analyze_module_perf",
    "module_perf_doc",
]

#: recursion cap mirroring ``Engine._run_computation`` — a frame entered
#: deeper than this contributes zero cycles there, so the DAG composes
#: identically to keep critpath <= engine
_MAX_DEPTH = 32

#: TL501 — a collective is "mostly exposed" when at least this fraction
#: of its priced cycles is uncovered by in-window core work
TL501_EXPOSED_FRAC = 0.5
#: TL501 — and the movable compute must cover a meaningful share of the
#: exposure for the warning to be actionable
TL501_MOVABLE_FRAC = 0.25
#: TL502 — a pinning predecessor is "small" when the pinned op is at
#: least this many times wider
TL502_SMALL_RATIO = 8.0
#: TL502 — the bubble (extra wait the small chain inflicts beyond the
#: op's other operands) must be at least this fraction of the pinned
#: op's own width
TL502_BUBBLE_FRAC = 0.5
#: TL503 — an op "dominates" the critical path at this width fraction
TL503_DOMINANCE_FRAC = 0.5

#: per-computation retention caps — the streaming feed must hold O(1)
#: state per computation to stay inside the lint RSS bound
_TOP_OPS = 32
_MAX_CHAIN = 64
_MAX_FINDINGS = 16
_MAX_BAD = 64

#: engine classification of async joins (engine.py done-branch): these
#: base opcodes account their wait as exposed COLLECTIVE cycles
_COLLECTIVE_DONE_BASES = frozenset({
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
})

_CONTROL_BASES = frozenset({"while", "conditional", "call"})


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclass
class OpPerf:
    """One op's place in its computation's DAG (slack-table row)."""

    name: str
    opcode: str
    cycles: float          # core width (engine t-advance lower bound)
    start: float           # earliest-start (completion of operand defs)
    finish: float          # start + width
    slack: float           # cycles it could slip without growing the path
    bound: str             # classify_bound() class
    on_critical_path: bool = False


@dataclass
class Exposure:
    """One collective's start→done window accounting."""

    op: str                # start-op name
    opcode: str
    done: str | None       # join-op name (None: drained at comp end)
    priced_cycles: float   # the ICI model's duration for this collective
    exposed_cycles: float  # priced - in-window core work (>= 0, <= priced)
    overlapped_cycles: float
    movable_cycles: float = 0.0  # independent core work after the join
    sync: bool = False     # priced synchronously (fully exposed)


@dataclass
class Bubble:
    """TL502 evidence: a small op's chain pinning a big op."""

    op: str                # the pinned (large) op
    opcode: str
    pinned_cycles: float   # the large op's width
    pred: str              # the small op heading the pinning chain
    pred_cycles: float
    bubble_cycles: float   # extra wait beyond the op's other operands


@dataclass
class RooflineSuspect:
    """TL503 evidence: HBM-bound critical-path op that shouldn't be."""

    op: str
    opcode: str
    cycles: float
    intensity: float       # shape-derived flops/byte
    ridge: float           # arch mxu_flops_per_cycle / hbm_bytes_per_cycle


@dataclass
class BadCost:
    """TL504 evidence: non-finite / negative priced cost."""

    op: str
    opcode: str
    detail: str


@dataclass
class CompPerf:
    """Perf verdict for one computation (one DAG)."""

    name: str
    critical_path_cycles: float = 0.0
    serial_cycles: float = 0.0
    op_count: int = 0
    collective_cycles: float = 0.0
    exposed_collective_cycles: float = 0.0
    #: (name, opcode, core-width) triples along the critical chain, in
    #: schedule order, capped at _MAX_CHAIN
    critical_ops: tuple[tuple[str, str, float], ...] = ()
    #: top-width ops (slack table), capped at _TOP_OPS
    ops: tuple[OpPerf, ...] = ()
    #: roofline mix: bound-class -> cycles attributed
    bound_cycles: dict[str, float] = field(default_factory=dict)
    exposures: tuple[Exposure, ...] = ()
    bubbles: tuple[Bubble, ...] = ()
    suspects: tuple[RooflineSuspect, ...] = ()
    bad_costs: tuple[BadCost, ...] = ()
    #: control-flow composition sites: (kind, callee names, multiplier)
    #: — finish() aggregates collective/exposure totals through these
    cf_sites: tuple[tuple[str, tuple[str, ...], float], ...] = ()

    @property
    def dominant_bound(self) -> str:
        if not self.bound_cycles:
            return "none"
        return max(sorted(self.bound_cycles), key=self.bound_cycles.get)


@dataclass
class ModulePerf:
    """Perf verdict for one module: per-comp DAGs + entry-tree totals."""

    module: str
    entry: str | None
    comps: dict[str, CompPerf]
    #: computations reachable from the entry via control flow — the only
    #: ones the engine prices, hence the only ones diagnostics fire on
    reachable: frozenset[str]
    #: entry-tree totals, composed through while-trip multipliers and
    #: worst conditional arms exactly like EngineResult.merge_scaled
    critical_path_cycles: float = 0.0
    serial_cycles: float = 0.0
    collective_cycles: float = 0.0
    exposed_collective_cycles: float = 0.0


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------


class CritBuilder:
    """Builds per-computation perf DAGs, full-module or streaming.

    Full-module mode (``module`` given): call :meth:`run`.  Streaming
    mode (``module=None``): :meth:`feed` computations in dump order
    (callees first), then :meth:`finish` with the entry name.
    """

    def __init__(
        self,
        config: SimConfig,
        *,
        num_devices: int = 1,
        topology=None,
        module: ModuleTrace | None = None,
        cost_model: CostModel | None = None,
    ) -> None:
        from tpusim_torch.ici.detailed import make_collective_model
        from tpusim_torch.ici.topology import torus_for

        self.config = config
        self.arch = config.arch
        self.cost = cost_model or CostModel(self.arch)
        devices = module.num_devices if module is not None else num_devices
        topo = topology or torus_for(max(int(devices), 1), self.arch.name)
        self.coll = make_collective_model(topo, self.arch.ici)
        self.module = module
        self.perf: dict[str, CompPerf] = {}
        self._memo: dict[tuple[str, int], CompPerf] = {}
        self._growth_memo: dict[str, int] = {}
        #: streaming fusion pricing: per fed computation, the aggregate
        #: compute OpCost (what fused_compute_cost would return)
        self._fused: dict[str, OpCost] = {}
        # vmem over-subscription: mirror Engine._run_serial exactly so
        # post-spill per-op costs match the engine's byte-for-byte
        self.spill_frac = 1.0
        if module is not None and config.model_vmem_capacity:
            from tpusim_torch.timing.engine import Engine, _residency_of

            resident = _residency_of(module)
            cap = float(self.arch.vmem_bytes)
            if resident > cap > 0:
                resident = Engine._peak_live_of(module)
            if resident > cap > 0:
                self.spill_frac = cap / resident

    # -- public drivers ----------------------------------------------------

    def run(self) -> ModulePerf:
        """Full-module analysis: the entry's control-flow closure only —
        the frames the engine prices (fusion bodies are costed inside
        their fusion op, never walked as schedules)."""
        module = self.module
        assert module is not None, "run() needs a full module; use feed()"
        if module.entry_name and module.entry_name in module.computations:
            self._analyze(module.entry_name, 0, frozenset())
        else:
            for cname in sorted(module.computations):
                self._analyze(cname, 0, frozenset())
        return self.finish(module.entry_name)

    def feed(self, comp: Computation) -> CompPerf:
        """Streaming feed: analyze one computation against what has
        already been fed (callees precede callers in dump order)."""
        cp = self._feed_one(comp, self.perf.get)
        self.perf[comp.name] = cp
        if self.module is None:
            self._fused[comp.name] = self._stream_aggregate(comp)
        return cp

    def finish(self, entry_name: str | None) -> ModulePerf:
        """Compose entry-tree totals through the retained call sites."""
        reachable: set[str] = set()
        totals: dict[str, tuple[float, float]] = {}

        def walk(name: str, stack: frozenset[str]) -> tuple[float, float]:
            """(collective, exposed) cycles of the subtree rooted here,
            scaled like EngineResult.merge_scaled (while x trips, worst
            conditional arm by duration, call x 1)."""
            if name in stack:
                return (0.0, 0.0)
            reachable.add(name)
            got = totals.get(name)
            if got is not None:
                return got
            cp = self.perf.get(name)
            if cp is None:
                return (0.0, 0.0)
            coll = cp.collective_cycles
            exp = cp.exposed_collective_cycles
            sub = stack | {name}
            for kind, callees, mult in cp.cf_sites:
                if kind == "cond":
                    present = [c for c in callees if self.perf.get(c)]
                    if not present:
                        continue
                    worst = max(
                        present,
                        key=lambda c: self.perf[c].critical_path_cycles,
                    )
                    c2, e2 = walk(worst, sub)
                    coll += c2
                    exp += e2
                else:
                    for c in callees:
                        c2, e2 = walk(c, sub)
                        coll += c2 * mult
                        exp += e2 * mult
            totals[name] = (coll, exp)
            return totals[name]

        critical = serial = coll = exp = 0.0
        if entry_name is not None and entry_name in self.perf:
            coll, exp = walk(entry_name, frozenset())
            critical = self.perf[entry_name].critical_path_cycles
            serial = self.perf[entry_name].serial_cycles
        module_name = self.module.name if self.module is not None else ""
        return ModulePerf(
            module=module_name,
            entry=entry_name,
            comps=dict(self.perf),
            reachable=frozenset(reachable),
            critical_path_cycles=critical,
            serial_cycles=serial,
            collective_cycles=coll,
            exposed_collective_cycles=exp,
        )

    # -- full-module recursion ---------------------------------------------

    def _growth(self, name: str, stack: frozenset[str]) -> int:
        """Max control-flow nesting below (and including) entry of this
        computation: entered at depth d, the deepest frame sits at
        d + growth - 1.  Cycles count as unbounded (always clip-checked)."""
        got = self._growth_memo.get(name)
        if got is not None:
            return got
        if name in stack:
            return _MAX_DEPTH + 2  # call-graph cycle: force depth keying
        module = self.module
        comp = module.computations.get(name) if module is not None else None
        if comp is None:
            return 1
        g = 1
        sub = stack | {name}
        for callee in _callee_names(comp):
            g = max(g, 1 + self._growth(callee, sub))
        if g <= _MAX_DEPTH + 1:
            self._growth_memo[name] = g
        return g

    def _analyze(
        self, name: str, depth: int, stack: frozenset[str],
    ) -> CompPerf | None:
        module = self.module
        comp = module.computations.get(name)
        if comp is None or name in stack:
            return None
        # a comp whose whole subtree fits under the cap prices the same
        # at every depth (memo key -1); otherwise the engine's clipping
        # makes the result depth-dependent
        g = self._growth(name, stack)
        key = (name, -1) if depth + g - 1 <= _MAX_DEPTH else (name, depth)
        got = self._memo.get(key)
        if got is not None:
            return got
        if depth > _MAX_DEPTH:
            cp = CompPerf(name=name)  # engine returns t0 here: zero width
        else:
            kids: dict[str, CompPerf] = {}
            sub = stack | {name}
            for callee in _callee_names(comp):
                child = self._analyze(callee, depth + 1, sub)
                if child is not None:
                    kids[callee] = child
            cp = self._feed_one(comp, kids.get)
        self._memo[key] = cp
        if key[1] == -1 or name not in self.perf:
            self.perf[name] = cp
        return cp

    # -- pricing -----------------------------------------------------------

    def _op_cost(self, op: TraceOp, comp: Computation) -> OpCost:
        """Price one op exactly as the engine will, including the spill
        repricing; streaming mode intercepts fusions (they are the only
        op_cost path that dereferences the module)."""
        if self.module is None and op.base == "fusion" and op.called:
            c = self._stream_fusion_cost(op, comp)
        else:
            c = self.cost.op_cost(op, comp, self.module)
        a = self.arch
        if self.spill_frac < 1.0 and c.vmem_bytes > 0:
            spilled = c.vmem_bytes * (1.0 - self.spill_frac)
            c.vmem_bytes -= spilled
            c.hbm_bytes += spilled
            c.mem_cycles = max(
                c.hbm_bytes / (a.hbm_bytes_per_cycle * c.hbm_rate_scale),
                c.vmem_bytes / (a.vmem_bytes_per_cycle * c.vmem_rate_scale),
            )
            c.cycles = max(
                c.cycles,
                a.op_overhead_cycles + max(c.compute_cycles, c.mem_cycles),
            )
        return c

    def _stream_aggregate(self, comp: Computation) -> OpCost:
        """What fused_compute_cost(module, comp) would return, computed
        from already-retained callee aggregates (streaming only)."""
        total = OpCost()
        for op in comp.ops:
            if op.base == "fusion" and op.called:
                agg = self._fused.get(op.called[0])
                if agg is not None:
                    total.add_compute(agg)
                continue
            total.add_compute(self.cost._compute_cost(op, comp, None))
        return total

    def _stream_fusion_cost(self, op: TraceOp, comp: Computation) -> OpCost:
        """op_cost's fusion path without a resident module: compute side
        from the retained aggregate, memory side from the op's shapes
        (the full-module path's region caps need the called computation,
        which streaming mode deliberately does not retain)."""
        a = self.arch
        c = OpCost()
        agg = self._fused.get(op.called[0])
        if agg is not None:
            c.add_compute(agg)
        c.unit = Unit.MXU if c.mxu_flops > 0 else Unit.VPU
        c.hbm_bytes, c.vmem_bytes = shape_memory_bytes(comp, op, None)
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
            and _small_kernel(op, comp)
        ):
            c.cycles = max(c.cycles, float(a.small_kernel_floor_cycles))
        return c

    def _while_trips(self, comp: Computation, op: TraceOp) -> int:
        trips = while_trip_count(op, 0)
        if trips > 0:
            return trips
        if self.module is not None:
            from tpusim_torch.trace.loop_analysis import infer_trip_count

            trips = infer_trip_count(self.module, comp, op, -1)
            if trips >= 0:
                return trips
        return self.config.default_loop_trip_count

    # -- the DAG walk ------------------------------------------------------

    def _feed_one(self, comp: Computation, resolve) -> CompPerf:
        """One computation's forward DAG pass + reverse slack pass.

        Mirrors the engine's serial walk branch-for-branch (control flow
        -> async join -> collective -> async DMA start -> sync op) so the
        per-op widths/serial contributions inherit its semantics; see the
        module docstring for the two bound arguments.
        """
        a = self.arch
        overhead = float(a.op_overhead_cycles)
        dma_lat = a.seconds_to_cycles(a.dma_issue_latency)
        overlap = self.config.overlap_collectives
        contend = self.config.model_hbm_contention
        hbm_bpc = a.hbm_bytes_per_cycle
        ridge = (
            a.mxu_flops_per_cycle / hbm_bpc if hbm_bpc > 0 else math.inf
        )

        dist: dict[str, float] = {}      # op -> completion (core view)
        start_at: dict[str, float] = {}  # op -> earliest start (data-ready)
        width: dict[str, float] = {}     # op -> core width
        bclass: dict[str, str] = {}
        pred: dict[str, tuple[str, str] | None] = {}   # core-view chain pred
        tpred: dict[str, tuple[str, str] | None] = {}  # transfer-view pred
        transfer_end: dict[str, float] = {}
        done_of: dict[str, str] = {}
        consumers: dict[str, list[str]] = {}
        costs: dict[str, OpCost] = {}
        pos: dict[str, int] = {}
        bubbles_raw: list[tuple[str, str, str, float, float]] = []
        cf_sites: list[tuple[str, tuple[str, ...], float]] = []
        bound_cycles: dict[str, float] = {}
        bad: list[BadCost] = []
        open_colls: dict[str, dict] = {}
        exposures: list[Exposure] = []
        serial = 0.0
        coll_cycles = 0.0
        ici_chain = 0.0
        ici_last: str | None = None
        dma_chain = 0.0
        dma_last: str | None = None

        def check_cost(op: TraceOp, c: OpCost, dur: float) -> None:
            vals = (c.cycles, c.compute_cycles, c.mem_cycles, dur)
            if all(math.isfinite(v) and v >= 0 for v in vals):
                return
            if len(bad) < _MAX_BAD:
                detail = (
                    f"cycles={c.cycles!r} compute={c.compute_cycles!r} "
                    f"mem={c.mem_cycles!r} collective={dur!r}"
                )
                bad.append(BadCost(op=op.name, opcode=op.opcode,
                                   detail=detail))

        def tally(kind: str, cycles: float) -> None:
            if cycles > 0:
                bound_cycles[kind] = bound_cycles.get(kind, 0.0) + cycles

        for idx, op in enumerate(comp.ops):
            name = op.name
            base = op.base
            pos[name] = idx
            # data-ready over operand defs (ops referencing names not yet
            # defined in this comp — TL002 territory — contribute nothing,
            # which keeps the bound sound: the engine ignores them too)
            ready = 0.0
            ready2 = 0.0
            dpred: str | None = None
            for operand in op.operands:
                d = dist.get(operand)
                if d is None:
                    continue
                consumers.setdefault(operand, []).append(name)
                if d > ready:
                    ready2 = ready
                    ready, dpred = d, operand
                elif d > ready2:
                    ready2 = d
            core_pred = (dpred, "core") if dpred is not None else None

            w = 0.0
            kind = "flow"

            # ---- control flow (engine recurses; we compose) ------------
            if base == "while" and len(op.called) >= 1:
                body = op.attrs.get("body", "").lstrip("%") or op.called[0]
                trips = float(self._while_trips(comp, op))
                sub = resolve(body)
                sub_cp = sub.critical_path_cycles if sub is not None else 0.0
                sub_ser = sub.serial_cycles if sub is not None else 0.0
                w = sub_cp * trips + overhead * (trips + 1)
                serial += sub_ser * trips + overhead * (trips + 1)
                cf_sites.append(("while", (body,), trips))
            elif base == "conditional" and op.called:
                arms = [resolve(c) for c in op.called]
                arms = [x for x in arms if x is not None]
                if arms:
                    w = max(x.critical_path_cycles for x in arms) + overhead
                    serial += max(x.serial_cycles for x in arms) + overhead
                cf_sites.append(("cond", tuple(op.called), 1.0))
            elif base == "call" and op.called:
                sub = resolve(op.called[0])
                if sub is not None:
                    w = sub.critical_path_cycles
                    serial += sub.serial_cycles
                cf_sites.append(("call", (op.called[0],), 1.0))

            elif op.is_async_done:
                # join: zero-width; entry pulled forward to the transfer
                # end when the transfer is the binding constraint
                src = op.operands[0] if op.operands else None
                entry = ready
                p = core_pred
                if src is not None:
                    te = transfer_end.get(src)
                    if te is not None and te > entry:
                        entry = te
                        p = (src, "transfer")
                    rec = open_colls.pop(src, None)
                    if rec is not None:
                        exposed = max(0.0, rec["dur"] - rec["covered"])
                        exposures.append(Exposure(
                            op=src, opcode=rec["opcode"], done=name,
                            priced_cycles=rec["dur"],
                            exposed_cycles=exposed,
                            overlapped_cycles=rec["dur"] - exposed,
                        ))
                    done_of.setdefault(src, name)
                start_at[name] = entry
                dist[name] = entry
                width[name] = 0.0
                bclass[name] = "join"
                pred[name] = p
                continue

            elif op.is_collective:
                cost = self._op_cost(op, comp)
                dur = 0.0
                if op.collective is not None:
                    dur = a.seconds_to_cycles(
                        self.coll.seconds(op.collective, cost.ici_bytes)
                    )
                check_cost(op, cost, dur)
                coll_cycles += dur
                tally("ici", dur)
                chan_pred = (
                    (ici_last, "transfer")
                    if ici_chain > ready and ici_last is not None
                    else core_pred
                )
                if op.is_async_start and overlap:
                    # engine: start=max(t, ici_free); pending=start+dur;
                    # core pays only the issue overhead
                    te = max(ready, ici_chain) + dur
                    transfer_end[name] = te
                    tpred[name] = chan_pred
                    ici_chain = te
                    ici_last = name
                    serial += overhead + dur
                    w = overhead
                    kind = "overhead"
                    if base in _COLLECTIVE_DONE_BASES:
                        # covered starts at 0: the common tail adds this
                        # op's own issue overhead (it happens in-window)
                        open_colls[name] = {
                            "opcode": op.opcode, "dur": dur,
                            "covered": 0.0,
                        }
                else:
                    # sync (or overlap disabled): core rides the ICI
                    chan_start = max(ready, ici_chain)
                    start_at[name] = ready
                    dist[name] = chan_start + dur
                    width[name] = dur
                    bclass[name] = "ici"
                    pred[name] = chan_pred
                    ici_chain = dist[name]
                    ici_last = name
                    serial += dur
                    if op.is_async_start:
                        # engine registers pending[name]=t: complete by
                        # the time its done arrives
                        transfer_end[name] = dist[name]
                        tpred[name] = chan_pred
                    exposures.append(Exposure(
                        op=name, opcode=op.opcode, done=None,
                        priced_cycles=dur, exposed_cycles=dur,
                        overlapped_cycles=0.0, sync=True,
                    ))
                    for rec in open_colls.values():
                        rec["covered"] += dur
                    costs[name] = cost
                    continue

            elif op.is_async_start:
                # async DMA: channel serializes on bandwidth, completion
                # adds the pipelined issue latency; core pays overhead
                cost = self._op_cost(op, comp)
                dur = cost.cycles
                check_cost(op, cost, 0.0)
                chan_start = max(ready, dma_chain)
                transfer_end[name] = chan_start + dma_lat + dur
                tpred[name] = (
                    (dma_last, "transfer")
                    if dma_chain > ready and dma_last is not None
                    else core_pred
                )
                dma_chain = chan_start + dur
                dma_last = name
                serial += overhead + dma_lat + dur
                tally(classify_bound(cost, a), dur)
                w = overhead
                kind = "overhead"
                costs[name] = cost

            else:
                # ---- ordinary synchronous op ---------------------------
                cost = self._op_cost(op, comp)
                check_cost(op, cost, 0.0)
                w = cost.cycles
                kind = classify_bound(cost, a)
                serial += w
                if contend and cost.hbm_bytes > 0:
                    # worst-case fair-share allowance: covers both this
                    # op's own stretch and the penalty the engine applies
                    # to in-flight DMA finishes (penalty <= hbm_bytes/bpc)
                    serial += cost.hbm_bytes / hbm_bpc
                tally(kind, w)
                costs[name] = cost
                if w > 0 and dpred is not None:
                    bubbles_raw.append((name, op.opcode, dpred,
                                        ready - ready2, w))

            start_at[name] = ready
            dist[name] = ready + w
            width[name] = w
            bclass[name] = kind
            pred[name] = core_pred
            if w > 0:
                for rec in open_colls.values():
                    rec["covered"] += w

        # collectives never joined in this comp: the engine's final drain
        # waits for them without booking exposure; account the uncovered
        # remainder here so the number is conservative, still <= priced
        for src, rec in open_colls.items():
            exposed = max(0.0, rec["dur"] - rec["covered"])
            exposures.append(Exposure(
                op=src, opcode=rec["opcode"], done=None,
                priced_cycles=rec["dur"], exposed_cycles=exposed,
                overlapped_cycles=rec["dur"] - exposed,
            ))

        # ---- critical path: terminal = global max over completions ------
        total = 0.0
        term: tuple[str, str] | None = None
        for op in comp.ops:
            n = op.name
            d = dist.get(n)
            if d is not None and d > total:
                total, term = d, (n, "core")
            te = transfer_end.get(n)
            if te is not None and te > total:
                total = te
                term = (n, "transfer")

        chain: list[tuple[str, str, float]] = []
        critical: set[str] = set()
        node = term
        while node is not None and len(chain) < _MAX_CHAIN:
            n, view = node
            critical.add(n)
            if view == "core":
                chain.append((
                    n,
                    comp.op(n).opcode if comp.has_op(n) else "?",
                    width.get(n, 0.0),
                ))
                node = pred.get(n)
            else:
                chain.append((
                    n,
                    comp.op(n).opcode if comp.has_op(n) else "?",
                    transfer_end.get(n, 0.0) - start_at.get(n, 0.0)
                    if n in start_at else 0.0,
                ))
                node = tpred.get(n)
        chain.reverse()

        # ---- reverse pass: slack over data + transfer edges --------------
        # tail[u] = longest downstream width-sum hanging off u's completion;
        # slack = T - dist - tail (channel-serialization edges excluded:
        # they order, but reordering could dissolve them)
        tail: dict[str, float] = {}
        for op in reversed(comp.ops):
            n = op.name
            t_n = 0.0
            for c in consumers.get(n, ()):
                t_n = max(t_n, width.get(c, 0.0) + tail.get(c, 0.0))
            d = done_of.get(n)
            if d is not None:
                span = transfer_end.get(n, 0.0) - start_at.get(n, 0.0)
                t_n = max(t_n, span - width.get(n, 0.0) + tail.get(d, 0.0))
            tail[n] = t_n

        # ---- TL501: movable compute for exposed collectives --------------
        for exp in exposures:
            if exp.priced_cycles <= 0:
                continue
            if exp.exposed_cycles < TL501_EXPOSED_FRAC * exp.priced_cycles:
                continue
            ref = pos.get(exp.done if exp.done is not None else exp.op)
            if ref is None:
                continue
            # everything scheduled after the join that does NOT depend on
            # the collective could have been hoisted into its window
            dependents: set[str] = set()
            frontier = [exp.op]
            if exp.done:
                frontier.append(exp.done)
            while frontier:
                cur = frontier.pop()
                if cur in dependents:
                    continue
                dependents.add(cur)
                frontier.extend(consumers.get(cur, ()))
            movable = 0.0
            for other, p in pos.items():
                if p <= ref or other in dependents:
                    continue
                if bclass.get(other) in ("ici", "join", "flow", "overhead"):
                    continue
                movable += width.get(other, 0.0)
            exp.movable_cycles = movable

        # ---- TL502: serialization bubbles --------------------------------
        bubbles: list[Bubble] = []
        for n, opcode, small, bubble, w_large in bubbles_raw:
            if len(bubbles) >= _MAX_FINDINGS:
                break
            if n in critical:
                continue
            w_small = width.get(small, 0.0)
            if w_small <= 0 or w_small * TL502_SMALL_RATIO > w_large:
                continue
            if bubble < TL502_BUBBLE_FRAC * w_large:
                continue
            bubbles.append(Bubble(
                op=n, opcode=opcode, pinned_cycles=w_large,
                pred=small, pred_cycles=w_small, bubble_cycles=bubble,
            ))

        # ---- TL503: mis-rooflined critical-path dominators ---------------
        suspects: list[RooflineSuspect] = []
        if total > 0 and math.isfinite(ridge):
            for n in sorted(critical):
                if len(suspects) >= _MAX_FINDINGS:
                    break
                c = costs.get(n)
                if c is None or not comp.has_op(n):
                    continue
                w_n = width.get(n, 0.0)
                if w_n < TL503_DOMINANCE_FRAC * total:
                    continue
                if bclass.get(n) != "hbm":
                    continue
                hbm_s, vmem_s = shape_memory_bytes(
                    comp, comp.op(n), self.module
                )
                intensity = c.flops / max(hbm_s + vmem_s, 1.0)
                if intensity >= ridge:
                    suspects.append(RooflineSuspect(
                        op=n, opcode=comp.op(n).opcode, cycles=w_n,
                        intensity=intensity, ridge=ridge,
                    ))

        # ---- slack table: top-width ops, critical chain flagged ----------
        ranked = sorted(
            (n for n in width if width[n] > 0),
            key=lambda n: (-width[n], pos.get(n, 0)),
        )[:_TOP_OPS]
        table = tuple(
            OpPerf(
                name=n,
                opcode=comp.op(n).opcode if comp.has_op(n) else "?",
                cycles=width[n],
                start=start_at.get(n, 0.0),
                finish=dist.get(n, 0.0),
                slack=max(0.0, total - dist.get(n, 0.0) - tail.get(n, 0.0)),
                bound=bclass.get(n, "none"),
                on_critical_path=n in critical,
            )
            for n in ranked
        )

        return CompPerf(
            name=comp.name,
            critical_path_cycles=total,
            serial_cycles=serial,
            op_count=len(comp.ops),
            collective_cycles=coll_cycles,
            exposed_collective_cycles=sum(
                e.exposed_cycles for e in exposures
            ),
            critical_ops=tuple(chain),
            ops=table,
            bound_cycles=bound_cycles,
            exposures=tuple(exposures),
            bubbles=tuple(bubbles),
            suspects=tuple(suspects),
            bad_costs=tuple(bad),
            cf_sites=tuple(cf_sites),
        )


def _callee_names(comp: Computation) -> list[str]:
    """Control-flow callees of one computation, in first-use order
    (fusion bodies are priced inside op_cost, not entered as frames)."""
    out: list[str] = []
    seen: set[str] = set()
    for op in comp.ops:
        if op.base not in _CONTROL_BASES:
            continue
        names = list(op.called)
        if op.base == "while":
            body = op.attrs.get("body", "").lstrip("%")
            if body:
                names.append(body)
        for n in names:
            if n and n not in seen:
                seen.add(n)
                out.append(n)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_module_perf(
    module: ModuleTrace,
    config: SimConfig,
    topology=None,
) -> ModulePerf:
    """Full-module perf analysis with the engine's exact pricing inputs.

    ``config`` must be the same composed SimConfig the engine prices
    with (arch + overlays) for the critpath <= engine <= serial-sum
    guarantee to hold.
    """
    builder = CritBuilder(config, topology=topology, module=module)
    return builder.run()


def module_perf_doc(mp: ModulePerf) -> dict:
    """JSON-stable document for one module's perf verdict (`lint --json`
    ``perf`` key and the perf-report CLI both render from this)."""
    comps = {}
    for name in sorted(mp.comps):
        if mp.reachable and name not in mp.reachable:
            # fed but never priced (streaming feeds fusion bodies too)
            continue
        cp = mp.comps[name]
        comps[name] = {
            "critical_path_cycles": cp.critical_path_cycles,
            "serial_cycles": cp.serial_cycles,
            "op_count": cp.op_count,
            "collective_cycles": cp.collective_cycles,
            "exposed_collective_cycles": cp.exposed_collective_cycles,
            "dominant_bound": cp.dominant_bound,
            "bound_cycles": {
                k: cp.bound_cycles[k] for k in sorted(cp.bound_cycles)
            },
            "critical_path": [
                {"op": n, "opcode": oc, "cycles": w}
                for n, oc, w in cp.critical_ops
            ],
            "ops": [
                {
                    "op": o.name, "opcode": o.opcode, "cycles": o.cycles,
                    "start": o.start, "finish": o.finish, "slack": o.slack,
                    "bound": o.bound, "critical": o.on_critical_path,
                }
                for o in cp.ops
            ],
            "exposures": [
                {
                    "op": e.op, "opcode": e.opcode, "done": e.done,
                    "priced_cycles": e.priced_cycles,
                    "exposed_cycles": e.exposed_cycles,
                    "overlapped_cycles": e.overlapped_cycles,
                    "movable_cycles": e.movable_cycles,
                    "sync": e.sync,
                }
                for e in cp.exposures
            ],
        }
    return {
        "module": mp.module,
        "entry": mp.entry,
        "critical_path_cycles": mp.critical_path_cycles,
        "serial_cycles": mp.serial_cycles,
        "collective_cycles": mp.collective_cycles,
        "exposed_collective_cycles": mp.exposed_collective_cycles,
        "computations": comps,
    }

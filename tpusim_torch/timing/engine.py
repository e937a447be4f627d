"""Schedule-walking timing engine.

Port of the serial walk of ``tpusim/timing/engine.py`` (``Engine.run`` →
``_run_serial`` → ``_run_computation``), which is the JAX package's
reference semantics: its fastpath backends are held byte for byte to it.

A TPU TensorCore executes its scheduled program sequentially, with
asynchronous DMA and ICI transfers bracketed in the HLO as
``*-start`` / ``*-done`` pairs, so the engine walks the schedule advancing
a core clock, runs async DMA on a resource timeline, and joins at the
``-done`` ops.  ``while`` bodies are recursed into and multiplied by their
trip count.  Collectives are priced by the ICI model the config selects
(:func:`tpusim_torch.ici.detailed.make_collective_model`, analytic or
detailed) over the module's torus: an overlapped ``*-start`` runs on the
ICI timeline and joins at its ``-done``; any other collective stalls the
core.

``Engine.run`` hands every eligible module to the pricing fastpath
(:mod:`tpusim_torch.fastpath`), which is byte-identical to the serial walk
``_run_serial`` kept here as the reference.  A degraded chip (a straggler
clock, a throttled HBM) prices through the ``clock_scale``/``hbm_scale``
multipliers, which the driver takes from the fault schedule's view at
each kernel's issue cycle (:mod:`tpusim_torch.faults`).  A cancel token
(:mod:`tpusim_torch.guard.cancel`) is checked every ``CHECK_EVERY_OPS``
ops of the serial walk and between the fastpath's compiled blocks.  Not
ported yet: the observability sampler (ROADMAP A10).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from tpusim_torch.ici.collectives import CollectiveModel
from tpusim_torch.ici.detailed import make_collective_model
from tpusim_torch.ici.topology import Topology, torus_for
from tpusim_torch.ir import (
    Computation,
    FREE_OPCODES,
    ModuleTrace,
    TraceOp,
    Unit,
    leaves_of,
)
from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.cost import CostModel, while_trip_count
from tpusim_torch.trace.loop_analysis import infer_trip_count

__all__ = ["Engine", "EngineResult", "TimelineEvent"]

#: events a recorded timeline keeps per computation walk
MAX_TIMELINE_EVENTS = 100_000

#: async ``-done`` bases whose wait counts as exposed collective time
_COLLECTIVE_DONE_BASES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)


@dataclass
class TimelineEvent:
    """One op's span on its unit, recorded under ``record_timeline``."""

    name: str
    opcode: str
    unit: str
    start_cycle: float
    end_cycle: float


@dataclass
class EngineResult:
    """Counters for one simulated module execution."""

    cycles: float = 0.0
    seconds: float = 0.0
    op_count: int = 0
    flops: float = 0.0
    mxu_flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    vmem_bytes: float = 0.0
    ici_bytes: float = 0.0
    collective_count: int = 0
    collective_cycles: float = 0.0       # total ICI busy cycles
    exposed_collective_cycles: float = 0.0  # cycles the core waited on ICI
    dma_cycles: float = 0.0
    exposed_dma_cycles: float = 0.0
    vmem_resident_bytes: float = 0.0     # peak S(1) residency of the module
    vmem_spill_bytes: float = 0.0        # vmem traffic re-priced at HBM rate
    hbm_contention_cycles: float = 0.0   # extra cycles from DMA/compute share
    orphan_async_joins: int = 0     # -done with no matching -start
    unjoined_async: int = 0         # -start never joined before comp end
    unknown_trip_loops: int = 0     # while loops with unresolvable bounds
    worst_case_branches: int = 0    # conditionals timed at their worst arm
    unit_busy_cycles: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    opcode_cycles: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    # per-instruction aggregates (loop bodies scaled by trip count)
    per_op_cycles: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    per_op_count: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    per_op_opcode: dict[str, str] = field(default_factory=dict)
    per_op_async: dict[str, bool] = field(default_factory=dict)
    per_op_hbm_bytes: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    per_op_flops: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    per_op_mxu_flops: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    #: op spans of a run with ``record_timeline`` (serial walk only)
    timeline: list[TimelineEvent] = field(default_factory=list)

    # -- derived -----------------------------------------------------------

    @property
    def mxu_utilization(self) -> float:
        busy = self.unit_busy_cycles.get(Unit.MXU.value, 0.0)
        return busy / self.cycles if self.cycles else 0.0

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds if self.seconds else 0.0

    @property
    def hbm_gbps(self) -> float:
        return self.hbm_bytes / self.seconds / 1e9 if self.seconds else 0.0

    def merge_scaled(self, other: "EngineResult", times: float = 1.0) -> None:
        """Accumulate a sub-result (e.g. a while body × trip count)."""
        self.op_count += int(other.op_count * times)
        self.flops += other.flops * times
        self.mxu_flops += other.mxu_flops * times
        self.transcendentals += other.transcendentals * times
        self.hbm_bytes += other.hbm_bytes * times
        self.vmem_bytes += other.vmem_bytes * times
        self.ici_bytes += other.ici_bytes * times
        self.collective_count += int(other.collective_count * times)
        self.collective_cycles += other.collective_cycles * times
        self.exposed_collective_cycles += other.exposed_collective_cycles * times
        self.dma_cycles += other.dma_cycles * times
        self.exposed_dma_cycles += other.exposed_dma_cycles * times
        self.vmem_resident_bytes = max(
            self.vmem_resident_bytes, other.vmem_resident_bytes
        )
        self.vmem_spill_bytes += other.vmem_spill_bytes * times
        self.hbm_contention_cycles += other.hbm_contention_cycles * times
        self.orphan_async_joins += int(other.orphan_async_joins * times)
        self.unjoined_async += int(other.unjoined_async * times)
        self.unknown_trip_loops += int(other.unknown_trip_loops * times)
        self.worst_case_branches += int(other.worst_case_branches * times)
        for k, v in other.unit_busy_cycles.items():
            self.unit_busy_cycles[k] += v * times
        for k, v in other.opcode_cycles.items():
            self.opcode_cycles[k] += v * times
        for k, v in other.per_op_cycles.items():
            self.per_op_cycles[k] += v * times
        for k, v in other.per_op_count.items():
            self.per_op_count[k] += v * times
        for k, v in other.per_op_hbm_bytes.items():
            self.per_op_hbm_bytes[k] += v * times
        for k, v in other.per_op_flops.items():
            self.per_op_flops[k] += v * times
        for k, v in other.per_op_mxu_flops.items():
            self.per_op_mxu_flops[k] += v * times
        self.per_op_opcode.update(other.per_op_opcode)
        self.per_op_async.update(other.per_op_async)

    def stats_dict(self) -> dict[str, float]:
        d = {
            "sim_cycles": self.cycles,
            "sim_seconds": self.seconds,
            "op_count": self.op_count,
            "flops": self.flops,
            "mxu_flops": self.mxu_flops,
            "hbm_bytes": self.hbm_bytes,
            "vmem_bytes": self.vmem_bytes,
            "ici_bytes": self.ici_bytes,
            "collective_count": self.collective_count,
            "collective_cycles": self.collective_cycles,
            "exposed_collective_cycles": self.exposed_collective_cycles,
            "dma_cycles": self.dma_cycles,
            "exposed_dma_cycles": self.exposed_dma_cycles,
            "vmem_resident_bytes": self.vmem_resident_bytes,
            "vmem_spill_bytes": self.vmem_spill_bytes,
            "hbm_contention_cycles": self.hbm_contention_cycles,
            "orphan_async_joins": self.orphan_async_joins,
            "unjoined_async": self.unjoined_async,
            "unknown_trip_loops": self.unknown_trip_loops,
            "worst_case_branches": self.worst_case_branches,
            "mxu_utilization": self.mxu_utilization,
            "achieved_tflops": self.achieved_flops / 1e12,
            "hbm_gbps": self.hbm_gbps,
        }
        for unit, busy in self.unit_busy_cycles.items():
            d[f"busy_cycles_{unit}"] = busy
        return d


def _vmem_resident_bytes(module: ModuleTrace) -> float:
    """Total bytes XLA pinned in vmem (layout memory space ``S(1)``),
    counted once per *allocating* op; alias chains (pass-through ops,
    while/conditional results, ``*-done`` halves, in-place body DUS) are
    not double-counted.  See :func:`_alloc_vmem_bytes`."""
    total = 0.0
    entry_name = module.entry_name
    for cname, comp in module.computations.items():
        is_entry = entry_name is not None and cname == entry_name
        for op in comp.ops:
            total += _alloc_vmem_bytes(op, is_entry)
    return total


def _alloc_vmem_bytes(op: TraceOp, is_entry: bool) -> float:
    """Vmem (``S(1)``) bytes newly allocated by one op; 0 for aliases."""
    if op.opcode in FREE_OPCODES or op.base in FREE_OPCODES:
        if not (is_entry and op.opcode == "parameter"):
            return 0.0
    if op.base in ("while", "conditional", "call") or op.is_async_done:
        # while/conditional/call results alias their init/branch/callee-root
        # values — the callee's own walk already counts the allocation
        return 0.0
    if not is_entry and op.base == "dynamic-update-slice":
        return 0.0
    leaves = leaves_of(op.result)
    if op.is_async_start and op.base == "copy":
        # result is (dst, src-alias, ctx): only the leading dst leaf is a
        # new allocation
        if leaves and leaves[0].memory_space != 0:
            return float(leaves[0].nbytes)
        return 0.0
    if op.is_async_start:
        # collective starts carry (operand-alias, result, ...): one buffer
        return float(max(
            (l.nbytes for l in leaves if l.memory_space != 0),
            default=0.0,
        ))
    return float(sum(l.nbytes for l in leaves if l.memory_space != 0))


def _vmem_peak_live_bytes(module: ModuleTrace) -> float:
    """Peak *concurrently-live* ``S(1)`` bytes — what the vmem budget
    actually constrains.  Per computation: parameters' vmem leaves are
    live throughout; local defs become live at their def index and die
    after their last use.  At a while/conditional/call, the callee's peak
    coexists with the caller's live set, minus the carried operands."""
    entry_name = module.entry_name
    peaks: dict[str, float] = {}

    def comp_peak(cname: str, depth: int) -> float:
        comp = module.computations.get(cname)
        if comp is None or depth > 16:
            return 0.0
        if cname in peaks:
            return peaks[cname]
        is_entry = entry_name is not None and cname == entry_name
        n = len(comp.ops)
        last_use: dict[str, int] = {}
        for i, op in enumerate(comp.ops):
            for o in op.operands:
                last_use[o] = max(last_use.get(o, i), i)
        # extend lifetimes through aliasing consumers; reverse order so an
        # alias's extended lifetime is final before its operands are seen
        ext: dict[str, int] = {}
        for i in range(n - 1, -1, -1):
            op = comp.ops[i]
            is_alias = (
                op.opcode in FREE_OPCODES or op.base in FREE_OPCODES
                or op.is_async_done
                or op.base in ("while", "conditional", "call")
                or (not is_entry and op.base == "dynamic-update-slice")
            )
            if not is_alias:
                continue
            eff = max(last_use.get(op.name, i), ext.get(op.name, i))
            for o in op.operands:
                ext[o] = max(ext.get(o, 0), eff)
        frees: dict[int, float] = defaultdict(float)
        live = 0.0
        local_peak = 0.0
        for i, op in enumerate(comp.ops):
            if op.base in ("while", "conditional", "call") and op.called:
                carried = sum(
                    l.nbytes
                    for o in op.operands if comp.has_op(o)
                    for l in leaves_of(comp.op(o).result)
                    if l.memory_space != 0
                )
                inner = max(
                    comp_peak(callee, depth + 1) for callee in op.called
                )
                local_peak = max(
                    local_peak, live + max(inner - carried, 0.0)
                )
            nbytes = (
                float(sum(
                    l.nbytes for l in leaves_of(op.result)
                    if l.memory_space != 0
                ))
                if op.opcode == "parameter" and not is_entry
                else _alloc_vmem_bytes(op, is_entry)
            )
            if nbytes > 0:
                live += nbytes
                if live > local_peak:
                    local_peak = live
                if op.opcode == "parameter" and not is_entry:
                    die = n  # carried state stays live for the body
                else:
                    die = max(last_use.get(op.name, n), ext.get(op.name, 0))
                frees[die] += nbytes
            live -= frees.pop(i, 0.0)
        peaks[cname] = local_peak
        return local_peak

    if entry_name is not None and entry_name in module.computations:
        return comp_peak(entry_name, 0)
    return max(
        (comp_peak(cname, 0) for cname in list(module.computations)),
        default=0.0,
    )


def _residency_of(module: ModuleTrace) -> float:
    """:func:`_vmem_resident_bytes`, memoized on the module (it is not
    mutated after parse).  A lazy module answers with its raw-text scan
    (``vmem_resident_bytes``), so the check does not force a parse."""
    cached = getattr(module, "_residency_cache", None)
    if cached is None:
        fast = getattr(module, "vmem_resident_bytes", None)
        cached = module._residency_cache = (
            fast() if callable(fast) else _vmem_resident_bytes(module)
        )
    return cached


class Engine:
    """Times one module on one modeled device of a topology."""

    def __init__(
        self,
        config: SimConfig,
        topology: Topology | None = None,
        record_timeline: bool = False,
        clock_scale: float = 1.0,
        hbm_scale: float = 1.0,
        pricing_backend: str | None = None,
        cancel=None,
    ):
        self.config = config
        # cooperative cancellation (tpusim_torch.guard.CancelToken | None):
        # changes whether a result is produced, never its value
        self.cancel = cancel
        self.arch = config.arch
        self.cost = CostModel(self.arch)
        # pricing backend (tpusim_torch.fastpath): None/"auto" resolves to
        # the fastest available path; "serial" pins the reference walk.
        # Resolved at the first run.
        self.pricing_backend = pricing_backend
        self._resolved_backend: str | None = None
        self.topology = topology
        self.record_timeline = record_timeline
        # degraded-chip multipliers: a straggler runs its core/vmem at
        # clock_scale x nominal, a throttled HBM streams at hbm_scale x
        # nominal.  Cycles stay in NOMINAL units (the pod clock), so a
        # straggler's ops take 1/clock_scale more of them; 1.0/1.0 keeps
        # the healthy path bit-identical (no per-op branch)
        if not 0.0 < clock_scale <= 1.0 or not 0.0 < hbm_scale <= 1.0:
            raise ValueError(
                "clock_scale/hbm_scale must be in (0, 1] "
                f"(got {clock_scale}, {hbm_scale})"
            )
        self.clock_scale = float(clock_scale)
        self.hbm_scale = float(hbm_scale)
        self._degraded = clock_scale != 1.0 or hbm_scale != 1.0

    @staticmethod
    def _peak_live_of(module: ModuleTrace) -> float:
        cached = getattr(module, "_peak_live_cache", None)
        if cached is None:
            cached = module._peak_live_cache = _vmem_peak_live_bytes(module)
        return cached

    def _topology_for(self, module: ModuleTrace) -> Topology:
        if self.topology is not None:
            return self.topology
        return torus_for(module.num_devices, self.arch.name)

    def run(self, module: ModuleTrace) -> EngineResult:
        """Simulate one execution of the module's entry computation.

        Dispatches to the compiled fastpath (:mod:`tpusim_torch.fastpath`)
        when a non-serial backend resolves and the run is eligible (see
        ``fastpath_eligible``); the serial walk is the reference semantics
        the fastpath is byte-identical to."""
        backend = self._resolved_backend
        if backend is None:
            from tpusim_torch.fastpath.price import resolve_backend

            backend = self._resolved_backend = resolve_backend(
                self.pricing_backend
            )
        if backend != "serial":
            from tpusim_torch.fastpath.price import (
                fastpath_eligible,
                price_module,
            )

            if fastpath_eligible(self):
                return price_module(self, module, backend)
        return self._run_serial(module)

    def _run_serial(self, module: ModuleTrace) -> EngineResult:
        """The reference per-op schedule walk."""
        topo = self._topology_for(module)
        coll = make_collective_model(topo, self.arch.ici)
        result = EngineResult()
        spill_frac = 1.0
        if self.config.model_vmem_capacity:
            resident = _residency_of(module)
            cap = float(self.arch.vmem_bytes)
            if resident > cap > 0:
                # the conservative sum counts every allocation as
                # simultaneous; check what is actually concurrently live
                resident = self._peak_live_of(module)
            result.vmem_resident_bytes = resident
            if resident > cap > 0:
                # over-subscribed vmem: the overflow fraction spills to HBM
                spill_frac = cap / resident
        end = self._run_computation(
            module, module.entry, t0=0.0, coll=coll, result=result, depth=0,
            spill_frac=spill_frac,
        )
        result.cycles = end
        result.seconds = self.arch.cycles_to_seconds(end)
        return result

    # ------------------------------------------------------------------

    def _run_computation(
        self,
        module: ModuleTrace,
        comp: Computation,
        t0: float,
        coll: CollectiveModel,
        result: EngineResult,
        depth: int,
        spill_frac: float = 1.0,
    ) -> float:
        """Walk one computation's schedule; returns the finish cycle."""
        if depth > 32:
            return t0
        a = self.arch
        t = t0
        ici_free = t0
        dma_free = t0
        pending: dict[str, float] = {}  # async op name -> finish cycle
        dma_names: set[str] = set()     # pending entries on the DMA channel
        # horizon until which the async DMA channel is draining HBM, plus
        # the in-flight transfer segments [start, end, bytes/cycle]
        dma_busy_until = t0
        dma_segments: list[list[float]] = []
        hbm_bpc = a.hbm_bytes_per_cycle
        dma_lat = a.seconds_to_cycles(a.dma_issue_latency)
        contend = self.config.model_hbm_contention
        overlap = self.config.overlap_collectives
        # op-granularity checkpoint/resume applies to the entry walk only
        resume_op = self.config.resume_op if depth == 0 else 0
        checkpoint_op = self.config.checkpoint_op if depth == 0 else 0
        skipped_starts: set[str] = set()
        # one pointer compare per op when ungoverned; a real check every
        # CHECK_EVERY_OPS ops
        cancel = self.cancel
        if cancel is not None:
            from tpusim_torch.guard.cancel import CHECK_EVERY_OPS as _stride

        for op_index, op in enumerate(comp.ops):
            if cancel is not None and op_index % _stride == 0:
                cancel.check()
            if checkpoint_op and op_index >= checkpoint_op:
                break
            if resume_op and op_index < resume_op:
                # fast-forward; starts skipped here join silently later
                if op.is_async_start:
                    skipped_starts.add(op.name)
                continue
            base = op.base

            # ---- control flow: recurse ---------------------------------
            if base == "while" and len(op.called) >= 1:
                body_name = op.attrs.get("body", "").lstrip("%") or op.called[0]
                trips = while_trip_count(op, 0)
                if trips <= 0:  # no backend_config: infer from the IV pattern
                    trips = infer_trip_count(module, comp, op, -1)
                    if trips < 0:
                        trips = self.config.default_loop_trip_count
                        result.unknown_trip_loops += 1
                sub = EngineResult()
                body_end = self._run_computation(
                    module, module.computation(body_name), 0.0, coll, sub,
                    depth + 1, spill_frac,
                )
                result.merge_scaled(sub, float(trips))
                dur = body_end * trips + a.op_overhead_cycles * (trips + 1)
                self._emit(result, op, t, t + dur, Unit.SCALAR)
                t += dur
                result.op_count += 1
                continue
            if base == "conditional" and op.called:
                durs = []
                subs = []
                for branch in op.called:
                    if branch not in module.computations:
                        continue
                    sub = EngineResult()
                    d = self._run_computation(
                        module, module.computation(branch), 0.0, coll, sub,
                        depth + 1, spill_frac,
                    )
                    durs.append(d)
                    subs.append(sub)
                if durs:
                    worst = max(range(len(durs)), key=lambda i: durs[i])
                    result.merge_scaled(subs[worst], 1.0)
                    dur = durs[worst] + a.op_overhead_cycles
                    if len(durs) > 1 and max(durs) > 1.5 * min(durs):
                        # the worst-case assumption is materially wrong for
                        # whichever arm actually runs — surface it
                        result.worst_case_branches += 1
                    self._emit(result, op, t, t + dur, Unit.SCALAR)
                    t += dur
                result.op_count += 1
                continue
            if base == "call" and op.called:
                sub = EngineResult()
                d = self._run_computation(
                    module, module.computation(op.called[0]), 0.0, coll, sub,
                    depth + 1, spill_frac,
                )
                result.merge_scaled(sub, 1.0)
                self._emit(result, op, t, t + d, Unit.SCALAR)
                t += d
                result.op_count += 1
                continue

            # ---- async joins -------------------------------------------
            if op.is_async_done:
                src = op.operands[0] if op.operands else None
                if src in skipped_starts:
                    # started before the resume point: complete by now
                    result.op_count += 1
                    continue
                if src not in pending:
                    result.orphan_async_joins += 1
                finish = pending.pop(src, t)
                waited = max(0.0, finish - t)
                if op.base in _COLLECTIVE_DONE_BASES:
                    result.exposed_collective_cycles += waited
                else:
                    result.exposed_dma_cycles += waited
                t = max(t, finish)
                result.op_count += 1
                continue

            cost = self.cost.op_cost(op, comp, module)

            # ---- degraded chip: straggler clock / HBM throttle ---------
            # (free ops — parameter/tuple/bitcast — cost 0 and stay 0:
            # there is no work to slow down)
            if self._degraded and cost.cycles > 0:
                cs, hs = self.clock_scale, self.hbm_scale
                # core + vmem run on the chip clock; HBM is derated
                # independently.  Cycles are nominal, so slower silicon
                # means MORE nominal cycles; the max() keeps floors
                # (dispatch, small-kernel) monotone under degradation.
                cost.compute_cycles /= cs
                cost.hbm_rate_scale *= hs
                cost.vmem_rate_scale *= cs
                cost.mem_cycles = max(
                    cost.hbm_bytes / (hbm_bpc * cost.hbm_rate_scale),
                    cost.vmem_bytes
                    / (a.vmem_bytes_per_cycle * cost.vmem_rate_scale),
                )
                cost.cycles = max(
                    cost.cycles,
                    a.op_overhead_cycles / cs + max(
                        cost.compute_cycles, cost.mem_cycles
                    ),
                )

            # ---- vmem capacity: spill the over-subscribed fraction -----
            if spill_frac < 1.0 and cost.vmem_bytes > 0:
                spilled = cost.vmem_bytes * (1.0 - spill_frac)
                cost.vmem_bytes -= spilled
                cost.hbm_bytes += spilled
                result.vmem_spill_bytes += spilled
                cost.mem_cycles = max(
                    cost.hbm_bytes / (hbm_bpc * cost.hbm_rate_scale),
                    cost.vmem_bytes
                    / (a.vmem_bytes_per_cycle * cost.vmem_rate_scale),
                )
                # spilling only adds traffic: never below the original
                # price (which may carry the small-kernel dispatch floor)
                cost.cycles = max(
                    cost.cycles,
                    a.op_overhead_cycles + max(
                        cost.compute_cycles, cost.mem_cycles
                    ),
                )

            # ---- collectives -------------------------------------------
            if op.is_collective:
                seconds = coll.seconds(op.collective, cost.ici_bytes)
                dur = a.seconds_to_cycles(seconds)
                result.collective_count += 1
                result.ici_bytes += cost.ici_bytes
                result.collective_cycles += dur
                result.unit_busy_cycles[Unit.ICI.value] += dur
                result.opcode_cycles[base] += dur
                if op.is_async_start and overlap:
                    # runs on the ICI timeline; the core pays the issue
                    start = max(t, ici_free)
                    pending[op.name] = start + dur
                    ici_free = start + dur
                    self._emit(result, op, start, start + dur, Unit.ICI)
                    t += a.op_overhead_cycles
                else:
                    start = max(t, ici_free)
                    self._emit(result, op, start, start + dur, Unit.ICI)
                    t = start + dur
                    ici_free = t
                    result.exposed_collective_cycles += dur
                    if op.is_async_start:
                        # already complete when the done-op arrives;
                        # register so the join doesn't count as orphaned
                        pending[op.name] = t
                result.op_count += 1
                continue

            # ---- async DMA (copy-start etc.) ---------------------------
            if op.is_async_start:
                dur = cost.cycles
                start = max(t, dma_free)
                # issue latency delays the completion but does not occupy
                # the channel; payloads serialize on bandwidth
                pending[op.name] = start + dma_lat + dur
                dma_names.add(op.name)
                dma_free = start + dur
                if cost.hbm_bytes > 0:
                    dma_busy_until = max(dma_busy_until, start + dur)
                    if dur > 0:
                        dma_segments.append(
                            [start, start + dur, cost.hbm_bytes / dur]
                        )
                result.dma_cycles += dur
                result.unit_busy_cycles[Unit.DMA.value] += dur
                result.opcode_cycles[base] += dur
                result.hbm_bytes += cost.hbm_bytes
                result.per_op_hbm_bytes[op.name] += cost.hbm_bytes
                # per-op aggregates see the exposure (queueing + latency +
                # transfer); the timeline keeps the channel occupancy span
                self._emit(
                    result, op, start, start + dur, Unit.DMA,
                    per_op_span=(t, start + dma_lat + dur),
                )
                t += a.op_overhead_cycles
                result.op_count += 1
                continue

            # ---- ordinary synchronous op -------------------------------
            dur = cost.cycles
            if contend and cost.hbm_bytes > 0 and dma_busy_until > t:
                # the async DMA queue and this op stream HBM concurrently;
                # fair-share split: each side pays the overlapped bytes once
                # more
                dma_segments = [s for s in dma_segments if s[1] > t]
                q_bytes = sum(
                    s[2] * (s[1] - max(t, s[0])) for s in dma_segments
                )
                shared = min(cost.hbm_bytes, q_bytes)
                penalty = shared / hbm_bpc
                hbm_time = (
                    cost.hbm_bytes / (hbm_bpc * cost.hbm_rate_scale)
                    + penalty
                )
                mem_cycles = max(
                    hbm_time,
                    cost.vmem_bytes
                    / (a.vmem_bytes_per_cycle * cost.vmem_rate_scale),
                )
                # contention only slows an op down
                new_dur = max(dur, a.op_overhead_cycles + max(
                    cost.compute_cycles, mem_cycles
                ))
                result.hbm_contention_cycles += (
                    max(new_dur - dur, 0.0) + penalty
                )
                # the DMA side loses the same bandwidth
                for name in dma_names:
                    fin = pending.get(name)
                    if fin is not None and fin > t:
                        pending[name] = fin + penalty
                dma_free += penalty
                dma_busy_until += penalty
                for s in dma_segments:
                    if s[0] >= t:
                        s[0] += penalty
                        s[1] += penalty
                    else:
                        remaining = s[2] * (s[1] - t)
                        s[0] = t
                        s[1] += penalty
                        if s[1] > t:
                            s[2] = remaining / (s[1] - t)
                dur = new_dur
            if dur > 0:
                self._emit(result, op, t, t + dur, cost.unit)
            t += dur
            result.op_count += 1
            result.flops += cost.flops
            result.mxu_flops += cost.mxu_flops
            result.transcendentals += cost.transcendentals
            result.hbm_bytes += cost.hbm_bytes
            result.vmem_bytes += cost.vmem_bytes
            if cost.hbm_bytes > 0:
                result.per_op_hbm_bytes[op.name] += cost.hbm_bytes
            if cost.flops > 0:
                result.per_op_flops[op.name] += cost.flops
            if cost.mxu_flops > 0:
                result.per_op_mxu_flops[op.name] += cost.mxu_flops
            if dur > 0:
                result.unit_busy_cycles[cost.unit.value] += dur
                result.opcode_cycles[base] += dur

        # drain: leftovers indicate a truncated/corrupt trace, except at an
        # op-granularity checkpoint, where the drain is the barrier itself
        stopped_at_checkpoint = (
            checkpoint_op and len(comp.ops) > checkpoint_op
        )
        if not stopped_at_checkpoint:
            result.unjoined_async += len(pending)
        for finish in pending.values():
            t = max(t, finish)
        return t

    # ------------------------------------------------------------------

    def _emit(
        self, result: EngineResult, op: TraceOp, start: float, end: float,
        unit: Unit,
        per_op_span: tuple[float, float] | None = None,
    ) -> None:
        """Per-instruction aggregates (loop bodies scaled by the caller),
        and the op's span when the timeline is recorded.  ``per_op_span``
        lets async transfers report their exposure (issue to completion)
        to the aggregates while the timeline keeps the channel span."""
        po_start, po_end = per_op_span if per_op_span else (start, end)
        result.per_op_cycles[op.name] += po_end - po_start
        result.per_op_count[op.name] += 1.0
        result.per_op_opcode.setdefault(op.name, op.base)
        if op.is_async_start:
            result.per_op_async[op.name] = True
        if not self.record_timeline:
            return
        if len(result.timeline) >= MAX_TIMELINE_EVENTS:
            return
        result.timeline.append(
            TimelineEvent(op.name, op.opcode, unit.value, start, end)
        )

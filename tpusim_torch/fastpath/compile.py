"""Phase 1: compile a module's computations into flat pricing columns.

Port of ``tpusim/fastpath/compile.py``.  One cost-model pass per
computation produces parallel CPU ``torch.float64`` columns (one row per
scheduled op) plus a *step program* that preserves the serial walk's
structure:

* ``("run", lo, hi, ...)``    — a contiguous block of ordinary
  synchronous ops with **no async DMA statically in flight**: safe to
  accumulate in one vectorized serial scan (HBM contention cannot
  engage, so every op's duration is its precompiled column value after
  the launch-class transforms).
* ``("crun", lo, hi)``        — sync ops inside a DMA-in-flight region;
  stepped one by one with the full contention logic.
* scalar steps for control flow (``while``/``cond``/``call``), async
  joins, collectives, and async DMA starts.

Whether DMA is in flight is static: ``pending`` starts empty at every
computation entry, async starts open it, their ``-done`` joins close it,
and after the last join the core clock provably sits at-or-past the DMA
channel horizon (``finish = start + latency + dur >= start + dur``), so
the contention predicate ``dma_busy_until > t`` is statically false in
``run`` blocks.  A start that is never joined keeps the rest of the
computation in ``crun`` conservatively.

Columns hold the *healthy* per-op costs; degraded-chip multipliers and
vmem spill are applied per launch class at price time (see
``price._Ctx.view``) with the exact float-op sequence of the serial walk.
Index tables (emit masks, per-unit and per-opcode groups) are int64
tensors.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch

from tpusim_torch.ir import Computation, ModuleTrace
from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.cost import CostModel, while_trip_count
from tpusim_torch.timing.engine import _COLLECTIVE_DONE_BASES
from tpusim_torch.trace.loop_analysis import infer_trip_count

__all__ = ["CompiledComputation", "CompiledModule", "compile_module"]


def _f64(values: list[float]) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64)


def _idx(values: list[int]) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64)


@dataclass
class CompiledComputation:
    """Flat columns + step program for one computation."""

    name: str
    n_ops: int
    #: per-op identity (None when compiled lean for streaming pricing)
    names: list[str] | None
    bases: list[str]
    #: per-op unit value string (None for rows that never emit)
    units: list = field(default_factory=list)
    #: float64 columns, one row per op (zeros for non-sync rows)
    cycles: torch.Tensor = None
    compute: torch.Tensor = None
    hbm: torch.Tensor = None
    vmem: torch.Tensor = None
    hrs: torch.Tensor = None          # hbm_rate_scale
    vrs: torch.Tensor = None          # vmem_rate_scale
    flops: torch.Tensor = None
    mxu: torch.Tensor = None
    trans: torch.Tensor = None
    ici_bytes: torch.Tensor = None
    #: the step program (tuples; see module docstring)
    steps: list = field(default_factory=list)
    #: True when any row has vmem > 0 — lets price skip building spill
    #: views that would be identity
    any_vmem: bool = False
    #: cached .tolist() views of the healthy columns (built lazily)
    _lists: dict = field(default_factory=dict, repr=False)
    #: step index -> the run step's scans packed for one launch of the
    #: ``scan_rows`` kernel (the ``cuda`` batch route; built lazily)
    scan_plans: dict = field(default_factory=dict, repr=False)

    def col_list(self, attr: str) -> list:
        cached = self._lists.get(attr)
        if cached is None:
            cached = self._lists[attr] = getattr(self, attr).tolist()
        return cached


class CompiledModule:
    """Lazily-compiled computations of one module (compiled as the pricing
    walk first reaches them — a streaming module never compiles
    computations its schedule never runs).

    ``lean`` compiles drop the per-op name table (the streaming module's
    O(trace) memory term; the priced result then carries no per-op
    aggregates), and ``release_ir`` hands each computation back to the
    module's ``release_computation`` once its columns exist.

    Only a WEAK reference to the source :class:`ModuleTrace` is held: the
    process-wide tier in :mod:`tpusim_torch.perf.cache` keeps instances
    alive, and a strong ref would pin every priced module's parsed IR for
    the process lifetime.  Every pricing call re-binds the live module via
    :func:`tpusim_torch.perf.cache.compiled_for`."""

    def __init__(self, module: ModuleTrace, cost: CostModel,
                 config: SimConfig, lean: bool = False,
                 release_ir: bool = False):
        self._module_ref = weakref.ref(module)
        self.cost = cost
        self.config = config
        self.lean = lean               # skip per-op identity (streaming)
        self.release_ir = release_ir   # drop parsed IR after compile
        self.comps: dict[str, CompiledComputation] = {}
        # content-derived module scalars cached beside the columns, so a
        # disk-loaded instance never re-scans the trace text: the entry
        # computation's name, the S(1) residency sum (tagged with the
        # KIND of scan that produced it: the raw-text scan of a lazy
        # module and the IR walk of an eager one never cross-serve) and
        # (when a spill run computed it) the peak-live refinement
        self.entry_name: str | None = None
        self.residency: float | None = None
        self.residency_kind: str | None = None
        self.peak_live: float | None = None
        # durable tier bookkeeping (tpusim_torch.fastpath.store): the key
        # the instance publishes under (None = not in the shared tier)
        # and whether a pricing walk compiled columns not yet on disk
        self._store_key: str | None = None
        self._store_dirty = False

    def bind(self, module: ModuleTrace, cost: CostModel) -> None:
        """(Re)attach the live module for lazy compiles of computations
        the walk has not reached yet."""
        self._module_ref = weakref.ref(module)
        self.cost = cost

    @property
    def module(self) -> ModuleTrace:
        m = self._module_ref()
        if m is None:
            raise RuntimeError(
                "CompiledModule's source ModuleTrace was released; "
                "re-enter through tpusim_torch.perf.cache.compiled_for"
            )
        return m

    def comp(self, name: str) -> CompiledComputation:
        cc = self.comps.get(name)
        if cc is None:
            module = self.module
            cc = compile_computation(
                module, module.computation(name), self.cost, self.config,
                lean=self.lean,
            )
            self.comps[name] = cc
            self._store_dirty = True
            if self.release_ir:
                release = getattr(module, "release_computation", None)
                if release is not None:
                    release(name)
        return cc


def compile_computation(
    module: ModuleTrace,
    comp: Computation,
    cost_model: CostModel,
    config: SimConfig,
    lean: bool = False,
) -> CompiledComputation:
    """One cost-model pass over ``comp`` -> columns + step program."""
    ops = comp.ops
    n = len(ops)
    # lean (streaming) compiles drop the per-op identity column — the one
    # O(distinct names) memory term — but keep bases: opcode_cycles
    # accumulates in every mode.  Bases are interned: every parse mints
    # its own "add"/"fusion" string objects, and a streaming compile
    # keeping one per op would hold O(ops) duplicates of a dozen opcodes
    intern = sys.intern
    names: list[str] | None = None if lean else [op.name for op in ops]
    bases = [intern(op.base) for op in ops]

    # the columns are filled as Python lists (exact float64 values) and
    # become tensors once the pass is over
    cycles = [0.0] * n
    compute = [0.0] * n
    hbm = [0.0] * n
    vmem = [0.0] * n
    hrs = [1.0] * n
    vrs = [1.0] * n
    flops = [0.0] * n
    mxu = [0.0] * n
    trans = [0.0] * n
    icib = [0.0] * n
    unit_val: list[str | None] = [None] * n

    steps: list = []
    dma_open: set[str] = set()   # async DMA starts not yet joined
    run_lo = -1                  # open run/crun block start
    run_kind = ""

    def close_run(hi: int) -> None:
        nonlocal run_lo, run_kind
        if run_lo < 0:
            return
        if run_kind == "run":
            steps.append(_finish_run(run_lo, hi))
        else:
            steps.append(("crun", run_lo, hi))
        run_lo = -1

    def _finish_run(lo: int, hi: int):
        # emit mask (dur > 0 is static: transforms only grow positive
        # durations and leave exact zeros exactly zero), plus the grouped
        # accumulator index tables the vector executor chains
        rng = range(lo, hi)
        emit = [i for i in rng if cycles[i] > 0.0]
        ug: dict[str, list[int]] = {}
        og: dict[str, list[int]] = {}
        for i in emit:
            ug.setdefault(unit_val[i], []).append(i)
            og.setdefault(bases[i], []).append(i)
        return (
            "run", lo, hi, _idx(emit),
            _idx([i for i in rng if hbm[i] > 0.0]),
            _idx([i for i in rng if flops[i] > 0.0]),
            _idx([i for i in rng if mxu[i] > 0.0]),
            [(u, _idx(idx)) for u, idx in ug.items()],
            [(b, _idx(idx)) for b, idx in og.items()],
        )

    def open_run(i: int) -> None:
        nonlocal run_lo, run_kind
        kind = "run" if not dma_open else "crun"
        if run_lo >= 0 and run_kind == kind:
            return
        close_run(i)
        run_lo = i
        run_kind = kind

    for i, op in enumerate(ops):
        base = op.base

        if base == "while" and len(op.called) >= 1:
            close_run(i)
            body = op.attrs.get("body", "").lstrip("%") or op.called[0]
            trips = while_trip_count(op, 0)
            unknown = False
            if trips <= 0:
                trips = infer_trip_count(module, comp, op, -1)
                if trips < 0:
                    trips = config.default_loop_trip_count
                    unknown = True
            steps.append(("while", i, op.name, base, body, trips, unknown))
            continue
        if base == "conditional" and op.called:
            close_run(i)
            branches = tuple(
                b for b in op.called if b in module.computations
            )
            steps.append(("cond", i, op.name, base, branches))
            continue
        if base == "call" and op.called:
            close_run(i)
            steps.append(("call", i, op.name, base, op.called[0]))
            continue
        if op.is_async_done:
            close_run(i)
            src = op.operands[0] if op.operands else None
            steps.append(("done", i, src, base in _COLLECTIVE_DONE_BASES))
            if src is not None:
                dma_open.discard(src)
            continue

        cost = cost_model.op_cost(op, comp, module)
        cycles[i] = cost.cycles
        compute[i] = cost.compute_cycles
        hbm[i] = cost.hbm_bytes
        vmem[i] = cost.vmem_bytes
        hrs[i] = cost.hbm_rate_scale
        vrs[i] = cost.vmem_rate_scale
        flops[i] = cost.flops
        mxu[i] = cost.mxu_flops
        trans[i] = cost.transcendentals
        unit_val[i] = cost.unit.value

        if op.is_collective:
            close_run(i)
            icib[i] = cost.ici_bytes
            steps.append((
                "coll", i, op.name, base, op.collective,
                op.is_async_start,
            ))
            continue
        if op.is_async_start:
            close_run(i)
            steps.append(("dma", i, op.name, base))
            dma_open.add(op.name)
            continue

        open_run(i)

    close_run(n)

    return CompiledComputation(
        name=comp.name, n_ops=n, names=names, bases=bases,
        units=unit_val,
        cycles=_f64(cycles), compute=_f64(compute), hbm=_f64(hbm),
        vmem=_f64(vmem), hrs=_f64(hrs), vrs=_f64(vrs), flops=_f64(flops),
        mxu=_f64(mxu), trans=_f64(trans), ici_bytes=_f64(icib),
        steps=steps,
        any_vmem=any(v > 0.0 for v in vmem),
    )


def compile_module(
    module: ModuleTrace,
    cost_model: CostModel,
    config: SimConfig,
    lean: bool = False,
    release_ir: bool = False,
) -> CompiledModule:
    """A lazily-populated :class:`CompiledModule`.  Callers wanting
    cross-engine reuse go through :func:`tpusim_torch.perf.cache.
    compiled_for` instead."""
    return CompiledModule(
        module=module, cost=cost_model, config=config, lean=lean,
        release_ir=release_ir,
    )

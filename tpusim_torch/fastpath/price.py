"""Phase 2: price a compiled module for one launch class.

Port of ``tpusim/fastpath/price.py``.  ``price_module`` mirrors
:meth:`tpusim_torch.timing.engine.Engine._run_serial` step for step —
same accumulators, same float-op order, same dict-insertion order — but
consumes the precompiled columns of :mod:`tpusim_torch.fastpath.compile`
instead of calling the cost model per op.  Runs of ordinary sync ops
collapse into serial scans (``torch.cumsum`` on CPU float64 tensors);
async DMA, HBM contention, collectives, and control flow step through
scalar logic lifted verbatim from the engine.

Byte-identity invariants this file leans on (pinned by
``tests/test_torch_fastpath.py`` against the serial walk and the JAX
package):

* ``torch.cumsum`` on a CPU float64 tensor is a strict serial scan
  (``r[i] = r[i-1] + a[i]``), so chained-cumsum accumulation equals the
  walk's ``+=`` sequence bit for bit;
* torch's CPU float64 elementwise ``+ - * /``, ``maximum`` and ``where``
  equal the corresponding Python float ops lane for lane — except
  ``scalar / tensor``, which torch computes as a reciprocal times the
  scalar, so no such quotient appears here;
* an op's duration is strictly positive iff its *healthy* compiled
  duration is (the degraded/spill transforms only grow positive
  durations and map exact zeros to exact zeros), so emit masks are
  static;
* adding an exact ``0.0`` to a non-negative accumulator is the
  identity, so whole-column scans may include zero rows exactly like
  the serial walk does.

After a walk that compiled new columns, the durable compile store
(:mod:`tpusim_torch.fastpath.store`), when active, publishes them.

Not ported yet: the ``native`` backend (``native/op_price.cpp`` through
ctypes, ROADMAP A10).
"""

from __future__ import annotations

import os

import torch

from tpusim_torch.ici.detailed import make_collective_model
from tpusim_torch.timing.engine import EngineResult, _residency_of

__all__ = [
    "BACKENDS",
    "fastpath_eligible",
    "price_module",
    "resolve_backend",
    "resolve_engine_scales",
]

BACKENDS = ("auto", "serial", "vectorized", "native")

#: below this run length the chained-scan setup costs more than a plain
#: Python loop over the cached column lists (byte-identical either way)
_VEC_MIN = 48


def resolve_backend(requested: str | None = None) -> str:
    """Resolve a pricing-backend request to the backend that will run.

    ``None``/"auto" (or ``$TPUSIM_PRICING_BACKEND``) picks the fastest
    available path, which in the port is ``vectorized``.  An *explicit*
    request for an unavailable backend raises — a user pinning ``native``
    must not silently measure something else."""
    req = requested or os.environ.get("TPUSIM_PRICING_BACKEND") or "auto"
    if req not in BACKENDS:
        raise ValueError(
            f"unknown pricing backend {req!r} (choose from {BACKENDS})"
        )
    if req == "serial":
        return "serial"
    if req == "native":
        raise ValueError(
            "pricing backend 'native' requested but libtpusim_native.so "
            "is not loadable from tpusim_torch (its ctypes binding is not "
            "ported yet)"
        )
    return "vectorized"


def resolve_engine_scales(engine) -> tuple[float, float]:
    """The launch-class scale pair one pricing call runs under — one
    source of truth for the per-state walk (``_Ctx``) and the
    scenario-batched walk (:mod:`tpusim_torch.fastpath.batch`)."""
    return engine.clock_scale, engine.hbm_scale


def fastpath_eligible(engine) -> bool:
    """When the compiled walk may substitute for the serial one.

    The serial walk stays in charge whenever the run carries run-scoped
    observables the columns don't model: obs instrumentation (per-op
    cost/ici wall profiling and cycle-window samplers), timeline
    recording, and op-granularity checkpoint/resume."""
    return (
        not engine.obs.enabled
        and not engine.record_timeline
        and not engine.config.resume_op
        and not engine.config.checkpoint_op
    )


# ---------------------------------------------------------------------------
# Launch-class views (degraded-chip + vmem-spill transforms)
# ---------------------------------------------------------------------------


class _View:
    """Per-(computation, launch class) transformed columns + cached
    ``.tolist()`` mirrors for the scalar step paths."""

    __slots__ = (
        "dur", "hbm", "vmem", "spilled", "compute", "hrs", "vrs",
        "_cc", "_lists", "raw",
    )

    def __init__(self, cc, dur, hbm, vmem, spilled, compute, hrs, vrs,
                 raw: bool):
        self._cc = cc
        self.dur = dur
        self.hbm = hbm
        self.vmem = vmem
        self.spilled = spilled
        self.compute = compute
        self.hrs = hrs
        self.vrs = vrs
        self.raw = raw
        self._lists = {}

    def col_list(self, attr: str) -> list:
        if self.raw:
            # healthy view: share the compile-time list cache across
            # every pricing call of this compiled computation
            return self._cc.col_list(_RAW_ATTR[attr])
        cached = self._lists.get(attr)
        if cached is None:
            col = getattr(self, attr)
            cached = self._lists[attr] = (
                col.tolist() if col is not None else None
            )
        return cached


_RAW_ATTR = {
    "dur": "cycles", "hbm": "hbm", "vmem": "vmem", "compute": "compute",
    "hrs": "hrs", "vrs": "vrs",
}


class _Ctx:
    """One pricing call's shared state (launch class + backend)."""

    __slots__ = (
        "cm", "coll", "views", "arch", "config", "degraded", "cs", "hs",
        "spill_frac", "hbm_bpc", "vmem_bpc", "overhead", "dma_lat",
        "contend", "overlap", "cancel",
    )

    def __init__(self, engine, cm, coll, spill_frac):
        self.cm = cm
        # cooperative cancellation: checked between compiled blocks
        self.cancel = engine.cancel
        self.coll = coll
        self.views = {}
        a = engine.arch
        self.arch = a
        self.config = engine.config
        self.degraded = engine._degraded
        self.cs, self.hs = resolve_engine_scales(engine)
        self.spill_frac = spill_frac
        self.hbm_bpc = a.hbm_bytes_per_cycle
        self.vmem_bpc = a.vmem_bytes_per_cycle
        self.overhead = a.op_overhead_cycles
        self.dma_lat = a.seconds_to_cycles(a.dma_issue_latency)
        self.contend = engine.config.model_hbm_contention
        self.overlap = engine.config.overlap_collectives

    def view(self, cc) -> _View:
        v = self.views.get(cc.name)
        if v is not None:
            return v
        spill = self.spill_frac < 1.0 and cc.any_vmem
        if not self.degraded and not spill:
            v = _View(cc, cc.cycles, cc.hbm, cc.vmem, None,
                      cc.compute, cc.hrs, cc.vrs, raw=True)
            self.views[cc.name] = v
            return v
        cycles = cc.cycles
        compute = cc.compute
        hrs = cc.hrs
        vrs = cc.vrs
        hbm = cc.hbm
        vmem = cc.vmem
        if self.degraded:
            # mirror of the engine's degraded-chip block: same ops in the
            # same order, lane-selected so untouched rows keep their
            # healthy values exactly
            cs, hs = self.cs, self.hs
            mask = cycles > 0.0
            compute = torch.where(mask, compute / cs, compute)
            hrs = torch.where(mask, hrs * hs, hrs)
            vrs = torch.where(mask, vrs * cs, vrs)
            mem = torch.maximum(
                hbm / (self.hbm_bpc * hrs),
                vmem / (self.vmem_bpc * vrs),
            )
            cycles = torch.where(
                mask,
                torch.maximum(
                    cycles,
                    self.overhead / cs + torch.maximum(compute, mem),
                ),
                cycles,
            )
        spilled = None
        if spill:
            # mirror of the engine's vmem-spill block (post-degrade)
            vmask = vmem > 0.0
            sp = vmem * (1.0 - self.spill_frac)
            spilled = torch.where(vmask, sp, 0.0)
            vmem = torch.where(vmask, vmem - sp, vmem)
            hbm = torch.where(vmask, hbm + sp, hbm)
            mem = torch.maximum(
                hbm / (self.hbm_bpc * hrs),
                vmem / (self.vmem_bpc * vrs),
            )
            cycles = torch.where(
                vmask,
                torch.maximum(
                    cycles, self.overhead + torch.maximum(compute, mem)
                ),
                cycles,
            )
        v = _View(cc, cycles, hbm, vmem, spilled, compute, hrs, vrs,
                  raw=False)
        self.views[cc.name] = v
        return v


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def module_spill(engine, module, cm) -> tuple[float | None, float]:
    """(residency recorded on the result or None, spill fraction) of one
    module under the engine's arch — the serial walk's vmem-capacity
    check, with the module scalars cached on the compiled form.  The
    spill fraction is a pure function of the module and the arch."""
    if not engine.config.model_vmem_capacity:
        return None, 1.0
    # the cached residency is reused only when its scan KIND matches this
    # module's representation (text scan for lazy, IR walk for eager), so
    # a run's value cannot depend on which representation populated the
    # compile store first
    kind = "text" if callable(
        getattr(module, "vmem_resident_bytes", None)
    ) else "ir"
    resident = cm.residency if cm.residency_kind == kind else None
    if resident is None:
        resident = _residency_of(module)
        cm.residency, cm.residency_kind = resident, kind
    cap = float(engine.arch.vmem_bytes)
    if resident > cap > 0:
        peak = cm.peak_live
        if peak is None:
            peak = cm.peak_live = engine._peak_live_of(module)
        resident = peak
    return resident, (cap / resident if resident > cap > 0 else 1.0)


def entry_of(module, cm) -> str:
    """The entry computation's name, cached on the compiled form; a
    module without one raises the serial walk's ValueError."""
    if cm.entry_name is None:
        if module.entry_name is None:
            module.entry  # raises ValueError (no ENTRY computation)
        cm.entry_name = module.entry_name
    return cm.entry_name


def price_module(engine, module, backend: str) -> EngineResult:
    """Fastpath equivalent of :meth:`Engine._run_serial` — same result,
    byte for byte, for ``backend="vectorized"``."""
    from tpusim_torch.perf.cache import compiled_for

    if backend != "vectorized":
        raise ValueError(f"price_module prices 'vectorized', not {backend!r}")
    topo = engine._topology_for(module)
    coll = make_collective_model(topo, engine.arch.ici, obs=engine.obs)
    result = EngineResult()
    cm = compiled_for(module, engine)
    resident, spill_frac = module_spill(engine, module, cm)
    if resident is not None:
        result.vmem_resident_bytes = resident
    ctx = _Ctx(engine, cm, coll, spill_frac)
    end = _price_computation(ctx, entry_of(module, cm), 0.0, result, 0)
    result.cycles = end
    result.seconds = engine.arch.cycles_to_seconds(end)
    from tpusim_torch.fastpath.store import maybe_persist_compiled

    maybe_persist_compiled(cm)
    return result


# ---------------------------------------------------------------------------
# The step interpreter
# ---------------------------------------------------------------------------


def _chain(seed: float, col: torch.Tensor) -> float:
    """Serial left-to-right accumulation of ``col`` onto ``seed`` — the
    exact float sequence of a ``+=`` loop (cumsum is a strict serial
    scan)."""
    out = torch.empty(col.shape[0] + 1, dtype=torch.float64)
    out[0] = seed
    out[1:] = col
    out.cumsum_(0)
    return out[-1].item()


def _price_computation(ctx, comp_name: str, t0: float, result, depth: int
                       ) -> float:
    if depth > 32:
        return t0
    cc = ctx.cm.comp(comp_name)
    v = ctx.view(cc)
    a = ctx.arch
    overhead = ctx.overhead
    hbm_bpc = ctx.hbm_bpc
    vmem_bpc = ctx.vmem_bpc
    dma_lat = ctx.dma_lat
    contend = ctx.contend
    overlap = ctx.overlap

    names = cc.names
    bases = cc.bases

    t = t0
    ici_free = t0
    dma_free = t0
    pending: dict[str, float] = {}
    dma_names: set[str] = set()
    dma_busy_until = t0
    dma_segments: list[list[float]] = []
    cancel = ctx.cancel

    for step in cc.steps:
        if cancel is not None:
            cancel.check()
        kind = step[0]

        # ---- clean run of ordinary sync ops ---------------------------
        if kind == "run":
            (_, lo, hi, emit, hbm_idx, flops_idx, mxu_idx,
             ugroups, ogroups) = step
            n = hi - lo
            dur = v.dur
            spill_on = v.spilled is not None
            if n >= _VEC_MIN:
                # the t scan keeps its intermediates: per-op aggregates
                # need the clock BEFORE each op (the serial _emit adds
                # (t + dur) - t, which is not dur under IEEE rounding)
                tarr = torch.empty(n + 1, dtype=torch.float64)
                tarr[0] = t
                tarr[1:] = dur[lo:hi]
                tarr.cumsum_(0)
                tb_l = tarr.tolist()
                t = tb_l[-1]
                result.flops = _chain(result.flops, cc.flops[lo:hi])
                result.mxu_flops = _chain(result.mxu_flops, cc.mxu[lo:hi])
                result.transcendentals = _chain(
                    result.transcendentals, cc.trans[lo:hi])
                result.hbm_bytes = _chain(result.hbm_bytes, v.hbm[lo:hi])
                result.vmem_bytes = _chain(result.vmem_bytes, v.vmem[lo:hi])
                if spill_on:
                    result.vmem_spill_bytes = _chain(
                        result.vmem_spill_bytes, v.spilled[lo:hi])
                ub = result.unit_busy_cycles
                for u, idx in ugroups:
                    ub[u] = _chain(ub[u], dur[idx])
                oc = result.opcode_cycles
                for b, idx in ogroups:
                    oc[b] = _chain(oc[b], dur[idx])
                result.op_count += n
                dl = v.col_list("dur")
                pc = result.per_op_cycles
                pn = result.per_op_count
                po = result.per_op_opcode
                for i in emit.tolist():
                    nm = names[i]
                    tbk = tb_l[i - lo]
                    pc[nm] += (tbk + dl[i]) - tbk
                    pn[nm] += 1.0
                    po.setdefault(nm, bases[i])
            else:
                dl = v.col_list("dur")
                fl = cc.col_list("flops")
                ml = cc.col_list("mxu")
                tl = cc.col_list("trans")
                hl = v.col_list("hbm")
                vl = v.col_list("vmem")
                sl = v.col_list("spilled") if spill_on else None
                pc = result.per_op_cycles
                pn = result.per_op_count
                po = result.per_op_opcode
                for i in range(lo, hi):
                    d = dl[i]
                    if d > 0:
                        nm = names[i]
                        pc[nm] += (t + d) - t
                        pn[nm] += 1.0
                        po.setdefault(nm, bases[i])
                    t += d
                    result.flops += fl[i]
                    result.mxu_flops += ml[i]
                    result.transcendentals += tl[i]
                    result.hbm_bytes += hl[i]
                    result.vmem_bytes += vl[i]
                    if sl is not None:
                        result.vmem_spill_bytes += sl[i]
                ub = result.unit_busy_cycles
                for u, idx in ugroups:
                    for i in idx.tolist():
                        ub[u] += dl[i]
                oc = result.opcode_cycles
                for b, idx in ogroups:
                    for i in idx.tolist():
                        oc[b] += dl[i]
                result.op_count += n
            hl = v.col_list("hbm")
            ph = result.per_op_hbm_bytes
            hidx = (hbm_idx if not spill_on else
                    torch.nonzero(v.hbm[lo:hi] > 0.0).flatten() + lo)
            for i in hidx.tolist():
                ph[names[i]] += hl[i]
            fl = cc.col_list("flops")
            pf = result.per_op_flops
            for i in flops_idx.tolist():
                pf[names[i]] += fl[i]
            ml = cc.col_list("mxu")
            pm = result.per_op_mxu_flops
            for i in mxu_idx.tolist():
                pm[names[i]] += ml[i]
            continue

        # ---- async joins ----------------------------------------------
        if kind == "done":
            _, i, src, is_coll = step
            if src not in pending:
                result.orphan_async_joins += 1
            finish = pending.pop(src, t)
            waited = max(0.0, finish - t)
            if is_coll:
                result.exposed_collective_cycles += waited
            else:
                result.exposed_dma_cycles += waited
            t = max(t, finish)
            result.op_count += 1
            continue

        # ---- collectives ----------------------------------------------
        if kind == "coll":
            _, i, name, base, info, is_start = step
            ici_b = cc.col_list("ici_bytes")[i]
            seconds = ctx.coll.seconds(info, ici_b)
            dur = a.seconds_to_cycles(seconds)
            result.collective_count += 1
            result.ici_bytes += ici_b
            result.collective_cycles += dur
            result.unit_busy_cycles["ici"] += dur
            result.opcode_cycles[base] += dur
            if is_start and overlap:
                start = max(t, ici_free)
                pending[name] = start + dur
                ici_free = start + dur
                result.per_op_cycles[name] += (start + dur) - start
                result.per_op_count[name] += 1.0
                result.per_op_opcode.setdefault(name, base)
                result.per_op_async[name] = True
                t += overhead
            else:
                start = max(t, ici_free)
                result.per_op_cycles[name] += (start + dur) - start
                result.per_op_count[name] += 1.0
                result.per_op_opcode.setdefault(name, base)
                if is_start:
                    result.per_op_async[name] = True
                t = start + dur
                ici_free = t
                result.exposed_collective_cycles += dur
                if is_start:
                    pending[name] = t
            result.op_count += 1
            continue

        # ---- async DMA start ------------------------------------------
        if kind == "dma":
            _, i, name, base = step
            dur = v.col_list("dur")[i]
            hbm_b = v.col_list("hbm")[i]
            if v.spilled is not None:
                result.vmem_spill_bytes += v.col_list("spilled")[i]
            start = max(t, dma_free)
            pending[name] = start + dma_lat + dur
            dma_names.add(name)
            dma_free = start + dur
            if hbm_b > 0:
                dma_busy_until = max(dma_busy_until, start + dur)
                if dur > 0:
                    dma_segments.append(
                        [start, start + dur, hbm_b / dur]
                    )
            result.dma_cycles += dur
            result.unit_busy_cycles["dma"] += dur
            result.opcode_cycles[base] += dur
            result.hbm_bytes += hbm_b
            result.per_op_hbm_bytes[name] += hbm_b
            result.per_op_cycles[name] += (start + dma_lat + dur) - t
            result.per_op_count[name] += 1.0
            result.per_op_opcode.setdefault(name, base)
            result.per_op_async[name] = True
            t += overhead
            result.op_count += 1
            continue

        # ---- contended run (DMA statically in flight) -----------------
        if kind == "crun":
            _, lo, hi = step
            dl = v.col_list("dur")
            fl = cc.col_list("flops")
            ml = cc.col_list("mxu")
            tl = cc.col_list("trans")
            hl = v.col_list("hbm")
            vl = v.col_list("vmem")
            cl = v.col_list("compute")
            hrl = v.col_list("hrs")
            vrl = v.col_list("vrs")
            sl = v.col_list("spilled") if v.spilled is not None else None
            ub = result.unit_busy_cycles
            oc = result.opcode_cycles
            for i in range(lo, hi):
                dur = dl[i]
                hbm_b = hl[i]
                if sl is not None:
                    result.vmem_spill_bytes += sl[i]
                if contend and hbm_b > 0 and dma_busy_until > t:
                    dma_segments = [s for s in dma_segments if s[1] > t]
                    q_bytes = sum(
                        s[2] * (s[1] - max(t, s[0]))
                        for s in dma_segments
                    )
                    shared = min(hbm_b, q_bytes)
                    penalty = shared / hbm_bpc
                    hbm_time = (
                        hbm_b / (hbm_bpc * hrl[i]) + penalty
                    )
                    mem_cycles = max(
                        hbm_time,
                        vl[i] / (vmem_bpc * vrl[i]),
                    )
                    new_dur = max(dur, overhead + max(
                        cl[i], mem_cycles
                    ))
                    result.hbm_contention_cycles += (
                        max(new_dur - dur, 0.0) + penalty
                    )
                    for nm in dma_names:
                        fin = pending.get(nm)
                        if fin is not None and fin > t:
                            pending[nm] = fin + penalty
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
                    nm = names[i]
                    result.per_op_cycles[nm] += (t + dur) - t
                    result.per_op_count[nm] += 1.0
                    result.per_op_opcode.setdefault(nm, bases[i])
                t += dur
                result.op_count += 1
                result.flops += fl[i]
                result.mxu_flops += ml[i]
                result.transcendentals += tl[i]
                result.hbm_bytes += hbm_b
                result.vmem_bytes += vl[i]
                if hbm_b > 0:
                    result.per_op_hbm_bytes[names[i]] += hbm_b
                if fl[i] > 0:
                    result.per_op_flops[names[i]] += fl[i]
                if ml[i] > 0:
                    result.per_op_mxu_flops[names[i]] += ml[i]
                if dur > 0:
                    ub[cc.units[i]] += dur
                    oc[bases[i]] += dur
            continue

        # ---- control flow ---------------------------------------------
        if kind == "while":
            _, i, name, base, body, trips, unknown = step
            if unknown:
                result.unknown_trip_loops += 1
            sub = EngineResult()
            body_end = _price_computation(ctx, body, 0.0, sub, depth + 1)
            result.merge_scaled(sub, float(trips))
            dur = body_end * trips + overhead * (trips + 1)
            result.per_op_cycles[name] += (t + dur) - t
            result.per_op_count[name] += 1.0
            result.per_op_opcode.setdefault(name, base)
            t += dur
            result.op_count += 1
            continue
        if kind == "cond":
            _, i, name, base, branches = step
            durs = []
            subs = []
            for branch in branches:
                sub = EngineResult()
                d = _price_computation(ctx, branch, 0.0, sub, depth + 1)
                durs.append(d)
                subs.append(sub)
            if durs:
                worst = max(range(len(durs)), key=lambda k: durs[k])
                result.merge_scaled(subs[worst], 1.0)
                dur = durs[worst] + overhead
                if len(durs) > 1 and max(durs) > 1.5 * min(durs):
                    result.worst_case_branches += 1
                result.per_op_cycles[name] += (t + dur) - t
                result.per_op_count[name] += 1.0
                result.per_op_opcode.setdefault(name, base)
                t += dur
            result.op_count += 1
            continue
        if kind == "call":
            _, i, name, base, callee = step
            sub = EngineResult()
            d = _price_computation(ctx, callee, 0.0, sub, depth + 1)
            result.merge_scaled(sub, 1.0)
            result.per_op_cycles[name] += (t + d) - t
            result.per_op_count[name] += 1.0
            result.per_op_opcode.setdefault(name, base)
            t += d
            result.op_count += 1
            continue

        raise AssertionError(f"unknown fastpath step kind {kind!r}")

    # drain: mirror of the serial walk's end-of-computation accounting
    result.unjoined_async += len(pending)
    for finish in pending.values():
        t = max(t, finish)
    return t

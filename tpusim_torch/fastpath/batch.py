"""Scenario-batched pricing: one lane-axis pass for S degradation states.

Port of ``tpusim/fastpath/batch.py``'s pricer.  ``price_module_batch``
prices a batch of S launch classes of ONE module — S lanes, each a
(clock_scale, hbm_scale, topology) triple — through a single walk of the
compiled step program.  The lane axis rides the float64 columns of
:mod:`tpusim_torch.fastpath.compile` as the leading dimension of an
``(S, ops)`` matrix: the degraded-chip transform broadcasts every lane's
scales onto the shared columns at once, and the serial accumulation
chains of :mod:`tpusim_torch.fastpath.price` become row-seeded serial
scans.  Collective, async-DMA, and HBM-contended steps step through
per-lane scalar logic lifted verbatim from the per-state interpreter.

The row scans run on the host (``vectorized``: ``torch.cumsum`` along
the ops axis of a CPU float64 tensor, a strict serial scan per row) or,
when explicitly requested, on the card (``cuda``: the hand-written
kernel of :mod:`tpusim_torch.kernels.scan_rows`, one thread per lane,
serial over ops, the counterpart of the JAX package's ``jax`` backend).
Under ``cuda`` each computation's lane-variant duration column goes to
the card once per call, ops-major (one shared column when no lane
differs), and each run step's scans — its time chain and its unit and
opcode groups — are one launch of ``scan_segments``: one host→card copy
of the step's table and seeds, one card→host copy of its chains.  Both
give the bytes of the per-state walk; ``cuda`` without a card, or with a
kernel that fails to build or launch, raises.

Byte-identity discipline (extends price.py's invariants per lane):

* every lane-variant column (``cycles``/``compute``/``hrs``/``vrs``) is
  produced by the SAME elementwise float ops the per-state ``_Ctx`` view
  applies, lane-selected with a 2-D mask so healthy lanes keep the raw
  compile-time bytes exactly;
* ``hbm``/``vmem``/``spilled`` columns are lane-INVARIANT: the degrade
  transform never touches them and the vmem-spill transform depends only
  on the module-level spill fraction, so they stay 1-D and shared;
* row-seeded ``(S, n+1)`` scans equal S independent seed-prefixed 1-D
  cumsums (both are serial scans over the identical float sequence);
* lane-invariant counter chains (flops/mxu/transcendentals and the
  hbm/vmem/spill byte counters) collapse to ONE 1-D chain whenever the
  per-lane seeds are bitwise equal — which they are unless a
  conditional's worst-branch selection diverged across lanes — and fall
  back to per-lane-seeded row scans when they are not;
* conditionals price every branch batched, then select each lane's worst
  branch with the per-state walk's first-max argmax.

:func:`warm_states` batch-prices the launch classes of a set of
degradation states and publishes each lane into a result cache under the
key the per-state walk looks up; the campaign and fleet executors warm
their pending degradation states through it.  A cancel token is checked
between steps, states and modules.

Not ported yet: the ``native`` batch kernel (A10).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpusim_torch.ici.detailed import make_collective_model
from tpusim_torch.timing.engine import Engine, EngineResult

from tpusim_torch.fastpath.price import (
    _chain,
    entry_of,
    fastpath_eligible,
    module_spill,
    resolve_backend,
    resolve_engine_scales,
)

__all__ = [
    "BATCH_BACKENDS",
    "BatchStats",
    "price_module_batch",
    "resolve_batch_backend",
    "warm_states",
]

#: lane-axis pricing backends: the host row-scan interpreter, the same
#: interpreter with its row scans on the card, and the per-lane serial
#: walk (no batching)
BATCH_BACKENDS = ("vectorized", "cuda", "serial")


class BatchStats:
    """Engagement accounting for batched pricing passes.  ``stats_dict``
    mints the ``fastpath_batch*`` keys, which ride a result only when a
    batch pass actually ran."""

    __slots__ = ("states", "groups", "lanes_cached", "skipped")

    def __init__(self) -> None:
        self.states = 0        # lanes priced through a batch pass
        self.groups = 0        # (module, lane-set) batch passes
        self.lanes_cached = 0  # lanes already cached (skipped)
        self.skipped = 0       # states batching declined

    def merge(self, other: "BatchStats") -> None:
        self.states += other.states
        self.groups += other.groups
        self.lanes_cached += other.lanes_cached
        self.skipped += other.skipped

    def stats_dict(self) -> dict[str, float]:
        return {
            "fastpath_batched_states": float(self.states),
            "fastpath_batch_groups": float(self.groups),
            "fastpath_batch_lanes_cached": float(self.lanes_cached),
            "fastpath_batch_skipped": float(self.skipped),
        }


def resolve_batch_backend(requested: str | None = None) -> str:
    """Resolve the lane-axis backend.  ``None``/"auto" follows
    :func:`~tpusim_torch.fastpath.price.resolve_backend` (``vectorized``,
    or ``serial`` meaning "no batching").  ``"cuda"`` must be requested
    explicitly and raises when no CUDA device is available."""
    if requested == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "pricing backend 'cuda' requested but torch sees no CUDA "
                "device"
            )
        return "cuda"
    return resolve_backend(requested)


def _scan_rows_host(seeds, mat: torch.Tensor) -> torch.Tensor:
    """Row-seeded serial scans on the host: row ``s`` of the ``(S, k+1)``
    result is the exact float sequence of ``_chain(seeds[s], mat[s])``."""
    n_rows, k = mat.shape
    out = torch.empty((n_rows, k + 1), dtype=torch.float64)
    out[:, 0] = torch.as_tensor(seeds, dtype=torch.float64)
    out[:, 1:] = mat
    out.cumsum_(1)
    return out


#: where the ``cuda`` backend runs its row scans (the tests point it at
#: the CPU to take the same route through the kernel's plain version)
_SCAN_DEVICE = "cuda"


class _CardScans:
    """The ``cuda`` backend's scans, for one batched call: columns go to
    the scan device once, and each launch of ``scan_segments`` takes one
    staging copy there (table, indices, seeds and, for a shared column,
    its values) and one copy of its output back.  On the CPU (the tests'
    rehearsal) the same packing, gathering and unpacking run through the
    kernel's plain version."""

    __slots__ = ("dev", "cuda")

    def __init__(self, device: str):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def upload(self, dur2: torch.Tensor) -> torch.Tensor:
        """A view's ``(S, n)`` duration column on the scan device,
        ops-major ``[n, S]``, or ``[n]`` when every lane shares it (the
        kernel then reads it with a lane stride of 0)."""
        if dur2.stride(0) == 0:
            return dur2[0].to(self.dev)
        return dur2.t().contiguous().to(self.dev)

    def scan(self, plan, seeds, mat=None, column=None) -> torch.Tensor:
        """One launch of ``plan`` over ``mat`` (on the scan device, as
        :meth:`upload` gives it) or over a host ``column`` that travels
        with the staging copy; ``seeds`` is one list of S floats per
        segment.  Returns the ``[out_rows, S]`` output on the host."""
        from tpusim_torch.kernels import scan_rows as sr

        n_seg, S = len(seeds), len(seeds[0])
        nh = plan.head.numel()
        ns = nh + n_seg * S
        total = ns + (column.numel() if column is not None else 0)
        stage = torch.empty(total, dtype=torch.int64, pin_memory=self.cuda)
        # filled through numpy: a list of lists goes in without a tensor
        # built from it first
        fill = stage.numpy()
        fill[:nh] = plan.head.numpy()
        fill = fill.view(np.float64)
        fill[nh:ns].reshape(n_seg, S)[:] = seeds
        if column is not None:
            fill[ns:] = column.numpy()
        stage = stage.to(self.dev, non_blocking=True)
        table, idx = plan.split(stage)
        words = stage.view(torch.float64)
        if column is not None:
            mat = words[ns:]
        if mat.dim() == 1:
            mat = mat[:, None].expand(mat.shape[0], S)
        out = sr.scan_segments(mat, idx, table, words[nh:ns].view(n_seg, S),
                               plan.out_rows)
        if not self.cuda:
            return out
        back = torch.empty(out.shape, dtype=torch.float64, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.dev).synchronize()
        return back

    def scan_column(self, seeds: list, col: torch.Tensor) -> list:
        """The ends of a lane-invariant column's chains from per-lane
        seeds: one end-only segment over the whole column."""
        plan = _column_plan(col.shape[0])
        return self.scan(plan, [seeds], column=col)[0].tolist()


@functools.lru_cache(maxsize=256)
def _column_plan(n: int):
    """One end-only segment over rows 0 .. n."""
    from tpusim_torch.kernels import scan_rows as sr

    return sr.pack_segments([(range(n), False)])


# ---------------------------------------------------------------------------
# Lane-axis views
# ---------------------------------------------------------------------------


class _BatchView:
    """Per-computation transformed columns for S lanes: ``(S, n)``
    matrices for the lane-variant columns, shared 1-D tensors for the
    lane-invariant ones, plus cached ``.tolist()`` mirrors for the scalar
    step paths."""

    __slots__ = (
        "dur2", "compute2", "hrs2", "vrs2", "hbm", "vmem", "spilled",
        "dur_card", "_cc", "_shared_lists", "_lane_lists",
    )

    def __init__(self, cc, dur2, compute2, hrs2, vrs2, hbm, vmem,
                 spilled):
        self._cc = cc
        self.dur2 = dur2
        self.compute2 = compute2
        self.hrs2 = hrs2
        self.vrs2 = vrs2
        self.hbm = hbm
        self.vmem = vmem
        self.spilled = spilled
        #: ``dur2`` on the scan device (``cuda`` backend only)
        self.dur_card = None
        self._shared_lists = {}
        self._lane_lists = {}

    def shared_list(self, attr: str) -> list:
        cached = self._shared_lists.get(attr)
        if cached is None:
            cached = self._shared_lists[attr] = getattr(self, attr).tolist()
        return cached

    def lane_list(self, attr: str, s: int) -> list:
        key = (attr, s)
        cached = self._lane_lists.get(key)
        if cached is None:
            cached = self._lane_lists[key] = getattr(self, attr)[s].tolist()
        return cached


class _Lane:
    """One scenario lane: its engine (scales + topology), its collective
    model, and the model's memo key."""

    __slots__ = ("engine", "coll", "coll_key", "cs", "hs", "degraded")

    def __init__(self, engine, coll, coll_key):
        self.engine = engine
        self.coll = coll
        self.coll_key = coll_key
        self.cs, self.hs = resolve_engine_scales(engine)
        self.degraded = engine._degraded


class _BatchCtx:
    """One batched pricing call's shared state."""

    __slots__ = (
        "cm", "lanes", "S", "views", "arch", "config", "spill_frac",
        "hbm_bpc", "vmem_bpc", "overhead", "dma_lat", "contend",
        "overlap", "cs_col", "hs_col", "ovh_col", "deg_col",
        "any_degraded", "coll_memo", "card", "step_cache",
        "uniform_memo", "seen_cyc", "seen_hbm", "seen_flops", "seen_mxu",
        "cancel",
    )

    def __init__(self, engine, cm, lanes, spill_frac, backend, cancel):
        self.cm = cm
        self.cancel = cancel
        self.lanes = lanes
        self.S = len(lanes)
        self.views = {}
        a = engine.arch
        self.arch = a
        self.config = engine.config
        self.spill_frac = spill_frac
        self.hbm_bpc = a.hbm_bytes_per_cycle
        self.vmem_bpc = a.vmem_bytes_per_cycle
        self.overhead = a.op_overhead_cycles
        self.dma_lat = a.seconds_to_cycles(a.dma_issue_latency)
        self.contend = engine.config.model_hbm_contention
        self.overlap = engine.config.overlap_collectives
        f64 = torch.float64
        self.cs_col = torch.tensor([[ln.cs] for ln in lanes], dtype=f64)
        self.hs_col = torch.tensor([[ln.hs] for ln in lanes], dtype=f64)
        # overhead / cs per lane as Python float quotients: torch computes
        # a scalar-over-tensor quotient as a reciprocal times the scalar,
        # which is not the per-state walk's division
        self.ovh_col = torch.tensor(
            [[self.overhead / ln.cs] for ln in lanes], dtype=f64
        )
        self.deg_col = torch.tensor(
            [[ln.degraded] for ln in lanes], dtype=torch.bool
        )
        self.any_degraded = any(ln.degraded for ln in lanes)
        #: (coll_key, comp_name, step_idx) -> cycles; lanes sharing a
        #: topology signature share the deterministic collective price
        self.coll_memo: dict[tuple, float] = {}
        #: (comp_name, step_idx) -> per-op prototype dicts for run steps
        #: (built once, applied to every lane at C speed)
        self.step_cache: dict[tuple, tuple] = {}
        #: per-op names inserted into any lane's aggregate dicts so far,
        #: in walk order, one registry per dict family (cycles / hbm /
        #: flops / mxu aggregates are disjoint dicts).  A run step whose
        #: names are absent from its family registry at prep time can
        #: only INSERT fresh keys — dict.update with no collision checks —
        #: because anything already in a lane's dict was put there by an
        #: earlier-visited step (walk order == registry order; cached
        #: preps stay valid on revisits since a revisit fills a fresh
        #: sub-result whose walk repeats the same step order)
        self.seen_cyc: set[str] = set()
        self.seen_hbm: set[str] = set()
        self.seen_flops: set[str] = set()
        self.seen_mxu: set[str] = set()
        #: comp_name -> True when every lane provably builds identical
        #: count/opcode/traffic/async per-op dicts (see _comp_uniform)
        self.uniform_memo: dict[str, bool] = {}
        #: the ``cuda`` backend's scans (None: the host's row scans)
        self.card = _CardScans(_SCAN_DEVICE) if backend == "cuda" else None

    def view(self, cc) -> _BatchView:
        v = self.views.get(cc.name)
        if v is None:
            v = self.views[cc.name] = self._build_view(cc)
            if self.card is not None:
                v.dur_card = self.card.upload(v.dur2)
        return v

    def _build_view(self, cc) -> _BatchView:
        S = self.S
        n = len(cc.names)
        spill = self.spill_frac < 1.0 and cc.any_vmem
        cycles = cc.cycles
        compute = cc.compute
        hrs = cc.hrs
        vrs = cc.vrs
        hbm = cc.hbm
        vmem = cc.vmem
        if not self.any_degraded and not spill:
            return _BatchView(
                cc,
                cycles.expand(S, n), compute.expand(S, n),
                hrs.expand(S, n), vrs.expand(S, n),
                hbm, vmem, None,
            )
        if self.any_degraded:
            # the per-state degraded-chip block, lane-broadcast: same
            # elementwise ops in the same order; mask2 selects only
            # degraded lanes' positive-cycle rows, so healthy lanes keep
            # the raw compile-time bytes exactly
            mask2 = self.deg_col & (cycles > 0.0)
            compute2 = torch.where(mask2, compute / self.cs_col, compute)
            hrs2 = torch.where(mask2, hrs * self.hs_col, hrs)
            vrs2 = torch.where(mask2, vrs * self.cs_col, vrs)
            mem2 = torch.maximum(
                hbm / (self.hbm_bpc * hrs2),
                vmem / (self.vmem_bpc * vrs2),
            )
            cycles2 = torch.where(
                mask2,
                torch.maximum(
                    cycles, self.ovh_col + torch.maximum(compute2, mem2),
                ),
                cycles.expand(S, n),
            )
        else:
            compute2 = compute.expand(S, n)
            hrs2 = hrs.expand(S, n)
            vrs2 = vrs.expand(S, n)
            cycles2 = cycles.expand(S, n)
        spilled = None
        if spill:
            # the per-state vmem-spill block (post-degrade).  The spill
            # fraction is a module-level scalar, so the byte columns stay
            # lane-invariant 1-D; only the cycle floor consults the
            # per-lane hrs/vrs
            vmask = vmem > 0.0
            sp = vmem * (1.0 - self.spill_frac)
            spilled = torch.where(vmask, sp, 0.0)
            vmem = torch.where(vmask, vmem - sp, vmem)
            hbm = torch.where(vmask, hbm + sp, hbm)
            mem2 = torch.maximum(
                hbm / (self.hbm_bpc * hrs2),
                vmem / (self.vmem_bpc * vrs2),
            )
            cycles2 = torch.where(
                vmask,
                torch.maximum(
                    cycles2, self.overhead + torch.maximum(compute2, mem2)
                ),
                cycles2,
            )
        return _BatchView(cc, cycles2, compute2, hrs2, vrs2, hbm, vmem,
                          spilled)


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def price_module_batch(module, engines, backend: str | None = None,
                       cancel=None) -> list[EngineResult]:
    """Price one module under S launch classes in one lane-axis pass.

    ``engines`` is one :class:`~tpusim_torch.timing.engine.Engine` per
    lane — same config/arch, per-lane ``clock_scale``/``hbm_scale``/
    ``topology``.  Returns one :class:`EngineResult` per lane,
    byte-identical to what the serial walk produces for that lane.
    ``backend="serial"`` degenerates to the per-lane serial walk;
    ``"cuda"`` runs the row scans on the card and raises without one.
    ``cancel`` (a :class:`~tpusim_torch.guard.cancel.CancelToken`) is
    checked once per step, for every lane at once."""
    from tpusim_torch.perf.cache import compiled_for, topology_signature

    backend = resolve_batch_backend(backend)
    if backend == "serial" or not engines:
        return [e._run_serial(module) for e in engines]

    engine = engines[0]
    cm = compiled_for(module, engine)
    # the spill fraction is a pure function of the module + arch, so
    # every lane shares it
    resident, spill_frac = module_spill(engine, module, cm)

    # per-lane collective models, deduped by topology signature (the
    # models are pure functions of topology + arch.ici, and the memo in
    # _BatchCtx reuses each signature's collective prices across lanes)
    coll_by_sig: dict = {}
    lanes: list[_Lane] = []
    for e in engines:
        topo = e._topology_for(module)
        sig = topology_signature(topo)
        key = sig if sig is not None else id(topo)
        coll = coll_by_sig.get(key)
        if coll is None:
            coll = coll_by_sig[key] = make_collective_model(topo, e.arch.ici)
        lanes.append(_Lane(e, coll, key))

    results = [EngineResult() for _ in engines]
    if resident is not None:
        for r in results:
            r.vmem_resident_bytes = resident
    ctx = _BatchCtx(engine, cm, lanes, spill_frac, backend, cancel)
    ends = _price_comp_batch(
        ctx, entry_of(module, cm), [0.0] * len(lanes), results, 0
    )
    a = engine.arch
    for r, end in zip(results, ends):
        r.cycles = end
        r.seconds = a.cycles_to_seconds(end)
    from tpusim_torch.fastpath.store import maybe_persist_compiled

    maybe_persist_compiled(cm)
    return results


# ---------------------------------------------------------------------------
# The batched step interpreter
# ---------------------------------------------------------------------------


_MISS = object()


def _acc_shared(ctx, results, attr: str, col, cache) -> None:
    """Chain a lane-invariant column onto per-lane accumulators.
    Bitwise-equal seeds (the overwhelmingly common case — they diverge
    only after a lane-divergent conditional) collapse to one shared 1-D
    chain; divergent seeds fall back to row-seeded scans.

    The running value lives in ``cache`` (a float when uniform across
    lanes, a per-lane list otherwise) between run steps — result
    attributes are only materialized by ``_flush_acc`` when a step that
    reads or mutates them per-lane comes up, or at frame end."""
    cur = cache.get(attr, _MISS)
    if cur is _MISS:
        vals = [getattr(r, attr) for r in results]
        first = vals[0]
        cur = first if vals.count(first) == len(vals) else vals
    if type(cur) is list:
        if ctx.card is not None:
            cache[attr] = ctx.card.scan_column(cur, col)
        else:
            mat = col.expand(len(cur), col.shape[0])
            cache[attr] = _scan_rows_host(cur, mat)[:, -1].tolist()
    else:
        cache[attr] = _chain(cur, col)


def _flush_acc(results, cache) -> None:
    """Materialize cached accumulator values onto the result objects
    (exact floats the serial walk would hold at this point) and clear the
    cache so the next run step re-reads post-mutation state."""
    if not cache:
        return
    for attr, val in cache.items():
        if type(val) is list:
            for r, x in zip(results, val):
                setattr(r, attr, x)
        else:
            for r in results:
                setattr(r, attr, val)
    cache.clear()


def _merge_lane_variant(r, sub, times: float) -> None:
    """``EngineResult.merge_scaled`` minus the six per-op dicts the
    uniform-frame end-copy overwrites (count/opcode/hbm/flops/mxu/async).
    Used for lanes s>0 of a uniform frame: their sub-results carry
    identical copies of those dicts (the sub-frame's own end-copy), and
    the parent frame's end-copy restores them from lane 0 — merging them
    here would be pure waste.  Everything lane-variant (scalars,
    unit/opcode busy cycles, per_op_cycles) still merges."""
    r.op_count += int(sub.op_count * times)
    r.flops += sub.flops * times
    r.mxu_flops += sub.mxu_flops * times
    r.transcendentals += sub.transcendentals * times
    r.hbm_bytes += sub.hbm_bytes * times
    r.vmem_bytes += sub.vmem_bytes * times
    r.ici_bytes += sub.ici_bytes * times
    r.collective_count += int(sub.collective_count * times)
    r.collective_cycles += sub.collective_cycles * times
    r.exposed_collective_cycles += sub.exposed_collective_cycles * times
    r.dma_cycles += sub.dma_cycles * times
    r.exposed_dma_cycles += sub.exposed_dma_cycles * times
    r.vmem_resident_bytes = max(
        r.vmem_resident_bytes, sub.vmem_resident_bytes
    )
    r.vmem_spill_bytes += sub.vmem_spill_bytes * times
    r.hbm_contention_cycles += sub.hbm_contention_cycles * times
    r.orphan_async_joins += int(sub.orphan_async_joins * times)
    r.unjoined_async += int(sub.unjoined_async * times)
    r.unknown_trip_loops += int(sub.unknown_trip_loops * times)
    r.worst_case_branches += int(sub.worst_case_branches * times)
    for k, v in sub.unit_busy_cycles.items():
        r.unit_busy_cycles[k] += v * times
    for k, v in sub.opcode_cycles.items():
        r.opcode_cycles[k] += v * times
    for k, v in sub.per_op_cycles.items():
        r.per_op_cycles[k] += v * times


def _proto(names, idxs, vals, reg):
    """Prototype for a lane-invariant per-op fill (the hbm/flops/mxu
    aggregates), decided once per step:

    * ``None`` — nothing to fill;
    * ``(dict, None)`` — names unique AND fresh (absent from the walk
      registry): pure-insert ``dict.update`` per lane, no checks;
    * ``(dict, keyset)`` — unique but possibly colliding with
      earlier-walked names: per-lane set intersection + add;
    * ``(None, pairs)`` — a name repeats in the step: serial per-pair
      add order.
    """
    if not idxs:
        return None
    sel = [(names[i], vals[i]) for i in idxs]
    d = dict(sel)
    if len(d) != len(sel):
        reg.update(d)
        return (None, sel)
    fresh = reg.isdisjoint(d)
    reg.update(d)
    return (d, None if fresh else frozenset(d))


def _merge_add(dst, proto) -> None:
    """Accumulate a prototype add-dict into a per-lane aggregate dict.
    ``dict.update`` appends new keys in prototype (= op) order and leaves
    existing keys' positions untouched, and ``a + b`` is bitwise ``b + a``
    under IEEE-754 — so bytes match the serial ``+=`` loop."""
    d, keys = proto
    if d is None:
        for nm, val in keys:
            dst[nm] += val
        return
    if keys is not None:
        inter = keys & dst.keys()
        if inter:
            m = dict(d)
            for nm in inter:
                m[nm] += dst[nm]
            dst.update(m)
            return
    dst.update(d)


def _run_scans(ctx, cc, v, si: int, lo: int, hi: int, want_tb: bool,
               t: list, ugroups, ogroups, results):
    """A run step's serial scans: the lanes' time chain over ops ``lo ..
    hi`` and each unit and opcode group's busy-cycle chain, whose ends go
    into the lanes' dicts.  Returns the lanes' times after the step and,
    when ``want_tb``, the ``(S, n)`` times before each op.  On the host,
    one row scan each; under ``cuda``, one launch for them all."""
    card = ctx.card
    if card is None:
        tarr2 = _scan_rows_host(t, v.dur2[:, lo:hi])
        for u, idx in ugroups:
            seeds = [r.unit_busy_cycles[u] for r in results]
            ends = _scan_rows_host(seeds, v.dur2[:, idx])[:, -1].tolist()
            for r, e in zip(results, ends):
                r.unit_busy_cycles[u] = e
        for b, idx in ogroups:
            seeds = [r.opcode_cycles[b] for r in results]
            ends = _scan_rows_host(seeds, v.dur2[:, idx])[:, -1].tolist()
            for r, e in zip(results, ends):
                r.opcode_cycles[b] = e
        return tarr2[:, -1].tolist(), (tarr2[:, :-1] if want_tb else None)

    from tpusim_torch.kernels import scan_rows as sr

    plan = cc.scan_plans.get(si)
    if plan is None:
        plan = cc.scan_plans[si] = sr.pack_segments(
            [(range(lo, hi), want_tb)]
            + [(idx, False) for _, idx in ugroups]
            + [(idx, False) for _, idx in ogroups]
        )
    seeds = [t]
    seeds += [[r.unit_busy_cycles[u] for r in results] for u, _ in ugroups]
    seeds += [[r.opcode_cycles[b] for r in results] for b, _ in ogroups]
    chain, *ends = sr.unpack_segments(
        plan, card.scan(plan, seeds, mat=v.dur_card))
    nu = len(ugroups)
    for (u, _), e in zip(ugroups, ends[:nu]):
        for r, x in zip(results, e.tolist()):
            r.unit_busy_cycles[u] = x
    for (b, _), e in zip(ogroups, ends[nu:]):
        for r, x in zip(results, e.tolist()):
            r.opcode_cycles[b] = x
    if want_tb:
        return chain[-1].tolist(), chain[:-1].t()
    return chain.tolist(), None


def _comp_uniform(ctx, comp_name: str) -> bool:
    """True when every lane of a batch provably builds IDENTICAL
    count/opcode/traffic/async per-op dicts walking ``comp_name``: no
    ``cond`` (worst-branch selection may diverge per lane) and no
    ``crun`` (contention may zero-extend durations for some lanes only),
    transitively through while bodies and callees.  Uniform frames fill
    those dicts on lane 0 only and copy at frame end — ``dict.copy``
    preserves both insertion order and (for the defaultdict aggregates)
    the default factory."""
    memo = ctx.uniform_memo
    got = memo.get(comp_name)
    if got is not None:
        return got
    memo[comp_name] = False  # cycle guard: recursive graphs fall back
    ok = True
    for step in ctx.cm.comp(comp_name).steps:
        k = step[0]
        if k == "cond" or k == "crun":
            ok = False
            break
        if k == "while" or k == "call":
            # step[4] is the body / callee computation name
            if not _comp_uniform(ctx, step[4]):
                ok = False
                break
    memo[comp_name] = ok
    return ok


def _price_comp_batch(ctx, comp_name: str, t0s: list[float], results,
                      depth: int) -> list[float]:
    if depth > 32:
        return list(t0s)
    cc = ctx.cm.comp(comp_name)
    v = ctx.view(cc)
    S = ctx.S
    overhead = ctx.overhead
    hbm_bpc = ctx.hbm_bpc
    vmem_bpc = ctx.vmem_bpc
    dma_lat = ctx.dma_lat
    contend = ctx.contend
    overlap = ctx.overlap

    names = cc.names
    bases = cc.bases
    # lane-invariant per-op dicts: fill lane 0 only, copy at frame end
    uni = S > 1 and _comp_uniform(ctx, comp_name)
    aux_lanes = (0,) if uni else range(S)

    t = list(t0s)
    acc_cache: dict[str, object] = {}
    ici_free = list(t0s)
    dma_free = list(t0s)
    pending: list[dict[str, float]] = [{} for _ in range(S)]
    dma_names: list[set[str]] = [set() for _ in range(S)]
    dma_busy_until = list(t0s)
    dma_segments: list[list[list[float]]] = [[] for _ in range(S)]
    cancel = ctx.cancel

    for si, step in enumerate(cc.steps):
        # one check covers every lane of the step
        if cancel is not None:
            cancel.check()
        kind = step[0]

        # ---- clean run of ordinary sync ops ---------------------------
        if kind == "run":
            (_, lo, hi, emit, hbm_idx, flops_idx, mxu_idx,
             ugroups, ogroups) = step
            n = hi - lo
            spill_on = v.spilled is not None
            want_tb = len(emit) > 0
            t, tb2 = _run_scans(ctx, cc, v, si, lo, hi, want_tb, t, ugroups,
                                ogroups, results)
            _acc_shared(ctx, results, "flops", cc.flops[lo:hi], acc_cache)
            _acc_shared(ctx, results, "mxu_flops", cc.mxu[lo:hi],
                        acc_cache)
            _acc_shared(ctx, results, "transcendentals", cc.trans[lo:hi],
                        acc_cache)
            _acc_shared(ctx, results, "hbm_bytes", v.hbm[lo:hi],
                        acc_cache)
            _acc_shared(ctx, results, "vmem_bytes", v.vmem[lo:hi],
                        acc_cache)
            if spill_on:
                _acc_shared(ctx, results, "vmem_spill_bytes",
                            v.spilled[lo:hi], acc_cache)
            for r in results:
                r.op_count += n
            prep = ctx.step_cache.get((comp_name, si))
            if prep is None:
                emit_l = emit.tolist()
                emit_names = [names[i] for i in emit_l]
                hidx = (hbm_idx if not spill_on else
                        torch.nonzero(v.hbm[lo:hi] > 0.0).flatten() + lo)
                hl = v.shared_list("hbm")
                fl = cc.col_list("flops")
                ml = cc.col_list("mxu")
                unique = len(set(emit_names)) == len(emit_names)
                fresh = ctx.seen_cyc.isdisjoint(emit_names)
                ctx.seen_cyc.update(emit_names)
                prep = (
                    emit_l,
                    emit_names,
                    None if fresh else frozenset(emit_names),
                    unique,
                    dict.fromkeys(emit_names, 1.0),
                    {names[i]: bases[i] for i in emit_l},
                    _proto(names, hidx.tolist(), hl, ctx.seen_hbm),
                    _proto(names, flops_idx.tolist(), fl, ctx.seen_flops),
                    _proto(names, mxu_idx.tolist(), ml, ctx.seen_mxu),
                )
                ctx.step_cache[(comp_name, si)] = prep
            (emit_l, emit_names, ekeys, unique, proto_cnt,
             proto_op, proto_h, proto_f, proto_m) = prep
            if want_tb:
                tb_sel = tb2[:, emit - lo]
                d_sel = v.dur2[:, emit_l]
                # the serial _emit adds (t + dur) - t, which is not dur
                # under IEEE rounding — same op here, elementwise
                contrib_rows = ((tb_sel + d_sel) - tb_sel).tolist()
                if unique and ekeys is None:
                    # names unique within the step (SSA) and fresh to the
                    # walk: every lane's fill is a pure insert —
                    # dict.update appends new keys in emit order, the
                    # serial walk's insertion order, with zero collision
                    # checks
                    for s, r in enumerate(results):
                        r.per_op_cycles.update(
                            zip(emit_names, contrib_rows[s])
                        )
                    for s in aux_lanes:
                        r = results[s]
                        r.per_op_count.update(proto_cnt)
                        r.per_op_opcode.update(proto_op)
                elif unique:
                    # unique but possibly seen before: per-lane set
                    # intersection picks out the keys that need an add
                    # (a + b is bitwise b + a under IEEE-754); update
                    # leaves existing keys' positions untouched like the
                    # serial walk
                    for s, r in enumerate(results):
                        pc = r.per_op_cycles
                        step_map = dict(zip(emit_names, contrib_rows[s]))
                        inter = ekeys & pc.keys()
                        for nm in inter:
                            step_map[nm] += pc[nm]
                        pc.update(step_map)
                    for s in aux_lanes:
                        r = results[s]
                        pn = r.per_op_count
                        inter = ekeys & pn.keys()
                        if inter:
                            cnt = dict(proto_cnt)
                            for nm in inter:
                                cnt[nm] += pn[nm]
                            pn.update(cnt)
                        else:
                            pn.update(proto_cnt)
                        po = r.per_op_opcode
                        inter = ekeys & po.keys()
                        if inter:
                            ops = dict(proto_op)
                            for nm in inter:
                                ops[nm] = po[nm]
                            po.update(ops)
                        else:
                            po.update(proto_op)
                else:
                    emit_bases = [bases[i] for i in emit_l]
                    for s, r in enumerate(results):
                        pc = r.per_op_cycles
                        row = contrib_rows[s]
                        if uni and s:
                            for j, nm in enumerate(emit_names):
                                pc[nm] += row[j]
                            continue
                        pn = r.per_op_count
                        po = r.per_op_opcode
                        for j, nm in enumerate(emit_names):
                            pc[nm] += row[j]
                            pn[nm] += 1.0
                            po.setdefault(nm, emit_bases[j])
            if proto_h is not None or proto_f is not None \
                    or proto_m is not None:
                for s in aux_lanes:
                    r = results[s]
                    if proto_h is not None:
                        _merge_add(r.per_op_hbm_bytes, proto_h)
                    if proto_f is not None:
                        _merge_add(r.per_op_flops, proto_f)
                    if proto_m is not None:
                        _merge_add(r.per_op_mxu_flops, proto_m)
            continue

        # ---- async joins ----------------------------------------------
        if kind == "done":
            _, i, src, is_coll = step
            for s in range(S):
                r = results[s]
                ps = pending[s]
                if src not in ps:
                    r.orphan_async_joins += 1
                finish = ps.pop(src, t[s])
                waited = max(0.0, finish - t[s])
                if is_coll:
                    r.exposed_collective_cycles += waited
                else:
                    r.exposed_dma_cycles += waited
                t[s] = max(t[s], finish)
                r.op_count += 1
            continue

        # ---- collectives ----------------------------------------------
        if kind == "coll":
            _, i, name, base, info, is_start = step
            ici_b = cc.col_list("ici_bytes")[i]
            memo = ctx.coll_memo
            a = ctx.arch
            ctx.seen_cyc.add(name)
            for s in range(S):
                lane = ctx.lanes[s]
                mk = (lane.coll_key, comp_name, si)
                dur = memo.get(mk)
                if dur is None:
                    dur = a.seconds_to_cycles(
                        lane.coll.seconds(info, ici_b)
                    )
                    memo[mk] = dur
                r = results[s]
                r.collective_count += 1
                r.ici_bytes += ici_b
                r.collective_cycles += dur
                r.unit_busy_cycles["ici"] += dur
                r.opcode_cycles[base] += dur
                if is_start and overlap:
                    start = max(t[s], ici_free[s])
                    pending[s][name] = start + dur
                    ici_free[s] = start + dur
                    r.per_op_cycles[name] += (start + dur) - start
                    if not uni or s == 0:
                        r.per_op_count[name] += 1.0
                        r.per_op_opcode.setdefault(name, base)
                        r.per_op_async[name] = True
                    t[s] += overhead
                else:
                    start = max(t[s], ici_free[s])
                    r.per_op_cycles[name] += (start + dur) - start
                    if not uni or s == 0:
                        r.per_op_count[name] += 1.0
                        r.per_op_opcode.setdefault(name, base)
                        if is_start:
                            r.per_op_async[name] = True
                    t[s] = start + dur
                    ici_free[s] = t[s]
                    r.exposed_collective_cycles += dur
                    if is_start:
                        pending[s][name] = t[s]
                r.op_count += 1
            continue

        # ---- async DMA start ------------------------------------------
        if kind == "dma":
            _, i, name, base = step
            _flush_acc(results, acc_cache)  # mutates hbm/spill bytes
            dcol = v.dur2[:, i].tolist()
            hbm_b = v.shared_list("hbm")[i]
            sp_b = (v.shared_list("spilled")[i]
                    if v.spilled is not None else None)
            ctx.seen_cyc.add(name)
            ctx.seen_hbm.add(name)
            for s in range(S):
                r = results[s]
                dur = dcol[s]
                if sp_b is not None:
                    r.vmem_spill_bytes += sp_b
                start = max(t[s], dma_free[s])
                pending[s][name] = start + dma_lat + dur
                dma_names[s].add(name)
                dma_free[s] = start + dur
                if hbm_b > 0:
                    dma_busy_until[s] = max(dma_busy_until[s], start + dur)
                    if dur > 0:
                        dma_segments[s].append(
                            [start, start + dur, hbm_b / dur]
                        )
                r.dma_cycles += dur
                r.unit_busy_cycles["dma"] += dur
                r.opcode_cycles[base] += dur
                r.hbm_bytes += hbm_b
                r.per_op_cycles[name] += (start + dma_lat + dur) - t[s]
                if not uni or s == 0:
                    r.per_op_hbm_bytes[name] += hbm_b
                    r.per_op_count[name] += 1.0
                    r.per_op_opcode.setdefault(name, base)
                    r.per_op_async[name] = True
                t[s] += overhead
                r.op_count += 1
            continue

        # ---- contended run (DMA statically in flight) -----------------
        if kind == "crun":
            _, lo, hi = step
            _flush_acc(results, acc_cache)  # per-lane += on all six
            fl = cc.col_list("flops")
            ml = cc.col_list("mxu")
            tl = cc.col_list("trans")
            hl = v.shared_list("hbm")
            vl = v.shared_list("vmem")
            sl = (v.shared_list("spilled")
                  if v.spilled is not None else None)
            rng = names[lo:hi]
            ctx.seen_cyc.update(rng)
            ctx.seen_hbm.update(rng)
            ctx.seen_flops.update(rng)
            ctx.seen_mxu.update(rng)
            for s in range(S):
                r = results[s]
                dl = v.lane_list("dur2", s)
                cl = v.lane_list("compute2", s)
                hrl = v.lane_list("hrs2", s)
                vrl = v.lane_list("vrs2", s)
                ub = r.unit_busy_cycles
                oc = r.opcode_cycles
                t_s = t[s]
                segs = dma_segments[s]
                for i in range(lo, hi):
                    dur = dl[i]
                    hbm_b = hl[i]
                    if sl is not None:
                        r.vmem_spill_bytes += sl[i]
                    if contend and hbm_b > 0 and dma_busy_until[s] > t_s:
                        segs = [sg for sg in segs if sg[1] > t_s]
                        q_bytes = sum(
                            sg[2] * (sg[1] - max(t_s, sg[0]))
                            for sg in segs
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
                        r.hbm_contention_cycles += (
                            max(new_dur - dur, 0.0) + penalty
                        )
                        for nm in dma_names[s]:
                            fin = pending[s].get(nm)
                            if fin is not None and fin > t_s:
                                pending[s][nm] = fin + penalty
                        dma_free[s] += penalty
                        dma_busy_until[s] += penalty
                        for sg in segs:
                            if sg[0] >= t_s:
                                sg[0] += penalty
                                sg[1] += penalty
                            else:
                                remaining = sg[2] * (sg[1] - t_s)
                                sg[0] = t_s
                                sg[1] += penalty
                                if sg[1] > t_s:
                                    sg[2] = remaining / (sg[1] - t_s)
                        dur = new_dur
                    if dur > 0:
                        nm = names[i]
                        r.per_op_cycles[nm] += (t_s + dur) - t_s
                        r.per_op_count[nm] += 1.0
                        r.per_op_opcode.setdefault(nm, bases[i])
                    t_s += dur
                    r.op_count += 1
                    r.flops += fl[i]
                    r.mxu_flops += ml[i]
                    r.transcendentals += tl[i]
                    r.hbm_bytes += hbm_b
                    r.vmem_bytes += vl[i]
                    if hbm_b > 0:
                        r.per_op_hbm_bytes[names[i]] += hbm_b
                    if fl[i] > 0:
                        r.per_op_flops[names[i]] += fl[i]
                    if ml[i] > 0:
                        r.per_op_mxu_flops[names[i]] += ml[i]
                    if dur > 0:
                        ub[cc.units[i]] += dur
                        oc[bases[i]] += dur
                t[s] = t_s
                dma_segments[s] = segs
            continue

        # ---- control flow ---------------------------------------------
        if kind == "while":
            _, i, name, base, body, trips, unknown = step
            _flush_acc(results, acc_cache)  # merge_scaled reads attrs
            subs = [EngineResult() for _ in range(S)]
            ends = _price_comp_batch(ctx, body, [0.0] * S, subs, depth + 1)
            ft = float(trips)
            for s in range(S):
                r = results[s]
                if unknown:
                    r.unknown_trip_loops += 1
                if uni and s:
                    _merge_lane_variant(r, subs[s], ft)
                else:
                    r.merge_scaled(subs[s], ft)
                dur = ends[s] * trips + overhead * (trips + 1)
                r.per_op_cycles[name] += (t[s] + dur) - t[s]
                if not uni or s == 0:
                    r.per_op_count[name] += 1.0
                    r.per_op_opcode.setdefault(name, base)
                t[s] += dur
                r.op_count += 1
            continue
        if kind == "cond":
            _, i, name, base, branches = step
            _flush_acc(results, acc_cache)  # merge_scaled reads attrs
            branch_ends: list[list[float]] = []
            branch_subs: list[list[EngineResult]] = []
            for branch in branches:
                subs = [EngineResult() for _ in range(S)]
                ends = _price_comp_batch(
                    ctx, branch, [0.0] * S, subs, depth + 1
                )
                branch_ends.append(ends)
                branch_subs.append(subs)
            nb = len(branches)
            for s in range(S):
                r = results[s]
                if nb:
                    durs = [branch_ends[b][s] for b in range(nb)]
                    # first-max argmax, the per-state walk's tiebreak
                    worst = max(range(nb), key=lambda k: durs[k])
                    r.merge_scaled(branch_subs[worst][s], 1.0)
                    dur = durs[worst] + overhead
                    if nb > 1 and max(durs) > 1.5 * min(durs):
                        r.worst_case_branches += 1
                    r.per_op_cycles[name] += (t[s] + dur) - t[s]
                    r.per_op_count[name] += 1.0
                    r.per_op_opcode.setdefault(name, base)
                    t[s] += dur
                r.op_count += 1
            continue
        if kind == "call":
            _, i, name, base, callee = step
            _flush_acc(results, acc_cache)  # merge_scaled reads attrs
            subs = [EngineResult() for _ in range(S)]
            ends = _price_comp_batch(ctx, callee, [0.0] * S, subs,
                                     depth + 1)
            for s in range(S):
                r = results[s]
                if uni and s:
                    _merge_lane_variant(r, subs[s], 1.0)
                else:
                    r.merge_scaled(subs[s], 1.0)
                d = ends[s]
                r.per_op_cycles[name] += (t[s] + d) - t[s]
                if not uni or s == 0:
                    r.per_op_count[name] += 1.0
                    r.per_op_opcode.setdefault(name, base)
                t[s] += d
                r.op_count += 1
            continue

        raise AssertionError(f"unknown fastpath step kind {kind!r}")

    _flush_acc(results, acc_cache)
    # drain: mirror of the per-state walk's end-of-computation accounting
    for s in range(S):
        results[s].unjoined_async += len(pending[s])
        for finish in pending[s].values():
            t[s] = max(t[s], finish)

    if uni:
        # materialize the lane-invariant per-op dicts: every lane's serial
        # walk would have produced lane 0's dicts key-for-key (no
        # cond/crun divergence in this frame or below), and dict.copy
        # preserves insertion order + defaultdict factory
        src = results[0]
        cnt, opc = src.per_op_count, src.per_op_opcode
        hbm_d, fl_d = src.per_op_hbm_bytes, src.per_op_flops
        mx_d, asy = src.per_op_mxu_flops, src.per_op_async
        for s in range(1, S):
            r = results[s]
            r.per_op_count = cnt.copy()
            r.per_op_opcode = opc.copy()
            r.per_op_hbm_bytes = hbm_d.copy()
            r.per_op_flops = fl_d.copy()
            r.per_op_mxu_flops = mx_d.copy()
            r.per_op_async = asy.copy()
    return t


# ---------------------------------------------------------------------------
# Campaign/fleet integration: warm the result cache per launch class
# ---------------------------------------------------------------------------


def warm_states(
    pod, cfg, topo, states, cache, *, backend: str | None = None,
    cancel=None,
) -> BatchStats:
    """Batch-price the launch classes a set of degradation states will
    consume and publish each lane under its exact per-state cache key.

    ``states`` is a list of bound fault states (or ``None`` for the
    healthy state) against base topology ``topo``; windowed states are
    skipped (their multipliers depend on issue cycles the batch cannot
    see — the per-state walk prices them unchanged).  The launch-class
    enumeration mirrors the driver's segment-parallel pre-scan, so the
    keys minted here are exactly the ones ``CachedEngine.run`` looks up:
    a per-state driver walk that follows consumes pure cache hits and
    its bytes cannot move.  ``backend="cuda"`` runs the lanes' row scans
    on the card (``scan_rows``) and must be asked for explicitly.
    ``cancel`` is checked before each state and each module's pass."""
    from tpusim_torch.faults import TopologyPartitionedError
    from tpusim_torch.ir import CommandKind

    stats = BatchStats()
    if cache is None:
        stats.skipped += len(states)
        return stats
    backend = resolve_batch_backend(backend)
    if backend == "serial" or cfg.resume_op or cfg.checkpoint_op:
        # no batching; op-granularity checkpoint/resume keeps the serial
        # walk in charge (fastpath_eligible's discipline)
        stats.skipped += len(states)
        return stats

    device_ids = sorted(pod.devices) or [0]
    # lanes per module: module name -> list of (scales, topo_k, key)
    lanes_by_module: dict[str, list] = {}
    seen_keys: set[str] = set()
    for state in states:
        if cancel is not None:
            cancel.check()
        if state is not None and state.windowed:
            stats.skipped += 1
            continue
        view = state.view_at(0.0) if state is not None else None
        topo_k = topo.with_faults(view) if view is not None else topo
        for dev_id in device_ids:
            dev = pod.devices.get(dev_id)
            if dev is None:
                continue
            scales = (
                view.chip_scales(dev_id)
                if view is not None else (1.0, 1.0)
            )
            for cmd in dev.commands:
                if (
                    cmd.kind != CommandKind.KERNEL_LAUNCH
                    or cmd.module not in pod.modules
                ):
                    continue
                key = cache.key_for(
                    pod.modules[cmd.module], cfg, scales, topo_k
                )
                if key is None or key in seen_keys:
                    continue
                seen_keys.add(key)
                if cache.get(key) is not None:
                    stats.lanes_cached += 1
                    continue
                lanes_by_module.setdefault(cmd.module, []).append(
                    (scales, topo_k, key)
                )

    for mod_name, lanes in lanes_by_module.items():
        if cancel is not None:
            cancel.check()
        module = pod.modules[mod_name]
        engines = [
            Engine(cfg, topology=tk, clock_scale=cs, hbm_scale=hs)
            for (cs, hs), tk, _key in lanes
        ]
        if not fastpath_eligible(engines[0]):
            stats.skipped += len(lanes)
            continue
        try:
            results = price_module_batch(
                module, engines, backend=backend, cancel=cancel,
            )
        except TopologyPartitionedError:
            # a lane whose dead links disconnect this module's chips:
            # leave the whole group to the per-state walk, which records
            # the partition outcome itself
            stats.skipped += len(lanes)
            continue
        for (_scales, _tk, key), res in zip(lanes, results):
            cache.put(key, res)
        stats.states += len(lanes)
        stats.groups += 1
    return stats

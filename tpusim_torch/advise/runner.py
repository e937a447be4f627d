"""The advise sweep executor: enumerate cells, price, rank.

Port of ``tpusim/advise/runner.py``.  The CI gate named below is the
reference's: the port reaches the advisor through ``python -m
tpusim_torch advise``, ``run_advise``, ``lint --advise`` and the served
job (``POST /v1/advise``).

One cell = (slice, strategy, mesh degrees).  Cells price serially in
spec order through ONE shared :class:`tpusim_torch.perf.ResultCache`; the
synthesized compute modules are collective-free, so every cell with the
same per-chip shape scale shares one engine walk per arch (a 12-cell
sweep typically runs a handful of engine walks cold and ZERO warm —
CI-enforced by ``ci/check_golden.py --advise-smoke``).  The report
document is a pure function of the priced rows: fixed spec + fixed
capture -> byte-identical doc.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.advise.spec import (
    AdviseSpec,
    SliceSpec,
    load_advise_spec,
    spec_hash,
)
from tpusim_torch.advise.transform import (
    WorkloadProfile,
    build_cell_pod,
    build_profile,
    scaled_module,
)

__all__ = ["ADVISE_FORMAT_VERSION", "AdviseResult", "AdviseStats",
           "run_advise"]

ADVISE_FORMAT_VERSION = 1



@dataclass
class AdviseStats:
    """Executor accounting — the ``advise_*`` stats namespace
    (registered in the reference's ``tpusim/analysis/statskeys.py``).  Rides reports
    and ``/metrics`` only when an advise sweep actually ran — the
    healthy simulate path never stamps them."""

    slices: int = 0
    cells: int = 0
    priced: int = 0
    skipped: int = 0
    feasible: int = 0

    def stats_dict(self) -> dict[str, float]:
        return {
            "advise_slices_total": self.slices,
            "advise_cells_total": self.cells,
            "advise_cells_priced": self.priced,
            "advise_cells_skipped": self.skipped,
            "advise_cells_feasible": self.feasible,
        }


@dataclass
class AdviseResult:
    """One advise sweep's report document + executor accounting."""

    doc: dict
    stats: AdviseStats
    wall_seconds: float = 0.0
    profile: WorkloadProfile | None = field(default=None, repr=False)


# ---------------------------------------------------------------------------
# Cell enumeration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Cell:
    sl: SliceSpec
    strategy: str
    degrees: tuple[tuple[str, int], ...]

    @property
    def mesh(self) -> dict[str, int]:
        return {k: v for k, v in self.degrees if v > 1} or {"dp": 1}

    @property
    def label(self) -> str:
        mesh = "x".join(
            f"{k}{v}" for k, v in self.degrees if v > 1
        ) or "dp1"
        return f"{self.sl.label}/{mesh}"


def _strategy_meshes(strategy: str, chips: int) \
        -> list[tuple[tuple[str, int], ...]]:
    if strategy == "dp_tp":
        out = []
        for dp in range(2, chips):
            if chips % dp == 0 and chips // dp >= 2:
                out.append((("dp", dp), ("tp", chips // dp)))
        return out
    return [((strategy, chips),)]


def enumerate_cells(
    spec: AdviseSpec, default_chips: int,
) -> list[_Cell]:
    """The sweep's cross-product, in spec order (slices outer,
    strategies inner, pinned meshes last per slice) — the doc's cell
    ordering before ranking, so fixed specs enumerate identically."""
    cells: list[_Cell] = []
    seen: set[tuple[str, tuple[tuple[str, int], ...]]] = set()

    def add(sl: SliceSpec, strategy: str,
            degrees: tuple[tuple[str, int], ...]) -> None:
        key = (sl.label, degrees)
        if key in seen:
            return
        seen.add(key)
        cells.append(_Cell(sl=sl, strategy=strategy, degrees=degrees))

    for sl in spec.resolved_slices(default_chips):
        for strategy in spec.strategies:
            for degrees in _strategy_meshes(strategy, sl.chips):
                add(sl, strategy, degrees)
        for mesh in spec.meshes:
            if mesh.product == sl.chips:
                add(sl, "pinned", mesh.axes)
    return cells


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------


def _residency_gib(module) -> float:
    """Per-chip HBM residency (GiB): the dataflow engine's
    aliasing-aware peak-live HBM bytes of the exact scaled module this
    cell prices (``tpusim_torch.analysis.dataflow``).  The same liveness
    walk backs the TL400 "will not fit" lint error, so the ranked
    table and the linter can never disagree about what fits —
    replacing an earlier sharding heuristic, whose axis arithmetic could
    drift arbitrarily far from what the priced module actually holds.

    Known limit, inherited from the transform layer: ``scaled_module``
    scales every tensor uniformly by chips*launches (pricing has the
    same property), so cells at equal chip count report equal
    residency regardless of WHICH axis shards — dp-replicated weights
    and optimizer state beyond the captured step are outside the
    capture.  The column describes the module the cell actually
    prices; axis-aware weight layouts arrive with the transform layer,
    not here."""
    from tpusim_torch.analysis.dataflow import analyze_module

    return analyze_module(module).peak_live("hbm") / float(1 << 30)


def _exposed_comm_frac(
    compute, cfg, topo, cell_pod, step_cycles: float,
    module_exposed: float | None = None,
) -> float:
    """Fraction of the cell's step cycles that are exposed (uncovered)
    communication — the critical-path analyzer's
    ``exposed_collective_cycles`` of the EXACT scaled module this cell
    prices (same discipline as the hbm column: the ranked table and
    ``analyze_module_perf`` can never disagree), plus the synthesized
    standalone COLLECTIVE commands on device 0, which serialize on the
    stream clock and are therefore fully exposed, priced through the
    same collective model the driver uses.

    Today's transform strips in-module collectives from the scaled
    clone (``scaled_module``), so the module term is zero and the
    synthesized commands carry all the communication; the module term
    keeps the column correct the day the transform preserves them."""
    from tpusim_torch.analysis.critpath import analyze_module_perf
    from tpusim_torch.ici.detailed import make_collective_model
    from tpusim_torch.ir import CommandKind

    if step_cycles <= 0:
        return 0.0
    if module_exposed is None:
        module_exposed = analyze_module_perf(
            compute, cfg, topology=topo,
        ).exposed_collective_cycles
    coll = make_collective_model(topo, cfg.arch.ici)
    launches = 0
    cmd_cycles = 0.0
    for c in cell_pod.devices[0].commands:
        if c.kind == CommandKind.KERNEL_LAUNCH:
            launches += 1
        elif c.kind == CommandKind.COLLECTIVE and c.collective is not None:
            cmd_cycles += cfg.arch.seconds_to_cycles(
                coll.seconds(c.collective, float(c.nbytes))
            )
    exposed = module_exposed * max(launches, 1) + cmd_cycles
    return exposed / step_cycles


def run_advise(
    spec_src,
    trace_path: str | Path | None = None,
    pod=None,
    trace_name: str | None = None,
    result_cache=None,
    workers: int | None = None,
    validate: bool = True,
    progress=None,
    cancel=None,
    compile_cache=None,
) -> AdviseResult:
    """Execute one advise sweep end to end.

    ``spec_src`` is whatever :func:`~tpusim_torch.advise.spec.
    load_advise_spec` accepts.  The workload comes from ``trace_path``
    or an already-parsed ``pod`` (the serve tier passes its hot
    registry entry).  ``result_cache`` is shared across every cell
    (None = fresh in-memory cache); ``workers`` fans each replay's
    module pricing.  ``validate`` runs the TL22x advise passes first
    and refuses on errors — a broken spec must fail before cell 0
    prices.  ``cancel`` (a :class:`tpusim_torch.guard.CancelToken`) cancels
    cooperatively at cell grain (``DELETE /v1/jobs/<id>`` in serve);
    cells already priced sit warm in the shared cache, so a re-run
    re-prices nothing they covered."""
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.perf.cache import ResultCache, as_result_cache
    from tpusim_torch.sim.driver import SimDriver
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.model_version import model_version

    t0 = time.perf_counter()
    if compile_cache is not None and compile_cache is not False:
        # mount the durable compiled tier (tpusim_torch.fastpath.store)
        # before the trace loads; scaled cell clones each compile once
        # ever per (content, config) and persist for later sweeps
        from tpusim_torch.fastpath.store import as_compile_store

        as_compile_store(compile_cache)
    spec = load_advise_spec(spec_src)
    if pod is None:
        if trace_path is None:
            raise ValueError("run_advise needs trace_path or pod")
        from tpusim_torch.trace.format import load_trace

        pod = load_trace(trace_path)
    if trace_name is None:
        trace_name = (
            Path(trace_path).name if trace_path is not None
            else str(pod.meta.get("name", "inline"))
        )
    profile = build_profile(pod)

    if validate:
        from tpusim_torch.analysis import ValidationError
        from tpusim_torch.analysis.advise_passes import run_advise_passes
        from tpusim_torch.analysis.diagnostics import Diagnostics

        diags = Diagnostics()
        run_advise_passes(spec, diags, default_chips=profile.chips0)
        if diags.has_errors:
            raise ValidationError(diags)

    stats = AdviseStats()
    cache = as_result_cache(result_cache) or ResultCache()
    cells = enumerate_cells(spec, profile.chips0)
    dropped = max(len(cells) - spec.max_cells, 0)
    cells = cells[: spec.max_cells]

    cfg_cache: dict[tuple, object] = {}
    module_cache: dict[tuple[str, float], object] = {}
    # scaled-module exposed-collective cycles, memoized per
    # (module variant, arch) — analyze_module_perf is pure
    perf_cache: dict[tuple, float] = {}
    rows: list[dict] = []
    skipped: list[dict] = []
    for cell in cells:
        # cell-grain cancellation (tpusim_torch.guard): the shared cache keeps
        # every already-priced cell warm across a cancel + re-run
        if cancel is not None:
            cancel.check()
        stats.cells += 1
        degrees = dict(cell.degrees)
        if degrees.get("ep", 1) > 1 and not profile.ep_sites:
            stats.skipped += 1
            skipped.append({
                "cell": cell.label,
                "strategy": cell.strategy,
                "reason": "capture has no expert-parallel (all-to-all) "
                          "collectives to re-shard",
            })
            continue
        unsupported = _unsupported_combo(degrees)
        if unsupported is not None:
            stats.skipped += 1
            skipped.append({
                "cell": cell.label,
                "strategy": cell.strategy,
                "reason": unsupported,
            })
            continue

        # the fabric overlay sizes chips_per_slice from the cell's chip
        # count, so configs key on (arch, chips) when a dcn block rides
        ckey = (
            (cell.sl.arch, cell.sl.chips) if spec.dcn is not None
            else (cell.sl.arch,)
        )
        cfg = cfg_cache.get(ckey)
        if cfg is None:
            overlays: list[dict] = [{"power_enabled": True}]
            if spec.dcn is not None:
                from tpusim_torch.dcn.spec import fabric_overlay

                overlays.append(fabric_overlay(spec.dcn, cell.sl.chips))
            cfg = cfg_cache[ckey] = load_config(
                arch=cell.sl.arch,
                overlays=overlays,
                tuned=spec.tuned,
            )
        pp = degrees.get("pp", 1)
        launches = (spec.microbatches or pp) if pp > 1 else 1
        elem_factor = profile.chips0 / float(cell.sl.chips * launches)
        mkey = (profile.module_name, elem_factor)
        compute = module_cache.get(mkey)
        if compute is None:
            compute = module_cache[mkey] = scaled_module(
                pod.modules[profile.module_name], elem_factor,
                f"{profile.module_name}__advise_{elem_factor!r}",
                profile.capture_fp,
            )
        cell_pod = build_cell_pod(
            profile, compute, cell.sl.chips, degrees, launches=launches,
        )
        from tpusim_torch.ir import CommandKind

        # one device's synthesized collective count — the MULTICHIP
        # dryrun convention ("14 collectives" in MULTICHIP_r05 is one
        # chip's dp=4 x tp=2 step, not the pod total)
        coll_per_chip = sum(
            1 for c in cell_pod.devices[0].commands
            if c.kind == CommandKind.COLLECTIVE
        )
        topo = torus_for(cell.sl.chips, cfg.arch.name)
        report = SimDriver(
            cfg, topology=topo, result_cache=cache, workers=workers,
        ).run(cell_pod)
        stats.priced += 1

        clock_hz = cfg.arch.clock_hz
        step_ms = report.cycles / clock_hz * 1e3 if clock_hz else 0.0
        watts = energy = None
        if report.power is not None:
            watts = report.power.avg_watts
            energy = report.power.total_joules
        resident_gib = _residency_gib(compute)
        fits_hbm = resident_gib <= cfg.arch.hbm_gib
        pkey = (mkey, ckey)
        module_exposed = perf_cache.get(pkey)
        if module_exposed is None:
            from tpusim_torch.analysis.critpath import analyze_module_perf

            module_exposed = perf_cache[pkey] = analyze_module_perf(
                compute, cfg, topology=topo,
            ).exposed_collective_cycles
        exposed_frac = _exposed_comm_frac(
            compute, cfg, topo, cell_pod, report.cycles,
            module_exposed=module_exposed,
        )
        slo_ok = (
            None if spec.slo is None
            else step_ms <= spec.slo.step_time_ms
        )
        row = {
            "cell": cell.label,
            "arch": cell.sl.arch,
            "chips": cell.sl.chips,
            "strategy": cell.strategy,
            "mesh": cell.mesh,
            "launches": launches,
            "step_ms": step_ms,
            "step_cycles": report.cycles,
            "ici_bytes": report.totals.ici_bytes,
            "collectives": report.totals.collective_count,
            "collectives_per_chip": coll_per_chip,
            "hbm_resident_gib": resident_gib,
            "fits_hbm": fits_hbm,
            "exposed_comm_frac": exposed_frac,
            "watts": watts,
            "pod_watts": (
                watts * cell.sl.chips if watts is not None else None
            ),
            "perf_per_watt": (
                (1e3 / step_ms) / (watts * cell.sl.chips)
                if watts and step_ms > 0 else None
            ),
            "energy_j": energy,
            "slo_ok": slo_ok,
            "feasible": fits_hbm and slo_ok is not False,
        }
        if spec.dcn is not None:
            from tpusim_torch.dcn import slice_topology_for

            st = slice_topology_for(cell.sl.chips, cfg.arch.ici)
            if st is not None:
                # an axis "spans" the DCN when its collective group
                # outgrows one slice — the group then prices
                # hierarchically (or over the flat scalar term,
                # whichever is cheaper)
                row["dcn"] = {
                    "slices": st.num_slices,
                    "dp_over_dcn":
                        degrees.get("dp", 1) > st.chips_per_slice,
                    "spanning_axes": sorted(
                        k for k, v in degrees.items()
                        if v > st.chips_per_slice
                    ),
                }
        rows.append(row)
        if row["feasible"]:
            stats.feasible += 1
        if progress is not None:
            progress(
                f"{cell.label}: {step_ms:.3f}ms "
                f"({'ok' if row['feasible'] else 'infeasible'})"
            )
    stats.slices = len({c.sl.label for c in cells})

    ranked = sorted(
        rows, key=lambda r: (not r["feasible"], r["step_ms"], r["cell"]),
    )
    for i, r in enumerate(ranked):
        r["rank"] = i + 1
    recommendation = next((r for r in ranked if r["feasible"]), None)

    doc = {
        "format_version": ADVISE_FORMAT_VERSION,
        "advise": spec.name,
        "spec_hash": spec_hash(spec),
        "model_version": model_version(),
        "trace": trace_name,
        "capture": {
            "module": profile.module_name,
            "chips": profile.chips0,
            "dp": profile.dp0,
            "tp": profile.tp0,
            "collective_sites": {
                "tp": len(profile.tp_sites),
                "dp": len(profile.dp_sites),
                "ep": len(profile.ep_sites),
            },
            "param_bytes": profile.param_bytes_total,
        },
        "slo": (
            {"step_time_ms": spec.slo.step_time_ms}
            if spec.slo is not None else None
        ),
        "cells": ranked,
        "skipped": skipped,
        "cells_dropped": dropped,
        "recommendation": (
            {
                "cell": recommendation["cell"],
                "strategy": recommendation["strategy"],
                "mesh": recommendation["mesh"],
                "step_ms": recommendation["step_ms"],
            }
            if recommendation is not None else None
        ),
    }
    return AdviseResult(
        doc=doc, stats=stats,
        wall_seconds=time.perf_counter() - t0,
        profile=profile,
    )


def _unsupported_combo(degrees: dict[str, int]) -> str | None:
    """Reason string when the transform cannot synthesize this mesh
    combination, else None.  Supported composites: any subset of
    {dp, tp, pp}, plus dp x sp and dp x ep — sp/ep never combine with
    tp, pp, or each other (the synthesized chip layouts would
    conflict).  Enumerated strategies are always single-axis or
    dp x tp, so only pinned meshes can land here."""
    sp = degrees.get("sp", 1)
    ep = degrees.get("ep", 1)
    if sp > 1 and (
        degrees.get("tp", 1) > 1 or degrees.get("pp", 1) > 1 or ep > 1
    ):
        return "sp composes with a dp axis only"
    if ep > 1 and (
        degrees.get("tp", 1) > 1 or degrees.get("pp", 1) > 1
    ):
        return "ep composes with a dp axis only"
    return None

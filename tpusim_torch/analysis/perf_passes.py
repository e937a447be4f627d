"""Perf passes (TL50x): critical path, slack, exposed communication.

The third pass family.  Where the trace passes (TL0xx–TL3xx) prove
legality and the memory passes (TL40x) prove fit, these explain
*performance* — statically, from the same per-op costs the engine
prices with (:mod:`tpusim_torch.analysis.critpath`):

* **TL500** (info) — per-module critical-path summary: path length,
  serial bound, exposed vs priced collective cycles, dominant
  roofline class;
* **TL501** (warning) — a collective is mostly exposed while
  independently schedulable compute sits outside its issue window
  (overlap left on the table);
* **TL502** (warning) — serialization bubble: a dependency chain
  through a small op pins a large op off the critical path;
* **TL503** (warning) — an HBM-bound op dominates the critical path on
  an arch whose roofline (shape-level arithmetic intensity vs ridge
  point) says it should be compute-bound;
* **TL504** (error) — the cost model returned a non-finite or negative
  cost for an entry-reachable op.

Only computations reachable from the entry via control flow carry
op-level diagnostics — they are the only frames the engine prices.
Deferred (streaming) modules are analyzed one computation at a time via
:meth:`CritBuilder.feed`, retaining O(findings) line anchors, so the
lint RSS bound survives.

Port of ``tpusim/analysis/perf_passes.py``.
"""

from __future__ import annotations

from tpusim_torch.analysis.critpath import (
    TL501_EXPOSED_FRAC,
    TL501_MOVABLE_FRAC,
    CompPerf,
    CritBuilder,
    ModulePerf,
    analyze_module_perf,
    module_perf_doc,
)
from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["run_perf_passes"]


def _perf_of(entry, cfg, topology=None):
    """(ModulePerf, {(comp, op) -> line}) for one lint source entry —
    an eager/deferred ParsedModule or a plain ModuleTrace."""
    if not hasattr(entry, "iter_computations"):
        # plain ModuleTrace (serve pre-flight): full-module analysis
        return analyze_module_perf(entry, cfg, topology=topology), {}

    if entry.deferred_path is None:
        mp = analyze_module_perf(entry.module, cfg, topology=topology)
        return mp, entry.op_lines

    # deferred: stream computations straight off the file, keep only
    # the line anchors the findings actually cite
    builder = CritBuilder(
        cfg,
        num_devices=entry.module.num_devices,
        topology=topology,
    )
    lines: dict[tuple[str, str], int] = {}
    for comp, _header, op_lines in entry.iter_computations():
        cp = builder.feed(comp)
        for oname in _cited_ops(cp):
            line = op_lines.get(oname)
            if line is not None:
                lines[(comp.name, oname)] = line
    return builder.finish(entry.module.entry_name), lines


def _cited_ops(cp: CompPerf) -> set[str]:
    cited = {e.op for e in cp.exposures}
    cited.update(b.op for b in cp.bubbles)
    cited.update(s.op for s in cp.suspects)
    cited.update(b.op for b in cp.bad_costs)
    return cited


def _emit_module(
    name: str,
    mp: ModulePerf,
    cfg,
    diags: Diagnostics,
    file: str | None,
    header_line: int | None,
    op_lines,
) -> None:
    entry_cp = mp.comps.get(mp.entry) if mp.entry else None
    if entry_cp is not None:
        diags.emit(
            "TL500",
            f"module {name!r}: critical path {mp.critical_path_cycles:.0f} "
            f"cycles (entry {mp.entry!r}, {entry_cp.op_count} scheduled "
            f"ops), serial bound {mp.serial_cycles:.0f} cycles, exposed "
            f"collective {mp.exposed_collective_cycles:.0f} of "
            f"{mp.collective_cycles:.0f} priced cycles, dominant bound "
            f"{entry_cp.dominant_bound}",
            file=file, line=header_line,
        )

    for cname in sorted(mp.reachable):
        cp = mp.comps.get(cname)
        if cp is None:
            continue

        def anchor(oname: str) -> int | None:
            return op_lines.get((cname, oname))

        for b in cp.bad_costs:
            diags.emit(
                "TL504",
                f"cost model returned a non-finite or negative cost for "
                f"reachable op {b.op!r} ({b.opcode}) in {cname!r}: "
                f"{b.detail}",
                file=file, line=anchor(b.op),
            )
        for e in cp.exposures:
            if e.priced_cycles <= 0:
                continue
            if e.exposed_cycles < TL501_EXPOSED_FRAC * e.priced_cycles:
                continue
            if e.movable_cycles < TL501_MOVABLE_FRAC * e.exposed_cycles:
                continue
            pct = 100.0 * e.exposed_cycles / e.priced_cycles
            how = "priced synchronously" if e.sync else "mostly uncovered"
            diags.emit(
                "TL501",
                f"collective {e.op!r} ({e.opcode}) in {cname!r} is "
                f"{pct:.0f}% exposed ({e.exposed_cycles:.0f} of "
                f"{e.priced_cycles:.0f} priced cycles, {how}) while "
                f"{e.movable_cycles:.0f} cycles of independent compute "
                f"sit outside its window — overlap left on the table",
                file=file, line=anchor(e.op),
            )
        for b in cp.bubbles:
            diags.emit(
                "TL502",
                f"serialization bubble in {cname!r}: {b.op!r} "
                f"({b.opcode}, {b.pinned_cycles:.0f} cycles) waits "
                f"{b.bubble_cycles:.0f} extra cycles on the chain through "
                f"small op {b.pred!r} ({b.pred_cycles:.0f} cycles), "
                f"pinning it off the critical path",
                file=file, line=anchor(b.op),
            )
        for s in cp.suspects:
            diags.emit(
                "TL503",
                f"{s.op!r} ({s.opcode}) dominates {cname!r}'s critical "
                f"path HBM-bound ({s.cycles:.0f} cycles) but its "
                f"shape-level arithmetic intensity "
                f"{s.intensity:.1f} flop/B is above {cfg.arch.name}'s "
                f"ridge point {s.ridge:.1f} — the roofline says this op "
                f"should be compute-bound",
                file=file, line=anchor(s.op),
            )


def run_perf_passes(
    source,
    cfg,
    diags: Diagnostics,
    report: list | None = None,
    topology: object = None,
) -> None:
    """TL50x over every module of ``source`` priced against ``cfg``.

    ``source`` is a :class:`~tpusim_torch.analysis.trace_passes.ParsedTrace`
    (eager or deferred modules) or a plain ``{name: ModuleTrace}``
    mapping.  When ``report`` is a list, one
    :func:`~tpusim_torch.analysis.critpath.module_perf_doc` per module is
    appended (the ``perf`` key of ``lint --json`` and the perf-report
    CLI's data source).
    """
    modules = getattr(source, "modules", source)
    for key in sorted(modules):
        entry = modules[key]
        file = header_line = None
        op_lines: dict = {}
        if hasattr(entry, "iter_computations"):
            file = entry.file
            name = entry.module.name
            mp, op_lines = _perf_of(entry, cfg, topology=topology)
            if entry.comp_lines:
                ename = entry.module.entry_name
                header_line = entry.comp_lines.get(
                    ename, min(entry.comp_lines.values())
                )
        else:
            name = entry.name
            mp, op_lines = _perf_of(entry, cfg, topology=topology)
        _emit_module(name, mp, cfg, diags, file, header_line, op_lines)
        if report is not None:
            doc = module_perf_doc(mp)
            doc["file"] = file
            doc["key"] = key
            report.append(doc)

"""Single-link-failure sweeps — "what does step time look like when link
(2,3,0)→(3,3,0) is down?" answered for EVERY link.

Port of ``tpusim/faults/sweep.py``.  Two sweep grains, both deterministic:

* :func:`single_link_sweep` — analytic: for each undirected link of a
  topology, price a collective over the pod with that link dead
  (torus→mesh fallback + route-around come from the fault-aware ICI
  models) and report the inflation vs the healthy baseline.  Closed-form
  per scenario, so a v5p 4×4×4 torus (192 links) sweeps in milliseconds.
* :func:`trace_step_sweep` — end-to-end: replay a stored trace per
  scenario and report pod step-time (cycle) inflation.  Linear in trace
  replays, so callers cap scenarios (``max_scenarios``); scenario order
  is deterministic (sorted links).

Both fan out over :mod:`tpusim_torch.perf.pool` when ``workers`` is set,
and the trace sweep threads ONE shared
:class:`~tpusim_torch.perf.cache.ResultCache` through every per-link
driver, so the healthy-kernel class (modules whose price cannot depend on
a link — no collectives) is priced exactly once per sweep instead of once
per scenario.  Scenario rows merge in link order on every path, so
serial, parallel and cached sweeps emit byte-identical reports.

The CLI front end is ``python -m tpusim_torch faults``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.faults.schedule import FaultSchedule, load_fault_schedule
from tpusim_torch.ici.collectives import CollectiveModel
from tpusim_torch.ici.topology import Topology
from tpusim_torch.perf.pool import map_ordered, pool_context

__all__ = [
    "SweepRow",
    "SweepResult",
    "link_down_schedule",
    "single_link_sweep",
    "trace_step_sweep",
]


def link_down_schedule(topo: Topology, a: int, b: int) -> FaultSchedule:
    """A one-fault schedule killing the (undirected) link between chips
    ``a`` and ``b``, endpoints expressed as coordinates so the JSON form
    is human-readable."""
    return load_fault_schedule({
        "faults": [{
            "kind": "link_down",
            "src": list(topo.coords(a)),
            "dst": list(topo.coords(b)),
        }],
    })


@dataclass
class SweepRow:
    """One scenario's outcome."""

    link: tuple[tuple[int, ...], tuple[int, ...]]   # (src, dst) coords
    value: float                                    # seconds or cycles
    inflation: float                                # value / healthy value

    def label(self) -> str:
        s = ",".join(str(x) for x in self.link[0])
        d = ",".join(str(x) for x in self.link[1])
        return f"({s})->({d})"


@dataclass
class SweepResult:
    kind: str                   # "collective" | "trace"
    healthy: float              # baseline seconds (or cycles)
    unit: str                   # "s" | "cycles"
    rows: list[SweepRow] = field(default_factory=list)

    @property
    def worst(self) -> SweepRow | None:
        return max(self.rows, key=lambda r: r.inflation, default=None)

    def to_doc(self) -> dict:
        w = self.worst
        return {
            "sweep_kind": self.kind,
            "unit": self.unit,
            "healthy": self.healthy,
            "scenarios": len(self.rows),
            "worst_link": w.label() if w else None,
            "worst_inflation": w.inflation if w else None,
            "rows": [
                {"link": r.label(), self.unit: r.value,
                 "inflation": r.inflation}
                for r in self.rows
            ],
        }


def _analytic_link_worker(link: tuple[int, int]) -> float:
    """Price the sweep collective with one link dead (pool worker)."""
    topo, ici_cfg, info, payload_bytes = pool_context()
    a, b = link
    view = link_down_schedule(topo, a, b).bind(topo).view_at(0.0)
    model = CollectiveModel(topo.with_faults(view), ici_cfg)
    return model.seconds(info, payload_bytes)


def single_link_sweep(
    topo: Topology,
    ici_cfg,
    payload_bytes: float = 64 * 1024 * 1024,
    kind: str = "all-reduce",
    workers: int | None = None,
) -> SweepResult:
    """Price ``kind`` over the full pod once per dead link.  The healthy
    baseline uses the same analytic model on the same topology, so any
    inflation is purely the fault fallback (mesh bandwidth terms).
    ``workers`` fans the per-link scenarios over a process pool; rows
    merge in link order either way."""
    from tpusim_torch.ir import CollectiveInfo

    n = topo.num_chips
    info = CollectiveInfo(kind, replica_groups=(tuple(range(n)),))
    healthy = CollectiveModel(topo, ici_cfg).seconds(info, payload_bytes)
    result = SweepResult(kind="collective", healthy=healthy, unit="s")
    links = topo.undirected_links()
    seconds = map_ordered(
        _analytic_link_worker, links, workers=workers,
        context=(topo, ici_cfg, info, payload_bytes),
    )
    for (a, b), secs in zip(links, seconds):
        result.rows.append(SweepRow(
            link=(topo.coords(a), topo.coords(b)),
            value=secs,
            inflation=secs / healthy if healthy > 0 else float("inf"),
        ))
    return result


def _trace_link_worker(link: tuple[int, int]) -> float:
    """Replay the sweep trace with one link dead (pool worker).  Under
    fork the shared result cache arrives pre-warmed by the baseline
    replay, so only link-sensitive modules re-price."""
    from tpusim_torch.sim.driver import SimDriver

    pod, cfg, topo, cache = pool_context()
    a, b = link
    rep = SimDriver(
        cfg, topology=topo, faults=link_down_schedule(topo, a, b),
        result_cache=cache,
    ).run(pod)
    return rep.cycles


def trace_step_sweep(
    trace_path: str | Path | None,
    topo: Topology,
    arch: str | None = None,
    max_scenarios: int | None = 16,
    tuned: bool = True,
    workers: int | None = None,
    result_cache=None,
    pod=None,
    config=None,
) -> SweepResult:
    """Replay ``trace_path`` once healthy, then once per dead-link
    scenario, reporting pod step-time (cycles) inflation.  Scenarios
    beyond ``max_scenarios`` are dropped deterministically (sorted link
    order) — callers see the cap in the row count.

    The trace and config load ONCE; every replay (baseline included) runs
    on the same ``topo``, so the reported inflation isolates the fault
    effect.  One result cache (``result_cache``: a
    :class:`~tpusim_torch.perf.cache.ResultCache`, a disk dir, or None for
    a fresh in-memory cache) is shared by ALL replays: the baseline
    prices every module once, and per-link replays re-price only the
    modules whose key includes the faulted topology (those with
    collectives) — the healthy-kernel class is never re-priced.

    ``pod`` short-circuits the trace load with an already-parsed
    :class:`~tpusim_torch.ir.PodTrace`; ``config`` supplies an
    already-composed :class:`SimConfig` instead of the ``arch``/``tuned``
    composition."""
    from tpusim_torch.perf.cache import ResultCache, as_result_cache
    from tpusim_torch.sim.driver import SimDriver
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.trace.format import load_trace

    if pod is None:
        pod = load_trace(trace_path)
    if config is not None:
        cfg = config
    else:
        if arch is None:
            # same default as simulate_trace: the arch the trace was
            # captured on, via the named-preset route
            kind = str(pod.meta.get("device_kind", ""))
            if kind:
                from tpusim_torch.timing.arch import detect_arch

                arch = detect_arch(kind).name
        cfg = load_config(arch=arch, tuned=tuned)
    cache = as_result_cache(result_cache) or ResultCache()
    base = SimDriver(cfg, topology=topo, result_cache=cache).run(pod)
    healthy = base.cycles
    result = SweepResult(kind="trace", healthy=healthy, unit="cycles")
    links = topo.undirected_links()
    if max_scenarios is not None:
        links = links[:max_scenarios]
    cycles = map_ordered(
        _trace_link_worker, links, workers=workers,
        context=(pod, cfg, topo, cache),
    )
    for (a, b), cyc in zip(links, cycles):
        result.rows.append(SweepRow(
            link=(topo.coords(a), topo.coords(b)),
            value=cyc,
            inflation=cyc / healthy if healthy > 0 else float("inf"),
        ))
    return result

"""Pass orchestration: one entry point per artifact family + the
combined trace-dir analysis the CLI and the ``--validate`` pre-flight
share.

The combined run mirrors exactly what ``simulate`` would do — same
arch-from-meta defaulting, same overlay composition, same topology
derivation — so a clean lint means the driver sees the same artifacts
the analyzer blessed.

Port of ``tpusim/analysis/runner.py``.
"""

from __future__ import annotations

from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics
from tpusim_torch.analysis.config_passes import run_config_passes
from tpusim_torch.analysis.memory_passes import run_memory_passes
from tpusim_torch.analysis.schedule_passes import run_schedule_passes
from tpusim_torch.analysis.selfaudit import run_selfaudit_passes
from tpusim_torch.analysis.statskeys import run_statskey_passes
from tpusim_torch.analysis.trace_passes import (
    load_parsed_trace,
    run_trace_passes,
)

__all__ = [
    "ValidationError",
    "analyze_trace_dir",
    "analyze_config",
    "analyze_schedule",
    "analyze_self_audit",
    "analyze_stats_keys",
]


class ValidationError(ValueError):
    """A ``--validate`` pre-flight refused to price the trace.

    Carries the full :class:`Diagnostics` so callers can render or
    serialize every finding, not just the first."""

    def __init__(self, diags: Diagnostics, strict: bool = False):
        self.diags = diags
        gate = "error-or-warning" if strict else "error"
        lines = "\n".join(
            f"  {line}" for line in diags.text_lines()
        )
        super().__init__(
            f"static analysis found {diags.summary()} "
            f"({gate}-level diagnostics refuse the replay; see "
            f"'tpusim lint'):\n{lines}"
        )


def analyze_config(
    cfg, diags: Diagnostics | None = None,
    trace_meta: dict | None = None, file: str | None = None,
) -> Diagnostics:
    """Config passes over a composed :class:`SimConfig`."""
    diags = diags if diags is not None else Diagnostics()
    run_config_passes(cfg, diags, trace_meta=trace_meta, file=file)
    return diags


def analyze_schedule(
    schedule_src, topo, diags: Diagnostics | None = None,
    file: str | None = None,
) -> Diagnostics:
    """Schedule passes over one fault schedule + declared topology."""
    diags = diags if diags is not None else Diagnostics()
    run_schedule_passes(schedule_src, topo, diags, file=file)
    return diags


def analyze_stats_keys(
    diags: Diagnostics | None = None,
    root: str | Path | None = None,
    schema_path: str | Path | None = None,
    package: str = "tpusim_torch",
) -> Diagnostics:
    """Stats-key contract audit over ``package``'s sources in the repo
    (``lint --stats-keys``)."""
    diags = diags if diags is not None else Diagnostics()
    run_statskey_passes(diags, root=root, schema_path=schema_path,
                        package=package)
    return diags


def analyze_self_audit(
    diags: Diagnostics | None = None,
    root: str | Path | None = None,
    package: str = "tpusim_torch",
) -> Diagnostics:
    """TL35x determinism/durability self-audit over ``package``'s
    sources in the repo (``lint --self-audit``; the ``--dataflow-smoke``
    contract gates on it)."""
    diags = diags if diags is not None else Diagnostics()
    run_selfaudit_passes(diags, root=root, package=package)
    return diags


def analyze_trace_dir(
    trace_path: str | Path,
    arch: str | None = None,
    overlays: list | None = None,
    faults=None,
    tuned: bool = True,
    config=None,
    topology=None,
    lenient: bool = True,
    diags: Diagnostics | None = None,
    perf: bool = False,
    perf_report: list | None = None,
) -> Diagnostics:
    """The combined pre-flight: trace passes + config passes (composed
    the way ``simulate`` would) + schedule passes when ``faults`` is
    given.  Mirrors :func:`tpusim_torch.sim.driver.simulate_trace`'s
    resolution EXACTLY — same arch-from-meta defaulting, same
    base-``config`` + ``arch`` + ``overlays`` composition, same
    explicit-``topology`` override for fault binding — so lint and
    replay agree on what runs.  ``lenient`` mirrors the replay's parse
    mode (see :func:`run_trace_passes`); the advisory ``lint``
    default treats salvage damage as a warning."""
    from tpusim_torch.timing.config import load_config

    diags = diags if diags is not None else Diagnostics()
    pt = load_parsed_trace(trace_path)
    run_trace_passes(pt, diags, lenient=lenient)

    if arch is None and config is None:
        kind = str(pt.meta.get("device_kind", "") or "")
        if kind:
            from tpusim_torch.timing.arch import detect_arch

            arch = detect_arch(kind).name
    try:
        cfg = load_config(
            config, arch=arch, overlays=overlays, tuned=tuned,
        )
    except (KeyError, ValueError, FileNotFoundError) as e:
        diags.emit("TL107", f"config does not compose: {e}")
        return diags
    run_config_passes(cfg, diags, trace_meta=pt.meta)
    # TL40x: the dataflow liveness summaries the trace passes just
    # built, judged against the composed arch's HBM/vmem capacities
    run_memory_passes(pt, cfg, diags)
    if perf or perf_report is not None:
        # TL50x: critical path / exposed communication, priced with the
        # exact composed config the engine would use (opt-in: pricing
        # every op costs real time on big traces)
        from tpusim_torch.analysis.perf_passes import run_perf_passes

        run_perf_passes(
            pt, cfg, diags, report=perf_report, topology=topology,
        )

    if faults is not None:
        from tpusim_torch.ici.topology import torus_for

        # the driver binds faults against its explicit topology when
        # given, else the torus it derives for the replayed pod —
        # validate against the same one
        topo = topology if topology is not None else torus_for(
            pt.replay_devices, cfg.arch.name
        )
        file = (
            str(faults) if isinstance(faults, (str, Path)) and
            Path(str(faults)).suffix == ".json" else None
        )
        run_schedule_passes(faults, topo, diags, file=file)
    return diags

"""Experiment runner — the rebuild of ``util/job_launching/
run_simulations.py`` + ``job_status.py`` + ``monitor_func_test.py``.

Port of ``tpusim/harness/runner.py``.

The reference fabricates a run directory per (benchmark, config): symlinked
traces, concatenated config overlays, then submits jobs
(``ConfigurationSpec.run``, ``run_simulations.py:83-168``; config append
``:303-328``), polls their status (``job_status.py``), and fails loudly on
logs missing the exit sentinel (``monitor_func_test.py:66-75``).  Ours does
the same with typed pieces: a suite×config matrix from
:mod:`tpusim_torch.harness.suites`, a run dir per cell with a composed
``sim.config`` flag file, ``python -m tpusim_torch simulate`` jobs through
:class:`tpusim_torch.harness.procman.ProcMan` (capture jobs first for missing
traces), a live status monitor, and scraping via
:mod:`tpusim_torch.harness.scrape`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from tpusim_torch.harness.procman import ProcMan
from tpusim_torch.harness.scrape import scrape_run_dirs, write_csv
from tpusim_torch.perf.pool import env_workers

__all__ = ["RunSpec", "run_experiments", "run_suite", "overlay_to_flag_lines"]


@dataclass
class RunSpec:
    """One (trace, config) cell of the experiment matrix."""

    trace: Path
    arch: str = "v5p"
    overlays: list[str] = field(default_factory=list)   # flag-file lines
    name: str | None = None
    power: bool = False
    obs: bool = False           # per-run obs exports under <run_dir>/obs/
    #: shared engine-result cache dir for the simulate job (tpusim_torch.perf);
    #: repeat cells (re-runs, retries) skip their module pricing through it
    result_cache: str | None = None

    @property
    def run_name(self) -> str:
        base = self.name or Path(self.trace).name
        return f"{base}__{self.arch}"


def overlay_to_flag_lines(d: dict[str, Any], prefix: str = "") -> list[str]:
    """Flatten a nested overlay dict into reference-style ``-key value``
    flag lines (dotted paths reach nested configs)."""
    lines: list[str] = []
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            lines.extend(overlay_to_flag_lines(v, prefix=f"{key}."))
        else:
            lines.append(f"-{key} {json.dumps(v)}")
    return lines


def _fabricate_run_dir(root: Path, spec: RunSpec) -> Path:
    """Create the run dir: trace symlink + composed sim.config overlay —
    the ``setup_run_directory``/``append_gpgpusim_config`` step."""
    run_dir = root / spec.run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    link = run_dir / "trace"
    if link.is_symlink() or link.exists():
        link.unlink()
    os.symlink(Path(spec.trace).resolve(), link)
    cfg = run_dir / "sim.config"
    with open(cfg, "w") as f:
        f.write(f"# composed by tpusim runner for {spec.run_name}\n")
        for line in spec.overlays:
            f.write(line.rstrip() + "\n")
    return run_dir


def _monitor_printer(interval_s: float):
    """Periodic status line — the ``job_status.py`` polling loop."""
    last = [0.0]

    def on_tick(pm: ProcMan) -> None:
        now = time.time()
        if now - last[0] < interval_s:
            return
        last[0] = now
        s = pm.status_summary()
        running = [
            f"{Path(j.log_path or str(j.job_id)).parent.name}"
            f"({now - (j.started_at or now):.0f}s)"
            for j in pm.jobs if j.status == "running"
        ]
        print(
            f"tpusim run: {s.get('done', 0)} done, "
            f"{s.get('failed', 0)} failed, {s.get('running', 0)} running, "
            f"{s.get('pending', 0)} pending"
            + (f"  [{', '.join(running[:6])}]" if running else ""),
            flush=True,
        )

    return on_tick


def run_experiments(
    specs: list[RunSpec],
    out_root: str | Path,
    parallel: int | None = None,
    timeout_s: float | None = 1800,
    monitor_interval_s: float | None = None,
    csv_path: str | Path | None = None,
    retries: int = 1,
    backoff_s: float = 0.5,
) -> dict[str, dict[str, object]]:
    """Fabricate run dirs, execute all cells, monitor, scrape results.
    Returns run-name → stats (plus '__failed__' listing); also writes
    ``jobs.json`` (status DB, including per-job attempt counts),
    ``failures.json`` (sentinel audit) and optionally a stats CSV.

    ``retries``: extra attempts per failed job (exponential backoff with
    jitter via :class:`~tpusim_torch.harness.procman.ProcMan`); the default of
    one resubmission absorbs transient box flake without masking a
    deterministic simulator failure for long.

    ``parallel=None`` honors ``$TPUSIM_WORKERS`` before ProcMan's
    half-the-cores default.  When the job matrix itself runs parallel,
    every submitted simulate gets ``--workers 1``: the children inherit
    the env var, and N matrix jobs each forking N pricing workers would
    compound to N*N processes — the matrix IS the parallelism here."""
    out_root = Path(out_root)
    pm = ProcMan(parallel=parallel if parallel is not None else env_workers())
    matrix_parallel = (pm.parallel or 1) > 1
    for spec in specs:
        run_dir = _fabricate_run_dir(out_root, spec)
        cmd = [
            sys.executable, "-m", "tpusim_torch", "simulate",
            str(run_dir / "trace"),
            "--arch", spec.arch,
            "--config", str(run_dir / "sim.config"),
            "--json", str(run_dir / "run.stats.json"),
        ]
        if spec.power:
            cmd.append("--power")
        if spec.obs:
            # per-run time series + prometheus text land beside the log,
            # scrapeable like the stats JSON
            cmd += ["--obs-out", str(run_dir / "obs")]
        if spec.result_cache:
            cmd += ["--result-cache", spec.result_cache]
        if matrix_parallel:
            cmd += ["--workers", "1"]
        pm.submit(
            cmd, log_path=run_dir / "run.log",
            retries=retries, backoff_s=backoff_s,
        )
    on_tick = _monitor_printer(monitor_interval_s) if monitor_interval_s \
        else None
    pm.run(timeout_s=timeout_s, on_tick=on_tick)
    pm.dump_state(out_root / "jobs.json")
    rows = scrape_run_dirs(out_root, "**/run.log")

    # sentinel audit — a job that exited 0 but never printed the exit
    # sentinel is still a failure (monitor_func_test.py:66-75); attempt
    # counts ride both the audit and the scraped rows so downstream
    # tooling sees how hard each result was to get
    failures = []
    for j in pm.jobs:
        log = Path(j.log_path) if j.log_path else None
        ok_log = log is not None and log.exists() and (
            "TPUSIM: *** exit detected ***" in log.read_text()
        )
        if j.status != "done" or not ok_log:
            failures.append({
                "job_id": j.job_id, "status": j.status,
                "returncode": j.returncode, "log": j.log_path,
                "sentinel": bool(ok_log),
                "attempts": j.attempts,
            })
        elif j.retried and log is not None:
            try:
                key = str(log.relative_to(out_root))
            except ValueError:
                key = log.name
            if key in rows:
                rows[key]["job_attempts"] = j.attempts
    summary = pm.status_summary()
    (out_root / "failures.json").write_text(json.dumps(failures, indent=2))
    if summary.get("retries"):
        (out_root / "retries.json").write_text(json.dumps({
            "retry_total": summary["retries"],
            "jobs_retried": sum(1 for j in pm.jobs if j.retried),
        }, indent=2))
    if csv_path:
        write_csv(rows, csv_path)
    return rows


def run_suite(
    suite: str,
    configs: list[str],
    out_root: str | Path,
    *,
    trace_root: str | Path | None = None,
    yaml_path: str | Path | None = None,
    capture_missing: bool = False,
    parallel: int | None = None,
    power: bool = False,
    obs: bool = False,
    timeout_s: float | None = 1800,
    monitor_interval_s: float | None = 10.0,
    retries: int = 1,
    capture_retries: int = 2,
    result_cache: str | Path | None = None,
) -> dict[str, dict[str, object]]:
    """The ``tpusim_torch run -B suite -C v5p,v5e`` flow: resolve the suite,
    locate (or capture) each workload's trace, fabricate the suite×config
    matrix, run with monitoring, and emit ``stats.csv``.

    ``configs`` items are ``arch`` or ``arch+named`` where ``named`` is a
    config from the YAML ``configs:`` section.  Capture jobs run against
    a live (flaky) backend — ``python -m tpusim_torch capture`` runs a
    workload on the card by default — and default to more resubmissions
    (``capture_retries``) than the deterministic simulate jobs
    (``retries``).  ``result_cache`` names a shared on-disk engine-result
    cache dir every simulate cell mounts (``--result-cache``): repeat
    cells — re-runs, retries after flake, unchanged (trace, config)
    pairs across invocations — skip their module pricing entirely."""
    from tpusim_torch.harness.suites import load_named_configs, load_suite

    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    entries = load_suite(suite, yaml_path)
    named = load_named_configs(yaml_path)

    trace_root = Path(trace_root) if trace_root else out_root / "traces"
    trace_root.mkdir(parents=True, exist_ok=True)

    # phase 1: capture jobs for missing traces (needs a live backend)
    missing = [
        e for e in entries if not (trace_root / e.run_name).is_dir()
    ]
    if missing:
        if not capture_missing:
            raise FileNotFoundError(
                f"no trace for {[e.run_name for e in missing]} under "
                f"{trace_root}; pass capture_missing=True (CLI: --capture) "
                f"or pre-capture with 'tpusim_torch capture'"
            )
        cap_pm = ProcMan(parallel=parallel)
        for e in missing:
            cmd = [
                sys.executable, "-m", "tpusim_torch", "capture", e.workload,
                str(trace_root / e.run_name),
                "--launches", str(e.launches),
            ]
            for k, v in e.params.items():
                cmd += ["--set", f"{k}={v}"]
            cap_pm.submit(
                cmd, log_path=trace_root / f"{e.run_name}.capture.log",
                retries=capture_retries,
            )
        on_tick = _monitor_printer(monitor_interval_s) \
            if monitor_interval_s else None
        if not cap_pm.run(timeout_s=timeout_s, on_tick=on_tick):
            bad = [
                f"{j.log_path} (attempts={j.attempts})"
                for j in cap_pm.jobs if j.status != "done"
            ]
            raise RuntimeError(f"capture phase failed: {bad}")
        cap_pm.dump_state(trace_root / "capture_jobs.json")

    # phase 2: the simulation matrix
    specs: list[RunSpec] = []
    for e in entries:
        for c in configs:
            arch, _, extra = c.partition("+")
            lines: list[str] = []
            if extra:
                if extra not in named:
                    raise KeyError(
                        f"unknown named config {extra!r}; yaml has "
                        f"{sorted(named)}"
                    )
                lines = overlay_to_flag_lines(named[extra])
            specs.append(RunSpec(
                trace=trace_root / e.run_name,
                arch=arch,
                overlays=lines,
                name=f"{e.run_name}__{extra}" if extra else e.run_name,
                power=power,
                obs=obs,
                result_cache=str(result_cache) if result_cache else None,
            ))
    return run_experiments(
        specs, out_root, parallel=parallel, timeout_s=timeout_s,
        monitor_interval_s=monitor_interval_s,
        csv_path=out_root / "stats.csv",
        retries=retries,
    )

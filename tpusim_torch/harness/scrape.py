"""Stat scraping — the rebuild of ``util/job_launching/get_stats.py``.

Port of ``tpusim/harness/scrape.py``.

The reference scrapes simulator stdout with YAML-configured regexes and
declares a run successful only when the log contains
``GPGPU-Sim: *** exit detected ***`` (``get_stats.py:224-246``).  We keep
the exact same contract: logs are scanned for ``tpusim_<name> = <value>``
lines, gated on :data:`tpusim_torch.sim.stats.EXIT_SENTINEL`, and emitted as
rows — plus the structured-JSON fast path when a ``--json`` stats file is
present next to the log.
"""

from __future__ import annotations

import csv
import json
import math
import re
from pathlib import Path
from typing import Iterable

from tpusim_torch.sim.stats import EXIT_SENTINEL, STAT_PREFIX

__all__ = ["scrape_log", "scrape_run_dirs", "write_csv", "diff_stats"]

_STAT_RE = re.compile(
    rf"^{re.escape(STAT_PREFIX)}(?P<name>[\w.]+)\s*=\s*(?P<value>\S+)\s*$"
)


def scrape_log(path: str | Path) -> dict[str, object] | None:
    """Parse one run log.  Returns None if the run did not complete (no
    exit sentinel — the reference's failure criterion)."""
    path = Path(path)
    if not path.exists():
        return None
    text = path.read_text(errors="replace")
    if EXIT_SENTINEL not in text:
        return None

    # structured fast path: a stats JSON written alongside
    sidecar = path.with_suffix(".stats.json")
    if sidecar.exists():
        try:
            return json.loads(sidecar.read_text())
        except json.JSONDecodeError:
            pass

    stats: dict[str, object] = {}
    for line in text.splitlines():
        m = _STAT_RE.match(line.strip())
        if not m:
            continue
        raw = m.group("value")
        try:
            val: object = int(raw)
        except ValueError:
            try:
                val = float(raw)
            except ValueError:
                val = raw
        stats[m.group("name")] = val
    return stats


def scrape_run_dirs(
    root: str | Path, pattern: str = "**/*.log"
) -> dict[str, dict[str, object]]:
    """Scrape every log under ``root``; key = path relative to root.
    Failed runs (no sentinel) appear with value None-filtered out but are
    reported in the '__failed__' list."""
    root = Path(root)
    out: dict[str, dict[str, object]] = {}
    failed: list[str] = []
    for log in sorted(root.glob(pattern)):
        rel = str(log.relative_to(root))
        stats = scrape_log(log)
        if stats is None:
            failed.append(rel)
        else:
            out[rel] = stats
    if failed:
        out["__failed__"] = {"runs": failed}  # type: ignore[assignment]
    return out


def write_csv(
    rows: dict[str, dict[str, object]], path: str | Path,
    columns: Iterable[str] | None = None,
) -> None:
    rows = {k: v for k, v in rows.items() if k != "__failed__"}
    if not rows:
        Path(path).write_text("")
        return
    if columns is None:
        cols: list[str] = []
        for stats in rows.values():
            for k in stats:
                if k not in cols:
                    cols.append(k)
    else:
        cols = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run"] + cols)
        for run, stats in sorted(rows.items()):
            w.writerow([run] + [stats.get(c, "") for c in cols])


def diff_stats(
    old: dict[str, dict[str, object]],
    new: dict[str, dict[str, object]],
    rel_tol: float = 0.0,
) -> dict[str, dict[str, tuple]]:
    """Per-run, per-stat differences between two scraped stat sets — the
    compare role of the reference's ``util/plotting/merge-stats.py``
    (two builds / two configs over the same app list).

    Returns ``{run: {stat: (old, new)}}`` for every run present in both
    sets where a stat differs beyond ``rel_tol`` (numeric) or at all
    (non-numeric); runs present on only one side appear under
    ``"__only_old__"`` / ``"__only_new__"``."""
    out: dict[str, dict[str, tuple]] = {}
    old = {k: v for k, v in old.items() if k != "__failed__"}
    new = {k: v for k, v in new.items() if k != "__failed__"}
    only_old = sorted(set(old) - set(new))
    only_new = sorted(set(new) - set(old))
    if only_old:
        out["__only_old__"] = {r: ((), ()) for r in only_old}
    if only_new:
        out["__only_new__"] = {r: ((), ()) for r in only_new}
    for run in sorted(set(old) & set(new)):
        diffs: dict[str, tuple] = {}
        for stat in sorted(set(old[run]) | set(new[run])):
            a, b = old[run].get(stat), new[run].get(stat)
            if a == b:
                continue
            if isinstance(a, float) and isinstance(b, float) and (
                math.isnan(a) and math.isnan(b)
            ):
                continue  # two NaNs are the same (non-)measurement
            if (
                isinstance(a, (int, float)) and isinstance(b, (int, float))
                and rel_tol > 0
            ):
                denom = max(abs(a), abs(b), 1e-12)
                if abs(a - b) / denom <= rel_tol:
                    continue
            diffs[stat] = (a, b)
        if diffs:
            out[run] = diffs
    return out

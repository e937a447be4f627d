"""Replay-based parameter refinement.

Port of ``tpusim/harness/refine.py``.

The reference's tuner feeds microbenchmark-derived numbers straight into
``gpgpusim.config`` (``util/tuner/tuner.py:23-67``) and relies on the
published correlation runs to catch a bad fit (``Jenkinsfile:83-97``).
Round 4 showed why that isn't enough here: each microbench fits one knob
in isolation, but the replayed workloads couple them (lowering the clock
re-balances every compute/memory roofline), and a jointly-worse overlay
shipped — caught only by bench's self-validation, which then had nothing
better to do than reject it.

``refine()`` closes the loop the other way: starting from a config (the
preset, or the microbench fit), coordinate-descent over the cost-model
knobs minimizing the mean |error| of the committed silicon fixtures'
replay.  Every accepted step is a measured improvement of the very
number bench reports, so the emitted overlay can never regress the
preset it started from.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

__all__ = [
    "RefineResult", "KNOBS", "refine", "refine_arch_on_fixtures",
    "load_per_op_rows", "leave_one_out", "replay_errors_with_values",
    "split_held_out",
]


def split_held_out(
    entries: list[dict],
    per_op_rows: dict[str, list[dict]] | None = None,
) -> tuple[list[dict], dict[str, list[dict]], list[dict]]:
    """(train_entries, train_per_op_rows, held_out_entries).

    THE one place that enforces the out-of-sample invariant: manifest
    entries flagged ``held_out`` (the full-model validation workloads,
    VERDICT r4 #2) never reach a fit — neither their totals nor their
    per-op device rows."""
    train = [e for e in entries if not e.get("held_out")]
    held = [e for e in entries if e.get("held_out")]
    names = {e.get("name", e.get("trace", "?")) for e in train}
    rows = {
        k: v for k, v in (per_op_rows or {}).items() if k in names
    }
    return train, rows, held


def load_per_op_rows(artifact_path: str | Path) -> dict[str, list[dict]]:
    """Matched per-op rows of a committed ``correl_ops.json``, keyed by
    workload — the device-duration targets for the joint objective.
    Missing/corrupt artifact → {} (the refiner falls back to e2e-only)."""
    import json

    p = Path(artifact_path)
    if not p.is_file():
        return {}
    try:
        doc = json.loads(p.read_text())
    except (ValueError, OSError):
        return {}
    out: dict[str, list[dict]] = {}
    for w in doc.get("workloads", []):
        rows = w.get("rows")
        if isinstance(rows, list) and rows:
            out[str(w.get("workload"))] = rows
    return out

#: knob name -> (bounds lo, hi).  Names are ArchConfig fields; values
#: outside the bounds are physically implausible and rejected even if
#: they fit better (a 0.99 "HBM efficiency" would be curve-fitting the
#: fixture noise, not modeling hardware).
KNOBS: dict[str, tuple[float, float]] = {
    "clock_ghz": (1.2, 1.9),
    "hbm_efficiency": (0.6, 0.95),
    "vpu_transcendental_per_cycle": (256, 1024),
    "vpu_reduce_slowdown": (4.0, 16.0),
    "vpu_lane_cross_cycles": (0.1, 2.0),
    "gather_row_overhead_cycles": (4, 64),
    "dma_issue_latency": (0.2e-6, 4e-6),
    "relayout_efficiency": (0.2, 0.9),
    "relayout_lane_efficiency": (0.3, 0.95),
    "small_kernel_floor_cycles": (100, 2000),
    "vmem_copy_efficiency": (0.1, 0.9),
    "vmem_slice_efficiency": (0.2, 0.9),
    "mxu_conv_tap_efficiency": (0.5, 1.0),
    "mxu_weight_stall_cycles": (16, 256),
    "mxu_fill_cycles": (32, 512),
    "mxu_efficiency": (0.6, 1.0),
    "op_overhead_cycles": (1, 200),
}

#: integer-valued ArchConfig fields among the knobs
_INT_KNOBS = frozenset({
    "gather_row_overhead_cycles", "mxu_weight_stall_cycles",
    "mxu_fill_cycles", "op_overhead_cycles",
    "small_kernel_floor_cycles",
})


@dataclass
class RefineResult:
    start_err_pct: float
    final_err_pct: float
    values: dict[str, float] = field(default_factory=dict)
    #: knobs whose refined value differs from the starting config
    changed: dict[str, float] = field(default_factory=dict)
    sweeps: int = 0
    evals: int = 0
    #: fixtures actually replayed vs offered — a corrupt trace silently
    #: shrinking the training set must be visible in the result
    replayed: int = 0
    total: int = 0
    skipped: list[str] = field(default_factory=list)
    #: objective decomposition at the final vector, when the joint
    #: per-op objective is active: end-to-end mean |err|, sync per-op
    #: weighted mean |err|, async exposure-aggregate mean |err|
    parts: dict[str, float] = field(default_factory=dict)

    def overlay_lines(self, device_kind: str = "") -> list[str]:
        lines = [
            "# tpusim replay-refined fit"
            + (f" for {device_kind}" if device_kind else ""),
            f"# fixture replay objective: {self.start_err_pct:.2f} -> "
            f"{self.final_err_pct:.2f}",
        ]
        if self.parts:
            lines.append(
                "# parts: " + ", ".join(
                    f"{k}={v:.2f}" for k, v in sorted(self.parts.items())
                )
            )
        for name, val in sorted(self.values.items()):
            if name in _INT_KNOBS:
                lines.append(f"-arch.{name} {round(val)}")
            else:
                lines.append(f"-arch.{name} {val:.4g}")
        return lines


def refine_arch_on_fixtures(
    arch_name: str,
    entries: list[dict],
    fixture_dir: str | Path,
    *,
    base_overlays: list | None = None,
    max_sweeps: int = 6,
    per_op_rows: dict[str, list[dict]] | None = None,
    per_op_weight: float = 0.5,
    async_weight: float = 0.0,
    anchor_weight: float = 0.0,
) -> RefineResult:
    """Refine the cost-model knobs of ``arch_name`` against a silicon
    fixture set (manifest ``entries`` + trace dirs under ``fixture_dir``).

    Starts from the preset composed with ``base_overlays`` (pass the
    microbench-fit overlay so physically-measured values seed the
    search).  Pure replay — no jax, no device.

    With ``per_op_rows`` (workload name -> the matched rows of a per-op
    correlation artifact, carrying measured ``real_ns``/``real_count``),
    the objective becomes JOINT:

        mean_e2e + per_op_weight * mean_sync_per_op
                 + async_weight  * mean_async_exposure

    Ten end-to-end totals cannot constrain fifteen knobs — the ~120
    matched per-op device durations can (VERDICT r4 #3); the reference
    correlates per-kernel, not per-app, for the same reason
    (``util/plotting/correl_mappings.py:21-100``).  The async term uses
    the exposure AGGREGATE per workload; it defaults to weight 0 —
    measured device async-start durations span issue→completion
    including dependency waits (embedding's copy-start reads 408µs for a
    ~1µs issue), so the aggregate carries a large constant residual that
    would otherwise dominate the descent and trade away sync accuracy
    (observed: e2e 1.19%→3.24% when weighted 0.25).

    ``anchor_weight`` adds a quadratic penalty on relative drift from
    the starting values — the knobs are physical quantities with
    measured/published priors, and unconstrained descent happily drifts
    them 30% for a 0.01-point objective gain, which is how the
    leave-one-out error ends up double the training error.  The penalty
    is ``anchor_weight * 100 * mean_k((v_k - v0_k)/v0_k)^2`` (so a 10%
    mean drift costs ``anchor_weight`` points)."""
    from tpusim_torch.harness.correl_ops import (
        correlate_ops, silicon_from_artifact_rows,
    )
    from tpusim_torch.perf.cache import CachedEngine, ResultCache
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.config import overlay as cfg_overlay
    from tpusim_torch.trace.format import load_trace, select_module

    base_cfg = load_config(
        arch=arch_name, tuned=False, overlays=base_overlays or [],
    )
    # coordinate descent revisits candidate vectors (neighbor probes
    # across sweeps, the final re-score of the winner): one in-memory
    # result cache across evals makes every repeat free without changing
    # a single objective value (tpusim_torch.perf; keys include the full
    # composed config, so distinct candidates can never collide)
    result_cache = ResultCache()
    mods = []
    skipped: list[str] = []
    for e in entries:
        # identical selection policy to bench's replay_fixture_errors: a
        # workload the validation would drop must not steer the fit either
        try:
            td = load_trace(Path(fixture_dir) / e["trace"])
            mods.append((e, select_module(td, e.get("module"))))
        except Exception as exc:
            name = e.get("name", e.get("trace", "?"))
            skipped.append(f"{name}: {type(exc).__name__}: {exc}")
            print(
                f"refine: skipping fixture {name} "
                f"({type(exc).__name__}: {exc})", file=sys.stderr,
            )

    base_values = {k: getattr(base_cfg.arch, k) for k in KNOBS}
    silicon_by_name = {
        name: silicon_from_artifact_rows(rows)
        for name, rows in (per_op_rows or {}).items()
    }

    def score(vec: dict[str, float]) -> tuple[float, dict[str, float]]:
        updates = {
            k: (round(v) if k in _INT_KNOBS else v) for k, v in vec.items()
        }
        cfg = cfg_overlay(base_cfg, {"arch": updates})
        eng = CachedEngine(cfg, result_cache=result_cache)
        e2e, perop, asyn = [], [], []
        for e, mod in mods:
            try:
                res = eng.run(mod)
            except Exception:
                return math.inf, {}
            real = float(e["real_seconds"])
            if real <= 0:
                continue
            sim = res.seconds / float(e.get("n_steps", 1))
            e2e.append(abs(100.0 * (sim - real) / real))
            wname = e.get("name", e.get("trace", "?"))
            silicon = silicon_by_name.get(wname)
            if silicon:
                corr = correlate_ops(
                    res, silicon, clock_hz=cfg.arch.clock_hz,
                    workload=wname, real_iters=1,
                )
                s = corr.sync_weighted_abs_error_pct
                if math.isfinite(s):
                    perop.append(s)
                agg = corr.async_aggregate()
                if agg is not None:
                    asyn.append(abs(agg["error_pct"]))
        if not e2e:
            return math.inf, {}
        parts = {"e2e_err_pct": sum(e2e) / len(e2e)}
        obj = parts["e2e_err_pct"]
        if perop:
            parts["per_op_sync_err_pct"] = sum(perop) / len(perop)
            obj += per_op_weight * parts["per_op_sync_err_pct"]
        if asyn:
            parts["async_exposure_err_pct"] = sum(asyn) / len(asyn)
            obj += async_weight * parts["async_exposure_err_pct"]
        if anchor_weight > 0:
            drifts = [
                ((v - base_values[k]) / base_values[k]) ** 2
                for k, v in vec.items()
                if base_values.get(k)
            ]
            if drifts:
                parts["anchor_drift"] = (
                    anchor_weight * 100.0 * sum(drifts) / len(drifts)
                )
                obj += parts["anchor_drift"]
        return obj, parts

    res = refine(base_values, lambda v: score(v)[0], max_sweeps=max_sweeps)
    res.replayed = len(mods)
    res.total = len(entries)
    res.skipped = skipped
    if silicon_by_name:
        _, res.parts = score(res.values)
        res.parts = {k: round(v, 3) for k, v in res.parts.items()}
    return res


def replay_errors_with_values(
    arch_name: str,
    entries: list[dict],
    fixture_dir: str | Path,
    values: dict[str, float],
    *,
    base_overlays: list | None = None,
) -> dict[str, float]:
    """Signed e2e replay error (%) per workload under an explicit knob
    vector — the held-out scoring half of leave-one-out."""
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.config import overlay as cfg_overlay
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.trace.format import load_trace, select_module

    base_cfg = load_config(
        arch=arch_name, tuned=False, overlays=base_overlays or [],
    )
    updates = {
        k: (round(v) if k in _INT_KNOBS else v) for k, v in values.items()
    }
    eng = Engine(cfg_overlay(base_cfg, {"arch": updates}))
    out: dict[str, float] = {}
    for e in entries:
        name = e.get("name", e.get("trace", "?"))
        try:
            td = load_trace(Path(fixture_dir) / e["trace"])
            mod = select_module(td, e.get("module"))
            res = eng.run(mod)
        except Exception:
            continue
        real = float(e["real_seconds"])
        if real <= 0:
            continue
        sim = res.seconds / float(e.get("n_steps", 1))
        out[name] = 100.0 * (sim - real) / real
    return out


def leave_one_out(
    arch_name: str,
    entries: list[dict],
    fixture_dir: str | Path,
    *,
    per_op_rows: dict[str, list[dict]] | None = None,
    base_overlays: list | None = None,
    max_sweeps: int = 6,
    anchor_weight: float = 0.0,
) -> dict:
    """Leave-one-out validation of the refinement procedure: for each
    fixture workload, refit the knobs on the other N-1 (per-op rows for
    the held-out workload excluded too) and score the held-out replay
    error under that fit.

    The round-4 headline was in-sample — 15 knobs fit to the same 10
    totals the bench reports (VERDICT r4 Missing #2); the reference
    separates tuning (microbenches) from validation (applications)
    structurally (``util/tuner/tuner.py:23-67`` + correlation runs).
    Each fold seeds from the PRESET, never from the committed overlay —
    the committed overlay saw all ten workloads, so seeding from it
    would leak the held-out target into the fold."""
    folds = []
    held_errs = []
    for held in entries:
        held_name = held.get("name", held.get("trace", "?"))
        train = [e for e in entries if e is not held]
        rows = {
            k: v for k, v in (per_op_rows or {}).items() if k != held_name
        }
        rr = refine_arch_on_fixtures(
            arch_name, train, fixture_dir,
            base_overlays=base_overlays, per_op_rows=rows or None,
            max_sweeps=max_sweeps, anchor_weight=anchor_weight,
        )
        scored = replay_errors_with_values(
            arch_name, [held], fixture_dir, rr.values,
            base_overlays=base_overlays,
        )
        err = scored.get(held_name)
        folds.append({
            "workload": held_name,
            "held_out_err_pct": round(err, 3) if err is not None else None,
            "train_objective": round(rr.final_err_pct, 3),
            "train_parts": rr.parts,
            "evals": rr.evals,
        })
        if err is not None:
            held_errs.append(abs(err))
    from tpusim_torch.timing.model_version import model_version

    return {
        "arch": arch_name,
        "model_version": model_version(),
        "seed": "preset",
        "anchor_weight": anchor_weight,
        "mean_loo_abs_err_pct": round(
            sum(held_errs) / len(held_errs), 3
        ) if held_errs else None,
        "worst_loo_abs_err_pct": round(max(held_errs), 3)
        if held_errs else None,
        "folds": folds,
    }


def refine(
    base_values: dict[str, float],
    evaluate: Callable[[dict[str, float]], float],
    *,
    knobs: dict[str, tuple[float, float]] | None = None,
    max_sweeps: int = 6,
    rel_steps: tuple[float, ...] = (0.25, 0.1, 0.04),
    min_gain: float = 0.01,
) -> RefineResult:
    """Coordinate descent over ``knobs`` minimizing ``evaluate``.

    ``base_values`` holds the starting value of every knob (taken from
    the preset or a microbench fit).  ``evaluate`` maps a full knob
    vector to the objective (fixture-replay mean |error|, percent).
    Each sweep probes every knob at ±rel_step (shrinking steps across
    sweeps) and keeps strict improvements; stops early when a full sweep
    at the FINEST step improves by less than ``min_gain`` percentage
    points (a no-gain coarse sweep still advances to finer steps — a
    coarse probe overshooting a nearby optimum must not end the search)."""
    knobs = dict(knobs or KNOBS)
    cur = {k: float(base_values[k]) for k in knobs if k in base_values}
    evals = 0

    def _eval(vec: dict[str, float]) -> float:
        nonlocal evals
        evals += 1
        return evaluate(vec)

    best = _eval(cur)
    start = best
    sweeps = 0
    for sweep in range(max_sweeps):
        sweeps = sweep + 1
        sweep_start = best
        step = rel_steps[min(sweep, len(rel_steps) - 1)]
        for name in cur:
            lo, hi = knobs[name]
            for direction in (1.0 + step, 1.0 - step):
                cand = dict(cur)
                val = cur[name] * direction
                val = min(max(val, lo), hi)
                if name in _INT_KNOBS:
                    val = float(round(val))
                if val == cur[name]:
                    continue
                cand[name] = val
                err = _eval(cand)
                if err < best:
                    best, cur = err, cand
        if sweep_start - best < min_gain and step == rel_steps[-1]:
            break
    changed = {
        k: v for k, v in cur.items()
        if not math.isclose(v, float(base_values[k]), rel_tol=1e-9)
    }
    return RefineResult(
        start_err_pct=start,
        final_err_pct=best,
        values=cur,
        changed=changed,
        sweeps=sweeps,
        evals=evals,
    )

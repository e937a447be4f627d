"""Campaign distribution reports + the SLO capacity answer.

Turns journaled per-scenario outcome rows into the document the CLI
returns: per-slice step-time-inflation percentiles (p50/p95/p99/max),
the :class:`~tpusim_torch.faults.TopologyPartitionedError` rate, energy
deltas (joules per step vs the healthy baseline, joined from
:mod:`tpusim_torch.power.model`), and a slice-vs-SLO **capacity
table** — the smallest candidate pod shape whose step time still meets the SLO at
the target percentile under the sampled degradation.

Determinism contract: the document is a pure function of the outcome
rows (nearest-rank percentiles over sorted values, sorted-key JSON,
no wall-clock anywhere), so a fixed-seed campaign reproduces its report
byte-for-byte.  Means are ``sum(values) / len(values)`` as the reference
writes them: Python 3.12's ``sum`` of floats rounds differently from
earlier interpreters, so the same interpreter gives the same bytes.

SLO accounting: a partitioned or failed scenario has no step time — it
is treated as *unboundedly slow* for the SLO percentile (a pod shape
that partitions in 2% of sampled worlds cannot claim a p99), serialized
as ``null`` with ``meets: false``.

Port of ``tpusim/campaign/report.py``.
"""

from __future__ import annotations

import math

__all__ = ["REPORT_FORMAT_VERSION", "build_report", "percentile"]

REPORT_FORMAT_VERSION = 1


def percentile(values: list[float], pct: float) -> float | None:
    """Nearest-rank percentile (deterministic, no interpolation):
    the ceil(pct/100 * N)-th smallest value.  None on empty input."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


def _dist(values: list[float]) -> dict | None:
    if not values:
        return None
    return {
        "p50": percentile(values, 50.0),
        "p95": percentile(values, 95.0),
        "p99": percentile(values, 99.0),
        "max": max(values),
        "mean": sum(values) / len(values),
    }


def _slice_section(sl_doc: dict, rows: list[dict], slo) -> dict:
    """One slice's distribution block from its ordered outcome rows."""
    ok = [r for r in rows if r["status"] == "ok"]
    partitioned = sum(1 for r in rows if r["status"] == "partitioned")
    failed = sum(1 for r in rows if r["status"] == "failed")
    n = len(rows)
    out = {
        **sl_doc,
        "scenarios": n,
        "ok": len(ok),
        "partitioned": partitioned,
        "failed": failed,
        "partition_rate": partitioned / n if n else 0.0,
        "inflation": _dist([r["inflation"] for r in ok]),
        "step_ms": _dist([r["step_s"] * 1e3 for r in ok]),
        "energy_delta_j": _dist([
            r["energy_delta_j"] for r in ok
            if r.get("energy_delta_j") is not None
        ]),
        "watts": _dist([
            r["watts"] for r in ok if r.get("watts") is not None
        ]),
    }
    dcn_rows = [r["dcn"] for r in rows if "dcn" in r]
    if dcn_rows:
        # slice-survival distribution over the WHOLE sampled population
        # (rows carry "dcn" only when the spec configured a fabric, so
        # legacy reports keep their exact byte shape)
        loss = sum(1 for d in dcn_rows if d["slices_lost"] > 0)
        hist: dict[str, int] = {}
        for d in dcn_rows:
            k = str(d["slices_ok"])
            hist[k] = hist.get(k, 0) + 1
        out["dcn"] = {
            "slices": max(d["slices"] for d in dcn_rows),
            "slice_loss_scenarios": loss,
            "slice_loss_rate": loss / len(dcn_rows),
            "min_slices_ok": min(d["slices_ok"] for d in dcn_rows),
            "slices_ok_hist": {
                k: hist[k] for k in sorted(hist, key=int)
            },
        }
    if slo is not None:
        # the SLO percentile ranks over ALL scenarios; a scenario with
        # no step time (partition / hard failure) ranks as +inf
        step_ms = sorted(
            (r["step_s"] * 1e3 if r["status"] == "ok" else math.inf)
            for r in rows
        )
        at = percentile(step_ms, slo.percentile)
        finite = at is not None and math.isfinite(at)
        out["slo"] = {
            "step_time_ms": slo.step_time_ms,
            "percentile": slo.percentile,
            "step_ms_at_percentile": at if finite else None,
            "meets": bool(finite and at <= slo.step_time_ms),
        }
    return out


def build_report(
    *,
    spec,
    spec_digest: str,
    model_version: str,
    trace_name: str,
    slices: list[dict],
    rows_by_slice: dict[str, list[dict]],
) -> dict:
    """The campaign report document.

    ``slices`` carries one dict per priced slice (label/arch/chips +
    healthy baseline: cycles, step seconds, watts, energy); rows are the
    journaled scenario outcomes, keyed by slice label."""
    sections = []
    flat_rows: list[dict] = []
    for sl in slices:
        rows = sorted(
            rows_by_slice.get(sl["label"], ()), key=lambda r: r["index"]
        )
        sections.append(_slice_section(sl, rows, spec.slo))
        flat_rows.extend(rows)

    doc = {
        "format_version": REPORT_FORMAT_VERSION,
        "campaign": spec.name,
        "seed": spec.seed,
        "spec_hash": spec_digest,
        "model_version": model_version,
        "trace": trace_name,
        "scenarios_per_slice": spec.scenarios,
        "slices": sections,
        "rows": flat_rows,
    }
    if spec.slo is not None:
        # capacity answer: smallest CANDIDATE slice (fewest chips;
        # watts as the tiebreak) whose step time meets the SLO at the
        # percentile — the primary slice is the pod being modeled, not
        # an offered shape, so it informs the table but is never the
        # answer
        candidate_labels = {c.label for c in spec.candidates}
        meeting = [
            s for s in sections
            if s["label"] in candidate_labels
            and s.get("slo", {}).get("meets")
        ]
        best = min(
            meeting,
            key=lambda s: (s["chips"], s.get("healthy_watts") or 0.0),
            default=None,
        )
        doc["capacity"] = {
            "slo_step_time_ms": spec.slo.step_time_ms,
            "percentile": spec.slo.percentile,
            "smallest_meeting_slice": best["label"] if best else None,
            "table": [
                {
                    "slice": s["label"],
                    "chips": s["chips"],
                    "candidate": s["label"] in candidate_labels,
                    "healthy_watts": s.get("healthy_watts"),
                    "healthy_step_ms": (
                        s["healthy_step_s"] * 1e3
                        if s.get("healthy_step_s") is not None else None
                    ),
                    "step_ms_at_percentile":
                        s["slo"]["step_ms_at_percentile"],
                    "partition_rate": s["partition_rate"],
                    "meets": s["slo"]["meets"],
                }
                for s in sections
            ],
        }
    return doc

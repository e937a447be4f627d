"""Fleet report assembly — the capacity-planning document.

Turns the priced degradation timelines, the event-walk cell results,
and the recovery rows into the document the CLI returns: goodput/MFU/
p99-vs-offered-load curves, a pods-needed capacity frontier, energy per
served request (joined from :mod:`tpusim_torch.power.model` via the
priced rows), and the per-policy loss attribution (requests lost to
shedding vs deadline vs partition vs restart windows).

Determinism contract: the document is a pure function of the inputs
(nearest-rank percentiles via :func:`tpusim_torch.campaign.report.percentile`,
sorted-key JSON, no wall-clock anywhere), so a fixed-seed fleet run
reproduces its report byte-for-byte (in one interpreter: the mean is
``sum / len``, and Python 3.12's float ``sum`` rounds differently).

SLO accounting is the campaign discipline at request grain: a lost
request has no latency — it ranks as *unboundedly slow* for the SLO
percentile (a fleet shedding 2% of traffic cannot claim a p99),
serialized as ``null`` with ``meets: false``.

Port of ``tpusim/fleet/report.py``.
"""

from __future__ import annotations

import math

from tpusim_torch.campaign.report import percentile

__all__ = ["FLEET_REPORT_FORMAT_VERSION", "build_report"]

FLEET_REPORT_FORMAT_VERSION = 1


def _latency_dist(latencies_s: list[float]) -> dict | None:
    if not latencies_s:
        return None
    ms = [v * 1e3 for v in latencies_s]
    return {
        "p50": percentile(ms, 50.0),
        "p95": percentile(ms, 95.0),
        "p99": percentile(ms, 99.0),
        "max": max(ms),
        "mean": sum(ms) / len(ms),
    }


def _slo_block(cell: dict, slo) -> dict:
    """The SLO verdict for one cell: percentile over ALL dispatched
    requests, lost ones ranked +inf."""
    n_lost = cell["requests"] - cell["served"]
    ranked = sorted(v * 1e3 for v in cell["latencies_s"])
    ranked += [math.inf] * n_lost
    at = percentile(ranked, slo.percentile)
    finite = at is not None and math.isfinite(at)
    return {
        "latency_ms": slo.latency_ms,
        "percentile": slo.percentile,
        "latency_ms_at_percentile": at if finite else None,
        "meets": bool(finite and at <= slo.latency_ms),
    }


def _cell_row(
    rate: float, n_pods: int, cell: dict, horizon_s: float, slo,
) -> dict:
    served = cell["served"]
    requests = cell["requests"]
    row = {
        "offered_rps": rate,
        "pods": n_pods,
        "requests": requests,
        "served": served,
        "goodput_rps": served / horizon_s if horizon_s > 0 else 0.0,
        "mfu": cell["mfu"],
        "latency_ms": _latency_dist(cell["latencies_s"]),
        "energy_per_request_j": (
            cell["energy_j"] / served
            if cell["energy_j"] is not None and served else None
        ),
        "losses": cell["losses"],
        "loss_rate": (
            (requests - served) / requests if requests else 0.0
        ),
    }
    if slo is not None:
        row["slo"] = _slo_block(cell, slo)
    return row


def _timeline_doc(timeline) -> list[dict]:
    return [
        {
            "start_s": lo,
            "end_s": hi,
            "faults": len(docs),
            "signature": sig,
        }
        for lo, hi, sig, docs in timeline
    ]


def build_report(
    *,
    spec,
    spec_digest: str,
    model_version: str,
    trace_name: str,
    chips: int,
    healthy: dict,
    timelines,
    deaths_by_pod,
    curve_cells,
    frontier_cells,
    recovery,
) -> dict:
    """The fleet report document; see the module docstring.

    ``curve_cells`` is ``[(rate, n_pods, cell_result)]`` for the spec
    fleet; ``frontier_cells`` is ``[(target, [(target, n, cell), ...])]``
    per frontier target (the tried ladder, smallest-first)."""
    horizon = spec.horizon_s

    pods_doc = []
    for p, tl in enumerate(timelines):
        degraded = [
            iv for iv in tl if iv[3]
        ]
        pods_doc.append({
            "pod": p,
            "intervals": _timeline_doc(tl),
            "degraded_intervals": len(degraded),
            "degraded_seconds": sum(
                iv[1] - iv[0] for iv in degraded
            ),
            "deaths": [
                {"at_s": d, "back_s": end}
                for d, end in deaths_by_pod[p]
            ],
        })

    curve = [
        _cell_row(rate, n, cell, horizon, spec.slo)
        for rate, n, cell in curve_cells
    ]
    totals = {
        "requests": sum(r["requests"] for r in curve),
        "served": sum(r["served"] for r in curve),
        "losses": {
            k: sum(r["losses"][k] for r in curve)
            for k in ("deadline", "partition", "restart", "shed")
        },
    }

    doc = {
        "format_version": FLEET_REPORT_FORMAT_VERSION,
        "fleet": spec.name,
        "seed": spec.seed,
        "spec_hash": spec_digest,
        "model_version": model_version,
        "trace": trace_name,
        "pods": spec.pods,
        "arch": spec.arch,
        "chips": chips,
        "horizon_s": horizon,
        "policies": {
            "max_inflight": spec.policies.max_inflight,
            "queue_depth": spec.policies.queue_depth,
            "deadline_s": spec.policies.deadline_s,
            "restart_backoff_s": spec.policies.restart_backoff_s,
        },
        "healthy": {
            "step_ms": healthy["step_s"] * 1e3,
            "watts": healthy.get("watts"),
            "energy_per_step_j": healthy.get("energy_j"),
        },
        "degradation": pods_doc,
        "curve": curve,
        "recovery": recovery,
        "totals": totals,
    }
    if spec.frontier is not None:
        table = []
        for target, tried in frontier_cells:
            rows = [
                _cell_row(t, n, cell, horizon, spec.slo)
                for t, n, cell in tried
            ]
            meeting = next(
                (r for r in rows if r["slo"]["meets"]), None,
            )
            table.append({
                "target_rps": target,
                "pods_needed": meeting["pods"] if meeting else None,
                "cells": rows,
            })
        doc["frontier"] = {
            "slo_latency_ms": spec.slo.latency_ms,
            "percentile": spec.slo.percentile,
            "max_pods": spec.frontier.max_pods,
            "table": table,
        }
    return doc

"""The comparison that decides ``correct``: what the timed path produced
against the plain reference's answer, on the same weights and inputs.

The family names the numbers compared (``readings(out, ref)``, each an
error: larger is worse); a cell's limit file,
``benchmark/limits/<cell>.json``, holds each one's limit with the
readings it was set from.  For the decoder the number is
``logit_row_err``: over every row compared (a position of a sequence of a
compared step), the worst relative gap ``||program - reference|| /
||reference||`` of that row's logits.  A position left out, a token
altered or a batch row dropped sets a row near 1; a step computed in a
lower precision than the configuration states lifts every row.  A NaN
anywhere reads NaN, which fails every limit.
"""

from __future__ import annotations

import torch


def worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN (Python's ``max``
    would pass over a NaN)."""
    return float(torch.tensor(list(values), dtype=torch.float64).max())


@torch.no_grad()
def row_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst relative gap of a row of ``out`` from ``ref`` (float32
    logits, rows along the last axis)."""
    ref = ref.reshape(-1, ref.shape[-1])
    out = out.reshape(-1, out.shape[-1])
    gaps = []
    for lo in range(0, ref.shape[0], 1024):
        r = ref[lo:lo + 1024]
        gap = (out[lo:lo + 1024].float() - r).norm(dim=-1)
        gaps.append(float((gap / r.norm(dim=-1).clamp_min(1e-30)).max()))
    return worst(gaps)


def judge(readings: dict[str, float], limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of each number the cell's limits
    name."""
    return {name: {"value": readings[name],
                   "limit": float(limit["limit"])}
            for name, limit in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())

"""Sim-vs-silicon correlation points (port of the offline part of
``tpusim/harness/correlate.py``).

A :class:`CorrelationPoint` pairs the timing engine's estimate for a
captured module with a measured time of the same program; the report
layer (:mod:`tpusim_torch.harness.plots`) summarises and plots a suite
of them.  The reference's live half — ``loopify`` and
``correlate_workload``, which time JAX programs on a TPU — is ROADMAP
A12 item 5.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CorrelationPoint"]


@dataclass
class CorrelationPoint:
    name: str
    sim_seconds: float
    real_seconds: float
    sim_cycles: float
    flops: float
    hbm_bytes: float
    #: where real_seconds came from: "device" (profiler module timeline)
    #: or "wall" (fenced wall clock; includes host dispatch gaps)
    real_source: str = "wall"

    @property
    def error_pct(self) -> float:
        """Signed cycle error vs silicon, percent (the headline metric —
        BASELINE.md north-star is |error| <= 15%)."""
        if self.real_seconds <= 0:
            return float("inf")
        return 100.0 * (self.sim_seconds - self.real_seconds) / self.real_seconds

    @property
    def abs_error_pct(self) -> float:
        return abs(self.error_pct)

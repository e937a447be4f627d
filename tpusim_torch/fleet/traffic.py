"""Seeded stochastic inputs of a fleet run: arrivals + fault streams.

Everything random in :mod:`tpusim_torch.fleet` is drawn here, from named PRNG
substreams (the :mod:`tpusim_torch.campaign.sample` discipline: CPython seeds
str keys through SHA-512, independent of ``PYTHONHASHSEED``), so

* the same spec + seed produce byte-identical arrival streams and fault
  windows on every run;
* the frontier search replays EXACTLY the arrival stream the curve saw
  for the same offered rate (streams key on the rate value, never the
  pod count), so "pods needed for X req/s" answers the same question
  the curve plots;
* a resumed fleet regenerates exactly the inputs it would have walked —
  nothing depends on pricing order or on how far the crash got.

Arrivals are an open-loop process over the horizon: homogeneous Poisson
for ``shape: poisson``; for ``bursty``/``diurnal`` a thinned Poisson at
the instantaneous peak rate (the classic Lewis–Shedler construction,
exact and deterministic under a seeded ``random.Random``).  Fault
streams mirror campaign sampling — correlated groups draw first in
declaration order, then ``count.sample`` independent faults — but every
record carries a ``[start_s, end_s)`` window in fleet seconds, and the
pod-loss Bernoulli rides the same per-pod substream.

Port of ``tpusim/fleet/traffic.py``.
"""

from __future__ import annotations

import math
import random

from tpusim_torch.campaign.sample import _weighted_kind
from tpusim_torch.campaign.spec import CorrelatedGroup
from tpusim_torch.faults.schedule import FAULT_KINDS, _DCN_KINDS, _LINK_KINDS
from tpusim_torch.fleet.spec import FleetSpec, TrafficModel

__all__ = [
    "fleet_rng",
    "sample_arrivals",
    "sample_pod_stream",
]


def fleet_rng(seed: int, tag: str) -> random.Random:
    """One named fleet PRNG substream."""
    return random.Random(f"{seed}:fleet:{tag}")


# ---------------------------------------------------------------------------
# Arrivals
# ---------------------------------------------------------------------------


def _rate_at(traffic: TrafficModel, rate: float, t: float) -> float:
    """Instantaneous offered rate at fleet time ``t`` (mean ``rate``)."""
    if traffic.shape == "bursty":
        in_burst = (t % traffic.burst_period_s) < (
            traffic.burst_fraction * traffic.burst_period_s
        )
        if in_burst:
            return rate * traffic.burst_factor
        # off-burst rate chosen so the long-run mean stays `rate`
        return rate * (1.0 - traffic.burst_factor
                       * traffic.burst_fraction) \
            / (1.0 - traffic.burst_fraction)
    if traffic.shape == "diurnal":
        return rate * (1.0 + traffic.diurnal_amplitude
                       * math.sin(2.0 * math.pi * t
                                  / traffic.diurnal_period_s))
    return rate


def _weighted_index(rng: random.Random, weights: list[float]) -> int:
    # campaign's weighted draw over (value, weight) pairs, values being
    # mix indices — one implementation, one draw per call
    return _weighted_kind(rng, list(enumerate(weights)))


def sample_arrivals(
    traffic: TrafficModel, seed: int, rate: float, horizon_s: float,
) -> list[tuple[float, int]]:
    """The arrival stream for one offered rate: ``[(t_s, class_idx)]``
    sorted by time.  Keyed by the RATE alone (see module docstring);
    thinning rejections consume rng draws deterministically."""
    rng = fleet_rng(seed, f"traffic:{rate!r}")
    peak = rate * traffic.peak_factor()
    weights = [c.weight for c in traffic.mix]
    out: list[tuple[float, int]] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= horizon_s:
            return out
        accept = _rate_at(traffic, rate, t) / peak
        if accept < 1.0 and rng.random() >= accept:
            continue
        out.append((t, _weighted_index(rng, weights)))


# ---------------------------------------------------------------------------
# Fault streams
# ---------------------------------------------------------------------------


def _sample_window(
    rng: random.Random, spec: FleetSpec,
) -> tuple[float, float]:
    dur = rng.uniform(spec.faults.window_min_s, spec.faults.window_max_s)
    start = rng.uniform(0.0, max(spec.horizon_s - dur, 0.0))
    return start, start + dur


def _group_records(
    g: CorrelatedGroup, topo, window: tuple[float, float],
) -> list[dict]:
    start, end = window
    return [
        {
            "fault": {
                "kind": "link_down",
                "src": list(topo.coords(a)),
                "dst": list(topo.coords(b)),
            },
            "start_s": start,
            "end_s": end,
        }
        for a, b in g.resolve_links(topo)
    ]


def sample_pod_stream(spec: FleetSpec, topo, pod_index: int) -> dict:
    """One pod's sampled degradation: windowed fault records plus pod
    loss events, a pure function of ``(seed, pod_index)``::

        {"faults": [{"fault": {...schedule record...},
                     "start_s": ..., "end_s": ...}, ...],
         "deaths": [crash_instant_s, ...]}

    Correlated groups draw first (declaration order, one shared window
    per firing group — a cable bundle's links die together), then
    ``count.sample`` independent faults; the pod-loss Bernoulli draws
    last.  An empty stream is a legitimate healthy pod."""
    rng = fleet_rng(spec.seed, f"faults:{pod_index}")
    fm = spec.faults
    recs: list[dict] = []

    for g in spec.groups:
        if rng.random() < g.prob:
            recs.extend(_group_records(g, topo, _sample_window(rng, spec)))

    links = topo.undirected_links()
    num_slices = spec.dcn.num_slices if spec.dcn is not None else 0
    n = fm.count.sample(rng)
    for _ in range(n):
        kind = _weighted_kind(rng, fm.kinds)
        if kind in _DCN_KINDS:
            # DCN faults target a TPU hardware slice of the configured
            # fabric (spec validation guarantees a dcn block exists
            # when these kinds have weight — TL231)
            if num_slices <= 1:
                continue
            rec = {"kind": kind, "slice": rng.randrange(num_slices)}
        elif kind in _LINK_KINDS:
            if not links:
                # a 1-chip slice has no ICI links: the draw is omitted
                # (the zero-fault stream is already a legitimate
                # sample), mirroring campaign sampling
                continue
            a, b = links[rng.randrange(len(links))]
            rec = {
                "kind": kind,
                "src": list(topo.coords(a)),
                "dst": list(topo.coords(b)),
            }
        else:
            rec = {"kind": kind, "chip": rng.randrange(topo.num_chips)}
        scale_key = FAULT_KINDS[kind]
        if scale_key is not None:
            rec[scale_key] = rng.uniform(fm.scale_min, fm.scale_max)
        start, end = _sample_window(rng, spec)
        recs.append({"fault": rec, "start_s": start, "end_s": end})

    deaths: list[float] = []
    if fm.pod_loss_prob > 0.0 and rng.random() < fm.pod_loss_prob:
        # one crash somewhere in the middle 80% of the horizon — early
        # enough that the restart window and the post-loss regime both
        # land inside the simulated span
        deaths.append(rng.uniform(0.1 * spec.horizon_s,
                                  0.9 * spec.horizon_s))
    return {"faults": recs, "deaths": deaths}

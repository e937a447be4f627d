"""Seeded Monte-Carlo fault-schedule generation.

One scenario = one :mod:`tpusim_torch.faults` schedule document sampled from a
:class:`~tpusim_torch.campaign.spec.CampaignSpec`'s fault model against a
concrete torus.  ("Slice" throughout this module means a campaign
slice — one candidate pod shape's label — NOT a TPU hardware slice;
the latter only appear as the ``slice`` index of sampled DCN fault
records.)  Reproducibility contract: scenario ``i`` of slice ``L``
under seed ``S`` draws from its own ``random.Random(f"{S}:{L}:{i}")``
substream, so

* the same spec + seed produce byte-identical schedules on every run
  (CPython seeds str keys through SHA-512, independent of
  ``PYTHONHASHSEED``);
* a resumed campaign regenerates exactly the schedules it would have
  priced — scenario schedules never depend on pricing order or on how
  many scenarios ran before the crash.

Sampled faults use coordinate endpoints (human-readable journals) and
pass through :func:`tpusim_torch.faults.load_fault_schedule` unchanged, so a
generated scenario is exactly as expressive — and exactly as validated —
as a hand-written ``--faults`` schedule.

Port of ``tpusim/campaign/sample.py``.
"""

from __future__ import annotations

import random

from tpusim_torch.campaign.spec import CampaignSpec
from tpusim_torch.faults.schedule import FAULT_KINDS, _DCN_KINDS, _LINK_KINDS

__all__ = ["sample_schedule_doc", "scenario_rng"]


def scenario_rng(seed: int, slice_label: str, index: int) -> random.Random:
    """The per-scenario PRNG substream (see module docstring)."""
    return random.Random(f"{seed}:{slice_label}:{index}")


def _weighted_kind(rng: random.Random, kinds) -> str:
    total = sum(w for _, w in kinds)
    r = rng.random() * total
    acc = 0.0
    for kind, w in kinds:
        acc += w
        if r < acc:
            return kind
    return kinds[-1][0]


def sample_schedule_doc(
    spec: CampaignSpec, topo, slice_label: str, index: int,
) -> dict:
    """Sample scenario ``index``'s fault-schedule document for one
    slice.  Correlated groups draw first (declaration order), then
    ``count.sample`` independent faults; an empty draw is a legitimate
    healthy scenario — the distribution's zero bucket."""
    rng = scenario_rng(spec.seed, slice_label, index)
    fm = spec.faults
    recs: list[dict] = []

    for g in spec.groups:
        if rng.random() < g.prob:
            for a, b in g.resolve_links(topo):
                recs.append({
                    "kind": "link_down",
                    "src": list(topo.coords(a)),
                    "dst": list(topo.coords(b)),
                })

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
                # a 1-chip slice has no ICI links: the draw lands on a
                # fault that cannot exist there, so the record is
                # simply omitted (the zero-fault scenario is already a
                # legitimate sample) — never a mid-campaign crash
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
        if fm.window_prob > 0.0 and rng.random() < fm.window_prob:
            h = fm.window_horizon
            start = rng.uniform(0.0, 0.75 * h)
            rec["start_cycle"] = start
            rec["end_cycle"] = start + rng.uniform(0.05 * h, 0.5 * h)
        recs.append(rec)

    return {"faults": recs}

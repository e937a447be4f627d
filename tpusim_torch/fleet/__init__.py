"""tpusim_torch.fleet — the traffic-driven fleet digital twin.

Port of ``tpusim/fleet/``.

A seeded, deterministic discrete-event simulation of N serving pods
under an open-loop arrival process, where each pod prices steps through
the cached engine, a campaign-style fault stream degrades links, chips,
and HBM mid-run, admission is governed by the exact policies the serve
daemon implements as flags, and pod loss prices elastic recovery via
the advise transforms.  Answers the capacity-planning questions the
roadmap's "millions of users" framing demands: goodput/MFU/p99 versus
offered load, pods needed for a target rate at a latency SLO under
realistic degradation, energy per served request, and per-policy loss
attribution.  Reached via ``python -m tpusim_torch fleet`` and
:func:`run_fleet`.
"""

from tpusim_torch.campaign.journal import JournalError
from tpusim_torch.fleet.report import FLEET_REPORT_FORMAT_VERSION
from tpusim_torch.fleet.runner import (
    FleetResult,
    FleetStats,
    run_fleet,
    simulate_cell,
)
from tpusim_torch.fleet.spec import (
    FleetSpec,
    FleetSpecError,
    load_fleet_spec,
    spec_hash,
)

__all__ = [
    "FLEET_REPORT_FORMAT_VERSION",
    "FleetResult",
    "FleetSpec",
    "FleetSpecError",
    "FleetStats",
    "JournalError",
    "load_fleet_spec",
    "run_fleet",
    "simulate_cell",
    "spec_hash",
]

"""Monte-Carlo compound-fault campaigns (``tpusim_torch.campaign``).

Port of ``tpusim/campaign/``.  The fleet-planning pillar over
:mod:`tpusim_torch.faults`: where a fault sweep answers "what does ONE
dead link cost?", a campaign answers "what does my step-time
distribution look like under realistic compound degradation — k
simultaneous faults, correlated cable-bundle outages, straggler +
HBM-throttle mixes — and what is the smallest pod slice that still
meets my SLO at p99?".

Four pieces: declarative specs with a PRNG seed
(:mod:`~tpusim_torch.campaign.spec`), per-scenario substream sampling
(:mod:`~tpusim_torch.campaign.sample`), a crash-safe resumable executor
over the shared engine-result cache (:mod:`~tpusim_torch.campaign.runner`
+ :mod:`~tpusim_torch.campaign.journal`), and distribution/capacity
reports joining the power model (:mod:`~tpusim_torch.campaign.report`).
Reached via ``python -m tpusim_torch campaign``.

Not ported yet: the sharded campaign (``campaign/shard.py``,
``--nodes``), which needs the serving plane's hash ring (ROADMAP A11).
"""

from tpusim_torch.campaign.journal import Journal, JournalError
from tpusim_torch.campaign.report import build_report, percentile
from tpusim_torch.campaign.runner import (
    CampaignResult,
    CampaignStats,
    run_campaign,
)
from tpusim_torch.campaign.sample import sample_schedule_doc, scenario_rng
from tpusim_torch.campaign.spec import (
    CampaignSpec,
    CampaignSpecError,
    load_campaign_spec,
    spec_hash,
)

__all__ = [
    "CampaignResult",
    "CampaignSpec",
    "CampaignSpecError",
    "CampaignStats",
    "Journal",
    "JournalError",
    "build_report",
    "load_campaign_spec",
    "percentile",
    "run_campaign",
    "sample_schedule_doc",
    "scenario_rng",
    "spec_hash",
]

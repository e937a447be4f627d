"""Monte-Carlo compound-fault campaigns (``tpusim_torch.campaign``).

Port of ``tpusim/campaign/``.  The fleet-planning pillar over
:mod:`tpusim_torch.faults`: where a fault sweep answers "what does ONE
dead link cost?", a campaign answers "what does my step-time
distribution look like under realistic compound degradation — k
simultaneous faults, correlated cable-bundle outages, straggler +
HBM-throttle mixes — and what is the smallest pod slice that still
meets my SLO at p99?".

Five pieces: declarative specs with a PRNG seed
(:mod:`~tpusim_torch.campaign.spec`), per-scenario substream sampling
(:mod:`~tpusim_torch.campaign.sample`), a crash-safe resumable executor
over the shared engine-result cache (:mod:`~tpusim_torch.campaign.runner`
+ :mod:`~tpusim_torch.campaign.journal`), distribution/capacity reports
joining the power model (:mod:`~tpusim_torch.campaign.report`), and the
sharded run over node processes, placed by the serving cluster's hash
ring and merged into the single-node report
(:mod:`~tpusim_torch.campaign.shard`).  Reached via ``python -m
tpusim_torch campaign`` (``--nodes N`` shards it).
"""

from tpusim_torch.campaign.journal import Journal, JournalError
from tpusim_torch.campaign.report import build_report, percentile
from tpusim_torch.campaign.runner import (
    CampaignResult,
    CampaignStats,
    run_campaign,
)
from tpusim_torch.campaign.sample import sample_schedule_doc, scenario_rng
from tpusim_torch.campaign.shard import run_sharded_campaign, shard_assignment
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
    "run_sharded_campaign",
    "sample_schedule_doc",
    "scenario_rng",
    "shard_assignment",
    "spec_hash",
]

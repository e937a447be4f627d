"""tpusim_torch.advise — the strategy-transform layer of the sharding
advisor.

Port of ``tpusim/advise/transform.py`` (:mod:`~tpusim_torch.advise.
transform`): the workload profile, per-chip scaled modules and the
synthetic cell pods the fleet twin's pod-loss recovery prices.  The
advisor itself (``advise/spec.py``, ``runner.py``, its passes and the
``advise`` subcommand) is the next slice of the port (ROADMAP A8).
"""

from tpusim_torch.advise.transform import (
    TRANSFORM_VERSION,
    CollectiveSite,
    WorkloadProfile,
    build_cell_pod,
    build_profile,
    scaled_module,
)

__all__ = [
    "CollectiveSite",
    "TRANSFORM_VERSION",
    "WorkloadProfile",
    "build_cell_pod",
    "build_profile",
    "scaled_module",
]

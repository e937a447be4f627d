"""tpusim_torch.advise — parallelism-strategy sweep & sharding advisor.

Port of ``tpusim/advise/``.  Answers "how should I run it" for one
traced workload: sweep the cross-product of pod slices (arch x chips)
x parallelism strategies (dp / tp / dp x tp / sp ring attention / pp
pipeline / ep expert, plus user-pinned mesh combos), price every cell
through the shared engine-result cache on a modeled torus, and emit a
ranked step-time / ICI-bytes / HBM-residency / watts table with the
recommended sharding.  Reached via ``python -m tpusim_torch advise``;
the served advise job waits for the serving layer (ROADMAP A11).
"""

from tpusim_torch.advise.runner import (
    ADVISE_FORMAT_VERSION,
    AdviseResult,
    AdviseStats,
    run_advise,
)
from tpusim_torch.advise.spec import (
    AdviseSpec,
    AdviseSpecError,
    STRATEGIES,
    load_advise_spec,
    spec_hash,
)
from tpusim_torch.advise.transform import (
    TRANSFORM_VERSION,
    CollectiveSite,
    WorkloadProfile,
    build_cell_pod,
    build_profile,
    scaled_module,
)

__all__ = [
    "ADVISE_FORMAT_VERSION",
    "AdviseResult",
    "AdviseSpec",
    "AdviseSpecError",
    "AdviseStats",
    "CollectiveSite",
    "STRATEGIES",
    "TRANSFORM_VERSION",
    "WorkloadProfile",
    "build_cell_pod",
    "build_profile",
    "load_advise_spec",
    "run_advise",
    "scaled_module",
    "spec_hash",
]

"""tpusim_torch.dcn — the multi-slice DCN fabric layer.

Port of ``tpusim/dcn/``.  Sits above :mod:`tpusim_torch.ici` the way DCN
sits above ICI in hardware: slices are ICI domains, and this package
models what joins them — per-slice NIC banks into an optionally
oversubscribed spine — and the ``dcn`` spec block the campaign and fleet
specs share (:mod:`tpusim_torch.dcn.spec`).
"""

from tpusim_torch.dcn.fabric import DcnFabric
from tpusim_torch.dcn.spec import DcnBlock, DcnSpecError, fabric_overlay
from tpusim_torch.dcn.topology import SliceTopology, slice_topology_for

__all__ = [
    "DcnBlock",
    "DcnFabric",
    "DcnSpecError",
    "SliceTopology",
    "fabric_overlay",
    "slice_topology_for",
]

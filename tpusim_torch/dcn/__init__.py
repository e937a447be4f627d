"""tpusim_torch.dcn — the multi-slice DCN fabric layer.

Port of ``tpusim/dcn/`` without ``spec.py`` (the campaign/advise ``dcn``
block, ROADMAP A8).  Sits above :mod:`tpusim_torch.ici` the way DCN sits
above ICI in hardware: slices are ICI domains, and this package models
what joins them — per-slice NIC banks into an optionally oversubscribed
spine.
"""

from tpusim_torch.dcn.fabric import DcnFabric
from tpusim_torch.dcn.topology import SliceTopology, slice_topology_for

__all__ = [
    "DcnFabric",
    "SliceTopology",
    "slice_topology_for",
]

"""Fault-aware DCN fabric pricing: the cross-slice cost primitives.

Port of ``tpusim/dcn/fabric.py``.

A :class:`DcnFabric` binds a :class:`~tpusim_torch.dcn.topology.
SliceTopology` to a fault view and answers "what does moving bytes
BETWEEN slices cost right now".  The hierarchical decompositions in
:mod:`tpusim_torch.ici.collectives` compose these cross-slice terms with
the in-slice schedules.

Degradation semantics (per slice ``k``), read from the fault view when
one is bound (:class:`tpusim_torch.faults.FaultView`):

* ``dcn_link_down`` removes one NIC from slice ``k``;
* ``dcn_link_degraded`` scales slice ``k``'s usable bandwidth;
* ``slice_down`` zeroes it (the spine-outage / slice-loss case).

A zero-bandwidth participant makes every cross-slice term ``inf`` — the
collective model's ``min(flat, hierarchical)`` then falls back to the
flat scalar cap.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from tpusim_torch.dcn.topology import SliceTopology

__all__ = ["DcnFabric"]


@dataclass
class DcnFabric:
    """One degradation state's view of the inter-slice fabric."""

    slices: SliceTopology
    #: a fault view (or None = healthy)
    faults: object | None = None

    def slice_bandwidth(self, s: int) -> float:
        """Usable injection bandwidth of slice ``s`` under the bound
        fault view: surviving NICs × per-NIC bandwidth ÷
        oversubscription × degradation scale.  0.0 when the slice (or
        its every NIC) is down."""
        topo = self.slices
        nics = topo.nics_per_slice
        scale = 1.0
        fv = self.faults
        if fv is not None:
            if s in getattr(fv, "slices_down", ()):
                return 0.0
            nics -= getattr(fv, "dcn_nics_down", {}).get(s, 0)
            scale = getattr(fv, "dcn_scales", {}).get(s, 1.0)
        if nics <= 0 or scale <= 0.0:
            return 0.0
        return nics * topo.nic_bandwidth / topo.oversubscription * scale

    def bottleneck_bandwidth(self, s_count: int) -> float:
        """A ring/tree schedule over slices ``0..s_count-1`` drains at
        its slowest participant's injection rate."""
        if s_count <= 0:
            return 0.0
        return min(
            self.slice_bandwidth(s) for s in range(s_count)
        )

    # -- cross-slice schedule terms (the DCN phase of a hierarchical
    # -- decomposition; in-slice phases are priced by the ICI model) --

    def _lat(self, s_count: int) -> float:
        return self.slices.hop_latency * math.ceil(
            math.log2(max(s_count, 2))
        )

    def cross_allreduce_seconds(
        self, payload: float, s_count: int,
    ) -> float:
        """Ring all-reduce of one slice-representative's ``payload``
        over ``s_count`` slices: 2(S-1)/S byte phases at the bottleneck
        injection rate + tree-depth hop latencies."""
        if s_count <= 1 or payload <= 0:
            return 0.0
        w = self.bottleneck_bandwidth(s_count)
        if w <= 0.0:
            return math.inf
        return (
            2.0 * (s_count - 1) / s_count * payload / w
            + self._lat(s_count)
        )

    def cross_allgather_seconds(
        self, full_bytes: float, s_count: int,
    ) -> float:
        """All-gather (or reduce-scatter, by symmetry) of a
        ``full_bytes`` result over ``s_count`` slices: (S-1)/S byte
        phases at the bottleneck rate."""
        if s_count <= 1 or full_bytes <= 0:
            return 0.0
        w = self.bottleneck_bandwidth(s_count)
        if w <= 0.0:
            return math.inf
        return (
            (s_count - 1) / s_count * full_bytes / w
            + self._lat(s_count)
        )

    def cross_alltoall_seconds(
        self, payload: float, chips_in_slice: int, s_count: int,
    ) -> float:
        """All-to-all across slices: each chip keeps 1/S of its
        ``payload`` local, so a slice of ``chips_in_slice`` chips
        pushes ``m·B·(S-1)/S`` bytes through its NICs, concurrently
        across slices — the bottleneck slice sets the time."""
        if s_count <= 1 or payload <= 0:
            return 0.0
        w = self.bottleneck_bandwidth(s_count)
        if w <= 0.0:
            return math.inf
        egress = chips_in_slice * payload * (s_count - 1) / s_count
        return egress / w + self.slices.hop_latency

    def transfer_seconds(self, nbytes: float, s: int) -> float:
        """One slice's bulk egress (point-to-point) — the recovery-
        migration primitive: ``nbytes`` through slice ``s``'s NICs."""
        if nbytes <= 0:
            return 0.0
        w = self.slice_bandwidth(s)
        if w <= 0.0:
            return math.inf
        return nbytes / w + self.slices.hop_latency

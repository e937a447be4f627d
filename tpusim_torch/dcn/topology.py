"""Slice-aware topology: N TPU slices × the ICI torus, joined by a
modeled inter-slice DCN fabric.

Port of ``tpusim/dcn/topology.py``.

The reference's entire "distributed" layer was one constant
(``-nccl_allreduce_latency``, ``gpu-sim.cc:759-762``).  The single-slice
ICI torus (:mod:`tpusim_torch.ici.topology`) left DCN as a flat scalar
term (``dcn_bandwidth``/``dcn_latency``).  This module adds the layer
above the torus: a :class:`SliceTopology` describing how many slices a
replica group tiles across and what each slice's injection capacity into
the spine is (per-slice NIC count × per-NIC bandwidth ÷
oversubscription).

Terminology note: a *TPU slice* here is a hardware pod partition (one
ICI domain), unrelated to the campaign layer's "slices" (pod-size
variants of one campaign spec).

Back-compat contract: the fabric is gated on ``dcn_nics_per_slice > 0``
(:func:`slice_topology_for` returns ``None`` otherwise), so every config
that only sets ``chips_per_slice`` keeps pricing through the flat scalar
model, byte-identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["SliceTopology", "slice_topology_for"]


@dataclass(frozen=True)
class SliceTopology:
    """The inter-slice layer of a multi-slice system.

    Chips ``[k*chips_per_slice, (k+1)*chips_per_slice)`` form slice
    ``k``; a ``chips_per_slice`` that does not evenly tile the chip
    count leaves the last slice partial (the collective model rounds the
    slice count UP, pricing the partial slice as a full participant)."""

    num_slices: int
    chips_per_slice: int
    #: DCN NICs per slice (the per-slice injection parallelism)
    nics_per_slice: int
    #: per-NIC usable bandwidth into the spine, bytes/second
    nic_bandwidth: float
    #: per-DCN-hop latency, seconds
    hop_latency: float
    #: spine oversubscription factor (>= 1 divides usable bandwidth)
    oversubscription: float = 1.0

    def slice_of(self, chip: int) -> int:
        """Slice index of a global chip id (ids beyond the last slice
        fold around, matching how replica groups alias chips)."""
        return (chip // self.chips_per_slice) % self.num_slices

    def slice_bandwidth(self) -> float:
        """Healthy per-slice injection bandwidth into the spine."""
        return (
            self.nics_per_slice * self.nic_bandwidth
            / self.oversubscription
        )

    def slices_for_group(self, n: int) -> int:
        """Slices a contiguous group of ``n`` chips spans (rounded up
        — a partially-occupied slice still pays full DCN hops)."""
        return min(
            math.ceil(n / self.chips_per_slice), self.num_slices,
        ) if n > 0 else 0


def slice_topology_for(num_chips: int, cfg) -> SliceTopology | None:
    """Compose the slice layer from an :class:`~tpusim_torch.timing.config.
    IciConfig`, the way :func:`tpusim_torch.ici.topology.torus_for`
    composes the intra-slice torus.

    Returns ``None`` — fabric unconfigured, flat scalar model stays in
    charge — unless BOTH ``chips_per_slice`` and ``dcn_nics_per_slice``
    are positive.  ``dcn_hop_bandwidth``/``dcn_hop_latency`` fall back
    to the flat ``dcn_bandwidth``/``dcn_latency`` scalars when left 0,
    so a fabric can be enabled by NIC count alone."""
    cps = int(getattr(cfg, "chips_per_slice", 0) or 0)
    nics = int(getattr(cfg, "dcn_nics_per_slice", 0) or 0)
    if cps <= 0 or nics <= 0:
        return None
    return SliceTopology(
        num_slices=max(math.ceil(num_chips / cps), 1),
        chips_per_slice=cps,
        nics_per_slice=nics,
        nic_bandwidth=(
            cfg.dcn_hop_bandwidth or cfg.dcn_bandwidth
        ),
        hop_latency=(
            cfg.dcn_hop_latency or cfg.dcn_latency
        ),
        oversubscription=cfg.dcn_oversubscription,
    )

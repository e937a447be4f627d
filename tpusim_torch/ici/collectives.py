"""Analytic collective schedules over the ICI torus.

Port of ``tpusim/ici/collectives.py``.

This replaces the distributed fork's entire collective "model" — a constant
``-nccl_allreduce_latency`` added serially to the cycle counter
(``gpu-simulator/main.cc:116-134``, ``gpu-sim.cc:759-762``) — with real
cost functions: ring and double-binary-tree schedules, bidirectional links,
multi-axis torus phases, and a DCN term for groups spanning slices.  Unlike
the reference (which records neither byte counts nor groups for NCCL ops —
SURVEY.md §5), every cost here is driven by the payload size and replica
groups captured in the HLO.

Model summary (B = payload bytes per participant, N = group size, W =
per-link per-direction bandwidth × efficiency, D = link directions usable by
the group = 2 per torus axis):

* ring all-reduce:     2·(N-1)/N · B / (W·D)   (reduce-scatter + all-gather)
* tree all-reduce:     2·B / (W·D) pipelined, 2·log2(N) hop latencies
* all-gather:          (N-1)/N · B_full / (W·D)
* reduce-scatter:      (N-1)/N · B_in / (W·D)
* all-to-all (ring):   B · N / (8·W) per axis (balanced shortest-path
  bound over the 2N directed links), axis-factored
* collective-permute:  B / W + hops · hop_latency

The per-collective time is ``launch_latency + max(bandwidth term, latency
term)`` with the cheaper of ring/tree chosen, mirroring how real collective
libraries switch algorithms by message size.

Multi-slice groups (``0 < chips_per_slice < N``) add a DCN term.  Two
models coexist: the original flat scalar (ring over S slices at
``dcn_bandwidth``, applied as a max) and — when a fabric is configured
via ``dcn_nics_per_slice`` (:mod:`tpusim_torch.dcn`) — a hierarchical
decomposition (in-slice reduce-scatter → cross-slice all-reduce over
the modeled fabric → in-slice all-gather, per-kind variants in
``_hier_seconds``), with the cheaper of flat/hierarchical chosen the
same way ring/tree is.  An unconfigured fabric prices byte-identically
to the flat model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from tpusim_torch.dcn.fabric import DcnFabric
from tpusim_torch.dcn.topology import slice_topology_for
from tpusim_torch.ir import CollectiveInfo
from tpusim_torch.ici.topology import Topology

if TYPE_CHECKING:  # avoid a circular import with tpusim_torch.timing
    from tpusim_torch.timing.config import IciConfig

__all__ = ["CollectiveModel", "collective_seconds"]


@dataclass
class CollectiveModel:
    topo: Topology
    cfg: "IciConfig"
    # memoized inter-slice fabric (tpusim_torch.dcn); False = not yet built,
    # None = fabric unconfigured (the flat scalar model stays in charge)
    _fabric: object = field(
        default=False, init=False, repr=False, compare=False
    )

    # -- helpers -----------------------------------------------------------

    def _axes_for_group(self, n: int) -> list[int]:
        """Torus axes a contiguous group of ``n`` chips spans (greedy,
        largest axes first)."""
        if n <= 1:
            return []
        axes = sorted(
            range(self.topo.ndims), key=lambda i: -self.topo.dims[i]
        )
        chosen: list[int] = []
        prod = 1
        for ax in axes:
            if prod >= n:
                break
            if self.topo.dims[ax] > 1:
                chosen.append(ax)
                prod *= self.topo.dims[ax]
        return chosen or [0]

    def _link_bw(self) -> float:
        return self.cfg.link_bandwidth * self.cfg.efficiency * max(
            self.cfg.links_per_axis, 1
        )

    def _directions(self, n: int) -> int:
        """Usable link directions for a group of n chips: 2 per spanned
        axis (bidirectional ICI).  With a fault view attached, an axis
        whose ring is broken by a dead link falls back to the mesh term
        — one rotation direction instead of two counter-rotating rings
        (the torus→mesh degradation a dead wrap link forces)."""
        if n <= 1:
            return 1
        axes = self._axes_for_group(n)
        faults = self.topo.faults
        if faults is not None and faults.broken_axes:
            return max(
                sum(1 if ax in faults.broken_axes else 2 for ax in axes), 1
            )
        return max(2 * len(axes), 1)

    def _fault_bw_scale(self, n: int) -> float:
        """Bandwidth multiplier from degraded (not dead) links on the
        group's spanned axes: a ring schedule drains at its slowest
        link, so the axis bottlenecks at the worst per-link scale.
        1.0 on a healthy topology — the fault-free path is unchanged."""
        faults = self.topo.faults
        if faults is None or not faults.axis_min_scale:
            return 1.0
        return min(
            (faults.axis_min_scale.get(ax, 1.0)
             for ax in self._axes_for_group(n)),
            default=1.0,
        )

    def _spans_dcn(self, n: int) -> bool:
        return 0 < self.cfg.chips_per_slice < n

    def _dcn_term(self, payload: float, n: int) -> float:
        """Inter-slice portion when a group spans slices: ring over S
        slices at DCN bandwidth."""
        s = math.ceil(n / self.cfg.chips_per_slice)
        return (
            2.0 * (s - 1) / s * payload / self.cfg.dcn_bandwidth
            + self.cfg.dcn_latency * math.ceil(math.log2(max(s, 2)))
        )

    def _dcn_fabric(self):
        """The modeled inter-slice fabric (:mod:`tpusim_torch.dcn`), bound to
        this model's fault view; None when unconfigured — every path
        below then degenerates byte-identically to the flat scalar
        ``_dcn_term`` model."""
        if self._fabric is False:
            st = slice_topology_for(self.topo.num_chips, self.cfg)
            self._fabric = (
                DcnFabric(st, self.topo.faults)
                if st is not None else None
            )
        return self._fabric

    def _hier_seconds(
        self, kind: str, payload: float, n: int
    ) -> float | None:
        """Hierarchical decomposition of a slice-spanning collective
        over the modeled fabric: in-slice phases priced by the ICI
        schedules above, the cross-slice phase by the fabric.  Each
        phase is a separately launched collective (it pays its own
        ``launch_latency``).  None when the fabric is unconfigured; may
        be ``inf`` when a participating slice has zero DCN bandwidth —
        the caller's ``min(flat, hier)`` then keeps the flat cap, and
        slice-loss catastrophe is left to the campaign/fleet executors
        (ROADMAP A8), not the cost model."""
        fabric = self._dcn_fabric()
        if fabric is None:
            return None
        m = min(self.cfg.chips_per_slice, n)
        s = math.ceil(n / m)
        launch = self.cfg.launch_latency
        if kind == "all-reduce":
            # in-slice reduce-scatter -> cross-slice all-reduce of the
            # full payload (each slice's m shards inject concurrently)
            # -> in-slice all-gather
            return (
                self.reducescatter_seconds(payload, m)
                + launch + fabric.cross_allreduce_seconds(payload, s)
                + self.allgather_seconds(payload, m)
            )
        if kind == "all-gather":
            # cross-slice all-gather of the full result between slice
            # representatives, then in-slice all-gather fans it out
            # (reduce-scatter is the same walk mirrored — its caller
            # delegates here via allgather_seconds)
            return (
                launch + fabric.cross_allgather_seconds(payload, s)
                + self.allgather_seconds(payload, m)
            )
        if kind == "all-to-all":
            # in-slice exchange, then each slice pushes its (S-1)/S
            # off-slice fraction through its NIC bank
            return (
                self.alltoall_seconds(payload, m)
                + launch
                + fabric.cross_alltoall_seconds(payload, m, s)
            )
        return None

    # -- schedules ---------------------------------------------------------

    def allreduce_seconds(self, payload: float, n: int) -> float:
        if n <= 1 or payload <= 0:
            return self.cfg.launch_latency
        w = self._link_bw() * self._directions(n) * self._fault_bw_scale(n)
        ring_bw = 2.0 * (n - 1) / n * payload / w
        ring_lat = 2.0 * (n - 1) * self.cfg.hop_latency
        tree_bw = 2.0 * payload / w
        tree_lat = 2.0 * math.ceil(math.log2(n)) * self.cfg.hop_latency
        t = min(ring_bw + ring_lat, tree_bw + tree_lat)
        if self._spans_dcn(n):
            t = max(t, self._dcn_term(payload, n))
            hier = self._hier_seconds("all-reduce", payload, n)
            if hier is not None:
                return min(self.cfg.launch_latency + t, hier)
        return self.cfg.launch_latency + t

    def allgather_seconds(self, full_bytes: float, n: int) -> float:
        """``full_bytes`` = the gathered (output) size."""
        if n <= 1 or full_bytes <= 0:
            return self.cfg.launch_latency
        w = self._link_bw() * self._directions(n) * self._fault_bw_scale(n)
        t = (n - 1) / n * full_bytes / w + (n - 1) * self.cfg.hop_latency
        if self._spans_dcn(n):
            t = max(t, 0.5 * self._dcn_term(full_bytes, n))
            hier = self._hier_seconds("all-gather", full_bytes, n)
            if hier is not None:
                return min(self.cfg.launch_latency + t, hier)
        return self.cfg.launch_latency + t

    def reducescatter_seconds(self, in_bytes: float, n: int) -> float:
        """``in_bytes`` = the unreduced (input) size per participant."""
        return self.allgather_seconds(in_bytes, n)

    def alltoall_seconds(self, payload: float, n: int) -> float:
        """Axis-factored all-to-all; ``payload`` = bytes held per chip."""
        if n <= 1 or payload <= 0:
            return self.cfg.launch_latency
        axes = self._axes_for_group(n)
        w = self._link_bw()
        faults = self.topo.faults
        t = 0.0
        remaining = n
        for ax in axes:
            n_ax = min(self.topo.dims[ax], remaining)
            if n_ax <= 1:
                continue
            # balanced bidirectional ring all-to-all on this axis: total
            # byte-hops = payload * n_ax^2 / 4 (mean shortest-path hop
            # distance n_ax/4) spread over 2*n_ax directed links of
            # bandwidth w -> per-link traffic payload * n_ax / 8
            w_ax = w
            denom = 8.0
            if faults is not None:
                # a broken ring halves the usable directed links on the
                # axis; degraded links bottleneck it at their worst scale
                if ax in faults.broken_axes:
                    denom = 4.0
                w_ax *= faults.axis_min_scale.get(ax, 1.0)
            t += payload * n_ax / (denom * w_ax)
            t += (n_ax / 2.0) * self.cfg.hop_latency
            remaining = max(remaining // n_ax, 1)
        if self._spans_dcn(n):
            t = max(t, self._dcn_term(payload, n))
            hier = self._hier_seconds("all-to-all", payload, n)
            if hier is not None:
                return min(self.cfg.launch_latency + t, hier)
        return self.cfg.launch_latency + t

    def permute_seconds(
        self, payload: float, pairs: tuple[tuple[int, int], ...]
    ) -> float:
        """Point-to-point shifts (``ppermute``): all pairs transfer
        concurrently; time set by the longest path and per-chip injection."""
        if not pairs or payload <= 0:
            return self.cfg.launch_latency
        w = self._link_bw()
        faults = self.topo.faults
        if faults is not None and faults.scales:
            # conservative: a shift chain drains at its slowest link
            w *= min(faults.scales.values())
        max_hops = 1
        out_degree: dict[int, int] = {}
        for s, t_ in pairs:
            out_degree[s] = out_degree.get(s, 0) + 1
            if self.topo.num_chips > max(s, t_):
                max_hops = max(max_hops, self.topo.hop_distance(s, t_))
        fan = max(out_degree.values())
        fabric = self._dcn_fabric()
        if fabric is not None:
            # cross-slice shifts pay the DCN hop: the slice with the
            # most crossing pairs bottlenecks at its own NIC bank
            # (fabric-gated — unconfigured fabrics change nothing)
            crossing: dict[int, int] = {}
            for s, t_ in pairs:
                src = fabric.slices.slice_of(s)
                if src != fabric.slices.slice_of(t_):
                    crossing[src] = crossing.get(src, 0) + 1
            cross = 0.0
            for src, cnt in crossing.items():
                w_s = fabric.slice_bandwidth(src)
                cross = max(cross, (
                    cnt * payload / w_s if w_s > 0.0 else math.inf
                ) + fabric.slices.hop_latency)
            if cross > 0.0:
                return self.cfg.launch_latency + max(
                    fan * payload / w
                    + max_hops * self.cfg.hop_latency,
                    cross,
                )
        return (
            self.cfg.launch_latency
            + fan * payload / w
            + max_hops * self.cfg.hop_latency
        )

    # -- dispatch ----------------------------------------------------------

    def seconds(self, info: CollectiveInfo, payload_bytes: float) -> float:
        n = max(info.group_size, 1)
        kind = info.kind
        if kind == "all-reduce":
            return self.allreduce_seconds(payload_bytes, n)
        if kind in ("all-gather", "collective-broadcast"):
            return self.allgather_seconds(payload_bytes, n)
        if kind == "reduce-scatter":
            return self.reducescatter_seconds(payload_bytes, n)
        if kind in ("all-to-all", "ragged-all-to-all"):
            return self.alltoall_seconds(payload_bytes, n)
        if kind == "collective-permute":
            return self.permute_seconds(payload_bytes, info.source_target_pairs)
        # unknown collective: be conservative, treat as all-reduce
        return self.allreduce_seconds(payload_bytes, n)


def collective_seconds(
    info: CollectiveInfo,
    payload_bytes: float,
    topo: Topology,
    cfg: "IciConfig",
) -> float:
    return CollectiveModel(topo, cfg).seconds(info, payload_bytes)

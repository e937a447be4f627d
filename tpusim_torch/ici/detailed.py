"""Detailed ICI network model: per-packet link contention on the torus.

Port of ``tpusim/ici/detailed.py``, Python backend only.

The analytic model (:mod:`tpusim_torch.ici.collectives`) prices a collective with
closed-form schedule math; this module *simulates* it — every transfer is
split into packets that dimension-order-route across the torus and contend
for directed links with cut-through pipelining and FIFO arbitration.  It is
the rebuild of the reference's detailed-interconnect option (BookSim2's
``kncube`` torus behind ``-network_mode``, ``src/intersim2/networks/
kncube.{hpp,cpp}`` + ``icnt_wrapper.h:36-64``), selected the same way via
``IciConfig.network_mode = "detailed"``.

The reference has two interchangeable backends: ``native/ici_net.cpp``
through ctypes and a pure-Python event-driven twin, its contract
reference.  The port has the Python twin; the native one is an optional
accelerator, queued with ``native/`` (ROADMAP A10), so ``use_native=True``
raises.  ``tests/test_torch_ici.py`` holds this backend to the
reference's Python backend exactly.

Collectives are decomposed into *phases* of point-to-point transfers with a
barrier between phases (the data dependence of ring steps); the network
returns the summed phase makespans in network cycles (1 cycle = 1 ns).
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable, Sequence

from tpusim_torch.ici.collectives import CollectiveModel
from tpusim_torch.ici.topology import Topology
from tpusim_torch.ir import CollectiveInfo

if TYPE_CHECKING:
    from tpusim_torch.timing.config import IciConfig

__all__ = [
    "NET_CYCLE_S",
    "TorusNetwork",
    "DetailedCollectiveModel",
    "make_collective_model",
]

#: the detailed network's clock: 1 cycle == 1 ns (independent of the core
#: clock; callers convert seconds via NET_CYCLE_S)
NET_CYCLE_S = 1e-9

#: (src_chip, dst_chip, bytes[, direction_hint]) — hint = axis*2+dir
#: forces the rotation direction on that axis (-1/absent = DOR default),
#: letting counter-rotating rings claim both directions of an axis
Transfer = tuple


class TorusNetwork:
    """Event-driven cut-through packet network on a 1-3D torus.

    ``flit_bytes`` = bytes a link moves per cycle; ``hop_cycles`` = head
    latency per hop (router + SerDes).  ``run_phases`` simulates phases of
    transfers with barriers between them and returns total cycles.
    """

    def __init__(
        self,
        topo: Topology,
        flit_bytes: float,
        hop_cycles: int,
        use_native: bool | None = None,
    ):
        if topo.ndims > 3:
            raise ValueError("TorusNetwork supports 1-3 dims")
        self.topo = topo
        self.flit_bytes = float(flit_bytes)
        self.hop_cycles = int(hop_cycles)
        if self.flit_bytes <= 0:
            raise ValueError("flit_bytes must be positive")
        if use_native:
            raise RuntimeError(
                "the native ici_net backend is not ported (ROADMAP A10); "
                "the python backend prices every network"
            )
        self._faulted = topo.has_faults
        self._detour_cache: dict[tuple[int, int], list[int]] = {}
        self._scale_cache: dict[int, float] = {}

    # -- public ------------------------------------------------------------

    def run_phases(
        self,
        phases: Sequence[Iterable[Transfer]],
        packet_bytes: float = 16384.0,
    ) -> float:
        """Total cycles to complete ``phases`` (barrier between phases)."""
        flat: list[tuple[int, int, int, float, int]] = []
        for pi, phase in enumerate(phases):
            for tr in phase:
                src, dst, nbytes = tr[0], tr[1], tr[2]
                hint = tr[3] if len(tr) > 3 else -1
                flat.append((pi, int(src), int(dst), float(nbytes), int(hint)))
        if not flat:
            return 0.0
        return self._run_python(flat, packet_bytes)

    # -- python backend (the contract reference) ---------------------------

    def _link_endpoints(self, lid: int) -> tuple[int, int | None]:
        """Decode a directed link id back to ``(src, dst)`` chips."""
        nd = self.topo.ndims
        direction = lid % 2
        axis = (lid // 2) % nd
        src = lid // (2 * nd)
        return src, self.topo.neighbor(src, axis, direction)

    def _lid_scale(self, lid: int) -> float:
        """Bandwidth multiplier of one directed link (memoized)."""
        s = self._scale_cache.get(lid)
        if s is None:
            a, b = self._link_endpoints(lid)
            s = self.topo.link_scale(a, b) if b is not None else 1.0
            self._scale_cache[lid] = s
        return s

    def _route_around(self, src: int, dst: int) -> list[int]:
        """BFS shortest path over LIVE links only — the fallback when the
        dimension-order route crosses a dead link.  Raises
        :class:`~tpusim_torch.faults.TopologyPartitionedError` when the
        dead links disconnect ``src`` from ``dst``."""
        key = (src, dst)
        cached = self._detour_cache.get(key)
        if cached is not None:
            return cached
        from collections import deque

        topo = self.topo
        nd = topo.ndims
        prev: dict[int, tuple[int, int] | None] = {src: None}
        q = deque([src])
        while q:
            cur = q.popleft()
            if cur == dst:
                break
            for axis in range(nd):
                if topo.dims[axis] <= 1:
                    continue
                for direction in (0, 1):
                    nxt = topo.neighbor(cur, axis, direction)
                    if nxt is None or nxt in prev:
                        continue
                    if not topo.link_alive(cur, nxt):
                        continue
                    prev[nxt] = (cur, (cur * nd + axis) * 2 + direction)
                    q.append(nxt)
        if dst not in prev:
            from tpusim_torch.faults import TopologyPartitionedError

            faults = topo.faults
            ndead = getattr(faults, "links_down", 0)
            raise TopologyPartitionedError(
                f"topology partitioned: no live ICI route from chip {src} "
                f"{list(topo.coords(src))} to chip {dst} "
                f"{list(topo.coords(dst))} with {ndead} directed link(s) "
                f"down — the fault schedule disconnects the pod"
            )
        links: list[int] = []
        cur = dst
        while prev[cur] is not None:
            p, lid = prev[cur]  # type: ignore[misc]
            links.append(lid)
            cur = p
        links.reverse()
        self._detour_cache[key] = links
        return links

    def _route(self, src: int, dst: int, hint: int = -1) -> list[int]:
        """Directed link ids along the dimension-order route src->dst;
        ``hint`` (axis*2+dir) forces the rotation direction on one axis.
        On a faulted topology, a route crossing a dead link is replaced
        by the shortest live detour (ignoring the hint — a forced
        rotation through a dead cable is meaningless)."""
        topo = self.topo
        nd = topo.ndims
        links: list[int] = []
        cur = src
        cc = list(topo.coords(cur))
        cd = topo.coords(dst)
        for axis in range(nd):
            d = topo.dims[axis]
            cs, ct = cc[axis], cd[axis]
            if cs == ct:
                continue
            fwd = (ct - cs) % d
            bwd = (cs - ct) % d
            if hint >= 0 and hint // 2 == axis and (
                topo.wrap[axis]
                or (hint % 2 == 0) == (ct > cs)
            ):
                direction = hint % 2
                hops = fwd if direction == 0 else bwd
            elif not topo.wrap[axis]:
                direction, hops = (0, ct - cs) if ct > cs else (1, cs - ct)
            elif fwd <= bwd:
                direction, hops = 0, fwd
            else:
                direction, hops = 1, bwd
            for _ in range(hops):
                links.append((cur * nd + axis) * 2 + direction)
                step = 1 if direction == 0 else -1
                cc[axis] = (cc[axis] + step) % d
                cur = topo.chip_at(tuple(cc))
        if self._faulted and links and any(
            not topo.link_alive(*self._link_endpoints(lid)) for lid in links
        ):
            return self._route_around(src, dst)
        return links

    def _run_python(
        self, flat: list[tuple[int, int, int, float, int]],
        packet_bytes: float,
    ) -> float:
        total = 0.0
        i, n = 0, len(flat)
        while i < n:
            cur_phase = flat[i][0]
            pkts: list[list] = []  # [links, pos, ser]
            heap: list[tuple[float, int, int]] = []
            seq = 0
            while i < n and flat[i][0] == cur_phase:
                _, src, dst, nbytes, hint = flat[i]
                i += 1
                if src == dst or nbytes == 0:
                    continue
                links = self._route(src, dst, hint)
                npk = max(int(math.ceil(nbytes / packet_bytes)), 1)
                per = nbytes / npk
                for _ in range(npk):
                    pkts.append([links, 0, per / self.flit_bytes])
                    heapq.heappush(heap, (0.0, seq, len(pkts) - 1))
                    seq += 1
            link_free: dict[int, float] = {}
            phase_end = 0.0
            faulted = self._faulted
            while heap:
                t, _, pid = heapq.heappop(heap)
                links, pos, ser = pkts[pid]
                lid = links[pos]
                # a degraded link serializes the same flits more slowly
                ser_l = ser / self._lid_scale(lid) if faulted else ser
                depart = max(t, link_free.get(lid, 0.0))
                link_free[lid] = depart + ser_l
                arrive = depart + self.hop_cycles
                pkts[pid][1] = pos + 1
                if pos + 1 >= len(links):
                    phase_end = max(phase_end, arrive + ser_l)
                else:
                    heapq.heappush(heap, (arrive, seq, pid))
                    seq += 1
            total += phase_end
        return total


# ---------------------------------------------------------------------------
# collective schedules on the detailed network
# ---------------------------------------------------------------------------

def _snake_order(topo: Topology, members: Sequence[int]) -> list[int]:
    """Order group members so consecutive entries are torus neighbors where
    possible: an N-D boustrophedon.  Axis ``i``'s direction flips each time
    the traversal of the outer axes advances by one line — i.e. on the
    parity of the outer axes' *mixed-radix* index, not their coordinate
    sum (a sum-parity snake breaks adjacency at block boundaries on 3D
    tori)."""
    nd = topo.ndims

    def key(chip: int):
        c = topo.coords(chip % topo.num_chips)
        transformed = [0] * nd
        super_index = 0  # mixed-radix index over outer (already-placed) axes
        for axis in range(nd - 1, -1, -1):
            v = c[axis]
            if super_index % 2:
                v = topo.dims[axis] - 1 - v
            transformed[axis] = v
            super_index = super_index * topo.dims[axis] + v
        return tuple(transformed[a] for a in range(nd - 1, -1, -1))

    return sorted((m % topo.num_chips for m in members), key=key)


def _merge_phase_lists(
    lists: list[list[list[Transfer]]],
) -> list[list[Transfer]]:
    """Positionally merge several phase lists (concurrent parts/groups);
    shorter lists simply contribute nothing to the trailing phases."""
    if not lists:
        return []
    out: list[list[Transfer]] = []
    for i in range(max(len(pl) for pl in lists)):
        phase: list[Transfer] = []
        for pl in lists:
            if i < len(pl):
                phase.extend(pl[i])
        out.append(phase)
    return out


@dataclass
class DetailedCollectiveModel:
    """Same ``seconds(info, payload)`` interface as the analytic
    :class:`~tpusim_torch.ici.collectives.CollectiveModel`, but every schedule is
    replayed packet-by-packet on a :class:`TorusNetwork`.

    ``obs`` (a :class:`tpusim_torch.obs.hub.Instrumentation`) turns on link
    accounting, recorded once per ``seconds()`` PRICING CALL — which is
    once per unique module for kernel-internal collectives (the driver
    caches engine results per module) and once per participating device
    command for standalone ones.  The absolute counters therefore do not
    scale with run-level launch counts; consume them as the
    busy/capacity RATIO (``ici.detailed.link_busy_cycles`` /
    ``ici.detailed.link_cycle_capacity``), a pricing-weighted mean link
    occupancy, which is what the schedule-level view can support."""

    topo: Topology
    cfg: "IciConfig"
    obs: object | None = None

    def __post_init__(self):
        # link moves (bandwidth * efficiency) bytes/sec; at the 1 GHz
        # network clock that's bandwidth * efficiency * 1e-9 bytes/cycle
        flit = (
            self.cfg.link_bandwidth * self.cfg.efficiency
            * max(self.cfg.links_per_axis, 1) * NET_CYCLE_S
        )
        self.net = TorusNetwork(
            self.topo,
            flit_bytes=flit,
            hop_cycles=max(int(round(self.cfg.hop_latency / NET_CYCLE_S)), 1),
        )
        self._analytic = CollectiveModel(self.topo, self.cfg)

    # -- group handling ----------------------------------------------------

    def _groups(self, info: CollectiveInfo) -> list[list[int]]:
        if info.replica_groups:
            return [
                [m % self.topo.num_chips for m in g]
                for g in info.replica_groups if len(g) > 1
            ]
        n = max(info.group_size, 1)
        if n <= 1:
            return []
        return [list(range(min(n, self.topo.num_chips)))]

    def _grid_axes(
        self, g: list[int]
    ) -> list[tuple[int, list[int]]] | None:
        """If the group is a cartesian product over some torus axes (the
        shape pjit meshes map to), return ``[(axis, sorted values), ...]``;
        else None."""
        topo = self.topo
        coords = [topo.coords(m) for m in g]
        if len(set(g)) != len(g):
            return None
        axes: list[tuple[int, list[int]]] = []
        prod = 1
        for a in range(topo.ndims):
            vals = sorted({c[a] for c in coords})
            if len(vals) > 1:
                axes.append((a, vals))
                prod *= len(vals)
        if not axes or prod != len(g):
            return None
        coordset = {tuple(c) for c in coords}
        fixed = list(coords[0])
        for combo in itertools.product(*(vals for _, vals in axes)):
            cc = list(fixed)
            for (a, _), v in zip(axes, combo):
                cc[a] = v
            if tuple(cc) not in coordset:
                return None
        return axes

    def _axis_neighbors(
        self, chip: int, axis: int, vals: list[int]
    ) -> tuple[int, int]:
        """(next, prev) group member along ``axis`` (wrapping within the
        member values — physical neighbors when the group spans the full
        axis)."""
        topo = self.topo
        c = list(topo.coords(chip))
        i = vals.index(c[axis])
        nxt, prv = list(c), list(c)
        nxt[axis] = vals[(i + 1) % len(vals)]
        prv[axis] = vals[(i - 1) % len(vals)]
        return topo.chip_at(tuple(nxt)), topo.chip_at(tuple(prv))

    # -- schedule builders (all groups proceed concurrently) ---------------
    #
    # Grid groups get the real torus schedule: per spanned axis,
    # counter-rotating rings along the physical axis lines; the payload is
    # split across len(axes) parts that traverse the axes in rotated
    # orders, so every axis carries its large phase concurrently — the
    # packet-level realization of the analytic model's D = 2·axes
    # assumption.  Irregular groups fall back to one snake-embedded ring.

    def _grid_ring_step(
        self, g: list[int], axis: int, vals: list[int], step_bytes: float
    ) -> list[Transfer]:
        half = step_bytes / 2.0
        out: list[Transfer] = []
        # with two members the forward/backward neighbor coincide; the
        # counter-rotating split only pays off on a wrapped length-2 axis
        # (a genuine double link) — otherwise a single direct transfer is
        # the schedule (routing the "backward" half the long way around
        # would cross other groups' links for no bandwidth gain)
        pair_has_double_link = (
            len(vals) == 2
            and self.topo.wrap[axis]
            and self.topo.dims[axis] == 2
        )
        for chip in g:
            nxt, prv = self._axis_neighbors(chip, axis, vals)
            if nxt == prv and not pair_has_double_link:
                out.append((chip, nxt, step_bytes, -1))
                continue
            # direction hints keep the two rotations on the two physical
            # link directions even when they reach the same chip
            out.append((chip, nxt, half, axis * 2 + 0))
            out.append((chip, prv, half, axis * 2 + 1))
        return out

    def _grid_sweep(
        self,
        g: list[int],
        order: list[tuple[int, list[int]]],
        start_bytes: float,
        mode: str,
    ) -> list[list[Transfer]]:
        """One part's phase list. ``mode``: "rs" (shrinking reduce-scatter
        sweep), "ag" (growing all-gather sweep), or "ar" (rs then mirrored
        ag)."""
        rs: list[list[Transfer]] = []
        cur = start_bytes
        for axis, vals in order:
            d = len(vals)
            chunk = cur / d
            for _ in range(d - 1):
                rs.append(self._grid_ring_step(g, axis, vals, chunk))
            cur = chunk
        if mode == "rs":
            return rs
        if mode == "ar":
            return rs + rs[::-1]
        # "ag": reversed axis order, chunk growing from the shard size
        ag: list[list[Transfer]] = []
        n = 1
        for _, vals in order:
            n *= len(vals)
        cur = start_bytes / n
        for axis, vals in reversed(order):
            d = len(vals)
            for _ in range(d - 1):
                ag.append(self._grid_ring_step(g, axis, vals, cur))
            cur *= d
        return ag

    def _snake_ring_phases(
        self, g: list[int], steps: int, step_bytes: float
    ) -> list[list[Transfer]]:
        ring = _snake_order(self.topo, g)
        n = len(ring)
        half = step_bytes / 2.0
        phase = []
        for idx, chip in enumerate(ring):
            phase.append((chip, ring[(idx + 1) % n], half))
            phase.append((chip, ring[(idx - 1) % n], half))
        return [list(phase) for _ in range(steps)]

    def _group_phases(
        self, g: list[int], kind: str, payload: float
    ) -> list[list[Transfer]]:
        n = len(g)
        axes = self._grid_axes(g)
        if axes:
            mode = {
                "all-reduce": "ar",
                "reduce-scatter": "rs",
                "all-gather": "ag",
                "collective-broadcast": "ag",
            }.get(kind, "ar")
            parts = len(axes)
            part_phases = [
                self._grid_sweep(
                    g, axes[p:] + axes[:p], payload / parts, mode
                )
                for p in range(parts)
            ]
            return _merge_phase_lists(part_phases)
        if kind in ("all-gather", "collective-broadcast", "reduce-scatter"):
            return self._snake_ring_phases(g, n - 1, payload / n)
        return self._snake_ring_phases(g, 2 * (n - 1), payload / n)

    def _phases_for(
        self, info: CollectiveInfo, payload: float
    ) -> list[list[Transfer]]:
        groups = self._groups(info)
        kind = info.kind
        if kind == "collective-permute":
            nc = self.topo.num_chips
            return [[
                (s % nc, t % nc, payload)
                for s, t in info.source_target_pairs if s != t
            ]]
        if not groups or payload <= 0:
            return []
        if kind in ("all-to-all", "ragged-all-to-all"):
            phase: list[Transfer] = []
            for g in groups:
                per = payload / len(g)
                for s in g:
                    for t in g:
                        if s != t:
                            phase.append((s, t, per))
            return [phase]
        return _merge_phase_lists(
            [self._group_phases(g, kind, payload) for g in groups]
        )

    def _aliases_chips(self, info: CollectiveInfo) -> bool:
        nc = self.topo.num_chips
        for g in info.replica_groups:
            if len({m % nc for m in g}) < len(set(g)):
                return True
        return False

    # -- dispatch ----------------------------------------------------------

    def seconds(self, info: CollectiveInfo, payload_bytes: float) -> float:
        if self._aliases_chips(info):
            # multi-slice groups (replica ids >= num_chips) fold distinct
            # replicas onto one chip under the mod mapping, producing
            # src==dst transfers the packet sim silently drops — the
            # collapsed group would understate intra-slice traffic.  Price
            # those with the analytic model, whose slice/DCN split handles
            # them explicitly.
            return self._analytic.seconds(info, payload_bytes)
        phases = self._phases_for(info, float(payload_bytes))
        if not phases:
            return self.cfg.launch_latency
        cycles = self.net.run_phases(
            phases, packet_bytes=self.cfg.packet_bytes
        )
        if self.obs is not None and getattr(self.obs, "enabled", False):
            self._record_link_occupancy(info, phases, cycles)
        t = self.cfg.launch_latency + cycles * NET_CYCLE_S
        n = max(info.group_size, 1)
        if 0 < self.cfg.chips_per_slice < n:
            # inter-slice portion still priced analytically (DCN is not an
            # ICI torus); take the slower of the two
            t = max(t, self._analytic.seconds(info, payload_bytes))
        return t

    def _record_link_occupancy(
        self, info: CollectiveInfo, phases, cycles: float
    ) -> None:
        """Feed the obs hub with per-PRICING-CALL link accounting: each
        transfer serializes ``bytes/flit_bytes`` cycles onto every
        directed link of its route, so summed link-busy over the touched
        links' cycle capacity is the schedule's achieved occupancy (the
        per-link view the analytic model's closed forms can't see).
        See the class docstring for the multiplicity caveat — only the
        busy/capacity ratio is meaningful, not the absolutes."""
        busy = 0.0
        faulted = self.net._faulted
        per_link: dict[int, float] = {}
        degraded_busy = 0.0
        for phase in phases:
            for tr in phase:
                src, dst, nbytes = int(tr[0]), int(tr[1]), float(tr[2])
                if src == dst or nbytes <= 0:
                    continue
                hint = int(tr[3]) if len(tr) > 3 else -1
                route = self.net._route(src, dst, hint)
                ser = nbytes / self.net.flit_bytes
                for lid in route:
                    if faulted:
                        scale = self.net._lid_scale(lid)
                        b = ser / scale
                        if scale < 1.0:
                            degraded_busy += b
                    else:
                        b = ser
                    busy += b
                    per_link[lid] = per_link.get(lid, 0.0) + b
        obs = self.obs
        obs.counter_add("ici.detailed.priced_collectives", 1)
        obs.counter_add(f"ici.detailed.priced_{info.kind}_count", 1)
        obs.counter_add("ici.detailed.link_busy_cycles", busy)
        obs.counter_add(
            "ici.detailed.link_cycle_capacity", len(per_link) * cycles
        )
        if faulted:
            # degraded-pod visibility: busy attributed to degraded links
            # plus the per-pricing-call worst link's occupancy (running
            # max across calls — the schedule's hottest surviving cable)
            obs.counter_add(
                "ici.detailed.degraded_link_busy_cycles", degraded_busy
            )
            worst = (
                max(per_link.values()) / cycles
                if per_link and cycles > 0 else 0.0
            )
            prev = getattr(obs, "counters", {}).get(
                "ici.detailed.worst_link_occupancy", 0.0
            )
            obs.counter_set(
                "ici.detailed.worst_link_occupancy", max(prev, worst)
            )


def make_collective_model(topo: Topology, cfg: "IciConfig", obs=None):
    """The ``icnt_wrapper_init`` equivalent: pick the network
    implementation by config (``-network_mode``)."""
    mode = getattr(cfg, "network_mode", "analytic")
    if mode == "detailed":
        return DetailedCollectiveModel(topo, cfg, obs=obs)
    if mode != "analytic":
        raise ValueError(
            f"unknown network_mode {mode!r} (analytic|detailed)"
        )
    return CollectiveModel(topo, cfg)

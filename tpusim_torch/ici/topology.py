"""ICI topologies: tori of 1-3 dimensions.

Port of ``tpusim/ici/topology.py``.

Models the physical chip meshes TPU pods are built from: v4/v5p slices are 3D
tori (wrap-around links on axes of length >= some threshold; smaller slices
are meshes), v5e/v6e slices are 2D tori up to 16x16.  This replaces the
reference's BookSim topology zoo (``src/intersim2/networks/``) with the two
shapes TPUs actually use, while keeping the narrow-interface idea of
``icnt_wrapper.h:36-64`` — the collective model only asks a topology for
axis lengths, wrap-ness, and hop distances.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Iterator

__all__ = ["Topology", "torus_for"]


@dataclass(frozen=True)
class Topology:
    """An N-dimensional (1..3) torus/mesh of chips.

    ``faults`` optionally carries a fault view (attached via
    :meth:`with_faults`); the link-liveness queries below forward to it
    and are trivially True/1.0 on a healthy topology, so fault awareness
    costs the healthy path nothing.  Excluded from eq/hash: a faulted
    topology is the same *shape*.  The views come from a fault schedule
    bound to this topology
    (:meth:`tpusim_torch.faults.FaultState.view_at`)."""

    dims: tuple[int, ...]            # e.g. (4, 4, 4) for v5p-128 (64 chips)
    wrap: tuple[bool, ...]           # per-axis wraparound links present?
    faults: object | None = field(default=None, compare=False)

    def __post_init__(self):
        if len(self.dims) != len(self.wrap):
            raise ValueError("dims and wrap must have equal length")

    @property
    def num_chips(self) -> int:
        return math.prod(self.dims)

    @property
    def ndims(self) -> int:
        return len(self.dims)

    def coords(self, chip: int) -> tuple[int, ...]:
        out = []
        for d in self.dims:
            out.append(chip % d)
            chip //= d
        return tuple(out)

    def chip_at(self, coords: tuple[int, ...]) -> int:
        idx = 0
        stride = 1
        for c, d in zip(coords, self.dims):
            idx += (c % d) * stride
            stride *= d
        return idx

    def hop_distance(self, a: int, b: int) -> int:
        """Shortest-path hops between two chips."""
        ca, cb = self.coords(a), self.coords(b)
        total = 0
        for x, y, d, w in zip(ca, cb, self.dims, self.wrap):
            delta = abs(x - y)
            total += min(delta, d - delta) if w else delta
        return total

    def axis_ring_length(self, axis: int) -> int:
        return self.dims[axis]

    def axis_is_ring(self, axis: int) -> bool:
        """True if the axis supports a wraparound ring (torus links)."""
        return self.wrap[axis] and self.dims[axis] >= 2

    @property
    def links_per_chip(self) -> int:
        """Usable ICI links per chip (2 per axis on a torus axis, fewer on
        mesh edges — reported as the interior count)."""
        return sum(2 if d > 1 else 0 for d in self.dims)

    def bisection_links(self) -> int:
        """Links crossing a bisection of the longest axis (for all-to-all)."""
        if self.num_chips <= 1:
            return 1
        longest = max(range(self.ndims), key=lambda i: self.dims[i])
        other = self.num_chips // self.dims[longest]
        per_cut = other * (2 if self.wrap[longest] else 1)
        return max(per_cut, 1)

    # -- link enumeration / liveness ---------------------------------------

    def neighbor(self, chip: int, axis: int, direction: int) -> int | None:
        """Chip one hop from ``chip`` along ``axis`` (direction 0 = +1,
        1 = -1); None at a mesh edge without a wrap link."""
        c = list(self.coords(chip))
        step = 1 if direction == 0 else -1
        nxt = c[axis] + step
        if not self.wrap[axis] and not 0 <= nxt < self.dims[axis]:
            return None
        c[axis] = nxt % self.dims[axis]
        return self.chip_at(tuple(c))

    def directed_links(self) -> Iterator[tuple[int, int, int, int]]:
        """Every directed ICI link as ``(src, dst, axis, direction)``.
        A wrapped length-2 axis yields both directions between the same
        chip pair — two physical cables, like real v5p wiring."""
        for chip in range(self.num_chips):
            for axis in range(self.ndims):
                if self.dims[axis] <= 1:
                    continue
                for direction in (0, 1):
                    dst = self.neighbor(chip, axis, direction)
                    if dst is not None:
                        yield (chip, dst, axis, direction)

    def undirected_links(self) -> list[tuple[int, int]]:
        """Unique chip pairs carrying at least one link (the sweep grain
        of the fault sweeps)."""
        seen: set[tuple[int, int]] = set()
        for src, dst, _, _ in self.directed_links():
            seen.add((min(src, dst), max(src, dst)))
        return sorted(seen)

    def with_faults(self, view) -> "Topology":
        """This topology shape with a fault view attached (None clears)."""
        return dataclasses.replace(self, faults=view)

    @property
    def has_faults(self) -> bool:
        return self.faults is not None

    def link_alive(self, src: int, dst: int) -> bool:
        """Is the directed link ``src -> dst`` up?  (True when no fault
        view is attached — the healthy default.)"""
        return self.faults is None or self.faults.link_alive(src, dst)

    def link_scale(self, src: int, dst: int) -> float:
        """Bandwidth multiplier of the directed link (1.0 = healthy)."""
        return 1.0 if self.faults is None else self.faults.link_scale(src, dst)

    def axis_ring_intact(self, axis: int) -> bool:
        """Can the counter-rotating ring schedule still run on ``axis``?
        Any dead link along the axis breaks the ring (traffic must
        route around), so the schedule math falls back to mesh terms."""
        if not self.wrap[axis]:
            return False
        return (
            self.faults is None
            or axis not in self.faults.broken_axes
        )


def torus_for(num_chips: int, generation: str = "v5p") -> Topology:
    """Build the default slice topology for ``num_chips`` of a generation.

    v4/v5p: 3D torus (cube-ish factorization; axes of length >= 4 get wrap
    links, matching how full cube slices are wired).  v5e/v6e: 2D torus up
    to 16x16.  Single chip: trivial topology.
    """
    if num_chips <= 1:
        return Topology(dims=(1,), wrap=(False,))
    gen = generation.lower()
    if gen in ("v5e", "v6e"):
        dims2 = _factor(num_chips, 2)
        wrap2 = tuple(d >= 4 for d in dims2)
        return Topology(dims=dims2, wrap=wrap2)
    dims3 = _factor(num_chips, 3)
    wrap3 = tuple(d >= 4 for d in dims3)
    return Topology(dims=dims3, wrap=wrap3)


def _factor(n: int, ndims: int) -> tuple[int, ...]:
    """Factor ``n`` into ``ndims`` near-equal factors (largest last)."""
    dims = [1] * ndims
    remaining = n
    for i in range(ndims - 1):
        target = round(remaining ** (1.0 / (ndims - i)))
        f = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        dims[i] = f
        remaining //= f
    dims[-1] = remaining
    return tuple(sorted(dims))

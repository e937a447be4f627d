"""Deterministic fault schedules for degraded-pod simulation.

Port of ``tpusim/faults/schedule.py`` (pure Python; the names are the
reference's, so a reader can find each counterpart).

Real TPU pods run degraded: ICI links die and traffic routes around them,
individual chips straggle under thermal throttling, and HBM channels get
derated.  This module is the schedule half of ``tpusim_torch.faults``: a
JSON format describing WHAT is broken and WHEN, loaded and validated up
front so a sweep of hundreds of scenarios cannot die mid-run on a typo.

Schedule document::

    {"faults": [
        {"kind": "link_down",      "src": [2,3,0], "dst": [3,3,0]},
        {"kind": "link_degraded",  "src": 0, "dst": 1, "bandwidth_scale": 0.5},
        {"kind": "chip_straggler", "chip": [1,1,0], "clock_scale": 0.8},
        {"kind": "hbm_throttle",   "chip": 5, "hbm_scale": 0.6,
         "start_cycle": 0, "end_cycle": 1e9},
        {"kind": "dcn_link_down",  "slice": 1},
        {"kind": "dcn_link_degraded", "slice": 0, "bandwidth_scale": 0.5},
        {"kind": "slice_down",     "slice": 1}
    ]}

Chips and link endpoints are either flat chip ids or coordinate lists;
link faults hit both directions unless ``"directed": true``.  DCN fault
kinds (``dcn_link_down`` = one NIC lost, ``dcn_link_degraded`` = a
slice's spine bandwidth derated, ``slice_down`` = the whole slice's DCN
reachability gone) target a TPU *slice* index instead of a chip — they
only change pricing when a DCN fabric is modeled
(:mod:`tpusim_torch.dcn`).  All scale multipliers are in ``(0, 1]`` (1.0
= healthy); windows are half-open ``[start_cycle, end_cycle)`` in device
cycles, defaulting to the whole run.  The machine-checked contract lives
in ``ci/faults_schema.json``.

Three layers:

* :class:`FaultSchedule` — the parsed, topology-independent document;
* :class:`FaultState` — a schedule bound to one :class:`Topology`
  (endpoints resolved to chip ids, adjacency checked);
* :class:`FaultView` — the static snapshot active at one cycle, the
  object the ICI/timing layers actually query (``link_alive``,
  ``link_scale``, ``chip_scales``).  Attached to a topology via
  ``Topology.with_faults(view)``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "FAULT_KINDS",
    "Fault",
    "FaultSchedule",
    "FaultScheduleError",
    "FaultState",
    "FaultView",
    "TopologyPartitionedError",
    "load_fault_schedule",
]

#: kind -> the scale field its JSON record carries (None = no scale)
FAULT_KINDS = {
    "link_down": None,
    "link_degraded": "bandwidth_scale",
    "chip_straggler": "clock_scale",
    "hbm_throttle": "hbm_scale",
    "dcn_link_down": None,
    "dcn_link_degraded": "bandwidth_scale",
    "slice_down": None,
}

_LINK_KINDS = ("link_down", "link_degraded")
_DCN_KINDS = ("dcn_link_down", "dcn_link_degraded", "slice_down")


class FaultScheduleError(ValueError):
    """A fault schedule failed validation (format or topology binding)."""


class TopologyPartitionedError(RuntimeError):
    """Dead links disconnect two chips that must communicate."""


@dataclass(frozen=True)
class Fault:
    """One validated fault record (endpoints still in document form:
    ints or coordinate tuples — :meth:`FaultSchedule.bind` resolves
    them against a concrete topology)."""

    kind: str
    src: object = None          # link endpoint (chip id or coords)
    dst: object = None
    chip: object = None         # chip faults
    slice: object = None        # DCN faults target a TPU slice index
    scale: float = 1.0          # bandwidth/clock/HBM multiplier
    start_cycle: float = 0.0
    end_cycle: float = math.inf
    directed: bool = False

    def active_at(self, cycle: float) -> bool:
        return self.start_cycle <= cycle < self.end_cycle

    def overlaps(self, other: "Fault") -> bool:
        """Do the two half-open activation windows intersect?"""
        return (
            self.start_cycle < other.end_cycle
            and other.start_cycle < self.end_cycle
        )

    @property
    def windowed(self) -> bool:
        return self.start_cycle > 0.0 or math.isfinite(self.end_cycle)


def _parse_fault(i: int, rec: dict) -> Fault:
    if not isinstance(rec, dict):
        raise FaultScheduleError(f"fault[{i}]: not an object: {rec!r}")
    kind = rec.get("kind")
    if kind not in FAULT_KINDS:
        raise FaultScheduleError(
            f"fault[{i}]: unknown kind {kind!r} "
            f"(valid: {sorted(FAULT_KINDS)})"
        )
    known = {"kind", "start_cycle", "end_cycle"}
    scale = 1.0
    scale_key = FAULT_KINDS[kind]
    if scale_key is not None:
        known.add(scale_key)
        if scale_key not in rec:
            raise FaultScheduleError(
                f"fault[{i}]: {kind} requires {scale_key!r}"
            )
        scale = rec[scale_key]
        if not isinstance(scale, (int, float)) or not 0.0 < scale <= 1.0:
            raise FaultScheduleError(
                f"fault[{i}]: {scale_key} must be in (0, 1], "
                f"got {scale!r}"
            )
    src = dst = chip = slice_ = None
    if kind in _LINK_KINDS:
        known.update(("src", "dst", "directed"))
        for k in ("src", "dst"):
            if k not in rec:
                raise FaultScheduleError(f"fault[{i}]: {kind} requires {k!r}")
        src, dst = _parse_endpoint(i, "src", rec["src"]), \
            _parse_endpoint(i, "dst", rec["dst"])
    elif kind in _DCN_KINDS:
        known.add("slice")
        if "slice" not in rec:
            raise FaultScheduleError(f"fault[{i}]: {kind} requires 'slice'")
        slice_ = rec["slice"]
        if not isinstance(slice_, int) or isinstance(slice_, bool) \
                or slice_ < 0:
            raise FaultScheduleError(
                f"fault[{i}]: slice must be a non-negative integer, "
                f"got {slice_!r}"
            )
    else:
        known.add("chip")
        if "chip" not in rec:
            raise FaultScheduleError(f"fault[{i}]: {kind} requires 'chip'")
        chip = _parse_endpoint(i, "chip", rec["chip"])
    start = rec.get("start_cycle", 0.0)
    end = rec.get("end_cycle", math.inf)
    for k, v in (("start_cycle", start), ("end_cycle", end)):
        if not isinstance(v, (int, float)) or v < 0:
            raise FaultScheduleError(
                f"fault[{i}]: {k} must be a non-negative number, got {v!r}"
            )
    if end <= start:
        raise FaultScheduleError(
            f"fault[{i}]: empty window [{start}, {end})"
        )
    extra = set(rec) - known
    if extra:
        raise FaultScheduleError(
            f"fault[{i}]: unknown field(s) {sorted(extra)} for {kind}"
        )
    return Fault(
        kind=kind, src=src, dst=dst, chip=chip, slice=slice_,
        scale=float(scale),
        start_cycle=float(start), end_cycle=float(end),
        directed=bool(rec.get("directed", False)),
    )


def _parse_endpoint(i: int, name: str, v: object):
    if isinstance(v, bool):
        raise FaultScheduleError(f"fault[{i}]: {name} must be a chip, not bool")
    if isinstance(v, int):
        if v < 0:
            raise FaultScheduleError(f"fault[{i}]: {name} chip id {v} < 0")
        return v
    if isinstance(v, (list, tuple)) and all(
        isinstance(x, int) and not isinstance(x, bool) and x >= 0 for x in v
    ) and v:
        return tuple(v)
    raise FaultScheduleError(
        f"fault[{i}]: {name} must be a chip id or coordinate list, "
        f"got {v!r}"
    )


@dataclass(frozen=True)
class FaultSchedule:
    """A validated, topology-independent fault schedule."""

    faults: tuple[Fault, ...] = ()

    @property
    def windowed(self) -> bool:
        return any(f.windowed for f in self.faults)

    def bind(self, topo) -> "FaultState":
        """Resolve endpoints against ``topo`` and adjacency-check link
        faults; raises :class:`FaultScheduleError` on any mismatch."""
        return FaultState(self, topo)

    def to_doc(self) -> dict:
        """Round-trip back to the JSON document form."""
        out = []
        for f in self.faults:
            rec: dict = {"kind": f.kind}
            if f.kind in _LINK_KINDS:
                rec["src"] = list(f.src) if isinstance(f.src, tuple) else f.src
                rec["dst"] = list(f.dst) if isinstance(f.dst, tuple) else f.dst
                if f.directed:
                    rec["directed"] = True
            elif f.kind in _DCN_KINDS:
                rec["slice"] = f.slice
            else:
                rec["chip"] = (
                    list(f.chip) if isinstance(f.chip, tuple) else f.chip
                )
            key = FAULT_KINDS[f.kind]
            if key is not None:
                rec[key] = f.scale
            if f.start_cycle > 0.0:
                rec["start_cycle"] = f.start_cycle
            if math.isfinite(f.end_cycle):
                rec["end_cycle"] = f.end_cycle
            out.append(rec)
        return {"faults": out}


def load_fault_schedule(src) -> FaultSchedule:
    """Load and validate a schedule from a path, JSON text, or dict."""
    if isinstance(src, FaultSchedule):
        return src
    if isinstance(src, (str, Path)) and not (
        isinstance(src, str) and src.lstrip().startswith("{")
    ):
        p = Path(src)
        if not p.is_file():
            raise FaultScheduleError(f"fault schedule not found: {p}")
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise FaultScheduleError(f"{p}: invalid JSON: {e}") from e
    elif isinstance(src, str):
        try:
            doc = json.loads(src)
        except json.JSONDecodeError as e:
            raise FaultScheduleError(f"invalid schedule JSON: {e}") from e
    else:
        doc = src
    if not isinstance(doc, dict) or "faults" not in doc:
        raise FaultScheduleError(
            "schedule document must be an object with a 'faults' list"
        )
    recs = doc["faults"]
    if not isinstance(recs, list):
        raise FaultScheduleError("'faults' must be a list")
    return FaultSchedule(
        faults=tuple(_parse_fault(i, r) for i, r in enumerate(recs))
    )


# ---------------------------------------------------------------------------
# topology binding
# ---------------------------------------------------------------------------


def _resolve_chip(topo, i: int, name: str, v) -> int:
    if isinstance(v, tuple):
        if len(v) != topo.ndims:
            raise FaultScheduleError(
                f"fault[{i}]: {name} coords {list(v)} have {len(v)} dims; "
                f"topology is {topo.ndims}D {list(topo.dims)}"
            )
        for x, d in zip(v, topo.dims):
            if x >= d:
                raise FaultScheduleError(
                    f"fault[{i}]: {name} coords {list(v)} out of range for "
                    f"dims {list(topo.dims)}"
                )
        return topo.chip_at(v)
    if v >= topo.num_chips:
        raise FaultScheduleError(
            f"fault[{i}]: {name} chip {v} out of range "
            f"(topology has {topo.num_chips} chips)"
        )
    return int(v)


@dataclass
class FaultState:
    """A schedule bound to one topology: endpoints resolved to chip ids,
    link adjacency checked.  :meth:`view_at` returns the (cached)
    :class:`FaultView` active at a given cycle."""

    schedule: FaultSchedule
    topo: object
    _bound: list = field(default_factory=list, repr=False)
    _views: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        topo = self.topo
        for i, f in enumerate(self.schedule.faults):
            if f.kind in _LINK_KINDS:
                a = _resolve_chip(topo, i, "src", f.src)
                b = _resolve_chip(topo, i, "dst", f.dst)
                if a == b:
                    raise FaultScheduleError(
                        f"fault[{i}]: src and dst are the same chip {a}"
                    )
                if topo.hop_distance(a, b) != 1:
                    raise FaultScheduleError(
                        f"fault[{i}]: no ICI link between chip {a} "
                        f"{list(topo.coords(a))} and chip {b} "
                        f"{list(topo.coords(b))} (not torus neighbors)"
                    )
                self._bound.append((f, (a, b)))
            elif f.kind in _DCN_KINDS:
                # slice indices bind as-is: the ICI topology does not
                # know the slice count
                self._bound.append((f, int(f.slice)))
            else:
                c = _resolve_chip(topo, i, "chip", f.chip)
                self._bound.append((f, c))

    @property
    def windowed(self) -> bool:
        return self.schedule.windowed

    def bound_faults(self) -> list[tuple["Fault", object]]:
        """Every fault with its resolved target: ``(fault, (src, dst))``
        for link kinds, ``(fault, chip)`` for chip kinds — the contract
        the static analyzer's overlap pass works from."""
        return list(self._bound)

    def intervals(self) -> list[tuple[float, float]]:
        """Per-fault ``[start_cycle, end_cycle)`` activation windows."""
        return [
            (f.start_cycle, f.end_cycle) for f, _ in self._bound
        ]

    def full_view(self) -> "FaultView":
        """A view over EVERY bound fault regardless of window — the
        schedule-shape summary the driver stamps into ``faults_*``
        stats."""
        return FaultView.build(self.topo, list(self._bound))

    def view_at(self, cycle: float) -> "FaultView":
        """The static fault snapshot active at ``cycle`` (cached per
        distinct active set, so unwindowed schedules build one view)."""
        key = tuple(
            i for i, (f, _) in enumerate(self._bound) if f.active_at(cycle)
        )
        view = self._views.get(key)
        if view is None:
            view = FaultView.build(
                self.topo, [self._bound[i] for i in key]
            )
            self._views[key] = view
        return view


class FaultView:
    """The static fault set the ICI/timing layers query.  Built once per
    distinct active set; all queries are O(1) dict/set lookups."""

    __slots__ = (
        "dead", "scales", "chip_clock", "chip_hbm", "broken_axes",
        "axis_min_scale", "num_active", "signature", "min_link_scale",
        "dcn_nics_down", "dcn_scales", "slices_down",
    )

    @classmethod
    def build(cls, topo, bound: list) -> "FaultView":
        self = cls()
        dead: set[tuple[int, int]] = set()
        # overlapping same-resource faults stack MULTIPLICATIVELY, and the
        # product is taken in sorted-scale order: float multiplication is
        # commutative but not associative, so three 0.x scales composed in
        # schedule-file order can differ in the last ulp from the same
        # faults listed in another order.  Generated schedules (the
        # Monte-Carlo campaign sampler) must price identically however
        # their records happen to be emitted, so factors are collected
        # per resource and reduced deterministically.
        link_factors: dict[tuple[int, int], list[float]] = {}
        clock_factors: dict[int, list[float]] = {}
        hbm_factors: dict[int, list[float]] = {}
        nics_down: dict[int, int] = {}
        dcn_factors: dict[int, list[float]] = {}
        slices_down: set[int] = set()
        for f, where in bound:
            if f.kind == "link_down":
                a, b = where
                dead.add((a, b))
                if not f.directed:
                    dead.add((b, a))
            elif f.kind == "link_degraded":
                a, b = where
                pairs = [(a, b)] if f.directed else [(a, b), (b, a)]
                for p in pairs:
                    link_factors.setdefault(p, []).append(f.scale)
            elif f.kind == "chip_straggler":
                clock_factors.setdefault(where, []).append(f.scale)
            elif f.kind == "hbm_throttle":
                hbm_factors.setdefault(where, []).append(f.scale)
            elif f.kind == "dcn_link_down":
                nics_down[where] = nics_down.get(where, 0) + 1
            elif f.kind == "dcn_link_degraded":
                dcn_factors.setdefault(where, []).append(f.scale)
            elif f.kind == "slice_down":
                slices_down.add(where)

        def _reduce(factors: dict) -> dict:
            out = {}
            for k, fs in factors.items():
                prod = 1.0
                for s in sorted(fs):
                    prod *= s
                out[k] = prod
            return out

        scales = _reduce(link_factors)
        chip_clock = _reduce(clock_factors)
        chip_hbm = _reduce(hbm_factors)
        self.dead = frozenset(dead)
        self.scales = scales
        self.chip_clock = chip_clock
        self.chip_hbm = chip_hbm
        self.dcn_nics_down = nics_down
        self.dcn_scales = _reduce(dcn_factors)
        self.slices_down = frozenset(slices_down)
        self.num_active = len(bound)
        self.signature = (
            self.dead,
            tuple(sorted(scales.items())),
            tuple(sorted(chip_clock.items())),
            tuple(sorted(chip_hbm.items())),
            tuple(sorted(nics_down.items())),
            tuple(sorted(self.dcn_scales.items())),
            self.slices_down,
        )
        # per-axis degradation summary for the analytic schedules: an
        # axis with ANY dead link cannot run the counter-rotating ring
        # (torus -> mesh bandwidth fallback); degraded links bottleneck
        # the axis at their worst scale
        broken: set[int] = set()
        axis_min: dict[int, float] = {}
        for (a, b) in dead | set(scales):
            ca, cb = topo.coords(a), topo.coords(b)
            axis = next(
                (ax for ax in range(topo.ndims) if ca[ax] != cb[ax]), 0
            )
            if (a, b) in dead:
                broken.add(axis)
            s = scales.get((a, b))
            if s is not None:
                axis_min[axis] = min(axis_min.get(axis, 1.0), s)
        self.broken_axes = frozenset(broken)
        self.axis_min_scale = axis_min
        self.min_link_scale = (
            0.0 if dead else min(scales.values(), default=1.0)
        )
        return self

    # -- queries (the contract topology.py forwards to) --------------------

    def link_alive(self, src: int, dst: int) -> bool:
        return (src, dst) not in self.dead

    def link_scale(self, src: int, dst: int) -> float:
        return self.scales.get((src, dst), 1.0)

    def chip_scales(self, chip: int) -> tuple[float, float]:
        """(clock multiplier, HBM multiplier) for one chip."""
        return (
            self.chip_clock.get(chip, 1.0), self.chip_hbm.get(chip, 1.0)
        )

    @property
    def links_down(self) -> int:
        """Dead DIRECTED link count."""
        return len(self.dead)

    @property
    def links_degraded(self) -> int:
        return len(self.scales)

    @property
    def chips_degraded(self) -> int:
        return len(set(self.chip_clock) | set(self.chip_hbm))

    def stats_dict(self) -> dict[str, float]:
        """The ``faults_*`` stat keys a driver stamps when a schedule is
        active (never emitted on the healthy path, so healthy reports
        keep their keys).  DCN keys ride along only when a DCN fault is
        bound, so pre-fabric schedules keep their exact byte shape."""
        out = {
            "faults_active": self.num_active,
            "faults_links_down": self.links_down,
            "faults_links_degraded": self.links_degraded,
            "faults_chips_degraded": self.chips_degraded,
            "faults_min_link_scale": self.min_link_scale,
        }
        if self.dcn_nics_down or self.dcn_scales or self.slices_down:
            out["faults_dcn_links_down"] = sum(
                self.dcn_nics_down.values()
            )
            out["faults_dcn_links_degraded"] = len(self.dcn_scales)
            out["faults_slices_down"] = len(self.slices_down)
        return out

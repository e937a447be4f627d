"""Cycle-window activity sampler — the AerialVision analogue.

Port of ``tpusim/obs/sampler.py``; the float order of every add is the
reference's, so the windows are equal by bytes.

The reference samples its counters every ``gpu_stat_sample_freq`` cycles
into gzip'd visualizer logs (``gpu-sim.cc:2042+``,
``src/gpgpu-sim/visualizer.cc``).  tpusim's engine feeds this sampler
**per op** as the schedule walk prices each instruction: busy cycles per
unit (MXU/VPU/DMA/ICI/...), HBM/vmem traffic, flops, and ICI bytes land
in fixed cycle windows, proportionally split when an event spans a
window boundary.

Two properties the timeline-derived :mod:`tpusim_torch.sim.interval` view
lacks:

* **loop bodies are visible** — the engine merges a while body's series
  back into the parent at every trip offset (tiled exactly when cheap,
  uniformly smeared when the trip count makes tiling quadratic), where
  the timeline records one opaque ``while`` event;
* **traffic, not just occupancy** — windows carry bytes and flops, so
  the export can derive HBM GB/s and watts per window, not only
  utilization.

Auto-windowing: with ``window_cycles <= 0`` the sampler starts at a fine
window and doubles it (merging neighbor bins) whenever the bin count
would exceed ``max_windows`` — any run length ends up with between
``max_windows/2`` and ``max_windows`` windows without knowing the total
in advance.
"""

from __future__ import annotations

__all__ = ["CycleWindowSampler", "WindowBin"]

#: traffic fields a bin accumulates (busy cycles are per-unit, separate)
_TRAFFIC = (
    "hbm_bytes", "vmem_bytes", "flops", "mxu_flops",
    "transcendentals", "ici_bytes",
)


class WindowBin:
    """One cycle window's accumulated activity."""

    __slots__ = ("busy", "op_count") + _TRAFFIC

    def __init__(self):
        self.busy: dict[str, float] = {}
        self.op_count = 0.0
        self.hbm_bytes = 0.0
        self.vmem_bytes = 0.0
        self.flops = 0.0
        self.mxu_flops = 0.0
        self.transcendentals = 0.0
        self.ici_bytes = 0.0

    def _merge_scaled(self, other: "WindowBin", frac: float) -> None:
        for u, b in other.busy.items():
            self.busy[u] = self.busy.get(u, 0.0) + b * frac
        self.op_count += other.op_count * frac
        for f in _TRAFFIC:
            setattr(self, f, getattr(self, f) + getattr(other, f) * frac)

    def is_empty(self) -> bool:
        return (
            not self.busy and self.op_count == 0.0
            and all(getattr(self, f) == 0.0 for f in _TRAFFIC)
        )

    def to_dict(self) -> dict:
        d = {"busy": dict(self.busy), "op_count": self.op_count}
        for f in _TRAFFIC:
            d[f] = getattr(self, f)
        return d


class CycleWindowSampler:
    """Buckets per-op activity into fixed cycle windows.

    ``window_cycles > 0`` pins the window (the ``--obs-window-cycles``
    flag / ``stat_sample_cycles`` analogue); ``<= 0`` means auto.  Either
    way the bin count stays bounded by ``max_windows`` via coarsening —
    ``window_cycles`` reports the *effective* window after any doubling.
    """

    __slots__ = ("window_cycles", "pinned", "max_windows", "coarsenings",
                 "_bins")

    #: auto mode's starting window (cycles); ~1µs at 1GHz
    AUTO_INITIAL_WINDOW = 1024.0
    #: bin-count cap in auto mode (fine→coarse is the design)
    AUTO_MAX_WINDOWS = 4096
    #: bin-count cap for a PINNED window: honored up to this memory-
    #: safety bound (~a few hundred MB of bins); beyond it the window
    #: still doubles, with ``coarsenings`` recording the betrayal so
    #: callers can warn
    PINNED_MAX_WINDOWS = 262_144
    #: budget for exact loop-body tiling in :meth:`add_series`
    _TILE_BUDGET = 65536

    def __init__(
        self, window_cycles: float = 0.0, max_windows: int | None = None
    ):
        self.pinned = window_cycles > 0
        if max_windows is None:
            max_windows = (
                self.PINNED_MAX_WINDOWS if self.pinned
                else self.AUTO_MAX_WINDOWS
            )
        if max_windows < 2:
            raise ValueError("max_windows must be >= 2")
        self.window_cycles = (
            float(window_cycles) if self.pinned else self.AUTO_INITIAL_WINDOW
        )
        self.max_windows = int(max_windows)
        self.coarsenings = 0
        self._bins: list[WindowBin] = []

    # -- core accumulation ---------------------------------------------------

    def _bin_for(self, idx: int) -> WindowBin:
        bins = self._bins
        if idx >= len(bins):
            bins.extend(WindowBin() for _ in range(idx + 1 - len(bins)))
        return bins[idx]

    def _ensure_capacity(self, end_cycle: float) -> None:
        while end_cycle / self.window_cycles > self.max_windows:
            self._coarsen()

    def _coarsen(self) -> None:
        """Double the window, merging neighbor bins — totals preserved."""
        old = self._bins
        merged: list[WindowBin] = []
        for i in range(0, len(old), 2):
            b = old[i]
            if i + 1 < len(old):
                b._merge_scaled(old[i + 1], 1.0)
            merged.append(b)
        self._bins = merged
        self.window_cycles *= 2.0
        self.coarsenings += 1

    def add(
        self,
        unit: str,
        start: float,
        end: float,
        *,
        hbm_bytes: float = 0.0,
        vmem_bytes: float = 0.0,
        flops: float = 0.0,
        mxu_flops: float = 0.0,
        transcendentals: float = 0.0,
        ici_bytes: float = 0.0,
        op_count: float = 1.0,
    ) -> None:
        """Record one event.  Busy cycles and traffic are split across the
        overlapped windows proportionally; a zero-cycle event still lands
        its op count and traffic in the window containing ``start``."""
        if end < start:
            start, end = end, start
        if start < 0:
            start = 0.0
        self._ensure_capacity(max(end, start + self.window_cycles))
        w = self.window_cycles
        dur = end - start
        if dur <= 0:
            b = self._bin_for(int(start // w))
            b.op_count += op_count
            b.hbm_bytes += hbm_bytes
            b.vmem_bytes += vmem_bytes
            b.flops += flops
            b.mxu_flops += mxu_flops
            b.transcendentals += transcendentals
            b.ici_bytes += ici_bytes
            return
        first = int(start // w)
        last = int(end // w)
        if last * w >= end:  # exactly on a boundary: no phantom window
            last = max(last - 1, first)
        self._bin_for(last)  # grow once
        for i in range(first, last + 1):
            w0, w1 = i * w, (i + 1) * w
            overlap = min(end, w1) - max(start, w0)
            if overlap <= 0:
                continue
            frac = overlap / dur
            b = self._bins[i]
            b.busy[unit] = b.busy.get(unit, 0.0) + overlap
            b.op_count += op_count * frac
            b.hbm_bytes += hbm_bytes * frac
            b.vmem_bytes += vmem_bytes * frac
            b.flops += flops * frac
            b.mxu_flops += mxu_flops * frac
            b.transcendentals += transcendentals * frac
            b.ici_bytes += ici_bytes * frac

    # -- series composition --------------------------------------------------

    def _add_bin_span(
        self, t0: float, t1: float, src: WindowBin, scale: float
    ) -> None:
        """Distribute ``src`` (scaled) over [t0, t1) proportionally."""
        if t1 <= t0:
            return
        self._ensure_capacity(t1)
        w = self.window_cycles
        dur = t1 - t0
        first = int(t0 // w)
        last = int(t1 // w)
        if last * w >= t1:  # exactly on a boundary: no phantom window
            last = max(last - 1, first)
        self._bin_for(last)
        for i in range(first, last + 1):
            overlap = min(t1, (i + 1) * w) - max(t0, i * w)
            if overlap > 0:
                self._bins[i]._merge_scaled(src, scale * overlap / dur)

    def add_series(
        self,
        other: "CycleWindowSampler",
        offset: float,
        repeats: int = 1,
        period: float | None = None,
        length: float | None = None,
    ) -> None:
        """Fold another sampler's series in at ``offset`` — the pod
        assembly step (each kernel's module series at its launch cycle)
        and the loop-body step (``repeats`` copies, one per trip, each
        ``period`` cycles apart).

        ``length`` is the source series' TRUE duration (a while body's
        end cycle): the source's last bin is window-quantized, so without
        the clamp a 50-cycle body sampled at a 1024-cycle window would
        smear each trip's activity ~20x past where it happened — and past
        the end of the program for the last trip.

        Exact tiling is O(repeats × bins); past ``_TILE_BUDGET`` the body
        is uniformly smeared over the full span instead — totals are
        identical, intra-body structure is traded for boundedness."""
        src = other._bins
        n = len(src)
        if n == 0 or repeats <= 0:
            return
        ow = other.window_cycles
        if length is None or length <= 0:
            length = n * ow
        if period is None:
            period = length
        if repeats * n <= self._TILE_BUDGET:
            for k in range(repeats):
                base = offset + k * period
                for i, b in enumerate(src):
                    if b.is_empty():
                        continue
                    # clamp the bin's span to the true series length;
                    # a bin somehow past it keeps its own span
                    t0 = i * ow
                    t1 = min((i + 1) * ow, length)
                    if t1 <= t0:
                        t1 = (i + 1) * ow
                    self._add_bin_span(base + t0, base + t1, b, 1.0)
            return
        # smear: one aggregate over [offset, offset + (R-1)*period + length)
        agg = WindowBin()
        for b in src:
            agg._merge_scaled(b, 1.0)
        self._add_bin_span(
            offset, offset + (repeats - 1) * period + length, agg,
            float(repeats),
        )

    # -- views ---------------------------------------------------------------

    @property
    def num_windows(self) -> int:
        return len(self._bins)

    @property
    def end_cycle(self) -> float:
        return len(self._bins) * self.window_cycles

    def bins(self) -> list[WindowBin]:
        return self._bins

    def total(self, field: str) -> float:
        if field == "op_count":
            return sum(b.op_count for b in self._bins)
        return sum(getattr(b, field) for b in self._bins)

    def total_busy(self, unit: str) -> float:
        return sum(b.busy.get(unit, 0.0) for b in self._bins)

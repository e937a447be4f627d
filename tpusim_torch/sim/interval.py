"""Interval-sampled statistics — the per-window time series the reference
emits every ``gpu_stat_sample_freq`` cycles for AerialVision
(``gpu-sim.cc:2042+`` sampling, ``src/gpgpu-sim/visualizer.cc`` gzip'd
``gpgpusim_visualizer__*.log.gz`` writers, viewer ``aerialvision/``).

Port of ``tpusim/sim/interval.py``.  The series is derived from the
engine's recorded timeline: each ``stat_sample_cycles`` window gets
per-unit busy cycles, op counts, and utilization.  Output is a gzip'd JSONL log (one sample per line — the
visualizer-log analogue) and a terminal time-lapse heat view
(``python -m tpusim_torch aerial``) in place of the bespoke matplotlib GUI.
"""

from __future__ import annotations

import gzip
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.timing.engine import EngineResult

__all__ = [
    "IntervalSample",
    "sample_intervals",
    "write_interval_log",
    "read_interval_log",
    "render_text_lanes",
    "render_scalar_lane",
]


@dataclass
class IntervalSample:
    """One ``stat_sample_cycles`` window."""

    t0: float
    t1: float
    unit_busy: dict[str, float] = field(default_factory=dict)
    op_count: int = 0

    def utilization(self, unit: str) -> float:
        span = self.t1 - self.t0
        return self.unit_busy.get(unit, 0.0) / span if span > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "t0": self.t0,
            "t1": self.t1,
            "unit_busy": self.unit_busy,
            "op_count": self.op_count,
        }


def sample_intervals(
    result: EngineResult,
    sample_cycles: float,
    offset: float = 0.0,
) -> list[IntervalSample]:
    """Bucket a recorded timeline into fixed windows.

    An event spanning several windows contributes proportionally to each
    (the busy-cycle accounting the reference does at sample boundaries).
    ``offset`` shifts event times (e.g. a kernel's start cycle within a
    multi-kernel replay).
    """
    if sample_cycles <= 0:
        raise ValueError("sample_cycles must be positive")
    if not result.timeline:
        return []
    end = max(ev.end_cycle for ev in result.timeline) + offset
    n_windows = max(int(math.ceil(end / sample_cycles)), 1)
    samples = [
        IntervalSample(i * sample_cycles, (i + 1) * sample_cycles)
        for i in range(n_windows)
    ]
    for ev in result.timeline:
        s, e = ev.start_cycle + offset, ev.end_cycle + offset
        if e <= s:
            # zero-duration events still count as ops in their window
            idx = min(int(s // sample_cycles), n_windows - 1)
            samples[idx].op_count += 1
            continue
        first = int(s // sample_cycles)
        last = min(int((e - 1e-12) // sample_cycles), n_windows - 1)
        samples[first].op_count += 1
        for w in range(first, last + 1):
            w0, w1 = samples[w].t0, samples[w].t1
            overlap = min(e, w1) - max(s, w0)
            if overlap > 0:
                ub = samples[w].unit_busy
                ub[ev.unit] = ub.get(ev.unit, 0.0) + overlap
    return samples


def write_interval_log(
    samples: list[IntervalSample], path: str | Path, meta: dict | None = None
) -> None:
    """Gzip'd JSONL: header line then one sample per line (the
    ``gpgpusim_visualizer__*.log.gz`` analogue)."""
    with gzip.open(path, "wt") as f:
        f.write(json.dumps({"tpusim_interval_log": 1, **(meta or {})}) + "\n")
        for s in samples:
            f.write(json.dumps(s.to_dict()) + "\n")


def read_interval_log(path: str | Path) -> tuple[dict, list[IntervalSample]]:
    with gzip.open(path, "rt") as f:
        header = json.loads(f.readline())
        if "tpusim_interval_log" not in header:
            raise ValueError(f"{path} is not a tpusim interval log")
        samples = []
        for line in f:
            d = json.loads(line)
            samples.append(IntervalSample(
                d["t0"], d["t1"], d.get("unit_busy", {}),
                d.get("op_count", 0),
            ))
    return header, samples


_BLOCKS = " ▁▂▃▄▅▆▇█"


def render_text_lanes(
    samples: list[IntervalSample],
    units: list[str] | None = None,
    width: int = 72,
) -> str:
    """Terminal time-lapse: one lane per unit, one char per (resampled)
    window, glyph height = utilization."""
    if not samples:
        return "(no samples)\n"
    if units is None:
        seen: dict[str, float] = {}
        for s in samples:
            for u, b in s.unit_busy.items():
                seen[u] = seen.get(u, 0.0) + b
        units = [u for u, _ in sorted(seen.items(), key=lambda kv: -kv[1])]
    # resample to at most `width` columns
    cols = min(len(samples), width)
    per = len(samples) / cols
    lines = []
    total_span = samples[-1].t1 - samples[0].t0
    lines.append(
        f"interval log: {len(samples)} windows x "
        f"{samples[0].t1 - samples[0].t0:.0f} cycles "
        f"(total {total_span:.3g} cycles)"
    )
    for u in units:
        chars = []
        for c in range(cols):
            lo, hi = int(c * per), max(int((c + 1) * per), int(c * per) + 1)
            chunk = samples[lo:hi]
            util = sum(s.utilization(u) for s in chunk) / len(chunk)
            chars.append(_BLOCKS[min(int(util * (len(_BLOCKS) - 1) + 0.5),
                                     len(_BLOCKS) - 1)])
        lines.append(f"{u:>7s} |{''.join(chars)}|")
    return "\n".join(lines) + "\n"


def render_scalar_lane(
    values: list[float], label: str, width: int = 72,
    suffix: str = "",
) -> str:
    """One sparkline lane for an arbitrary per-window scalar series (e.g.
    watts), using the same glyph ramp and quantization as the unit lanes."""
    if not values:
        return f"{label:>7s} |{'':{width}}|{suffix}\n"
    peak = max(values) or 1.0
    cols = min(len(values), width)
    per = len(values) / cols
    chars = []
    for c in range(cols):
        lo, hi = int(c * per), max(int((c + 1) * per), int(c * per) + 1)
        chunk = values[lo:hi]
        v = sum(chunk) / len(chunk) / peak
        chars.append(_BLOCKS[min(int(v * (len(_BLOCKS) - 1) + 0.5),
                                 len(_BLOCKS) - 1)])
    return f"{label:>7s} |{''.join(chars)}|{suffix}\n"

"""Timeline export — the AerialVision-slot visualizer
(``src/gpgpu-sim/visualizer.cc`` + ``aerialvision/`` in the reference).
Port of ``tpusim/sim/traceviz.py``.

Instead of gzip'd custom logs + a bespoke GUI, the engine's per-op timeline
is exported as Chrome trace-event JSON — loadable in ``chrome://tracing`` /
Perfetto, which is the de-facto viewer for accelerator timelines.  Rows
(tids) are the modeled units (MXU/VPU/DMA/ICI/...), so compute/collective
overlap is visible directly.
"""

from __future__ import annotations

import json
from pathlib import Path

from tpusim_torch.timing.config import ArchConfig
from tpusim_torch.timing.engine import EngineResult

__all__ = ["timeline_to_chrome_trace", "write_chrome_trace"]

_UNIT_ROWS = {
    "mxu": 1, "vpu": 2, "xpose": 3, "scalar": 4, "dma": 5, "ici": 6,
    "none": 7,
}


def timeline_to_chrome_trace(
    result: EngineResult, arch: ArchConfig, process_name: str = "tpusim",
    extra_events: list[dict] | None = None,
) -> dict:
    """Convert a recorded timeline to the Chrome trace-event format.

    ``extra_events`` lets callers merge additional trace events into the
    same process — the observability layer appends its Perfetto counter
    tracks (``tpusim_torch.obs.export.counter_track_events``) here so sampled
    utilization/bandwidth/power series render above the op rows."""
    events = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": process_name}},
    ]
    for unit, tid in _UNIT_ROWS.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": unit},
        })
    us_per_cycle = 1e6 / arch.clock_hz
    for ev in result.timeline:
        dur = (ev.end_cycle - ev.start_cycle) * us_per_cycle
        events.append({
            "name": f"{ev.opcode}:{ev.name}",
            "ph": "X",
            "pid": 0,
            "tid": _UNIT_ROWS.get(ev.unit, 7),
            "ts": ev.start_cycle * us_per_cycle,
            "dur": max(dur, 0.001),
            "args": {"op": ev.name, "opcode": ev.opcode, "unit": ev.unit},
        })
    if extra_events:
        events.extend(extra_events)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    result: EngineResult, arch: ArchConfig, path: str | Path,
    process_name: str = "tpusim",
    extra_events: list[dict] | None = None,
) -> None:
    with open(path, "w") as f:
        json.dump(
            timeline_to_chrome_trace(
                result, arch, process_name, extra_events=extra_events
            ),
            f,
        )

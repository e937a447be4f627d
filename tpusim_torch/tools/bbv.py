"""Op-class interval vectors for SimPoint-style phase sampling.

Port of ``tpusim/tools/bbv.py``.

The rebuild of the reference's bbv_tool (``util/tracer_nvbit/others/
bbv_tool/bbv_count.cu:56-104``): there, per-warp basic-block execution
counts per instruction interval feed SimPoint to pick representative
simulation regions.  At HLO granularity the analogue is per-interval
opcode-class frequency vectors over a module's flattened op schedule —
long training programs (scan loops unrolled by trip count) get phase
vectors SimPoint can cluster, so one representative window per phase can
be simulated instead of the whole program.

Output format matches SimPoint's frequency-vector input: one line per
interval, ``T:dim:count`` pairs (dims are 1-based, stable across a run).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from tpusim_torch.ir import Computation, ModuleTrace, TraceOp
from tpusim_torch.timing.cost import while_trip_count

__all__ = ["BBVResult", "compute_bbv", "write_simpoint_bb"]


@dataclass
class BBVResult:
    interval_ops: int
    #: opcode -> stable 1-based dimension id
    dims: dict[str, int] = field(default_factory=dict)
    #: one vector per interval: {dim_id: count}
    vectors: list[dict[int, int]] = field(default_factory=list)

    @property
    def num_intervals(self) -> int:
        return len(self.vectors)


def _walk_schedule(
    module: ModuleTrace, comp: Computation, default_trips: int,
    depth: int = 0,
) -> Iterator[TraceOp]:
    """Flatten the schedule the way the engine executes it: while bodies
    repeat trip-count times (same resolution chain as the engine:
    backend_config, then induction-variable inference, then the default),
    fusions/calls recurse."""
    if depth > 32:
        return
    for op in comp.ops:
        base = op.base
        if base == "while" and op.called:
            body_name = op.attrs.get("body", "").lstrip("%") or op.called[0]
            trips = while_trip_count(op, 0)
            if trips <= 0:
                from tpusim_torch.trace.loop_analysis import infer_trip_count

                trips = infer_trip_count(module, comp, op, -1)
                if trips < 0:
                    trips = default_trips
            body = module.computation(body_name)
            for _ in range(max(trips, 1)):
                yield from _walk_schedule(
                    module, body, default_trips, depth + 1
                )
            continue
        if base in ("fusion", "call") and op.called:
            yield from _walk_schedule(
                module, module.computation(op.called[0]), default_trips,
                depth + 1,
            )
            continue
        yield op


def compute_bbv(
    module: ModuleTrace, interval_ops: int = 1000, default_trips: int = 1
) -> BBVResult:
    """Opcode-frequency vector per ``interval_ops``-op window of the
    flattened execution schedule."""
    if interval_ops <= 0:
        raise ValueError("interval_ops must be positive")
    res = BBVResult(interval_ops=interval_ops)
    cur: dict[int, int] = {}
    n = 0
    for op in _walk_schedule(module, module.entry, default_trips):
        dim = res.dims.setdefault(op.base, len(res.dims) + 1)
        cur[dim] = cur.get(dim, 0) + 1
        n += 1
        if n >= interval_ops:
            res.vectors.append(cur)
            cur, n = {}, 0
    if cur:
        res.vectors.append(cur)
    return res


def write_simpoint_bb(res: BBVResult, path: str | Path) -> None:
    """SimPoint frequency-vector file: ``T:dim:count :dim:count ...``."""
    with open(path, "w") as f:
        for vec in res.vectors:
            parts = [f":{dim}:{count}" for dim, count in sorted(vec.items())]
            f.write("T" + " ".join(parts) + "\n")

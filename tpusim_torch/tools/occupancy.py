"""MXU / vmem occupancy calculator.

Port of ``tpusim/tools/occupancy.py``.

The rebuild of the reference's occupancy_calc_tool (``util/tracer_nvbit/
others/occupancy_calc_tool/``): there, an NVBit tool reports achievable SM
occupancy from register/shared-mem/block limits.  The TPU questions are
different but isomorphic: for each matmul-shaped op, how much of the
128x128 systolic array do the shapes actually cover (padding waste on the
K/N tile grid and the 8-row M granularity), and does the working set fit
vmem?  The report flags the ops whose shapes starve the MXU — the
first thing to look at when ``mxu_utilization`` is low.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from tpusim_torch.ir import Computation, ModuleTrace, TraceOp
from tpusim_torch.timing.config import ArchConfig
from tpusim_torch.timing.cost import conv_dims, dot_dims

__all__ = ["OpOccupancy", "OccupancyReport", "occupancy_report"]


@dataclass
class OpOccupancy:
    name: str
    opcode: str
    b: int
    m: int
    n: int
    k: int
    dtype: str
    #: fraction of the K x N tile grid the shapes fill (padding waste)
    tile_fill: float
    #: fraction of streamed rows that are real (M vs 8-row granularity)
    row_fill: float
    #: fill/drain overhead share of a pass (small-M penalty)
    pipeline_eff: float
    #: operand+result bytes vs vmem capacity
    vmem_fraction: float

    @property
    def mxu_occupancy(self) -> float:
        return self.tile_fill * self.row_fill * self.pipeline_eff


@dataclass
class OccupancyReport:
    arch: str
    ops: list[OpOccupancy] = field(default_factory=list)

    @property
    def worst(self) -> list[OpOccupancy]:
        return sorted(self.ops, key=lambda o: o.mxu_occupancy)

    def summary_lines(self, limit: int = 10) -> list[str]:
        out = [
            f"occupancy report ({self.arch}): {len(self.ops)} "
            f"matmul-shaped ops"
        ]
        if not self.ops:
            return out
        mean = sum(o.mxu_occupancy for o in self.ops) / len(self.ops)
        out.append(f"mean MXU occupancy = {mean:.1%}")
        out.append(
            f"{'op':32s} {'BxMxNxK':>20s} {'tile':>6s} {'rows':>6s} "
            f"{'pipe':>6s} {'occ':>6s} {'vmem':>6s}"
        )
        for o in self.worst[:limit]:
            dims = f"{o.b}x{o.m}x{o.n}x{o.k}"
            out.append(
                f"{o.name[:32]:32s} {dims:>20s} {o.tile_fill:6.1%} "
                f"{o.row_fill:6.1%} {o.pipeline_eff:6.1%} "
                f"{o.mxu_occupancy:6.1%} {o.vmem_fraction:6.1%}"
            )
        return out


def _op_bytes(comp: Computation, op: TraceOp) -> float:
    from tpusim_torch.ir import leaves_of

    total = sum(leaf.nbytes for leaf in leaves_of(op.result))
    for operand in op.operands:
        if comp.has_op(operand):
            total += sum(
                leaf.nbytes for leaf in leaves_of(comp.op(operand).result)
            )
    return float(total)


def _occupancy_for(
    arch: ArchConfig, comp: Computation, op: TraceOp,
    b: int, m: int, n: int, k: int, dtype: str,
) -> OpOccupancy:
    rows, cols = arch.mxu_rows, arch.mxu_cols
    k_tiles = max(math.ceil(k / rows), 1)
    n_tiles = max(math.ceil(n / cols), 1)
    tile_fill = (k * n) / (k_tiles * rows * n_tiles * cols)
    m_pad = max(8, math.ceil(m / 8) * 8)
    row_fill = m / m_pad
    # mirror CostModel.mxu_cycles: per-pass cost floors at the weight-load
    # stall (double-buffered tiles), and fill/drain is paid once per op
    passes = b * k_tiles * n_tiles
    serial = max(math.ceil(passes / arch.mxu_count), 1)
    per_pass = max(m_pad, arch.mxu_weight_stall_cycles)
    pipeline_eff = (serial * m_pad) / (
        serial * per_pass + arch.mxu_fill_cycles
    )
    vmem_fraction = _op_bytes(comp, op) / max(arch.vmem_bytes, 1)
    return OpOccupancy(
        name=op.name, opcode=op.base, b=b, m=m, n=n, k=k, dtype=dtype,
        tile_fill=tile_fill, row_fill=row_fill, pipeline_eff=pipeline_eff,
        vmem_fraction=vmem_fraction,
    )


def occupancy_report(
    module: ModuleTrace, arch: ArchConfig
) -> OccupancyReport:
    """Scan every computation for matmul-shaped ops (dot / convolution)
    and compute their array occupancy."""
    report = OccupancyReport(arch=arch.name)
    for comp in module.computations.values():
        for op in comp.ops:
            base = op.base
            try:
                if base == "dot":
                    b, m, n, k, dtype = dot_dims(op, comp)
                elif base == "convolution":
                    b, m, n, k, dtype = conv_dims(op, comp)
                else:
                    continue
            except (IndexError, KeyError, ValueError):
                continue
            report.ops.append(
                _occupancy_for(arch, comp, op, b, m, n, k, dtype)
            )
    return report

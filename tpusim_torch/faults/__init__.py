"""Fault injection and degraded-pod simulation (port of ``tpusim.faults``).

Deterministic fault schedules (dead/degraded ICI links, straggling chips,
throttled HBM, DCN faults — :mod:`tpusim_torch.faults.schedule`) threaded
through the topology, both ICI models, the timing engine and the driver;
plus single-link-failure sweeps reporting worst-case step-time inflation
(:mod:`tpusim_torch.faults.sweep`, CLI ``python -m tpusim_torch faults``).
"""

from tpusim_torch.faults.schedule import (
    FAULT_KINDS,
    Fault,
    FaultSchedule,
    FaultScheduleError,
    FaultState,
    FaultView,
    TopologyPartitionedError,
    load_fault_schedule,
)
from tpusim_torch.faults.sweep import (
    SweepRow,
    link_down_schedule,
    single_link_sweep,
    trace_step_sweep,
)

__all__ = [
    "FAULT_KINDS",
    "Fault",
    "FaultSchedule",
    "FaultScheduleError",
    "FaultState",
    "FaultView",
    "SweepRow",
    "TopologyPartitionedError",
    "link_down_schedule",
    "load_fault_schedule",
    "single_link_sweep",
    "trace_step_sweep",
]

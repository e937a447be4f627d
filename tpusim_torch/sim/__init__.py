"""Simulation driver and stats."""

from tpusim_torch.sim.driver import SimDriver, SimReport, simulate_trace
from tpusim_torch.sim.stats import EXIT_SENTINEL, StatsRegistry

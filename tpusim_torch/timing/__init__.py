"""Timing core: arch config, cost model, schedule-walking engine."""

from tpusim_torch.timing.arch import ARCH_PRESETS, arch_preset
from tpusim_torch.timing.config import ArchConfig, SimConfig, load_config, parse_flag_file
from tpusim_torch.timing.cost import CostModel, OpCost
from tpusim_torch.timing.engine import Engine, EngineResult

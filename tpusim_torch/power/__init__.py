"""TPUWattch — the AccelWattch rebuild for TPU units.

Port of ``tpusim/power/``.  The reference's power layer
(``src/accelwattch/``, a McPAT/CACTI fork) maps per-pipeline activity
counters to per-component dynamic power plus static power.  Ours maps the
timing engine's counters — MXU flops, VPU ops, transcendentals,
HBM/vmem/ICI bytes — through per-unit energy coefficients (pJ/op,
pJ/byte) fit to TPU generations, plus leakage and idle components.
"""

from tpusim_torch.power.model import PowerCoefficients, PowerModel, PowerReport

__all__ = ["PowerCoefficients", "PowerModel", "PowerReport"]

"""Per-unit energy/power model.

Port of ``tpusim/power/model.py``.  ``power_timeline`` (per-window watts
from the observability sampler's windows) waits for ROADMAP A10, and the
live power probe of ``tpusim/power/telemetry.py`` for A12.  The fitted
coefficients of ``tpusim/power/fitted/`` are kept as their own copy in
``tpusim_torch/power/fitted/``, read by :func:`load_fitted`.

Energy coefficients are first-principles estimates for a ~5nm-class TPU,
chosen so the derived chip power at full utilization lands near published
TDPs (v5e ~ 200W class, v5p ~ 500W class); the reference's fitting harness
(``tpusim/harness/tuner.py``) can refine them when real power telemetry is
available — the analogue of AccelWattch's quadprog coefficient fit
(``util/accelwattch/quadprog_solver.m``, ``AccelWattch.md:110-125``).

Model: for one simulated execution,

    E_dyn  = mxu_pj * mxu_flops + vpu_pj * vpu_ops + sfu_pj * transcendentals
           + hbm_pj * hbm_bytes + vmem_pj * vmem_bytes + ici_pj * ici_bytes
    P_avg  = E_dyn / t + P_static + P_idle_clock

mirroring AccelWattch's dynamic-activity × per-access-energy + leakage
split (``gpgpu_sim_wrapper.cc``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.timing.engine import EngineResult

__all__ = [
    "PowerCoefficients", "PowerModel", "PowerReport", "dvfs_overlays",
    "load_fitted", "POWER_PRESETS", "FITTED_DIR",
]

#: fitted coefficients committed by the reference's power-validation fit,
#: one ``<name>.json`` per generation (copies of ``tpusim/power/fitted/``)
FITTED_DIR = Path(__file__).resolve().parent / "fitted"


@dataclass(frozen=True)
class PowerCoefficients:
    """pJ per event, plus static watts — one set per TPU generation."""

    name: str = "v5p"
    mxu_pj_per_flop: float = 0.6       # bf16 MAC energy amortized
    vpu_pj_per_flop: float = 1.2
    sfu_pj_per_op: float = 4.0         # transcendentals
    hbm_pj_per_byte: float = 6.0       # HBM2e/3-class access energy
    vmem_pj_per_byte: float = 0.8      # on-chip SRAM
    ici_pj_per_byte: float = 10.0      # SerDes + link
    static_watts: float = 70.0         # leakage
    idle_clock_watts: float = 35.0     # clock tree / sequencer

    def component_picojoules(
        self,
        *,
        mxu_flops: float = 0.0,
        flops: float = 0.0,
        transcendentals: float = 0.0,
        hbm_bytes: float = 0.0,
        vmem_bytes: float = 0.0,
        ici_bytes: float = 0.0,
    ) -> dict[str, float]:
        """Per-component dynamic energy (pJ) for one set of activity
        counts — THE energy accounting of :meth:`PowerModel.report` (in
        the reference also of the obs layer's per-window watts track, so
        the two can't diverge).  VPU flops are the non-MXU,
        non-transcendental remainder."""
        return {
            "mxu": self.mxu_pj_per_flop * mxu_flops,
            "vpu": self.vpu_pj_per_flop * max(
                flops - mxu_flops - transcendentals, 0.0
            ),
            "sfu": self.sfu_pj_per_op * transcendentals,
            "hbm": self.hbm_pj_per_byte * hbm_bytes,
            "vmem": self.vmem_pj_per_byte * vmem_bytes,
            "ici": self.ici_pj_per_byte * ici_bytes,
        }

    def scaled(self, voltage_scale: float) -> "PowerCoefficients":
        """DVFS voltage scaling (the AccelWattch DVFS slot): per-event
        switching energy goes as V², and leakage roughly tracks V² at
        nearby operating points.  Pair with a ``clock_ghz`` overlay on the
        timing side — :func:`dvfs_overlays` builds both."""
        v2 = voltage_scale ** 2
        return PowerCoefficients(
            name=self.name,
            mxu_pj_per_flop=self.mxu_pj_per_flop * v2,
            vpu_pj_per_flop=self.vpu_pj_per_flop * v2,
            sfu_pj_per_op=self.sfu_pj_per_op * v2,
            hbm_pj_per_byte=self.hbm_pj_per_byte,   # HBM rail is separate
            vmem_pj_per_byte=self.vmem_pj_per_byte * v2,
            ici_pj_per_byte=self.ici_pj_per_byte,   # SerDes rail too
            static_watts=self.static_watts * v2,
            idle_clock_watts=self.idle_clock_watts * v2 * voltage_scale,
        )


def dvfs_overlays(base_clock_ghz: float, freq_scale: float) -> list[dict]:
    """Config overlays for a DVFS operating point: scale the core clock
    (timing side) and record the scale for the power side (``dvfs_scale``
    is read by the driver when building the PowerModel).  Voltage is
    assumed ∝ frequency near the nominal point."""
    return [{
        "arch": {"clock_ghz": base_clock_ghz * freq_scale},
        "dvfs_scale": freq_scale,
    }]


#: per-generation coefficient presets (fit targets: published TDP class)
POWER_PRESETS: dict[str, PowerCoefficients] = {
    "v4": PowerCoefficients(name="v4", mxu_pj_per_flop=0.35,
                            static_watts=55.0),
    "v5e": PowerCoefficients(name="v5e", mxu_pj_per_flop=0.30,
                             static_watts=40.0, idle_clock_watts=20.0),
    "v5p": PowerCoefficients(name="v5p"),
    "v6e": PowerCoefficients(name="v6e", mxu_pj_per_flop=0.18,
                             static_watts=45.0),
}


def load_fitted(name: str) -> PowerCoefficients | None:
    """The committed fitted coefficients of ``name``; None when absent."""
    path = FITTED_DIR / f"{name}.json"
    if not path.exists():
        return None
    doc = json.loads(path.read_text())
    return PowerCoefficients(name=doc["name"], **doc["coefficients"])


@dataclass
class PowerReport:
    """Per-component energy breakdown for one simulated execution — the
    ``accelwattch_power_report.log`` equivalent."""

    seconds: float
    component_joules: dict[str, float] = field(default_factory=dict)
    static_watts: float = 0.0
    idle_watts: float = 0.0

    @property
    def dynamic_joules(self) -> float:
        return sum(self.component_joules.values())

    @property
    def total_joules(self) -> float:
        return (
            self.dynamic_joules
            + (self.static_watts + self.idle_watts) * self.seconds
        )

    @property
    def avg_watts(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.total_joules / self.seconds

    def stats_dict(self) -> dict[str, float]:
        d = {
            "power_avg_watts": self.avg_watts,
            "energy_total_j": self.total_joules,
            "energy_dynamic_j": self.dynamic_joules,
            "power_static_watts": self.static_watts + self.idle_watts,
        }
        for comp, j in self.component_joules.items():
            d[f"energy_{comp}_j"] = j
        return d

    def report_text(self) -> str:
        lines = ["TPUWattch power report", "-" * 40]
        lines.append(f"elapsed            = {self.seconds:.6g} s")
        for comp, j in sorted(self.component_joules.items()):
            w = j / self.seconds if self.seconds else 0.0
            lines.append(f"{comp:18s} = {j:.6g} J ({w:.3g} W)")
        lines.append(f"{'static+idle':18s} = "
                     f"{(self.static_watts + self.idle_watts) * self.seconds:.6g} J "
                     f"({self.static_watts + self.idle_watts:.3g} W)")
        lines.append(f"{'avg power':18s} = {self.avg_watts:.6g} W")
        return "\n".join(lines)


class PowerModel:
    def __init__(
        self,
        coeffs: PowerCoefficients | str = "v5p",
        dvfs_scale: float = 1.0,
    ):
        if isinstance(coeffs, str):
            # fitted coefficients (committed by the power-validation fit,
            # power/fitted/<name>.json) take precedence over the
            # first-principles presets
            coeffs = load_fitted(coeffs) or POWER_PRESETS.get(
                coeffs, PowerCoefficients(name=coeffs)
            )
        if dvfs_scale != 1.0:
            coeffs = coeffs.scaled(dvfs_scale)
        self.coeffs = coeffs

    def report(
        self, result: EngineResult, measured_seconds: float | None = None,
    ) -> PowerReport:
        """Power report from one execution's activity counts.

        ``measured_seconds`` is the AccelWattch **HW-mode** slot
        (``AccelWattch.md``: activity factors with real kernel
        durations): the event counts are exact static properties of the
        program, so substituting the measured device time for the
        simulated time yields a power estimate independent of the timing
        model's error — the form the hw-validation CSV pipeline compares
        against NVML watts."""
        c = self.coeffs
        pj = c.component_picojoules(
            mxu_flops=result.mxu_flops,
            flops=result.flops,
            transcendentals=result.transcendentals,
            hbm_bytes=result.hbm_bytes,
            vmem_bytes=result.vmem_bytes,
            ici_bytes=result.ici_bytes,
        )
        seconds = (
            measured_seconds if measured_seconds is not None
            else result.seconds
        )
        return PowerReport(
            seconds=max(seconds, 1e-12),
            component_joules={k: v * 1e-12 for k, v in pj.items()},
            static_watts=c.static_watts,
            idle_watts=c.idle_clock_watts,
        )

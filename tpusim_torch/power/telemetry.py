"""Power telemetry capture + coefficient fitting (port of
``tpusim/power/telemetry.py``).

The rebuild of AccelWattch's hardware-validation pipeline
(``util/accelwattch/accelwattch_hw_profiler/measureGpuPower.cpp`` — an
NVML sampler — plus ``quadprog_solver.m`` fitting per-component
coefficients to measured kernel power, ``AccelWattch.md:110-125``).

TPU equivalents:

* **telemetry hook** (:func:`read_power_watts`): tries the power sources a
  TPU-VM can expose — the ``tpu-info``/``libtpu`` metrics service and sysfs
  hwmon rails.  Returns ``None`` when none is available, in which case the
  fitter falls back to anchor fixtures.
* **anchor fixtures** (:data:`POWER_ANCHOR_POINTS`): published TDP-class
  operating points per generation (idle, dense-matmul full load, HBM-bound
  stream).  These are documented estimates standing in for silicon
  telemetry — the same role AccelWattch's ``hw_power_validation_volta.csv``
  plays, at much coarser grain; swap in measured samples when a telemetry
  source exists.
* **least-squares fit** (:func:`fit_power_coefficients`): solves
  ``watts ≈ Σ coeff_i · rate_i · 1e-12 + static`` over the samples with
  non-negativity clamping — the quadprog slot.  Its 7x7 solve is
  ``numpy.linalg.solve`` in float64, as the reference's: the fitted
  document must equal the reference's by bytes, and another LAPACK path
  can move the last bit.

* **live sampler** (:func:`sample_workload_power`): runs a workload in a
  loop while polling a meter — on the card, the card's own
  (:func:`read_card_watts`, NVML's ``nvmlDeviceGetPowerUsage`` through
  ``ctypes`` on ``libnvidia-ml.so.1``), the counterpart of the
  reference's ``tpu_info`` source.  :func:`read_power_watts` and
  :func:`probe_power_sources` keep the reference's sources, so ``tune
  --power`` documents stay the reference's by bytes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.power.model import (
    FITTED_DIR,
    POWER_PRESETS,
    PowerCoefficients,
    load_fitted,
)

__all__ = [
    "PowerSample",
    "read_power_watts",
    "probe_power_sources",
    "read_card_watts",
    "sample_workload_power",
    "anchor_samples",
    "fit_power_coefficients",
    "save_fitted",
    "load_fitted",
    "FITTED_DIR",
]

#: activity-rate keys, in design-matrix order (events per second)
RATE_KEYS = (
    "mxu_flops", "vpu_flops", "transcendentals",
    "hbm_bytes", "vmem_bytes", "ici_bytes",
)

_COEF_FIELDS = (
    "mxu_pj_per_flop", "vpu_pj_per_flop", "sfu_pj_per_op",
    "hbm_pj_per_byte", "vmem_pj_per_byte", "ici_pj_per_byte",
)


@dataclass
class PowerSample:
    """One measured (or anchored) operating point."""

    name: str
    watts: float
    #: event rates per second, keyed by RATE_KEYS (missing = 0)
    rates: dict[str, float] = field(default_factory=dict)

    def row(self) -> list[float]:
        return [self.rates.get(k, 0.0) * 1e-12 for k in RATE_KEYS] + [1.0]


# ---------------------------------------------------------------------------
# telemetry hook
# ---------------------------------------------------------------------------


def read_power_watts() -> float | None:
    """Instantaneous chip power, or None when no source is available.

    Sources tried, in order (the measureGpuPower.cpp slot):
    1. the ``tpu_info`` library (TPU-VM metrics service, when installed);
    2. sysfs hwmon power rails (``/sys/class/hwmon/*/power*_input``, µW).

    One implementation with :func:`probe_power_sources` — the probe IS
    the source walk, this is just its scalar view."""
    return probe_power_sources()["watts"]


def probe_power_sources() -> dict:
    """Diagnose every power-telemetry source and report what happened —
    the committed evidence for why fitted coefficients are (or are not)
    anchor-based: attempt the measurement, and where no source exposes
    power counters, record that fact."""
    import glob

    tried: list[dict] = []
    watts: float | None = None
    n_chips: int | None = None

    try:
        from tpu_info import metrics  # type: ignore

        chips = list(metrics.get_chip_usage())
        vals = [
            getattr(c, "power_usage_watts", None) for c in chips
        ]
        vals = [v for v in vals if v]
        if vals:
            watts = float(sum(vals))
            n_chips = len(vals)
            tried.append({"source": "tpu_info", "ok": True,
                          "watts": watts, "chips": n_chips})
        else:
            tried.append({"source": "tpu_info", "ok": False,
                          "detail": f"{len(chips)} chips, "
                                    "no power_usage_watts"})
    except ImportError as e:
        tried.append({"source": "tpu_info", "ok": False,
                      "detail": f"not installed: {e}"})
    except Exception as e:
        tried.append({"source": "tpu_info", "ok": False,
                      "detail": f"{type(e).__name__}: {e}"})

    rails = glob.glob("/sys/class/hwmon/hwmon*/power*_input")
    if rails:
        vals = []
        for p in rails:
            try:
                vals.append(int(Path(p).read_text().strip()))
            except (OSError, ValueError):
                continue
        vals = [v for v in vals if v > 0]  # idle rails report 0µW — not data
        if vals:
            if watts is None:
                watts = sum(vals) / 1e6
            tried.append({"source": "hwmon", "ok": True,
                          "rails": len(vals),
                          "watts": sum(vals) / 1e6})
        else:
            tried.append({"source": "hwmon", "ok": False,
                          "detail": f"{len(rails)} rails, none with a "
                                    "nonzero reading"})
    else:
        tried.append({"source": "hwmon", "ok": False,
                      "detail": "no /sys/class/hwmon power rails"})

    return {"watts": watts, "chips": n_chips, "tried": tried}


def _nvml_bus_id(device) -> bytes | None:
    """The PCI bus id NVML names ``device``'s card by, or None (then the
    card is taken by its index)."""
    import torch

    props = torch.cuda.get_device_properties(device)
    try:
        return (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
                f"{props.pci_device_id:02x}.0").encode()
    except AttributeError:
        return None


def read_card_watts(device=None) -> float | None:
    """One reading of the card's own power meter in watts — NVML's
    ``nvmlDeviceGetPowerUsage`` (milliwatts) through ``ctypes`` on
    ``libnvidia-ml.so.1`` — or None when no meter answers (no library, no
    card, or an NVML error)."""
    import ctypes

    import torch

    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlShutdown.restype = ctypes.c_int
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetPowerUsage.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
    lib.nvmlDeviceGetPowerUsage.restype = ctypes.c_int
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        handle = ctypes.c_void_p()
        bus = None
        if torch.cuda.is_available():
            dev = torch.device("cuda" if device is None else device)
            bus = _nvml_bus_id(dev)
        if bus is not None:
            rc = lib.nvmlDeviceGetHandleByPciBusId_v2(bus,
                                                      ctypes.byref(handle))
        else:
            rc = lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle))
        if rc != 0:
            return None
        mw = ctypes.c_uint()
        if lib.nvmlDeviceGetPowerUsage(handle, ctypes.byref(mw)) != 0:
            return None
        return mw.value / 1000.0
    finally:
        lib.nvmlShutdown()


def sample_workload_power(
    fn, args, *, name: str = "workload", seconds: float = 3.0,
    poll_s: float = 0.1, meter=None,
) -> PowerSample | None:
    """Run ``fn`` in a loop for ~``seconds`` while polling a power meter;
    returns the averaged sample (rates must be attached by the caller from
    the capture's cost analysis), or None when no meter answers.

    ``meter`` (a callable returning watts or None) defaults to the card's
    own (:func:`read_card_watts`) for CUDA tensors, the reference's
    sources (:func:`read_power_watts`) otherwise."""
    import time

    import torch

    from tpusim_torch.spmd import SpmdModule
    from tpusim_torch.tracer.capture import _concrete

    dev = _concrete(tuple(args), "sample_workload_power")
    if meter is None:
        meter = ((lambda: read_card_watts(dev)) if dev.type == "cuda"
                 else read_power_watts)
    if meter() is None:
        return None
    run = fn.run if isinstance(fn, SpmdModule) else fn

    def step():
        run(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    readings: list[float] = []
    with torch.no_grad():
        step()
        t_end = time.time() + seconds
        while time.time() < t_end:
            step()
            w = meter()
            if w is not None:
                readings.append(w)
            time.sleep(poll_s)
    if not readings:
        return None
    return PowerSample(name=name, watts=sum(readings) / len(readings))


# ---------------------------------------------------------------------------
# anchor fixtures (documented estimates — the TDP-class operating points)
# ---------------------------------------------------------------------------

#: per-arch anchors as (name, watts, utilization profile).  Utilizations
#: are fractions of the arch's peak rates; watts are published TDP-class
#: figures for the generation (chip max power: v4 ~192W per the TPUv4
#: ISCA'23 paper; v5e ~200W class; v5p ~500W class per public TDP
#: statements) interpolated to the operating point.  ESTIMATES, not
#: silicon measurements — replace via telemetry when available.
POWER_ANCHOR_POINTS: dict[str, list[tuple[str, float, dict[str, float]]]] = {
    "v5e": [
        ("idle", 60.0, {}),
        ("dense_matmul", 200.0,
         {"mxu_flops": 0.65, "hbm_bytes": 0.30, "vmem_bytes": 0.60}),
        # HBM-bound streaming sits far below TDP: ~2.3TB/s at HBM-class
        # ~6pJ/B is only ~15W of dynamic draw over idle
        ("hbm_stream", 85.0,
         {"vpu_flops": 0.20, "hbm_bytes": 0.85}),
        ("mixed_train", 180.0,
         {"mxu_flops": 0.45, "vpu_flops": 0.30, "hbm_bytes": 0.55,
          "vmem_bytes": 0.40, "transcendentals": 0.20}),
    ],
    "v5p": [
        ("idle", 105.0, {}),
        ("dense_matmul", 500.0,
         {"mxu_flops": 0.65, "hbm_bytes": 0.30, "vmem_bytes": 0.60}),
        ("hbm_stream", 135.0,
         {"vpu_flops": 0.20, "hbm_bytes": 0.85}),
        ("mixed_train", 440.0,
         {"mxu_flops": 0.45, "vpu_flops": 0.30, "hbm_bytes": 0.55,
          "vmem_bytes": 0.40, "transcendentals": 0.20}),
    ],
}


def _peak_rates(arch) -> dict[str, float]:
    """Peak event rates per second for an ArchConfig."""
    return {
        "mxu_flops": arch.peak_bf16_flops,
        "vpu_flops": arch.vpu_flops_per_cycle * arch.clock_hz,
        "transcendentals": arch.vpu_transcendental_per_cycle * arch.clock_hz,
        "hbm_bytes": arch.hbm_bandwidth,
        "vmem_bytes": arch.vmem_bandwidth_mult * arch.hbm_bandwidth,
        "ici_bytes": arch.ici.link_bandwidth * 6,
    }


def anchor_samples(arch_name: str) -> list[PowerSample]:
    """The fixture samples for one generation, utilizations resolved
    against the arch's peak rates."""
    from tpusim_torch.timing.arch import arch_preset

    arch = arch_preset(arch_name)
    peaks = _peak_rates(arch)
    points = POWER_ANCHOR_POINTS.get(arch_name)
    if points is None:
        raise KeyError(
            f"no power anchors for {arch_name!r}; have "
            f"{sorted(POWER_ANCHOR_POINTS)}"
        )
    return [
        PowerSample(
            name=nm, watts=w,
            rates={k: u * peaks[k] for k, u in util.items()},
        )
        for nm, w, util in points
    ]


# ---------------------------------------------------------------------------
# fitting (the quadprog_solver.m slot)
# ---------------------------------------------------------------------------


def fit_power_coefficients(
    samples: list[PowerSample],
    name: str,
    *,
    prior_weight: float = 0.05,
) -> PowerCoefficients:
    """Least-squares fit of per-event energies + static watts to the
    samples — the quadprog slot.

    Anchor sets are few-sample and the design matrix is rank-deficient
    (7 unknowns, ~4 operating points), so an unconstrained solve attributes
    energy unphysically (e.g. all of a matmul's power billed to HBM).  The
    fit therefore regularizes toward the first-principles preset in
    *scaled* space: solve for per-coefficient scale factors s with a ridge
    pulling s→1, then clamp negatives.  prior_weight trades anchor
    exactness against physical attribution."""
    import numpy as np

    if len(samples) < 2:
        raise ValueError("need >= 2 samples to fit power coefficients")
    base = POWER_PRESETS.get(name, PowerCoefficients(name=name))
    prior = np.maximum(np.array(
        [getattr(base, f) for f in _COEF_FIELDS], dtype=np.float64,
    ), 1e-9)

    # stage 1: static power is directly observed by zero-activity samples
    # (the idle point); estimate it there rather than entangling it with
    # the under-determined dynamic fit
    idle = [s for s in samples if not any(s.rates.values())]
    loaded = [s for s in samples if any(s.rates.values())]
    if idle:
        static = float(sum(s.watts for s in idle) / len(idle))
    else:
        static = base.static_watts + base.idle_clock_watts
        loaded = samples

    # stage 2: dynamic coefficients on the static-subtracted residuals,
    # in prior-scaled space with a ridge pulling each scale toward 1
    # (rank-deficient anchor sets would otherwise attribute energy
    # unphysically — all of a matmul's power billed to HBM)
    A = np.array(
        [[s.rates.get(k, 0.0) * 1e-12 for k in RATE_KEYS] for s in loaded],
        dtype=np.float64,
    )
    b = np.array([s.watts - static for s in loaded], dtype=np.float64)
    Ap = A * prior[None, :]
    lam = prior_weight * float((Ap ** 2).sum()) / max(Ap.shape[1], 1)
    AtA = Ap.T @ Ap + lam * np.eye(Ap.shape[1])
    rhs = Ap.T @ b + lam * np.ones(Ap.shape[1])
    s = np.linalg.solve(AtA, rhs)
    x = np.maximum(s, 0.0) * prior
    kw = dict(zip(_COEF_FIELDS, (float(v) for v in x)))
    # split the fitted static between leakage and clock tree in the same
    # proportion as the preset (the fit cannot separate them)
    tot = base.static_watts + base.idle_clock_watts
    frac = base.static_watts / tot if tot > 0 else 0.5
    return PowerCoefficients(
        name=name,
        static_watts=static * frac,
        idle_clock_watts=static * (1.0 - frac),
        **kw,
    )


# ---------------------------------------------------------------------------
# fitted-coefficient persistence (the committed overlay)
# ---------------------------------------------------------------------------


def save_fitted(
    coeffs: PowerCoefficients, out_dir: str | Path = FITTED_DIR,
    meta: dict | None = None,
) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    doc = {
        "name": coeffs.name,
        "coefficients": {
            f: getattr(coeffs, f) for f in (
                *_COEF_FIELDS, "static_watts", "idle_clock_watts",
            )
        },
        "meta": meta or {},
    }
    path = out_dir / f"{coeffs.name}.json"
    path.write_text(json.dumps(doc, indent=2))
    return path

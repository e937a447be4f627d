"""The tuner's offline half: the power-coefficient fit (port of
``tpusim/harness/tuner.py``'s ``tune_power``).

The reference's ``tune`` fits arch parameters by timing microbenchmarks
on the live chip; on an H100 that would time an H100, which no arch
preset describes, so it is not ported (ROADMAP A12 item 5, and ``tune``
without ``--power`` refuses).  ``tune_power`` needs no chip: it fits
from telemetry when a source answers, else from the documented anchor
fixtures.
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["POWER_OUT", "tune_power"]

#: where ``tune_power`` writes by default (relative to the working dir,
#: like the CLI's other reports; git-ignored)
POWER_OUT = Path("build") / "tpusim_torch_reports" / "power_fitted"


def tune_power(
    arch_name: str, out_dir: str | Path | None = None,
    probe: dict | None = None,
) -> "Path":
    """Fit power coefficients for one generation and persist them under
    ``out_dir`` (default :data:`POWER_OUT`, never the committed
    ``power/fitted/``) — the AccelWattch hw-profiler + quadprog pipeline
    (``AccelWattch.md:110-125``).  The document is the reference's, byte
    for byte, in the same environment.

    Prefers live telemetry samples (TPU-VM power metrics via
    :func:`tpusim_torch.power.telemetry.read_power_watts`); when no telemetry
    source exists — the usual case on tunneled images — fits against the
    documented TDP-class anchor fixtures instead, so the committed
    coefficients always have a stated provenance."""
    from tpusim_torch.power.telemetry import (
        PowerSample,
        anchor_samples,
        fit_power_coefficients,
        probe_power_sources,
        save_fitted,
    )

    # Callers that already probed (and platform-verified) pass their
    # result in, vouching for it — that keeps logged and committed
    # provenance from disagreeing across two reads AND means a bare
    # `tune_power()` on a workstation whose hwmon exposes a battery rail
    # cannot relabel committed TPU coefficients as source=telemetry.
    trusted = probe is not None
    if probe is None:
        probe = probe_power_sources()
    watts = probe.get("watts")
    use_measurement = trusted and watts is not None
    samples = anchor_samples(arch_name)
    meta: dict = {
        "source": "telemetry" if use_measurement else "anchors",
        # the committed evidence: every source tried and what it said
        "telemetry_probe": probe["tried"],
    }
    if use_measurement:
        # one real measured point (chips at rest when tune_power runs),
        # normalized per chip (anchors are per-chip operating points; an
        # 8-chip VM's summed idle watts is not one chip's idle), replaces
        # the guessed idle anchor
        chips = max(int(probe.get("chips") or 1), 1)
        per_chip = float(watts) / chips
        samples = [PowerSample("measured_idle", per_chip)] + [
            s for s in samples if s.name != "idle"
        ]
        meta["measured_idle_watts"] = per_chip
        meta["measured_chips"] = chips
    elif watts is not None:
        meta["note"] = (
            "a power reading exists but was self-probed without platform "
            "verification — pass probe= from a TPU-guarded caller (bench) "
            "to use it; keeping anchor fixtures"
        )
    else:
        meta["note"] = (
            "no power source exposed on this VM (see telemetry_probe); "
            "anchor fixtures are published TDP-class estimates — re-run "
            "tune_power on a telemetry-capable TPU-VM"
        )
    meta["samples"] = [s.name for s in samples]
    coeffs = fit_power_coefficients(samples, arch_name)
    return save_fitted(coeffs, out_dir or POWER_OUT, meta=meta)

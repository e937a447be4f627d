"""The port's power model against the JAX package.

* ``PowerModel.report``: ``stats_dict()`` and ``report_text()`` are equal
  for v4, v5e, v5p and v6e at ``dvfs_scale`` 1.0 and 0.8, on seeded
  activity counts;
* ``dvfs_overlays`` and the coefficient presets are equal;
* the port's ``power/fitted/*.json`` are byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from tpusim.power import model as ref_power  # noqa: E402
from tpusim.timing.engine import EngineResult as RefResult  # noqa: E402
from tpusim_torch.power import model as port_power  # noqa: E402
from tpusim_torch.timing.engine import EngineResult as PortResult  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCHES = ("v4", "v5e", "v5p", "v6e")
COUNTERS = ("mxu_flops", "flops", "transcendentals", "hbm_bytes",
            "vmem_bytes", "ici_bytes", "seconds")


def _results(seed: int):
    """The same seeded activity counts as an EngineResult of each package."""
    rng = np.random.default_rng(seed)
    vals = dict(zip(COUNTERS, (float(x) for x in rng.uniform(0, 1, 7))))
    vals["mxu_flops"] *= 4e12
    vals["flops"] = vals["mxu_flops"] + vals["flops"] * 1e12
    vals["transcendentals"] *= 1e9
    vals["hbm_bytes"] *= 2e10
    vals["vmem_bytes"] *= 5e10
    vals["ici_bytes"] *= 1e9
    vals["seconds"] = 1e-3 + vals["seconds"] * 1e-2
    ref, port = RefResult(), PortResult()
    for k, v in vals.items():
        setattr(ref, k, v)
        setattr(port, k, v)
    return ref, port


@pytest.mark.parametrize("dvfs", [1.0, 0.8])
@pytest.mark.parametrize("arch", ARCHES)
def test_power_report_matches_reference(arch, dvfs):
    for seed in range(3):
        ref_res, port_res = _results(seed)
        want = ref_power.PowerModel(arch, dvfs_scale=dvfs).report(ref_res)
        got = port_power.PowerModel(arch, dvfs_scale=dvfs).report(port_res)
        assert got.stats_dict() == want.stats_dict()
        assert got.report_text() == want.report_text()
        # the hardware-mode slot: measured device seconds in place of
        # the simulated ones
        assert port_power.PowerModel(arch, dvfs).report(
            port_res, measured_seconds=2e-3).stats_dict() == \
            ref_power.PowerModel(arch, dvfs).report(
                ref_res, measured_seconds=2e-3).stats_dict()


def test_coefficients_and_dvfs_overlays_match_reference():
    for name in ARCHES + ("v9x",):
        want = ref_power.PowerModel(name).coeffs
        got = port_power.PowerModel(name).coeffs
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name, coeffs in ref_power.POWER_PRESETS.items():
        assert dataclasses.asdict(port_power.POWER_PRESETS[name]) == \
            dataclasses.asdict(coeffs)
    for clock, scale in ((0.94, 1.0), (1.75, 0.8), (1.5, 1.1)):
        assert port_power.dvfs_overlays(clock, scale) == \
            ref_power.dvfs_overlays(clock, scale)


def test_fitted_coefficients_are_byte_equal_copies():
    ref_dir = REPO / "tpusim" / "power" / "fitted"
    names = sorted(p.name for p in ref_dir.glob("*.json"))
    assert names == sorted(
        p.name for p in port_power.FITTED_DIR.glob("*.json"))
    assert names == ["v5e.json", "v5p.json"]
    for name in names:
        assert (port_power.FITTED_DIR / name).read_bytes() == \
            (ref_dir / name).read_bytes()
    assert port_power.load_fitted("v6e") is None
    assert port_power.load_fitted("v5e").name == "v5e"

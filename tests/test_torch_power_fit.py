"""The offline power fit and the correlation report in the port, on the
CPU: mirrors ``tests/test_power.py``'s fit, anchor, fitted-file,
telemetry-probe and ``tune_power`` tests and ``tests/test_plots.py``, and
holds ``tune --power`` to the JAX package.

* ``python -m tpusim_torch tune --power --arch A --out DIR`` writes the
  same bytes as ``python -m tpusim tune --power`` run in the same
  environment (the probe's findings are part of the document), and its
  ``coefficients`` equal the committed
  ``tpusim_torch/power/fitted/A.json`` by value, for v5e and v5p;
* without ``--out`` it writes under ``build/``, never the committed dir;
  ``tune`` without ``--power`` runs the arch tuner instead (its timings
  stubbed here; ``tests/test_torch_tuner_live.py`` holds it to the JAX
  package);
* the fit, the anchors and the report equal the JAX package's (the fit
  by float ``==``: both solve the 7x7 system with ``numpy.linalg.solve``
  in float64).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.harness.correlate import CorrelationPoint  # noqa: E402
from tpusim_torch.harness.plots import (  # noqa: E402
    correlation_stats,
    write_correlation_report,
)

REPO = Path(__file__).resolve().parent.parent


# -- the fit (tests/test_power.py) ------------------------------------------


def test_fit_recovers_known_coefficients():
    """A well-determined synthetic sample set must recover the generating
    coefficients (the quadprog_solver.m property)."""
    from tpusim_torch.power.model import POWER_PRESETS
    from tpusim_torch.power.telemetry import (
        RATE_KEYS, PowerSample, fit_power_coefficients,
    )

    truth = POWER_PRESETS["v5e"]
    coefs = dict(zip(RATE_KEYS, (
        truth.mxu_pj_per_flop, truth.vpu_pj_per_flop, truth.sfu_pj_per_op,
        truth.hbm_pj_per_byte, truth.vmem_pj_per_byte, truth.ici_pj_per_byte,
    )))
    static = truth.static_watts + truth.idle_clock_watts
    scale = {  # plausible absolute event rates
        "mxu_flops": 4e14, "vpu_flops": 7e12, "transcendentals": 9e11,
        "hbm_bytes": 2.7e12, "vmem_bytes": 2.7e13, "ici_bytes": 5e11,
    }
    samples = [PowerSample("idle", static, {})]
    for k in RATE_KEYS:
        rates = {k: scale[k]}
        w = static + coefs[k] * scale[k] * 1e-12
        samples.append(PowerSample(f"only_{k}", w, rates))
    mix = {k: 0.5 * scale[k] for k in RATE_KEYS}
    samples.append(PowerSample(
        "mix", static + sum(coefs[k] * mix[k] * 1e-12 for k in RATE_KEYS),
        mix,
    ))
    fit = fit_power_coefficients(samples, "v5e", prior_weight=1e-4)
    assert fit.mxu_pj_per_flop == pytest.approx(
        truth.mxu_pj_per_flop, rel=0.05
    )
    assert fit.hbm_pj_per_byte == pytest.approx(
        truth.hbm_pj_per_byte, rel=0.05
    )
    assert fit.static_watts + fit.idle_clock_watts == pytest.approx(
        static, rel=0.02
    )
    from tpusim.power.telemetry import PowerSample as RefSample
    from tpusim.power.telemetry import fit_power_coefficients as ref_fit

    ref = ref_fit([RefSample(s.name, s.watts, dict(s.rates))
                   for s in samples], "v5e", prior_weight=1e-4)
    assert vars(fit) == vars(ref)


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_fitted_coefficients_match_anchors_within_band(arch):
    """The committed fitted coefficients must reproduce every anchor
    operating point within the stated +/-16% band; the anchors are the
    reference's."""
    from tpusim.power.telemetry import anchor_samples as ref_anchors
    from tpusim_torch.power.telemetry import (
        _COEF_FIELDS, RATE_KEYS, anchor_samples, load_fitted,
    )

    c = load_fitted(arch)
    assert c is not None, f"tpusim_torch/power/fitted/{arch}.json missing"
    samples = anchor_samples(arch)
    assert [(s.name, s.watts, s.rates) for s in samples] == \
        [(s.name, s.watts, s.rates) for s in ref_anchors(arch)]
    for s in samples:
        watts = sum(
            getattr(c, f) * s.rates.get(k, 0.0) * 1e-12
            for f, k in zip(_COEF_FIELDS, RATE_KEYS)
        ) + c.static_watts + c.idle_clock_watts
        err = abs(watts - s.watts) / s.watts
        assert err < 0.16, (arch, s.name, watts, s.watts)


def test_power_model_prefers_fitted_coefficients():
    from tpusim_torch.power.model import PowerModel
    from tpusim_torch.power.telemetry import load_fitted

    fitted = load_fitted("v5e")
    assert PowerModel("v5e").coeffs == fitted


def test_tune_power_writes_fitted_json(tmp_path):
    from tpusim_torch.harness.tuner import tune_power

    p = tune_power("v5e", out_dir=tmp_path)
    doc = json.loads(p.read_text())
    assert doc["name"] == "v5e"
    assert doc["meta"]["source"] in ("anchors", "telemetry")
    assert doc["coefficients"]["static_watts"] > 0


def test_telemetry_hook_returns_none_or_positive():
    from tpusim_torch.power.telemetry import read_power_watts

    w = read_power_watts()
    assert w is None or w > 0


def test_probe_power_sources_reports_every_source():
    """The probe is the committed evidence for anchor-based
    coefficients: every source must appear with an ok flag and, when it
    failed, a reason; it reads what the reference's probe reads."""
    from tpusim.power.telemetry import probe_power_sources as ref_probe
    from tpusim_torch.power.telemetry import probe_power_sources

    probe = probe_power_sources()
    sources = {t["source"] for t in probe["tried"]}
    assert {"tpu_info", "hwmon"} <= sources
    for t in probe["tried"]:
        assert isinstance(t["ok"], bool)
        if not t["ok"]:
            assert t["detail"]
    if probe["watts"] is not None:
        assert probe["watts"] > 0
    assert [t["source"] for t in probe["tried"]] == \
        [t["source"] for t in ref_probe()["tried"]]


def test_tune_power_meta_records_probe(tmp_path):
    from tpusim_torch.harness.tuner import tune_power

    p = tune_power("v5e", out_dir=tmp_path)
    doc = json.loads(p.read_text())
    probe = doc["meta"]["telemetry_probe"]
    assert isinstance(probe, list) and probe
    if doc["meta"]["source"] == "anchors":
        assert "note" in doc["meta"]      # why no measurement exists
    else:
        assert doc["meta"]["measured_idle_watts"] > 0


# -- tune --power against the JAX package -----------------------------------


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_tune_power_equals_the_reference_cli(arch, tmp_path, capsys):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    assert port_main(["tune", "--power", "--arch", arch,
                      "--out", str(port_dir)]) == 0
    assert f"written to {port_dir / f'{arch}.json'}" in \
        capsys.readouterr().out
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "tpusim", "tune", "--power", "--arch", arch,
         "--out", str(ref_dir)], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = (port_dir / f"{arch}.json").read_bytes()
    assert got == (ref_dir / f"{arch}.json").read_bytes()
    committed = json.loads(
        (REPO / "tpusim_torch" / "power" / "fitted" / f"{arch}.json")
        .read_text())
    assert json.loads(got)["coefficients"] == committed["coefficients"]


def test_tune_defaults_and_refusal(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    committed = {p: p.read_bytes() for p in
                 (REPO / "tpusim_torch" / "power" / "fitted").glob("*.json")}
    assert port_main(["tune", "--power"]) == 0
    out = tmp_path / "build" / "tpusim_torch_reports" / "power_fitted"
    assert json.loads((out / "v5e.json").read_text())["name"] == "v5e"
    assert {p: p.read_bytes() for p in committed} == committed
    capsys.readouterr()
    import tpusim_torch.harness.tuner as tuner

    monkeypatch.setattr(tuner, "_per_step", lambda *a, **k: 1e-3)
    monkeypatch.setattr(tuner, "_fit_host_bw", lambda device=None: 1e10)
    assert port_main(["tune", "--arch", "v5e", "--device", "cpu",
                      "--out", ""]) == 0
    assert json.loads(capsys.readouterr().out)["base_arch"] == "v5e"
    assert not (tmp_path / "build" / "tpusim_torch_reports"
                / "tuned").exists()


# -- the correlation report (tests/test_plots.py) ---------------------------


def _points():
    return [
        CorrelationPoint("mxu", 1.00e-3, 1.05e-3, 1e6, 1e12, 1e9),
        CorrelationPoint("hbm", 2.10e-4, 2.00e-4, 2e5, 1e9, 4e9),
        CorrelationPoint("mix", 5.30e-5, 5.00e-5, 5e4, 1e10, 1e8),
    ]


def test_correlation_stats():
    from tpusim.harness.correlate import CorrelationPoint as RefPoint
    from tpusim.harness.plots import correlation_stats as ref_stats

    stats = correlation_stats(_points())
    assert stats["n"] == 3
    errs = [abs(100 * (p.sim_seconds - p.real_seconds) / p.real_seconds)
            for p in _points()]
    assert stats["mean_abs_error_pct"] == pytest.approx(sum(errs) / 3)
    assert stats["max_abs_error_pct"] == pytest.approx(max(errs))
    assert 0.99 < stats["log_correlation"] <= 1.0
    ref = ref_stats([RefPoint(**vars(p)) for p in _points()])
    assert stats == ref


def test_correlation_stats_empty_and_degenerate():
    assert correlation_stats([]) == {"n": 0}
    bad = [CorrelationPoint("z", 1e-3, 0.0, 1.0, 1.0, 1.0)]
    assert correlation_stats(bad) == {"n": 0}
    one = correlation_stats([_points()[0]])
    assert one["n"] == 1
    assert math.isfinite(one["mean_abs_error_pct"])


def test_write_report(tmp_path):
    from tpusim.harness.correlate import CorrelationPoint as RefPoint
    from tpusim.harness.plots import write_correlation_report as ref_write

    path = write_correlation_report(_points(), tmp_path / "port")
    assert path.name == "correl.html"
    text = path.read_text()
    assert "data:image/png;base64," in text
    assert "mxu" in text and "hbm" in text
    assert (tmp_path / "port" / "correl.png").stat().st_size > 1000
    # worst-error row first IN THE TABLE (hbm: |5.0%| > mxu: |4.76%|);
    # search after the <table> tag so base64 image bytes can't match
    table = text[text.index("<table"):]
    assert table.index("hbm") < table.index("mxu")
    ref = ref_write([RefPoint(**vars(p)) for p in _points()],
                    tmp_path / "ref").read_text()
    assert table == ref[ref.index("<table"):]

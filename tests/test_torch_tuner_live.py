"""The arch tuner and the live power sampler in the port, on the CPU:

* with ``_per_step`` (and the host-bandwidth timer) stubbed by one table in
  both packages, ``tune`` gives the JAX package's ``TunerResult`` (the
  device kind aside), overlay lines and overlay bytes;
* ``tune --out auto`` writes ``build/tpusim_torch_reports/tuned/
  <arch>.tuned.flags`` and leaves ``configs/`` untouched, and
  ``TPUSIM_TUNED_DIR`` pointed there applies it;
* ``_per_step`` off the card falls back to wall time, loudly, and the
  fall back reaches ``details``; ``_fit_ici`` is None on one device;
* ``sample_workload_power`` averages what its meter reads and returns
  None when no meter answers; the NVML reader answers None without
  ``libnvidia-ml``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpusim.harness.tuner as ref_tuner  # noqa: E402
import tpusim_torch.harness.tuner as tuner  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.power import telemetry  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

#: per-step seconds the stub answers, by workload and its distinguishing
#: build argument
PER_STEP = {
    ("matmul", "bfloat16"): 1.6e-4,
    ("matmul", "float32"): 2.1e-3,
    ("elementwise_stream", None): 1.9e-4,
    ("reduction", None): 2.3e-5,
    ("small_matmul_chain", None): 3.1e-4,
    ("op_overhead_chain", 64): 1.2e-4,
    ("op_overhead_chain", 256): 4.4e-4,
    ("transcendental", None): 4.7e-5,
    ("matmul_int8", None): 1.1e-3,
}
HOST_BW = 2.53e10


def _per_step(calls):
    def fake(workload, n_steps, iters=3, **kw):
        calls.append((workload, n_steps, {k: v for k, v in kw.items()
                                          if k != "device"}))
        key = kw.get("dtype", "bfloat16") if workload == "matmul" else (
            kw["depth"] if workload == "op_overhead_chain" else None)
        return PER_STEP[(workload, key)]
    return fake


@pytest.fixture
def stubbed(monkeypatch):
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(tuner, "_per_step", _per_step(calls["port"]))
    monkeypatch.setattr(ref_tuner, "_per_step", _per_step(calls["jax"]))
    monkeypatch.setattr(tuner, "_fit_host_bw", lambda *a, **k: HOST_BW)
    monkeypatch.setattr(ref_tuner, "_fit_host_bw", lambda *a, **k: HOST_BW)
    return calls


@pytest.mark.parametrize("arch", [None, "v5e", "v5p"])
def test_tune_equals_the_reference_under_one_stub(arch, stubbed, tmp_path):
    got = tuner.tune(arch, device="cpu")
    want = ref_tuner.tune(arch)
    assert stubbed["port"] == stubbed["jax"]
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.pop("device_kind") == "cpu"
    b.pop("device_kind")
    assert a == b
    assert got.base_arch == (arch or "v5e")
    assert got.ici_link_bandwidth is None and got.clock_ghz > 0
    assert "fit_errors" not in got.details
    assert got.overlay_lines()[1:] == want.overlay_lines()[1:]
    tuner.write_overlay(got, tmp_path / "port.flags")
    ref_tuner.write_overlay(want, tmp_path / "jax.flags")
    assert ((tmp_path / "port.flags").read_bytes()
            == (tmp_path / "jax.flags").read_bytes())


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_tune_out_auto_writes_under_build(stubbed, tmp_path, monkeypatch,
                                          capsys):
    configs = _digests(REPO / "configs")
    monkeypatch.chdir(tmp_path)
    assert port_main(["tune", "--arch", "v5e", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[:out.index("\noverlay written to")])
    flags = tmp_path / "build" / "tpusim_torch_reports" / "tuned"
    path = flags / "v5e.tuned.flags"
    assert path.read_text().splitlines()[1] == (
        f"-arch.clock_ghz {doc['clock_ghz']:.4g}")
    assert [p.name for p in flags.iterdir()] == ["v5e.tuned.flags"]
    assert not (tmp_path / "configs").exists()
    assert _digests(REPO / "configs") == configs
    # applied only on request, through TPUSIM_TUNED_DIR
    from tpusim_torch.timing.config import load_config

    monkeypatch.setenv("TPUSIM_TUNED_DIR", str(flags))
    assert load_config(arch="v5e").arch.clock_ghz == pytest.approx(
        float(f"{doc['clock_ghz']:.4g}"))
    assert port_main(["tune", "--arch", "v5p", "--device", "cpu",
                      "--out", ""]) == 0
    assert "overlay written" not in capsys.readouterr().out
    assert not (flags / "v5p.tuned.flags").exists()


def test_per_step_off_the_card_falls_back_to_wall_time(monkeypatch, capsys):
    tuner._WALL_FALLBACKS.clear()
    t = tuner._per_step("op_overhead_chain", 2, iters=1, depth=4,
                        device="cpu")
    assert t > 0
    assert tuner._WALL_FALLBACKS[0].startswith(
        "op_overhead_chain: RuntimeError: no device events")
    assert "fitting against WALL time" in capsys.readouterr().err
    tuner._WALL_FALLBACKS.clear()


def test_tune_records_wall_fallbacks_and_fit_errors(monkeypatch):
    """Every fit on the CPU falls back to wall time (recorded), the host
    copy has no device to reach (a fit error), and no link on one
    device."""
    def wall_step(workload, n_steps, iters=3, **kw):
        tuner._WALL_FALLBACKS.append(f"{workload}: stub")
        return 1e-3

    monkeypatch.setattr(tuner, "_per_step", wall_step)
    got = tuner.tune("v5e", device="cpu")
    assert len(got.details["wall_time_fallbacks"]) == 9
    assert list(got.details["fit_errors"]) == ["host_bandwidth"]
    assert got.host_bandwidth is None and got.ici_link_bandwidth is None
    assert tuner._fit_ici(None, device="cpu") is None


def test_sample_workload_power_averages_the_meter():
    module, args = get_workload("matmul").build(device="cpu", m=8, n=8, k=8,
                                                dtype="float32")
    reads = itertools.cycle([100.0, 110.0, 120.0])
    seen = []

    def meter():
        seen.append(next(reads))
        return seen[-1]

    s = telemetry.sample_workload_power(module, args, name="mm",
                                        seconds=0.05, poll_s=0.001,
                                        meter=meter)
    assert s is not None and s.name == "mm" and s.rates == {}
    polled = seen[1:]                    # the first read only probes
    assert polled and s.watts == pytest.approx(sum(polled) / len(polled))


def test_sample_workload_power_none_without_a_meter():
    module, args = get_workload("matmul").build(device="cpu", m=8, n=8, k=8,
                                                dtype="float32")
    assert telemetry.sample_workload_power(
        module, args, seconds=0.01, meter=lambda: None) is None
    # a meter that answers the probe and then stops: no readings
    answers = iter([50.0])
    assert telemetry.sample_workload_power(
        module, args, seconds=0.01, poll_s=0.001,
        meter=lambda: next(answers, None)) is None


def test_nvml_reader_answers_none_without_the_library(monkeypatch):
    import ctypes

    def no_library(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    w = telemetry.read_card_watts()
    assert w is None or w > 0
    monkeypatch.setattr(ctypes, "CDLL", no_library)
    assert telemetry.read_card_watts() is None
    assert telemetry.read_card_watts("cuda:0") is None

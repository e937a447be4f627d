"""The port's simulate against the JAX package and the golden cells.

* ``matmul_512`` at v5e and v5p (golden cells 1-2) passes
  ``ci/check_golden.py``'s ``compare`` (RTOL 1e-9, imported read-only);
* on the 11 collective-free corpus traces x {v4, v5e, v5p, v6e} the port's
  stats equal ``tpusim.sim.driver.simulate_trace``'s key for key at RTOL
  1e-9, untuned, plus one v5e case through the committed tuned overlay;
* a trace with collectives raises ``NotImplementedError`` naming A2.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.sim.stats import EXIT_SENTINEL  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
COLLECTIVE_FREE = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [FIXTURES / "matmul_512"]
)
ARCHES = ("v4", "v5e", "v5p", "v6e")
RTOL = 1e-9


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(report) -> dict:
    return json.loads(report.stats.to_json())


def assert_same_stats(got: dict, want: dict) -> None:
    volatile = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
    assert set(got) == set(want)
    for key in sorted(want):
        if key in volatile:
            continue
        g, w = got[key], want[key]
        if isinstance(w, (int, float)):
            assert abs(g - w) <= RTOL * max(abs(g), abs(w), 1e-30), (key, g, w)
        else:
            assert g == w, key


def test_corpus_has_eleven_collective_free_traces():
    assert len(COLLECTIVE_FREE) == 11


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_golden_cells(arch):
    cg = _check_golden()
    stats = _stats(port_simulate(FIXTURES / "matmul_512", arch=arch,
                                 tuned=False))
    stats = {k: v for k, v in stats.items() if k not in cg.VOLATILE}
    assert cg.compare({f"matmul_512__{arch}": stats}) == []


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("trace", COLLECTIVE_FREE, ids=lambda p: p.name)
def test_stats_match_reference(trace, arch):
    want = _stats(ref_simulate(trace, arch=arch, tuned=False))
    got = _stats(port_simulate(trace, arch=arch, tuned=False))
    assert_same_stats(got, want)


def test_tuned_overlay_matches_reference(monkeypatch):
    # the repo-root configs/v5e.tuned.flags applies in both packages
    monkeypatch.delenv("TPUSIM_TUNED_DIR", raising=False)
    trace = REPO / "reports" / "silicon" / "attention_1chip"
    want = _stats(ref_simulate(trace, arch="v5e"))
    got = _stats(port_simulate(trace, arch="v5e"))
    assert_same_stats(got, want)
    assert got != _stats(port_simulate(trace, arch="v5e", tuned=False))


def test_default_arch_follows_the_trace():
    # a TPU v5 lite capture defaults to v5e, as in the reference
    trace = REPO / "reports" / "silicon" / "matmul_chain"
    assert_same_stats(_stats(port_simulate(trace, tuned=False)),
                      _stats(ref_simulate(trace, tuned=False)))


def test_collectives_raise_naming_a2():
    with pytest.raises(NotImplementedError, match="A2"):
        port_simulate(FIXTURES / "llama_tiny_tp2dp2", arch="v5p")


def test_cli_simulate_prints_stats_and_sentinel():
    proc = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "simulate",
         str(FIXTURES / "matmul_512"), "--arch", "v5e"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == EXIT_SENTINEL
    assert any(ln.startswith("tpusim_sim_cycle = ") for ln in lines)
    assert sum(ln.startswith("tpusim_") for ln in lines) >= 29


def test_cli_simulate_refuses_collectives():
    from tpusim_torch.__main__ import main

    assert main(["simulate", str(FIXTURES / "llama_tiny_tp2dp2")]) == 2

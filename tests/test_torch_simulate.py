"""The port's simulate against the JAX package and the golden cells.

* all 5 golden cells (``ci/check_golden.py``'s ``MATRIX``: ``matmul_512``
  at v5e and v5p, ``llama_tiny_tp2dp2`` analytic, detailed and with power)
  pass its ``compare`` (RTOL 1e-9, imported read-only);
* on the 11 collective-free corpus traces x {v4, v5e, v5p, v6e} the port's
  stats equal ``tpusim.sim.driver.simulate_trace``'s key for key at RTOL
  1e-9, untuned, plus one v5e case through the committed tuned overlay;
* ``llama_tiny_tp2dp2`` (14 collectives) x {v4, v5e, v5p, v6e} x
  {analytic, detailed} x {power off, on} equals the JAX package the same
  way, as do its DCN flags, op- and kernel-granularity checkpoint/resume,
  and standalone collective commands on a 4-device pod (aligned,
  disjoint groups, a ragged count);
* the CLI prints the stats, the exit sentinel and the JAX CLI's power
  report.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim import ir as ref_ir  # noqa: E402
from tpusim.sim.driver import SimDriver as RefDriver  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.timing.config import SimConfig as RefConfig  # noqa: E402
from tpusim.trace.hlo_text import parse_hlo_module as ref_parse  # noqa: E402
from tpusim_torch import ir as port_ir  # noqa: E402
from tpusim_torch.sim.driver import SimDriver as PortDriver  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.sim.stats import EXIT_SENTINEL  # noqa: E402
from tpusim_torch.timing.config import SimConfig as PortConfig  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module as port_parse  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
COLLECTIVE_FREE = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [FIXTURES / "matmul_512"]
)
LLAMA = FIXTURES / "llama_tiny_tp2dp2"
ARCHES = ("v4", "v5e", "v5p", "v6e")
RTOL = 1e-9
DETAILED = {"arch": {"ici": {"network_mode": "detailed"}}}
POWER = {"power_enabled": True}
DCN = {"arch": {"ici": {"chips_per_slice": 2, "dcn_nics_per_slice": 8}}}


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
    """The collective gap of ROADMAP A2, which used to raise here, is
    closed: the multi-device fixture prices its 14 collectives."""
    stats = _stats(port_simulate(LLAMA, arch="v5p", tuned=False))
    assert stats["tot_collective_count"] == 14
    assert stats["tot_ici_bytes"] > 0 and stats["tot_collective_cycles"] > 0


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


def test_cli_simulate_refuses_collectives(tmp_path, capsys):
    """The CLI no longer refuses collectives; it refuses an ICI network
    mode that neither package knows, naming it."""
    from tpusim_torch.__main__ import main

    assert main(["simulate", str(LLAMA)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == EXIT_SENTINEL
    flags = tmp_path / "net.flags"
    flags.write_text("-arch.ici.network_mode booksim\n")
    assert main(["simulate", str(LLAMA), "--config", str(flags)]) == 2
    assert "booksim" in capsys.readouterr().err


# -- the multi-device slice: collectives, detailed ICI, DCN, power -----------

MULTI_DEVICE_CELLS = _check_golden().MATRIX[2:]


@pytest.mark.parametrize(
    "fixture,arch,overlays", MULTI_DEVICE_CELLS,
    ids=[f"{a}-{'_'.join(map(str, o)) or 'analytic'}"
         for _, a, o in MULTI_DEVICE_CELLS])
def test_golden_cells_multi_device(fixture, arch, overlays):
    cg = _check_golden()
    stats = _stats(port_simulate(FIXTURES / fixture, arch=arch,
                                 overlays=list(overlays), tuned=False))
    stats = {k: v for k, v in stats.items() if k not in cg.VOLATILE}
    name = f"{fixture}__{arch}"
    if overlays:
        name += "__" + cg._overlay_tag(overlays)
    assert cg.compare({name: stats}) == []


def _both(overlays: list, arch: str = "v5p") -> tuple[dict, dict]:
    got = _stats(port_simulate(LLAMA, arch=arch, overlays=list(overlays),
                               tuned=False))
    want = _stats(ref_simulate(LLAMA, arch=arch, overlays=list(overlays),
                               tuned=False))
    return got, want


@pytest.mark.parametrize("power", [False, True], ids=["nopower", "power"])
@pytest.mark.parametrize("mode", ["analytic", "detailed"])
@pytest.mark.parametrize("arch", ARCHES)
def test_llama_matches_reference(arch, mode, power):
    overlays = [{"arch": {"ici": {"network_mode": mode}}}]
    if power:
        overlays.append(POWER)
    got, want = _both(overlays, arch)
    assert_same_stats(got, want)
    assert got["tot_collective_count"] == 14
    assert ("power_avg_watts" in got) == power


@pytest.mark.parametrize("mode", ["analytic", "detailed"])
def test_llama_dcn_flags_match_reference(mode):
    got, want = _both([DCN, {"arch": {"ici": {"network_mode": mode}}}])
    assert_same_stats(got, want)
    assert got["dcn_slices"] == 2 and got["dcn_nics_per_slice"] == 8
    assert {k for k in got if k.startswith("dcn_")} == {
        "dcn_slices", "dcn_chips_per_slice", "dcn_nics_per_slice",
        "dcn_slice_bandwidth"}
    # a flat chips_per_slice (no NICs) prices slice-spanning groups but
    # stamps no dcn_* keys
    got, want = _both([{"arch": {"ici": {"chips_per_slice": 2}}}])
    assert_same_stats(got, want)
    assert not any(k.startswith("dcn_") for k in got)


@pytest.mark.parametrize("overlay", [
    {"resume_op": 100}, {"resume_op": 200},
    {"checkpoint_op": 100}, {"checkpoint_op": 200},
    {"resume_kernel": 1}, {"checkpoint_kernel": 1},
], ids=lambda o: "_".join(f"{k}{v}" for k, v in o.items()))
def test_llama_checkpoint_resume_match_reference(overlay):
    got, want = _both([overlay])
    assert_same_stats(got, want)


# standalone collective commands on a 4-device pod, built the same way in
# both packages (the shape of tests/test_driver.py's rendezvous tests)

def _standalone_pod(ir, parse, case: str):
    nb = 48 * 1024 * 1024
    mod = parse((FIXTURES.parent / "tiny_mlp.hlo").read_text())
    pod = ir.PodTrace(meta={"num_devices": 4})
    pod.modules["m"] = mod
    everyone = ir.CollectiveInfo("all-reduce", replica_groups=((0, 1, 2, 3),))
    pairs = {d: ir.CollectiveInfo(
        "all-gather", replica_groups=((0, 1),) if d < 2 else ((2, 3),))
        for d in range(4)}

    def cmd(kind, d, **kw):
        pod.device(d).commands.append(ir.TraceCommand(kind=kind, device_id=d,
                                                      **kw))

    for d in range(4):
        cmd(ir.CommandKind.MEMCPY_H2D, d, nbytes=1 << 20)
        if case == "aligned":
            for k in range(3):
                # device d runs d kernels before its first collective and
                # one before each later one, so the arrivals differ
                for _ in range(d if k == 0 else 1):
                    cmd(ir.CommandKind.KERNEL_LAUNCH, d, module="m")
                cmd(ir.CommandKind.COLLECTIVE, d, nbytes=nb, collective=everyone)
        elif case == "disjoint":
            if d >= 2:
                cmd(ir.CommandKind.KERNEL_LAUNCH, d, module="m")
            for _ in range(1 if d < 2 else 2):
                cmd(ir.CommandKind.COLLECTIVE, d, nbytes=nb,
                    collective=pairs[d])
        else:  # ragged: device 3 drops one of the all-reduces
            for k in range(3 if d != 3 else 2):
                cmd(ir.CommandKind.KERNEL_LAUNCH, d, module="m")
                cmd(ir.CommandKind.COLLECTIVE, d, nbytes=nb, collective=everyone)
        cmd(ir.CommandKind.MEMCPY_D2H, d, nbytes=1 << 20)
    return pod


@pytest.mark.parametrize("case", ["aligned", "disjoint", "ragged"])
@pytest.mark.parametrize("mode", ["analytic", "detailed"])
def test_standalone_collectives_match_reference(case, mode):
    overlay = {"arch": {"ici": {"network_mode": mode}}}
    from tpusim.timing.config import load_config as ref_load
    from tpusim_torch.timing.config import load_config as port_load

    want = RefDriver(ref_load(arch="v5p", overlays=[overlay], tuned=False)).run(
        _standalone_pod(ref_ir, ref_parse, case))
    got = PortDriver(port_load(arch="v5p", overlays=[overlay], tuned=False)).run(
        _standalone_pod(port_ir, port_parse, case))
    assert_same_stats(_stats(got), _stats(want))
    assert got.device_cycles == want.device_cycles
    mismatch = got.stats.get("collective_rendezvous_mismatch")
    assert mismatch == (1 if case == "ragged" else None)
    if case == "ragged":
        assert "dev3:2!=dev0:3" in got.stats.get("collective_counts_per_device")
    if case == "disjoint":
        # (0, 1) never waits for the later pair (2, 3)
        assert got.device_cycles[0] < got.device_cycles[2]


def test_standalone_collectives_resume_keeps_rendezvous_aligned():
    # resume after kernel 1: the skipped first collectives still advance
    # each device's per-group index
    cfgs = (RefConfig(resume_kernel=1), PortConfig(resume_kernel=1))
    want = RefDriver(cfgs[0]).run(_standalone_pod(ref_ir, ref_parse, "aligned"))
    got = PortDriver(cfgs[1]).run(_standalone_pod(port_ir, port_parse,
                                                  "aligned"))
    assert_same_stats(_stats(got), _stats(want))


def test_cli_detailed_power_matches_reference_report(capsys):
    from tpusim.__main__ import main as ref_main
    from tpusim_torch.__main__ import main as port_main

    argv = ["simulate", str(LLAMA), "--arch", "v5p", "--network-mode",
            "detailed", "--power"]
    assert port_main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    assert ref_main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[-1] == EXIT_SENTINEL
    n = got.index("tpusim_collective_cmd_cycles = 0")
    assert got[:n] == want[:want.index("tpusim_collective_cmd_cycles = 0")]
    assert got[0] == "TPUWattch power report"
    assert "tpusim_tot_collective_count = 14" in got


def test_chip_smoke_checks_every_golden_cell(capsys):
    """``chip_smoke.py``'s simulate half names the golden matrix cell for
    cell, and passes on the CPU host too (the card plays no part in it)."""
    cg = _check_golden()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = [(f, a, o, f"{f}__{a}" + (f"__{cg._overlay_tag(o)}" if o else ""))
            for f, a, o in cg.MATRIX]
    assert [tuple(c) for c in smoke.GOLDEN_CELLS] == want
    smoke.simulate_cells("cpu")
    out = capsys.readouterr().out
    assert out.count("stats match; host") == 5
    assert "tpusim_tot_collective_count = 14" in out
    assert "{'flash_attention': 0, 'scan_rows': 0}" in out

"""The port's degraded-pod simulation against the JAX package.

* schedules: ``FAULT_KINDS`` equals the JAX package's and
  ``ci/faults_schema.json``'s; every example schedule gives the same
  ``to_doc()``; every malformed document and every bad binding of
  ``tests/test_faults.py`` raises ``FaultScheduleError`` with the same
  message in both;
* fault views bound on ``torus_for(64, "v5p")`` and ``torus_for(4,
  "v5p")`` give equal ``stats_dict``, ``signature``, per-axis summaries,
  ``link_alive``/``link_scale`` over every directed link and
  ``chip_scales`` over every chip; a partitioning schedule raises
  ``TopologyPartitionedError`` with the same message;
* faulted ``simulate`` stats are equal under ``compare`` of
  ``ci/check_golden.py`` (RTOL 1e-9, with the JAX package's stats as the
  golden) and bit-equal: every example schedule on ``llama_tiny_tp2dp2``
  @ v5p with both networks on the pod's own topology and on
  ``torus_for(64, "v5p")``; ``chip_straggler`` and ``hbm_throttle`` on
  chip 0 of each of the 12 corpus traces; the windowed link fault and the
  windowed straggler of ``tests/test_faults.py``;
* the faults smoke contract, run against the port by ``chip_smoke.py``'s
  phase 7 (a), gives the JAX smoke's summary;
* ``python -m tpusim_torch faults --json`` equals ``python -m tpusim
  faults --json``, and a bad schedule is refused with rc 2 in both.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim import faults as ref_faults  # noqa: E402
from tpusim import ir as ref_ir  # noqa: E402
from tpusim.ici.detailed import TorusNetwork as RefNetwork  # noqa: E402
from tpusim.ici.topology import Topology as RefTopology  # noqa: E402
from tpusim.ici.topology import torus_for as ref_torus  # noqa: E402
from tpusim.sim.driver import SimDriver as RefDriver  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.timing.config import SimConfig as RefConfig  # noqa: E402
from tpusim.trace.hlo_text import parse_hlo_module as ref_parse  # noqa: E402
from tpusim_torch import faults as port_faults  # noqa: E402
from tpusim_torch import ir as port_ir  # noqa: E402
from tpusim_torch.ici.detailed import TorusNetwork as PortNetwork  # noqa: E402
from tpusim_torch.ici.topology import Topology as PortTopology  # noqa: E402
from tpusim_torch.ici.topology import torus_for as port_torus  # noqa: E402
from tpusim_torch.sim.driver import SimDriver as PortDriver  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.timing.config import SimConfig as PortConfig  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module as port_parse  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
LLAMA = FIXTURES / "llama_tiny_tp2dp2"
CORPUS = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [FIXTURES / "matmul_512", LLAMA]
)
SCHEMA = json.loads((REPO / "ci" / "faults_schema.json").read_text())
EXAMPLES = SCHEMA["example_schedules"]
MB = 1024 * 1024


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _check_golden()


def _stats(report) -> dict:
    return {k: v for k, v in json.loads(report.stats.to_json()).items()
            if k not in CG.VOLATILE}


def assert_same_under_compare(got, want, tmp_path: Path) -> None:
    """``compare`` of ``ci/check_golden.py`` with the JAX report as the
    golden (RTOL 1e-9), then bit-equality, which the port also keeps."""
    got, want = _stats(got), _stats(want)
    (tmp_path / "ref.json").write_text(json.dumps(want))
    CG.GOLDEN_DIR = tmp_path
    assert CG.compare({"ref": got}) == []
    assert got == want


# -- schedules ---------------------------------------------------------------

def test_fault_kinds_match_reference_and_schema():
    assert port_faults.FAULT_KINDS == ref_faults.FAULT_KINDS
    assert set(port_faults.FAULT_KINDS) == set(SCHEMA["fault_kinds"])


@pytest.mark.parametrize("kind", sorted(EXAMPLES))
def test_example_schedule_docs_match_reference(kind):
    doc = EXAMPLES[kind]
    got = port_faults.load_fault_schedule(doc)
    assert got.faults[0].kind == kind
    assert got.to_doc() == ref_faults.load_fault_schedule(doc).to_doc()
    # JSON text and the document round-trip to the same schedule
    assert port_faults.load_fault_schedule(json.dumps(doc)) == got
    assert port_faults.load_fault_schedule(got.to_doc()) == got


#: the malformed documents of tests/test_faults.py:45-86
MALFORMED = [
    {"faults": [{"kind": "meteor_strike"}]},
    {"faults": [{"kind": "link_down", "src": 0}]},
    {"faults": [{"kind": "chip_straggler", "clock_scale": 0.5}]},
    {"faults": [{"kind": "link_degraded", "src": 0, "dst": 1}]},
    *({"faults": [{"kind": "chip_straggler", "chip": 0, "clock_scale": bad}]}
      for bad in (0.0, -0.5, 1.5, "half")),
    {"faults": [{"kind": "link_down", "src": 0, "dst": 1,
                 "start_cycle": 100, "end_cycle": 100}]},
    {"faults": [{"kind": "link_down", "src": 0, "dst": 1, "oops": True}]},
    {"nope": []},
    "{not json",
    {"faults": [{"kind": "dcn_link_down", "slice": -1}]},
    {"faults": "link_down"},
    {"faults": [{"kind": "chip_straggler", "chip": True,
                 "clock_scale": 0.5}]},
]


@pytest.mark.parametrize("doc", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_schedule_raises_like_reference(doc):
    with pytest.raises(ref_faults.FaultScheduleError) as want:
        ref_faults.load_fault_schedule(doc)
    with pytest.raises(port_faults.FaultScheduleError) as got:
        port_faults.load_fault_schedule(doc)
    assert str(got.value) == str(want.value)


def test_missing_schedule_file_raises_like_reference(tmp_path):
    path = str(tmp_path / "absent.json")
    with pytest.raises(port_faults.FaultScheduleError, match="not found"):
        port_faults.load_fault_schedule(path)
    (tmp_path / "bad.json").write_text("{oops")
    with pytest.raises(ref_faults.FaultScheduleError) as want:
        ref_faults.load_fault_schedule(str(tmp_path / "bad.json"))
    with pytest.raises(port_faults.FaultScheduleError) as got:
        port_faults.load_fault_schedule(str(tmp_path / "bad.json"))
    assert str(got.value) == str(want.value)


#: the bad bindings of tests/test_faults.py's test_bind_validates_*
BAD_BINDINGS = [
    {"kind": "link_down", "src": [9, 0, 0], "dst": [0, 0, 0]},
    {"kind": "link_down", "src": [0, 0], "dst": [1, 0]},
    {"kind": "link_down", "src": [0, 0, 0], "dst": [2, 0, 0]},
    {"kind": "hbm_throttle", "chip": 64, "hbm_scale": 0.5},
    {"kind": "link_down", "src": 5, "dst": 5},
]


@pytest.mark.parametrize("rec", BAD_BINDINGS, ids=range(len(BAD_BINDINGS)))
def test_bad_binding_raises_like_reference(rec):
    doc = {"faults": [rec]}
    with pytest.raises(ref_faults.FaultScheduleError) as want:
        ref_faults.load_fault_schedule(doc).bind(ref_torus(64, "v5p"))
    with pytest.raises(port_faults.FaultScheduleError) as got:
        port_faults.load_fault_schedule(doc).bind(port_torus(64, "v5p"))
    assert str(got.value) == str(want.value)


# -- fault views -------------------------------------------------------------

#: three scales whose float64 product depends on the order of the factors
_SCALES = [0.6375365295912734, 0.8810846638965013, 0.5785151418630428]

VIEW_SCHEDULES = {
    **EXAMPLES,
    "overlapping": {"faults": [
        *({"kind": "hbm_throttle", "chip": 1, "hbm_scale": s}
          for s in _SCALES[::-1]),
        *({"kind": "link_degraded", "src": [0, 0, 0], "dst": [0, 1, 0],
           "bandwidth_scale": s} for s in _SCALES),
        {"kind": "chip_straggler", "chip": 0, "clock_scale": 0.7},
        {"kind": "chip_straggler", "chip": 0, "clock_scale": 0.9},
    ]},
    "mixed_windows": {"faults": [
        {"kind": "link_down", "src": [0, 0, 0], "dst": [0, 0, 1],
         "directed": True, "start_cycle": 100},
        {"kind": "link_degraded", "src": 0, "dst": 1,
         "bandwidth_scale": 0.25, "end_cycle": 5000},
        {"kind": "dcn_link_down", "slice": 0},
        {"kind": "dcn_link_down", "slice": 0},
        {"kind": "slice_down", "slice": 1},
    ]},
}


def _view_summary(view, topo) -> dict:
    return {
        "stats": view.stats_dict(),
        "signature": view.signature,
        "broken_axes": view.broken_axes,
        "axis_min_scale": view.axis_min_scale,
        "scales": view.scales,
        "links_down": view.links_down,
        "alive": [view.link_alive(s, d)
                  for s, d, _, _ in topo.directed_links()],
        "link_scale": [view.link_scale(s, d)
                       for s, d, _, _ in topo.directed_links()],
        "chips": [view.chip_scales(c) for c in range(topo.num_chips)],
    }


@pytest.mark.parametrize("chips", [64, 4])
@pytest.mark.parametrize("name", sorted(VIEW_SCHEDULES))
def test_fault_views_match_reference(name, chips):
    doc = VIEW_SCHEDULES[name]
    ref_topo, port_topo = ref_torus(chips, "v5p"), port_torus(chips, "v5p")
    want_state = ref_faults.load_fault_schedule(doc).bind(ref_topo)
    got_state = port_faults.load_fault_schedule(doc).bind(port_topo)
    assert got_state.intervals() == want_state.intervals()
    assert got_state.windowed == want_state.windowed
    for cycle in (0.0, 150.0, 1e7):
        assert _view_summary(got_state.view_at(cycle), port_topo) == \
            _view_summary(want_state.view_at(cycle), ref_topo)
    got_full = got_state.full_view()
    assert _view_summary(got_full, port_topo) == \
        _view_summary(want_state.full_view(), ref_topo)
    # the topology forwards its link queries to the attached view
    faulted = port_topo.with_faults(got_full)
    for s, d, _, _ in port_topo.directed_links():
        assert faulted.link_alive(s, d) == got_full.link_alive(s, d)
        assert faulted.link_scale(s, d) == got_full.link_scale(s, d)


def test_overlapping_composition_is_order_independent():
    topo = port_torus(64, "v5p")
    views = []
    for order in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        views.append(port_faults.load_fault_schedule({"faults": [
            {"kind": "hbm_throttle", "chip": 5, "hbm_scale": _SCALES[i]}
            for i in order]}).bind(topo).view_at(0.0))
    assert len({v.signature for v in views}) == 1
    prod = 1.0
    for s in sorted(_SCALES):
        prod *= s
    assert views[0].chip_scales(5) == (1.0, prod)


def test_partitioned_topology_raises_like_reference():
    def route(faults, topology_cls, network_cls):
        line = topology_cls(dims=(4,), wrap=(False,))
        view = faults.link_down_schedule(line, 1, 2).bind(line).view_at(0.0)
        net = network_cls(line.with_faults(view), flit_bytes=90.0,
                          hop_cycles=1)
        net._route(1, 2)

    with pytest.raises(ref_faults.TopologyPartitionedError) as want:
        route(ref_faults, RefTopology, RefNetwork)
    with pytest.raises(port_faults.TopologyPartitionedError) as got:
        route(port_faults, PortTopology, PortNetwork)
    assert str(got.value) == str(want.value)
    assert "no live ICI route from chip 1 [1] to chip 2" in str(got.value)


# -- faulted simulate --------------------------------------------------------

@pytest.mark.parametrize("on_64", [False, True], ids=["pod", "torus64"])
@pytest.mark.parametrize("mode", ["analytic", "detailed"])
@pytest.mark.parametrize("kind", sorted(EXAMPLES))
def test_example_schedules_simulate_like_reference(kind, mode, on_64,
                                                   tmp_path):
    overlays = [{"arch": {"ici": {"network_mode": mode}}}]
    kw = dict(arch="v5p", overlays=overlays, tuned=False,
              faults=EXAMPLES[kind])
    want = ref_simulate(LLAMA, topology=ref_torus(64, "v5p") if on_64
                        else None, **kw)
    got = port_simulate(LLAMA, topology=port_torus(64, "v5p") if on_64
                        else None, **kw)
    assert_same_under_compare(got, want, tmp_path)
    assert got.stats.get("faults_active") == 1


@pytest.mark.parametrize("fault", [
    {"kind": "chip_straggler", "chip": 0, "clock_scale": 0.7},
    {"kind": "hbm_throttle", "chip": 0, "hbm_scale": 0.55},
], ids=["chip_straggler", "hbm_throttle"])
@pytest.mark.parametrize("trace", CORPUS, ids=lambda p: p.name)
def test_chip_faults_on_corpus_like_reference(trace, fault, tmp_path):
    doc = {"faults": [fault]}
    want = ref_simulate(trace, arch="v5p", tuned=False, faults=doc)
    got = port_simulate(trace, arch="v5p", tuned=False, faults=doc)
    assert_same_under_compare(got, want, tmp_path)
    assert got.stats.get("faults_chips_degraded") == 1
    # chip 0 issues every command of a corpus trace: a slower clock slows
    # every op that costs cycles; a throttled HBM only the memory-bound ones
    healthy = port_simulate(trace, arch="v5p", tuned=False)
    if fault["kind"] == "chip_straggler":
        assert got.cycles > healthy.cycles
    else:
        assert got.cycles >= healthy.cycles


def test_schedule_path_and_text_simulate_alike(tmp_path):
    topo = port_torus(4, "v5p")
    a, b = topo.undirected_links()[0]
    doc = port_faults.link_down_schedule(topo, a, b).to_doc()
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(doc))
    runs = [_stats(port_simulate(LLAMA, arch="v5p", tuned=False, faults=f))
            for f in (doc, str(path), json.dumps(doc))]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0]["faults_links_down"] == 2


#: two chained dots, no collectives (tests/test_faults.py's _DOTS_HLO)
_DOTS_HLO = """\
HloModule straggler_test, is_scheduled=true

ENTRY %main (x: bf16[256,256], w: bf16[256,256]) -> bf16[256,256] {
  %x = bf16[256,256]{1,0:T(8,128)(2,1)} parameter(0)
  %w = bf16[256,256]{1,0:T(8,128)(2,1)} parameter(1)
  %dot.1 = bf16[256,256]{1,0:T(8,128)(2,1)} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %dot.2 = bf16[256,256]{1,0:T(8,128)(2,1)} dot(%dot.1, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""


def _collective_pod(ir):
    n, nb = 8, 64 * MB
    info = ir.CollectiveInfo("all-reduce", replica_groups=(tuple(range(n)),))
    pod = ir.PodTrace(meta={"num_devices": n})
    for d in range(n):
        for _ in range(2):
            pod.device(d).commands.append(ir.TraceCommand(
                kind=ir.CommandKind.COLLECTIVE, device_id=d, nbytes=nb,
                collective=info))
    return pod


def _kernel_pod(ir, parse, devices: int = 1):
    pod = ir.PodTrace(meta={"num_devices": devices})
    pod.modules["m"] = parse(_DOTS_HLO)
    for d in range(devices):
        for _ in range(2):
            pod.device(d).commands.append(ir.TraceCommand(
                kind=ir.CommandKind.KERNEL_LAUNCH, device_id=d, module="m"))
    return pod


def test_windowed_link_fault_like_reference(tmp_path):
    """tests/test_faults.py's windowed link fault: a dead wrap link whose
    window opens before the second of two standalone all-reduces."""
    ref_topo = RefTopology(dims=(8,), wrap=(True,))
    port_topo = PortTopology(dims=(8,), wrap=(True,))
    first_end = RefDriver(RefConfig(), topology=ref_topo).run(
        _collective_pod(ref_ir)).cycles / 2.0
    cycles = {}
    for label, window in (("healthy", None), ("full", {}),
                          ("windowed", {"start_cycle": first_end * 0.99})):
        faults = None
        if window is not None:
            faults = {"faults": [{"kind": "link_down", "src": 0, "dst": 7,
                                  **window}]}
        want = RefDriver(RefConfig(), topology=ref_topo, faults=faults).run(
            _collective_pod(ref_ir))
        got = PortDriver(PortConfig(), topology=port_topo, faults=faults).run(
            _collective_pod(port_ir))
        assert_same_under_compare(got, want, tmp_path)
        assert got.device_cycles == want.device_cycles
        cycles[label] = got.cycles
    assert cycles["healthy"] < cycles["windowed"] < cycles["full"]


def test_windowed_straggler_like_reference(tmp_path):
    """tests/test_faults.py's windowed straggler: only the launch its
    window overlaps slows; a window that never opens changes nothing but
    the schedule-shape stats."""
    first_end = RefDriver(RefConfig()).run(
        _kernel_pod(ref_ir, ref_parse)).cycles / 2.0
    cycles = {}
    for label, window in (("healthy", None), ("full", {}),
                          ("windowed", {"start_cycle": first_end * 0.99}),
                          ("late", {"start_cycle": first_end * 20})):
        faults = None
        if window is not None:
            faults = {"faults": [{"kind": "chip_straggler", "chip": 0,
                                  "clock_scale": 0.5, **window}]}
        want = RefDriver(RefConfig(), faults=faults).run(
            _kernel_pod(ref_ir, ref_parse))
        got = PortDriver(PortConfig(), faults=faults).run(
            _kernel_pod(port_ir, port_parse))
        assert_same_under_compare(got, want, tmp_path)
        assert [(k.start_cycle, k.end_cycle) for k in got.kernels] == \
            [(k.start_cycle, k.end_cycle) for k in want.kernels]
        cycles[label] = got.cycles
    assert cycles["healthy"] < cycles["windowed"] < cycles["full"]
    assert cycles["late"] == cycles["healthy"]


def test_straggler_slows_only_its_chip_like_reference(tmp_path):
    faults = {"faults": [{"kind": "chip_straggler", "chip": 0,
                          "clock_scale": 0.5}]}
    want = RefDriver(RefConfig(), faults=faults).run(
        _kernel_pod(ref_ir, ref_parse, devices=2))
    got = PortDriver(PortConfig(), faults=faults).run(
        _kernel_pod(port_ir, port_parse, devices=2))
    assert_same_under_compare(got, want, tmp_path)
    assert got.device_cycles[0] > got.device_cycles[1]


def test_engine_rejects_out_of_range_scales():
    from tpusim_torch.timing.engine import Engine

    for kw in ({"clock_scale": 0.0}, {"hbm_scale": 1.5},
               {"clock_scale": -1.0}):
        with pytest.raises(ValueError, match="clock_scale"):
            Engine(PortConfig(), **kw)


def test_faults_smoke_contract_like_reference(capsys):
    """``chip_smoke.py``'s phase 7 (a) runs ``ci/check_golden.py``'s faults
    smoke against the port; its summary equals the JAX smoke's."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.faults_smoke("cpu") == CG.faults_smoke()
    assert "(a) faults smoke: dead link" in capsys.readouterr().out


# -- CLI ---------------------------------------------------------------------

def _ref_faults_cli(argv: list[str], path: Path, capsys) -> tuple:
    from tpusim.__main__ import main as ref_main

    assert ref_main(["faults", *argv, "--json", str(path)]) == 0
    return capsys.readouterr().out.replace(str(path), "REPORT"), \
        path.read_bytes()


@pytest.mark.parametrize("argv", [
    ["--arch", "v5p", "--chips", "64", "--payload-mb", "16", "--top", "3"],
    ["--arch", "v4", "--chips", "64", "--kind", "reduce-scatter"],
    ["--arch", "v5e", "--chips", "16", "--kind", "all-gather"],
    ["--arch", "v5p", "--chips", "8", "--trace", str(LLAMA),
     "--max-scenarios", "5"],
], ids=["v5p-64", "v4-64-reduce-scatter", "v5e-16-all-gather",
        "v5p-8-trace"])
def test_faults_cli_matches_reference(argv, tmp_path, capsys):
    from tpusim_torch.__main__ import main as port_main

    want = _ref_faults_cli(argv, tmp_path / "ref.json", capsys)
    path = tmp_path / "port.json"
    assert port_main(["faults", *argv, "--json", str(path)]) == 0
    got = (capsys.readouterr().out.replace(str(path), "REPORT"),
           path.read_bytes())
    assert got == want
    assert "scenarios inflate the healthy baseline" in got[0]


def test_faults_cli_module_run_matches_reference(tmp_path, capsys):
    """``python -m tpusim_torch faults --json`` in its own process."""
    argv = ["--arch", "v5p", "--chips", "8", "--trace", str(LLAMA)]
    want = _ref_faults_cli(argv, tmp_path / "ref.json", capsys)
    path = tmp_path / "port.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "faults", *argv,
         "--json", str(path)],
        capture_output=True, text=True, cwd=REPO, timeout=180,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert (proc.stdout.replace(str(path), "REPORT"),
            path.read_bytes()) == want
    assert "(8 chips, 12 scenarios)" in want[0]


def test_simulate_cli_faults_and_bad_schedule(tmp_path, capsys):
    from tpusim.__main__ import main as ref_main
    from tpusim_torch.__main__ import main as port_main

    topo = port_torus(4, "v5p")
    a, b = topo.undirected_links()[0]
    good = tmp_path / "good.json"
    good.write_text(json.dumps(
        port_faults.link_down_schedule(topo, a, b).to_doc()))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"faults": [{"kind": "link_down", "src": 0,
                                           "dst": 3}]}))
    for main in (port_main, ref_main):
        assert main(["simulate", str(LLAMA), "--arch", "v5p",
                     "--faults", str(good)]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert "tpusim_faults_links_down = 2" in lines
    got = [port_main(["simulate", str(LLAMA), "--faults", str(bad)]),
           capsys.readouterr().err]
    want = [ref_main(["simulate", str(LLAMA), "--faults", str(bad)]),
            capsys.readouterr().err]
    assert got[0] == want[0] == 2
    # the message is the reference's; the prefix names each package's CLI
    assert got[1].removeprefix("tpusim_torch: error: ") == \
        want[1].removeprefix("tpusim: error: ")
    assert "not torus neighbors" in got[1]

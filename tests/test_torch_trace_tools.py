"""The port's trace tools against the JAX package.

* ``tpusim_torch.sim.interval`` (``tests/test_interval.py``, run on the
  port), ``tpusim_torch.tools.bbv`` and ``.occupancy``
  (``tests/test_tools.py:25-120``), the Chrome trace export and the
  debugger (``tests/test_aux_subsystems.py:40-57,261-284``);
* the CLI: ``timeline --counters`` (the JSON), ``aerial --power --gz``
  (the text lanes and the decompressed log), ``bbv --out``, ``occupancy``
  and a scripted ``debug`` session print and write the JAX CLI's bytes on
  ``matmul_512`` at v5e and the ``llama_tiny_tp2dp2`` module at v5p;
  ``profile`` prints the same phase names and top-op table; the obs flags'
  refusals exit 2;
* ``chip_smoke.py``'s phase 15 (d) and (c) digests (``TOOL_DIGESTS``,
  ``PROFILE_TOP_DIGEST``) are those of the JAX CLI's outputs.
"""

from __future__ import annotations

import contextlib
import gzip
import importlib.util
import io
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.__main__ import main as ref_cli  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.sim.debugger import Debugger  # noqa: E402
from tpusim_torch.sim.interval import (  # noqa: E402
    read_interval_log,
    render_text_lanes,
    sample_intervals,
    write_interval_log,
)
from tpusim_torch.sim.traceviz import (  # noqa: E402
    timeline_to_chrome_trace,
    write_chrome_trace,
)
from tpusim_torch.timing.config import SimConfig, load_config  # noqa: E402
from tpusim_torch.timing.engine import (  # noqa: E402
    Engine,
    EngineResult,
    TimelineEvent,
)
from tpusim_torch.tools.bbv import compute_bbv, write_simpoint_bb  # noqa: E402
from tpusim_torch.tools.occupancy import occupancy_report  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
TRACES = FIXTURES / "traces"
TOOL_CELLS = (("matmul_512", "v5e"), ("llama_tiny_tp2dp2", "v5p"))
TOOLS = ("timeline", "aerial", "bbv", "occupancy", "debug")


@pytest.fixture(scope="module")
def tiny_mlp():
    return parse_hlo_module((FIXTURES / "tiny_mlp.hlo").read_text())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_for_tools", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- interval sampling (tests/test_interval.py) --------------------------------


def _result(events):
    res = EngineResult()
    res.timeline = [TimelineEvent(*e) for e in events]
    return res


def test_event_split_across_windows():
    res = _result([("a", "dot", "mxu", 50.0, 250.0)])
    samples = sample_intervals(res, 100.0)
    assert len(samples) == 3
    assert samples[0].unit_busy["mxu"] == pytest.approx(50.0)
    assert samples[1].unit_busy["mxu"] == pytest.approx(100.0)
    assert samples[2].unit_busy["mxu"] == pytest.approx(50.0)
    # op counted once, in its starting window
    assert [s.op_count for s in samples] == [1, 0, 0]
    assert samples[1].utilization("mxu") == pytest.approx(1.0)


def test_busy_conservation():
    """Total bucketed busy time must equal the sum of event durations."""
    res = _result([
        ("a", "dot", "mxu", 0.0, 333.0),
        ("b", "add", "vpu", 100.0, 450.0),
        ("c", "ar", "ici", 50.0, 60.0),
    ])
    samples = sample_intervals(res, 128.0)
    tot = {}
    for s in samples:
        for u, b in s.unit_busy.items():
            tot[u] = tot.get(u, 0.0) + b
    assert tot["mxu"] == pytest.approx(333.0)
    assert tot["vpu"] == pytest.approx(350.0)
    assert tot["ici"] == pytest.approx(10.0)


def test_log_roundtrip(tmp_path):
    res = _result([("a", "dot", "mxu", 0.0, 150.0)])
    samples = sample_intervals(res, 100.0)
    path = tmp_path / "ivl.jsonl.gz"
    write_interval_log(samples, path, meta={"module": "m"})
    header, loaded = read_interval_log(path)
    assert header["module"] == "m"
    assert len(loaded) == len(samples)
    assert loaded[0].unit_busy == samples[0].unit_busy
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.gz"
        with gzip.open(bad, "wt") as f:
            f.write('{"nope": 1}\n')
        read_interval_log(bad)


def test_render_text_lanes_resamples():
    res = _result(
        [("a", "dot", "mxu", float(i * 10), float(i * 10 + 5))
         for i in range(200)]
    )
    samples = sample_intervals(res, 10.0)
    text = render_text_lanes(samples, width=40)
    lane = [l for l in text.splitlines() if l.strip().startswith("mxu")][0]
    assert lane.count("|") == 2
    assert len(lane.split("|")[1]) == 40


def test_engine_timeline_to_intervals(fixtures_dir):
    mod = parse_hlo_module((fixtures_dir / "tiny_mlp.hlo").read_text())
    cfg = SimConfig()
    res = Engine(cfg, record_timeline=True).run(mod)
    samples = sample_intervals(res, cfg.stat_sample_cycles)
    assert samples
    busy = sum(s.unit_busy.get("mxu", 0.0) for s in samples)
    assert busy == pytest.approx(
        res.unit_busy_cycles["mxu"], rel=1e-6
    )


# -- bbv and occupancy (tests/test_tools.py:25-120) ----------------------------


def test_bbv_vectors_cover_all_ops(tiny_mlp):
    res = compute_bbv(tiny_mlp, interval_ops=4)
    total = sum(sum(v.values()) for v in res.vectors)
    assert total > 0
    # every interval except possibly the last is exactly full
    for v in res.vectors[:-1]:
        assert sum(v.values()) == 4
    assert sum(res.vectors[-1].values()) <= 4
    # dot must appear as a dimension
    assert "dot" in res.dims


LOOPY = """
HloModule loopy, is_scheduled=true

%body (p: (f32[64,64], s32[])) -> (f32[64,64], s32[]) {
  %p = (f32[64,64]{1,0}, s32[]) parameter(0)
  %x = f32[64,64]{1,0} get-tuple-element(%p), index=0
  %i = s32[] get-tuple-element(%p), index=1
  %d = f32[64,64]{1,0} dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  ROOT %t = (f32[64,64]{1,0}, s32[]) tuple(%d, %ni)
}

%cond (p: (f32[64,64], s32[])) -> pred[] {
  %p = (f32[64,64]{1,0}, s32[]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=1
  %lim = s32[] constant(7)
  ROOT %lt = pred[] compare(%i, %lim), direction=LT
}

ENTRY %main (a: f32[64,64]) -> (f32[64,64], s32[]) {
  %a = f32[64,64]{1,0} parameter(0)
  %z = s32[] constant(0)
  %t0 = (f32[64,64]{1,0}, s32[]) tuple(%a, %z)
  ROOT %w = (f32[64,64]{1,0}, s32[]) while(%t0), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"7"}}
}
"""


def test_bbv_while_bodies_repeat():
    """A while with trip count K must contribute K copies of its body —
    the phase behavior SimPoint clusters on."""
    mod = parse_hlo_module(LOOPY)
    res = compute_bbv(mod, interval_ops=100000)
    dots = sum(v.get(res.dims["dot"], 0) for v in res.vectors)
    assert dots == 7


def test_simpoint_format(tmp_path, tiny_mlp):
    res = compute_bbv(tiny_mlp, interval_ops=4)
    out = tmp_path / "trace.bb"
    write_simpoint_bb(res, out)
    lines = out.read_text().splitlines()
    assert len(lines) == res.num_intervals
    for line in lines:
        assert line.startswith("T:")
        for part in line[1:].split():
            _, dim, count = part.split(":")
            assert int(dim) >= 1 and int(count) >= 1


def test_occupancy_full_tiles(tiny_mlp):
    cfg = load_config(arch="v5p")
    report = occupancy_report(tiny_mlp, cfg.arch)
    assert report.ops, "fixture has dots"
    for o in report.ops:
        assert 0 < o.tile_fill <= 1.0
        assert 0 < o.row_fill <= 1.0
        assert 0 < o.pipeline_eff < 1.0
        assert 0 < o.mxu_occupancy <= 1.0


SKINNY = """
HloModule skinny, is_scheduled=true

ENTRY %main (a: f32[1,32], b: f32[32,256], c: bf16[512,128], d: bf16[128,128]) -> f32[1,256] {
  %a = f32[1,32]{1,0} parameter(0)
  %b = f32[32,256]{1,0} parameter(1)
  %c = bf16[512,128]{1,0} parameter(2)
  %d = bf16[128,128]{1,0} parameter(3)
  %big = bf16[512,128]{1,0} dot(%c, %d), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %sk = f32[1,256]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""


def test_occupancy_flags_skinny_matmul():
    """A K=32 matmul fills 25% of a 128-row array; a 1-row M is
    pipeline-starved.  The calculator must rank them below a full tile."""
    mod = parse_hlo_module(SKINNY)
    cfg = load_config(arch="v5p")
    report = occupancy_report(mod, cfg.arch)
    by_name = {o.name: o for o in report.ops}
    assert by_name["sk"].tile_fill == pytest.approx(32 / 128 * 256 / 256)
    assert by_name["sk"].row_fill == pytest.approx(1 / 8)
    assert by_name["big"].mxu_occupancy > by_name["sk"].mxu_occupancy
    assert report.worst[0].name == "sk"


# -- Chrome trace and debugger (tests/test_aux_subsystems.py) -------------------


def test_chrome_trace_export(tiny_mlp, tmp_path):
    cfg = SimConfig()
    res = Engine(cfg, record_timeline=True).run(tiny_mlp)
    doc = timeline_to_chrome_trace(res, cfg.arch)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(events) == len(res.timeline) > 0
    names = {e["args"]["op"] for e in events}
    assert "dot.1" in names and "ar-start" in names
    tids = {e["tid"] for e in events}
    assert len(tids) >= 2  # MXU + ICI rows at minimum

    out = tmp_path / "t.json"
    write_chrome_trace(res, cfg.arch, out)
    loaded = json.loads(out.read_text())
    assert loaded["traceEvents"]


def _run_debugger(tiny_mlp, commands: str) -> str:
    out = io.StringIO()
    dbg = Debugger(tiny_mlp, SimConfig())
    dbg.repl(io.StringIO(commands), out)
    return out.getvalue()


def test_debugger_step_and_continue(tiny_mlp):
    text = _run_debugger(tiny_mlp, "s 3\nstats\nc\nq\n")
    assert "tpusim debugger" in text
    assert "dot.1" in text
    assert "done:" in text and "cycles total" in text


def test_debugger_breakpoint(tiny_mlp):
    text = _run_debugger(tiny_mlp, "b ar-start\nc\np\nq\n")
    assert "breakpoint: next op is ar-start" in text
    # 'p' on the breakpoint op shows the collective detail
    assert "all-reduce-start" in text
    # the ops after the breakpoint were NOT yet executed
    assert "dot.2" not in text.split("breakpoint:")[1].split("next op")[0]


def test_debugger_list_and_help(tiny_mlp):
    text = _run_debugger(tiny_mlp, "l 3\nbogus\nq\n")
    assert "[   0]" in text
    assert "commands:" in text


# -- the CLI against the JAX CLI ------------------------------------------------


@pytest.fixture(scope="module")
def tool_outputs(smoke, tmp_path_factory):
    """Every tool's output of both CLIs on both cells, computed once
    (``chip_smoke.tool_outputs``: paths left out, the gz log
    decompressed), untuned as the tests price."""
    out = {}
    for fixture, arch in TOOL_CELLS:
        for tag, main in (("port", port_cli), ("ref", ref_cli)):
            work = tmp_path_factory.mktemp(f"{tag}_{fixture}")
            out[(tag, fixture)] = smoke.tool_outputs(
                main, TRACES / fixture, arch, work)
    return out


@pytest.mark.parametrize("tool", TOOLS)
@pytest.mark.parametrize("cell", TOOL_CELLS, ids=lambda c: f"{c[0]}@{c[1]}")
def test_tool_output_equals_the_reference(tool_outputs, cell, tool):
    port = tool_outputs[("port", cell[0])][tool]
    ref = tool_outputs[("ref", cell[0])][tool]
    assert port and port == ref


@pytest.mark.parametrize("cell", TOOL_CELLS, ids=lambda c: f"{c[0]}@{c[1]}")
def test_chip_smoke_tool_digests_are_the_reference(smoke, tool_outputs,
                                                   cell):
    """Phase 15 (d) holds the card host's tools to these digests: they
    are the JAX CLI's outputs."""
    for tool in TOOLS:
        assert smoke.TOOL_DIGESTS[(cell[0], tool)] == smoke.sha256(
            tool_outputs[("ref", cell[0])][tool]), tool
    assert smoke.TOOL_CELLS == TOOL_CELLS


def _cli(main, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_tool_stdout_lines_equal_the_reference(tmp_path):
    """The CLI lines naming what was written (paths aside) are the
    reference's too."""
    trace = str(TRACES / "llama_tiny_tp2dp2")
    for argv in (["timeline", trace, "T", "--arch", "v5p", "--counters"],
                 ["timeline", trace, "T", "--arch", "v5p"],
                 ["bbv", trace, "--interval", "100", "--out", "T"],
                 ["aerial", trace, "--arch", "v5p", "--sample", "5000"]):
        got = []
        for tag, main in (("port", port_cli), ("ref", ref_cli)):
            path = tmp_path / f"{tag}.out"
            rc, out, _ = _cli(main, [a if a != "T" else str(path)
                                     for a in argv])
            assert rc == 0
            got.append(out.replace(str(path), "T"))
        assert got[0] == got[1], argv


def test_profile_prints_the_reference_table():
    """``profile`` prints the JAX CLI's phase names and top-op table (its
    wall-clock columns aside)."""
    argv = ["profile", str(TRACES / "llama_tiny_tp2dp2"), "--arch", "v5p",
            "--top", "5"]
    tables, phases = [], []
    for main in (port_cli, ref_cli):
        rc, out, _ = _cli(main, argv)
        assert rc == 0
        lines = out.splitlines()
        start = next(i for i, ln in enumerate(lines) if "costliest ops" in ln)
        tables.append(lines[start:])
        head = next(i for i, ln in enumerate(lines) if "peak_rss_mb" in ln)
        phases.append(sorted(ln.split()[0] for ln in lines[head + 1:start]
                             if ln.strip() and "(phases cover)" not in ln))
    assert tables[0] == tables[1]
    assert phases[0] == phases[1]
    assert {"init", "parse", "config", "simulate", "engine", "cost",
            "report"} <= set(phases[0])


def test_chip_smoke_profile_digest_is_the_reference(smoke):
    with smoke.untuned():
        rc, out, _ = _cli(ref_cli, [
            "profile", str(TRACES / "llama_tiny_tp2dp2"), "--arch", "v5p",
            "--top", str(smoke.PROFILE_TOP)])
    assert rc == 0
    assert smoke.sha256("\n".join(smoke.profile_table(out)).encode()) == \
        smoke.PROFILE_TOP_DIGEST


def test_obs_window_flags_refuse_without_their_output(tmp_path):
    trace = str(TRACES / "matmul_512")
    rc, _, err = _cli(port_cli, ["simulate", trace, "--obs-window-cycles",
                                 "100"])
    assert rc == 2 and "--obs-window-cycles requires --obs-out" in err
    rc, _, err = _cli(port_cli, ["timeline", trace, str(tmp_path / "t"),
                                 "--obs-window-cycles", "100"])
    assert rc == 2 and "--obs-window-cycles requires --counters" in err
    assert _cli(ref_cli, ["simulate", trace, "--obs-window-cycles",
                          "100"])[0] == 2


def test_debug_reads_its_script_from_stdin(monkeypatch):
    """``debug`` through the CLI, its session scripted on stdin, prints
    the JAX CLI's session."""
    argv = ["debug", str(TRACES / "matmul_512"), "--arch", "v5e"]
    outs = []
    for main in (port_cli, ref_cli):
        monkeypatch.setattr("sys.stdin", io.StringIO("s 2\np\nl 2\nc\nq\n"))
        rc, out, _ = _cli(main, argv)
        assert rc == 0
        outs.append(out)
    assert outs[0] == outs[1] and "done:" in outs[0]


def test_pick_module_refuses_an_unknown_module():
    rc, _, err = _cli(port_cli, ["occupancy", str(TRACES / "matmul_512"),
                                 "--module", "nope"])
    assert rc == 2 and "nope" in err

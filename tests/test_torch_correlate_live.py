"""The live correlator in the port, on the CPU, held to the JAX package:

* ``correlate_workload`` with ``measure_device_time`` stubbed alike in
  both packages (``tests/test_correl_ops.py``'s profile-reuse script):
  the device route, ``real_seconds == 1e-3 / n_steps``, equal flops and
  the ``op_profile_out`` keys; unstubbed on the CPU it takes the wall
  route, and ``measure_device_time`` raises (no device events);
* the per-op mechanics on the CPU's op events (the reference's
  end-to-end script on its CPU backend): at least 2 rows, more than half
  the time matched, ``n_matched >= 2`` in the written document;
* the capture's provenance: every live instruction of the entry, loop
  bodies and conditions has an origin among the graph's (qualified)
  nodes, every fused member names a live fusion, and the HLO text is the
  same bytes whether the provenance is recorded or not;
* the CLI: the reference's 27 subcommands, and ``correlate-ops --device
  cpu`` end to end at a small size;
* the card's profile, parsed from made-up events: a kernel filed under
  the op that launched it (a profiler event reusing the op's id aside),
  work outside every node unattributed, and an execution whose work the
  profiler lost left out.
"""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tpusim.harness.correl_ops as ref_co  # noqa: E402
from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.harness.correlate import (  # noqa: E402
    correlate_workload as ref_correlate_workload,
)
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
import tpusim_torch.harness.correl_ops as co  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.harness.correlate import (  # noqa: E402
    correlate_workload,
    loopify,
)
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.tracer import hlo_ir  # noqa: E402
from tpusim_torch.tracer.capture import capture  # noqa: E402

#: the keys the reference fills ``op_profile_out`` with
PROFILE_KEYS = {"ops", "engine_result", "clock_hz", "arch", "iters",
                "module"}


@pytest.fixture(autouse=True)
def _jax_default_precision():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _fake_mdt(silicon):
    """The reference test's stub of ``measure_device_time``."""
    def fake(fn, *args, iters=3, warmup=2, log_dir=None, with_ops=False):
        d = {"median_s": 1e-3, "n_exec": 3.0, "module": "jit_loop"}
        if with_ops:
            d["ops"] = {"dot.1": silicon("dot.1", count=3.0,
                                         total_ns=3000.0)}
        return d
    return fake


def _matmul_inputs():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((64, 64)).astype(np.float32)
            for _ in range(2))
    ref_fn, _ = ref_get_workload("matmul").build(m=64, n=64, k=64,
                                                 dtype="float32")
    module, _ = get_workload("matmul").build(device="cpu", m=64, n=64, k=64,
                                             dtype="float32")
    return (ref_fn, (jax.numpy.asarray(a), jax.numpy.asarray(b)), module,
            (torch.from_numpy(a), torch.from_numpy(b)))


def test_correlate_workload_device_route_equals_the_reference(monkeypatch):
    monkeypatch.setenv("TPUSIM_FORCE_DEVICE_TIMING", "1")
    monkeypatch.setattr(ref_co, "measure_device_time",
                        _fake_mdt(ref_co.OpSilicon))
    monkeypatch.setattr(co, "measure_device_time", _fake_mdt(co.OpSilicon))
    ref_fn, ref_args, module, args = _matmul_inputs()
    want_prof, got_prof = {}, {}
    want = ref_correlate_workload(ref_fn, ref_args, name="m", n_steps=2,
                                  arch="v5e", iters=3,
                                  op_profile_out=want_prof)
    got = correlate_workload(module, args, name="m", n_steps=2, arch="v5e",
                             iters=3, op_profile_out=got_prof)
    assert got.real_source == want.real_source == "device"
    assert got.real_seconds == want.real_seconds == 1e-3 / 2
    assert got.flops == want.flops
    assert PROFILE_KEYS <= set(got_prof) and PROFILE_KEYS <= set(want_prof)
    assert "dot.1" in got_prof["ops"]
    assert got_prof["engine_result"].cycles > 0
    assert got_prof["clock_hz"] == want_prof["clock_hz"] > 0
    assert got_prof["arch"].name == "v5e" and got_prof["iters"] == 3
    # the assembled artifact path
    corr = co.correlate_ops(
        got_prof["engine_result"], got_prof["ops"],
        clock_hz=got_prof["clock_hz"], workload="m",
        real_iters=got_prof["iters"])
    corr.counters = co.correlate_counters(
        got_prof["engine_result"], got_prof["ops"],
        clock_hz=got_prof["clock_hz"], arch=got_prof["arch"])
    assert isinstance(corr.counters, dict)


@pytest.mark.parametrize("forced", [False, True])
def test_correlate_workload_off_the_card_takes_the_wall_route(
        forced, monkeypatch, capsys):
    if forced:
        monkeypatch.setenv("TPUSIM_FORCE_DEVICE_TIMING", "1")
    else:
        monkeypatch.delenv("TPUSIM_FORCE_DEVICE_TIMING", raising=False)
    _, _, module, args = _matmul_inputs()
    pt = correlate_workload(module, args, name="m", n_steps=2, arch="v5e",
                            iters=1)
    assert pt.real_source == "wall" and pt.real_seconds > 0
    err = capsys.readouterr().err
    assert ("falling back to wall clock" in err) == forced


def test_measure_device_time_raises_without_device_events():
    _, _, module, args = _matmul_inputs()
    with pytest.raises(RuntimeError, match="no device events"):
        co.measure_device_time(loopify(module, 2), *args, iters=1)


def test_per_op_mechanics_on_the_cpu(tmp_path):
    fn, args = get_workload("matmul_chain").build(
        device="cpu", m=256, k=256, depth=2, dtype="float32")
    corr = co.correlate_workload_ops(fn, args, name="mini", arch="v5e",
                                     iters=2)
    assert len(corr.rows) >= 2, corr.rows
    assert corr.matched_time_fraction > 0.5, corr.matched_time_fraction
    p = co.write_correl_ops([corr], tmp_path / "correl_ops.json")
    doc = json.loads(p.read_text())
    assert doc["workloads"][0]["n_matched"] >= 2


def test_per_op_profile_counts_every_trip():
    """A loop body's rows count every trip, as per_op_count scales them;
    the loop's own plumbing lands in UNATTRIBUTED."""
    fn, args = get_workload("matmul_chain").build(
        device="cpu", m=64, k=64, depth=2, dtype="float32")
    looped = loopify(fn, 3)
    cap = capture(looped, *args, name="l")
    ops = co.profile_workload(looped, args, cap=cap, iters=2)
    assert ops["mm"].count == ops["mm_1"].count == 3 * 2
    assert ops["gelu"].count == 3 * 2 and ops["gelu"].total_ns > 0
    assert set(ops) <= {"mm", "mm_1", "gelu", "gelu_1", "broadcast",
                        co.UNATTRIBUTED}


#: captures whose provenance is checked: a plain chain, a loop (scan), a
#: train step (make_fx), the custom call, a while_loop and a multi-output
#: scan body
PROVENANCE = {
    "matmul_chain": dict(m=64, k=64, depth=2, dtype="float32"),
    "mlp_train_step": dict(batch=8, width=16, depth=2, dtype="float32",
                           lr=1e-2),
    "flash_attention_pallas": dict(batch=1, heads=2, seq=128, head_dim=32,
                                   dtype="float32"),
    "dynamic_loop": dict(elems=256),
    "lstm_layer": dict(batch=2, hidden=8, seq=4, dtype="float32"),
}


def _qualified_nodes(gm, prefix: str = "") -> set[str]:
    """Every node of ``gm`` and of its loops' bodies, qualified as the
    lowering qualifies origins."""
    out = set()
    for n in gm.graph.nodes:
        name = prefix + n.name
        out.add(name)
        if isinstance(n.target, torch._ops.HigherOrderOperator):
            subs = [getattr(gm, a.target) for a in n.args
                    if isinstance(a, torch.fx.Node) and a.op == "get_attr"]
            if n.target.name() == "scan":
                out |= _qualified_nodes(subs[0], name + "/")
            elif n.target.name() == "while_loop":
                out |= _qualified_nodes(subs[0], name + "/cond/")
                out |= _qualified_nodes(subs[1], name + "/")
    return out


def _provenance_capture(name: str, looped: bool):
    module, args = get_workload(name).build(device="cpu", **PROVENANCE[name])
    if looped:
        module = loopify(module, 3)
    return capture(module, *args, name=name)


def _loop_computations(module) -> set[str]:
    names, todo = set(), [module.entry_name]
    while todo:
        comp = module.computation(todo.pop())
        names.add(comp.name)
        for op in comp.ops:
            if op.opcode == "while":
                todo += [op.attrs["body"].lstrip("%"),
                         op.attrs["condition"].lstrip("%")]
    return names


@pytest.mark.parametrize("looped", [False, True])
@pytest.mark.parametrize("name", list(PROVENANCE))
def test_every_instruction_has_an_origin(name, looped):
    cap = _provenance_capture(name, looped)
    nodes = _qualified_nodes(cap.graph)
    live = {op.name: op.opcode
            for c in _loop_computations(cap.module)
            for op in cap.module.computation(c).ops}
    missing = [n for n in live if n not in cap.origins]
    assert not missing, missing
    assert {cap.origins[n] for n in live} <= nodes
    for member, fusion in cap.fused.items():
        assert member in cap.origins and live.get(fusion) == "fusion"
    picked = co.node_instructions(cap)
    assert all(live.get(i) not in (None, "while")
               for i in picked.values() if i is not None)
    assert set(picked) <= nodes


class _Discard(dict):
    """A provenance table that records nothing."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.parametrize("name", list(PROVENANCE))
def test_hlo_text_is_the_same_bytes_with_provenance(name, monkeypatch):
    recorded = _provenance_capture(name, True)
    assert recorded.origins
    init = hlo_ir.HloModule.__init__

    def unrecorded(self, *a, **k):
        init(self, *a, **k)
        self.origins, self.fused = _Discard(), _Discard()

    monkeypatch.setattr(hlo_ir.HloModule, "__init__", unrecorded)
    bare = _provenance_capture(name, True)
    assert not bare.origins and not bare.fused
    assert bare.hlo_text == recorded.hlo_text


def _subcommands(main, capsys) -> set[str]:
    with pytest.raises(SystemExit):
        main(["--help"])
    usage = capsys.readouterr().out
    return set(re.search(r"\{([^}]*)\}", usage).group(1).split(","))


def test_cli_registers_the_references_27_subcommands(capsys):
    want = _subcommands(ref_main, capsys)
    got = _subcommands(port_main, capsys)
    assert len(want) == 27 and got == want
    assert "correlate-ops" in got


def test_correlate_ops_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "correl_ops.json"
    assert port_main([
        "correlate-ops", "matmul_chain", "--device", "cpu", "--iters", "2",
        "--set", "m=128", "--set", "k=128", "--set", "depth=2",
        "--set", "dtype=float32", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert text.startswith("matched ") and f"report written to {out}" in text
    doc = json.loads(out.read_text())
    entry = doc["workloads"][0]
    assert entry["workload"] == "matmul_chain" and entry["n_matched"] >= 2
    assert entry["matched_time_fraction"] > 0.5
    assert {r["opcode"] for r in entry["rows"]} >= {"dot", "fusion"}


class _Event:
    """A profiler event as ``kineto_results.events()`` yields it."""

    def __init__(self, name, start, end, corr, linked=0, cuda=False,
                 annotation=False):
        from torch.autograd import DeviceType

        self._v = dict(name=name, start_ns=start, end_ns=end,
                       correlation_id=corr, linked_correlation_id=linked,
                       start_thread_id=1, is_user_annotation=annotation,
                       device_type=DeviceType.CUDA if cuda
                       else DeviceType.CPU)

    def __getattr__(self, key):
        if key not in self._v:
            raise AttributeError(key)
        return lambda: self._v[key]


def _card_profile(lose: set[int]):
    """Three executions on the card, each one node (``mm``) launching one
    kernel of 100 ns, then a 10 ns stacking copy outside every node;
    the kernels of the executions in ``lose`` never reach the profile.
    A profiler host event reuses the first op's id."""
    import types

    events = [_Event("Activity Buffer Request", 1, 2, corr=11)]
    for i in range(3):
        t = 1000 * (i + 1)
        op, api, kernel = 10 * (i + 1) + 1, 500 + i, 900 + i
        events += [
            _Event(co.EXEC_RANGE, t, t + 500, corr=10 * (i + 1),
                   annotation=True),
            _Event(co.NODE_RANGE + "mm", t + 10, t + 100, corr=op - 2,
                   annotation=True),
            _Event("aten::mm", t + 20, t + 90, corr=op),
            _Event("cudaLaunchKernel", t + 30, t + 40, corr=api, linked=op),
            _Event("aten::copy_", t + 200, t + 220, corr=op + 5),
            _Event("cudaMemcpyAsync", t + 205, t + 210, corr=api + 50,
                   linked=op + 5),
            _Event("Memcpy DtoD", t + 400, t + 410, corr=api + 50,
                   linked=op + 5, cuda=True),
        ]
        if i not in lose:
            events.append(_Event("gemm", t + 300, t + 400, corr=api,
                                 linked=op, cuda=True))
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_device_profile_parse():
    execs = co._parse_profile(_card_profile(set()), "cuda")
    assert execs == [{"busy_ns": 110.0, "span_ns": 110.0, "events": 2,
                      "nodes": {"mm": [1, 1, 100.0]},
                      "unattributed_ns": 10.0, "lost": False}] * 3
    prof = co.DeviceProfile("cuda", execs)
    assert prof.nodes == {"mm": [3, 3, 300.0]}
    assert prof.unattributed_ns == 30.0
    assert co.extract_module_events(prof, "p") == {"p": [110.0] * 3}


def test_device_profile_marks_executions_with_lost_work():
    execs = co._parse_profile(_card_profile({0}), "cuda")
    assert [e["lost"] for e in execs] == [True, False, False]
    assert [e["events"] for e in execs] == [1, 2, 2]


def _record(events=2, lost=False):
    return {"busy_ns": 100.0 * events, "span_ns": 100.0 * events,
            "events": events, "nodes": {}, "unattributed_ns": 0.0,
            "lost": lost}


@pytest.mark.parametrize("sessions,whole,lost", [
    # whole at once
    ([[_record(), _record(), _record()]], 3, 0),
    # a session that lost two: another runs; one with fewer events than
    # another execution of the program is left out too
    ([[_record(lost=True), _record(lost=True), _record()],
      [_record(events=1), _record(), _record()]], 3, 3),
])
def test_trace_capture_collects_whole_executions(sessions, whole, lost,
                                                  monkeypatch):
    runs = iter(sessions)
    monkeypatch.setattr(co, "_parse_profile", lambda prof, dev: next(runs))
    _, _, module, args = _matmul_inputs()
    prof = co._trace_capture(module, args, None, warmup=1, iters=3)
    assert len(prof.execs) == whole and prof.lost == lost
    assert next(runs, None) is None


def test_trace_capture_raises_when_every_execution_lost_work(monkeypatch):
    monkeypatch.setattr(co, "_parse_profile",
                        lambda prof, dev: [_record(lost=True)] * 3)
    _, _, module, args = _matmul_inputs()
    with pytest.raises(RuntimeError, match="lost device work in all 9"):
        co._trace_capture(module, args, None, warmup=1, iters=3)

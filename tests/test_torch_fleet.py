"""The fleet digital twin (``tpusim_torch.fleet``) against the JAX
package's, live and in the same process.

* the fleet smoke spec of ``ci/check_golden.py`` through ``run_fleet``:
  the report document and ``stats_dict()`` equal the JAX package's
  (``==``, ``model_version`` dropped) with scenario batching on, off and
  on the card's route (``"cuda"``, scans sent to the CPU through the
  kernel's counted wrappers);
* the seeded inputs: ``sample_arrivals`` and ``sample_pod_stream`` at
  seeds 0-3 for each traffic shape, and the degradation timelines;
* the event walk's hand-built scenarios of ``tests/test_fleet.py``;
* the seeded bad specs: the same codes, severities and messages;
* the pod-loss recovery's advise transforms (profile, scaled module,
  synthetic cell pod and its replay);
* the CLI against ``python -m tpusim fleet``, cancellation after state
  *n* with its journal prefix and resume, the other package's journal
  refused, no fallback under ``"cuda"``, and the committed golden.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.advise import transform as ref_tf  # noqa: E402
from tpusim.analysis.diagnostics import Diagnostics as RefDiags  # noqa: E402
from tpusim.analysis.fleet_passes import (  # noqa: E402
    run_fleet_passes as ref_passes,
)
from tpusim.campaign.journal import JournalError as RefJournalError  # noqa: E402,E501
from tpusim.fleet import load_fleet_spec as ref_load  # noqa: E402
from tpusim.fleet import run_fleet as ref_run  # noqa: E402
from tpusim.fleet import runner as ref_runner  # noqa: E402
from tpusim.fleet import simulate_cell as ref_cell  # noqa: E402
from tpusim.fleet.spec import Policies as RefPolicies  # noqa: E402
from tpusim.fleet.traffic import sample_arrivals as ref_arrivals  # noqa: E402
from tpusim.fleet.traffic import sample_pod_stream as ref_stream  # noqa: E402
from tpusim.guard.cancel import CancelToken as RefToken  # noqa: E402
from tpusim.guard.cancel import OperationCancelled as RefCancelled  # noqa: E402,E501
from tpusim.ici.topology import torus_for as ref_torus  # noqa: E402
from tpusim.sim.driver import SimDriver as RefDriver  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.trace.format import load_trace as ref_load_trace  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.advise import transform as tf  # noqa: E402
from tpusim_torch.analysis.diagnostics import Diagnostics  # noqa: E402
from tpusim_torch.analysis.fleet_passes import run_fleet_passes  # noqa: E402
from tpusim_torch.campaign.journal import JournalError  # noqa: E402
from tpusim_torch.fastpath import batch as port_batch  # noqa: E402
from tpusim_torch.fleet import (  # noqa: E402
    FleetSpecError,
    load_fleet_spec,
    run_fleet,
    simulate_cell,
)
from tpusim_torch.fleet import runner as port_runner  # noqa: E402
from tpusim_torch.fleet.spec import Policies  # noqa: E402
from tpusim_torch.fleet.traffic import (  # noqa: E402
    sample_arrivals,
    sample_pod_stream,
)
from tpusim_torch.guard.cancel import (  # noqa: E402
    CancelToken,
    OperationCancelled,
)
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402
from tpusim_torch.sim.driver import SimDriver  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRACE = REPO / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _check_golden()
SMOKE = CG.FLEET_SMOKE_SPEC
#: the golden rule of phase 9 (a): the committed golden's means were
#: summed by an interpreter whose float ``sum`` rounds differently from
#: Python 3.12's, so floats are held within a relative 1e-12
GOLDEN_RTOL = 1e-12


def base_spec(**over) -> dict:
    """``tests/test_fleet.py``'s base spec."""
    doc = {
        "name": "t-fleet", "seed": 3, "pods": 2,
        "arch": "v5p", "chips": 8, "tuned": False,
        "horizon_s": 30.0,
        "traffic": {
            "load_points": [6.0],
            "mix": [{"name": "chat", "weight": 3.0, "steps": 50},
                    {"name": "batch", "weight": 1.0, "steps": 200}],
        },
        "faults": {
            "count": {"dist": "uniform", "min": 0, "max": 2},
            "kinds": {"link_down": 1.0, "hbm_throttle": 1.0},
            "scale": {"min": 0.4, "max": 0.9},
            "window": {"min_s": 5.0, "max_s": 15.0},
            "pod_loss": {"prob": 0.9},
        },
        "policies": {"max_inflight": 1, "queue_depth": 4,
                     "deadline_s": 0.5, "restart_backoff_s": 3.0},
    }
    doc.update(over)
    return doc


def _drop_version(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "model_version"}


_REF: dict = {}


def _ref_smoke():
    if "smoke" not in _REF:
        _REF["smoke"] = ref_run(SMOKE, trace_path=TRACE)
    return _REF["smoke"]


@pytest.fixture
def cuda_route_on_cpu(monkeypatch):
    """``backend="cuda"`` with its scans sent to the CPU: the same route
    (columns staged ops-major, a run step's scans packed into one call of
    ``scan_segments``) into the kernel's wrappers, whose plain versions
    run for CPU tensors (launching nothing).  Records the matrix shape of
    every call of either wrapper entry."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_batch, "_SCAN_DEVICE", "cpu")
    calls = []
    rows, segments = sr.scan_rows, sr.scan_segments
    monkeypatch.setattr(sr, "scan_rows",
                        lambda s, m: calls.append(m.shape) or rows(s, m))
    monkeypatch.setattr(sr, "scan_segments", lambda m, *a: calls.append(
        m.shape) or segments(m, *a))
    return calls


# -- the smoke spec against the JAX package -----------------------------------


@pytest.mark.parametrize("batch", [None, False, "cuda"],
                         ids=["batched", "unbatched", "cuda"])
def test_smoke_equals_reference(batch, request):
    calls = (request.getfixturevalue("cuda_route_on_cpu")
             if batch == "cuda" else None)
    ref = _ref_smoke()
    res = run_fleet(SMOKE, trace_path=TRACE, scenario_batch=batch)
    assert _drop_version(res.doc) == _drop_version(ref.doc)
    assert res.stats.stats_dict() == ref.stats.stats_dict()
    if batch is False:
        assert res.batch_stats is None
    else:
        assert res.batch_stats.stats_dict() == \
            ref.batch_stats.stats_dict()
    if calls is not None:
        assert calls and res.batch_stats.states > 0


# -- seeded inputs ------------------------------------------------------------


TRAFFIC = {
    "poisson": {"load_points": [6.0]},
    "bursty": SMOKE["traffic"],
    "diurnal": {"shape": "diurnal", "load_points": [20.0],
                "diurnal": {"amplitude": 0.6, "period_s": 12.0},
                "mix": [{"name": "a", "weight": 1.0, "steps": 2},
                        {"name": "b", "weight": 0.5, "steps": 9},
                        {"name": "c", "weight": 2.5, "steps": 1}]},
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", sorted(TRAFFIC))
def test_arrivals_and_pod_streams_equal_reference(shape, seed):
    doc = base_spec(seed=seed, traffic=TRAFFIC[shape],
                    correlated_groups=[{"name": "z", "prob": 0.4,
                                        "axis": 2}])
    doc["faults"]["count"] = {"dist": "poisson", "mean": 2.5}
    spec, rspec = load_fleet_spec(doc), ref_load(doc)
    for rate in (*spec.traffic.load_points, 3.5, 41.0):
        assert sample_arrivals(spec.traffic, seed, rate, 30.0) == \
            ref_arrivals(rspec.traffic, seed, rate, 30.0)
    topo, rtopo = torus_for(8, "v5p"), ref_torus(8, "v5p")
    for p in range(4):
        stream = sample_pod_stream(spec, topo, p)
        assert stream == ref_stream(rspec, rtopo, p)
        assert port_runner.build_intervals(stream, 30.0) == \
            ref_runner.build_intervals(stream, 30.0)


# -- the event walk -----------------------------------------------------------


def _row(step_s=0.1, energy=2.0, partitioned=False):
    return {"partitioned": partitioned, "step_s": step_s,
            "energy_j": energy, "inflation": 1.0}


#: ``tests/test_fleet.py``'s hand-built cells: (arrivals, pods as
#: (intervals, deaths), policies, healthy step, mix steps)
CELLS = {
    "partition": ([(10.0, 0), (55.0, 0), (60.0, 0), (90.0, 0)],
                  [([(0.0, 50.0, _row()), (50.0, 80.0, _row(partitioned=True)),
                     (80.0, 100.0, _row())], [])],
                  (1, 8, 100.0, 3.0), 0.1, [1]),
    "shed": ([(0.0, 0), (1.0, 0), (2.0, 0), (3.0, 0)],
             [([(0.0, 100.0, _row(step_s=10.0))], [])],
             (1, 1, 100.0, 3.0), 10.0, [1]),
    "deadline": ([(0.0, 0), (6.0, 0)],
                 [([(0.0, 100.0, _row(step_s=10.0))], [])],
                 (1, 8, 5.0, 3.0), 10.0, [1]),
    "crash": ([(0.0, 0), (6.0, 0), (9.0, 0)],
              [([(0.0, 100.0, _row(step_s=10.0))], [(5.0, 8.0)]),
               ([(0.0, 100.0, _row())], [])],
              (1, 8, 100.0, 3.0), 0.1, [1]),
    "crash_before_deadline": ([(0.0, 0), (0.01, 0), (0.05, 0), (0.1, 0)],
                              [([(0.0, 100.0, _row(step_s=0.5))],
                                [(0.8, 20.8)])],
                              (1, 8, 1.0, 20.0), 0.5, [1]),
    "energy_mfu": ([(0.0, 0), (10.0, 1)],
                   [([(0.0, 100.0, _row(step_s=2.0, energy=3.0))], [])],
                   (1, 8, 100.0, 3.0), 2.0, [1, 2]),
}


@pytest.mark.parametrize("case", sorted(CELLS))
def test_event_walk_equals_reference(case):
    arrivals, pods, pol, healthy, mix = CELLS[case]
    got = simulate_cell(
        arrivals,
        [port_runner.PodState(intervals=iv, deaths=list(d)) for iv, d in pods],
        Policies(*pol), 100.0, healthy, mix)
    want = ref_cell(
        arrivals,
        [ref_runner.PodState(intervals=iv, deaths=list(d)) for iv, d in pods],
        RefPolicies(*pol), 100.0, healthy, mix)
    assert got == want


# -- validation ---------------------------------------------------------------


def _diags(run, diags_cls, doc, default_chips=8):
    diags = diags_cls()
    run(doc, diags, default_chips=default_chips)
    return [(d.code, d.severity.value, d.message, d.file, d.line)
            for d in diags.sorted_items()]


@pytest.mark.parametrize("mutate", [
    {"pods": 0},
    {"policies": {"deadline_s": 0.0}},
    {"policies": {"warp_core": 1}},
    {"faults": {"kinds": ["gamma_burst"]}},
    {"faults": {"pod_loss": {"prob": 2.0}}},
    {"recovery": {"dcn_gbps": 0}},
    {"traffic": {"shape": "tidal"}},
    {"traffic": {"load_points": []}},
    {"traffic": {"load_points": [1e9]}, "horizon_s": 3600.0},
    {"traffic": {"mix": [{"name": "a", "weight": 0}]}},
    {"traffic": {"burst": {"factor": 20.0, "fraction": 0.5}}},
    {"slo": {"latency_ms": 100.0, "percentile": 250}},
    {"frontier": {"target_rps": [10.0], "max_pods": 4}},
    {"correlated_groups": [{"name": "ghost", "prob": 0.5, "axis": 7}]},
    {"correlated_groups": [{"name": "g", "prob": 0.5}]},
    {"arch": "v9z"},
], ids=lambda m: json.dumps(m, sort_keys=True)[:40])
def test_bad_specs_give_reference_diagnostics(mutate):
    doc = base_spec(**mutate)
    got = _diags(run_fleet_passes, Diagnostics, doc)
    want = _diags(ref_passes, RefDiags, doc)
    assert got == want and got
    try:
        ref_load(doc)
    except ValueError as e:
        with pytest.raises(FleetSpecError) as ei:
            load_fleet_spec(doc)
        assert (ei.value.code, str(ei.value)) == (e.code, str(e))


# -- the recovery's advise transforms -----------------------------------------


def _pod_doc(pod) -> dict:
    return {
        "meta": pod.meta,
        "modules": {n: [(c.name, [(o.name, o.opcode, repr(o.result),
                                   o.operands, o.called)
                                  for o in c.ops])
                        for c in m.computations.values()]
                    for n, m in pod.modules.items()},
        "module_meta": {n: m.meta for n, m in pod.modules.items()},
        "devices": {d: [(c.kind.value, c.module, c.nbytes,
                         repr(c.collective)) for c in t.commands]
                    for d, t in pod.devices.items()},
    }


@pytest.mark.parametrize("degrees", [
    {}, {"dp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "sp": 2},
    {"pp": 2, "tp": 2}, {"ep": 2},
], ids=lambda d: "x".join(f"{k}{v}" for k, v in d.items()) or "none")
def test_advise_transforms_equal_reference(degrees):
    pod, rpod = load_trace(TRACE), ref_load_trace(TRACE)
    prof, rprof = tf.build_profile(pod), ref_tf.build_profile(rpod)
    assert repr(prof) == repr(rprof)
    factor = 2.0 / 3.0
    name = f"{prof.module_name}__fleet_{factor!r}"
    mod = tf.scaled_module(pod.modules[prof.module_name], factor, name,
                           prof.capture_fp)
    rmod = ref_tf.scaled_module(rpod.modules[rprof.module_name], factor,
                                name, rprof.capture_fp)
    cell = tf.build_cell_pod(prof, mod, 4, degrees, launches=2)
    rcell = ref_tf.build_cell_pod(rprof, rmod, 4, degrees, launches=2)
    assert _pod_doc(cell) == _pod_doc(rcell)
    cfg = load_config(arch="v5p", tuned=False)
    rcfg = ref_config(arch="v5p", tuned=False)
    got = SimDriver(cfg, topology=torus_for(4, "v5p")).run(cell)
    want = RefDriver(rcfg, topology=ref_torus(4, "v5p")).run(rcell)
    assert got.cycles == want.cycles


# -- the CLI ------------------------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_matches_reference(tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SMOKE))
    outs = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / tag
        rc, out, err = _cli(main, ["fleet", str(spec), "--trace", str(TRACE),
                                   "--out", str(d), "--json",
                                   str(d / "r.json")], capsys)
        assert rc == 0, err
        out = out.replace(str(d), "DIR")
        outs[tag] = ([re.sub(r"; \d+\.\d+s\)", "; Ts)", ln)
                      for ln in out.splitlines()],
                     _drop_version(json.loads((d / "r.json").read_text())),
                     _drop_version(json.loads(
                         (d / "report.json").read_text())))
    assert outs["port"] == outs["ref"]
    assert any(ln.startswith("  frontier: ") for ln in outs["port"][0])


@pytest.mark.parametrize("case", ["spec", "validation", "cancel"])
def test_cli_exit_codes_match_reference(case, tmp_path, capsys):
    spec = tmp_path / "spec.json"
    extra = []
    doc = base_spec()
    if case == "spec":
        doc["pods"] = 0
    elif case == "validation":
        doc["correlated_groups"] = [{"name": "ghost", "prob": 0.5,
                                     "axis": 7}]
    else:
        extra = ["--max-wall-s", "1e-9"]
    spec.write_text(json.dumps(doc))
    got = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / tag
        rc, out, err = _cli(main, ["fleet", str(spec), "--trace",
                                   str(TRACE), "--out", str(d), *extra],
                            capsys)
        err = err.replace(str(d), "DIR")
        got[tag] = (rc, out, re.sub(r"^tpusim(_torch)? ", "", err,
                                    flags=re.M))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"spec": 1, "validation": 1, "cancel": 3}[case]


# -- cancellation, the journal and resume -------------------------------------


def _records(path: Path) -> list[dict]:
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("model_version", None)
        out.append(rec)
    return out


def _cancel_after(token, n: int):
    seen = []

    def progress(msg: str) -> None:
        seen.append(msg)
        if len(seen) == n:
            token.cancel(f"cancelled after {n}")
    return progress


@pytest.mark.parametrize("n", [2, 5])
def test_cancel_after_n_then_resume(n, tmp_path):
    full = run_fleet(SMOKE, trace_path=TRACE, out_dir=tmp_path / "full")
    token = CancelToken()
    with pytest.raises(OperationCancelled, match=f"after {n}"):
        run_fleet(SMOKE, trace_path=TRACE, out_dir=tmp_path / "p",
                  cancel=token, progress=_cancel_after(token, n))
    rtoken = RefToken()
    with pytest.raises(RefCancelled):
        ref_run(SMOKE, trace_path=TRACE, out_dir=tmp_path / "r",
                cancel=rtoken, progress=_cancel_after(rtoken, n))
    prefix = _records(tmp_path / "p" / "journal.jsonl")
    assert prefix == _records(tmp_path / "r" / "journal.jsonl")
    res = run_fleet(SMOKE, trace_path=TRACE, out_dir=tmp_path / "p",
                    resume=True)
    journaled = sum(r["kind"] == "state" for r in prefix)
    assert res.stats.states_resumed == journaled > 0
    assert res.stats.states_priced == full.stats.states_priced - journaled
    assert (tmp_path / "p" / "report.json").read_bytes() == \
        (tmp_path / "full" / "report.json").read_bytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_journal_of_the_other_package_is_refused(writer, tmp_path):
    doc = base_spec()
    if writer == "ref":
        ref_run(doc, trace_path=TRACE, out_dir=tmp_path)
        with pytest.raises(JournalError, match="model_version .* refusing"):
            run_fleet(doc, trace_path=TRACE, out_dir=tmp_path, resume=True)
    else:
        run_fleet(doc, trace_path=TRACE, out_dir=tmp_path)
        with pytest.raises(RefJournalError,
                           match="model_version .* refusing"):
            ref_run(doc, trace_path=TRACE, out_dir=tmp_path, resume=True)


# -- no fallback that hides the card ------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the missing-card case")
def test_cuda_batch_without_a_card_raises():
    with pytest.raises(ValueError, match="'cuda' requested"):
        run_fleet(base_spec(), trace_path=TRACE, scenario_batch="cuda")


def test_failed_warm_host_backend_keeps_report_cuda_raises(
        cuda_route_on_cpu, monkeypatch):
    import tpusim_torch.fastpath.batch as fb

    want = run_fleet(base_spec(), trace_path=TRACE, scenario_batch=False)

    def boom(*a, **k):
        raise RuntimeError("warm failed")
    monkeypatch.setattr(fb, "warm_states", boom)
    got = run_fleet(base_spec(), trace_path=TRACE,
                    scenario_batch="vectorized")
    assert json.dumps(got.doc, sort_keys=True) == \
        json.dumps(want.doc, sort_keys=True)
    with pytest.raises(RuntimeError, match="warm failed"):
        run_fleet(base_spec(), trace_path=TRACE, scenario_batch="cuda")


# -- the committed golden -----------------------------------------------------


def _gaps(got, want, path=""):
    if isinstance(want, float) and isinstance(got, float):
        gap = abs(got - want) / max(abs(got), abs(want), 1e-300)
        assert gap <= GOLDEN_RTOL, f"{path}: {got!r} vs {want!r}"
        return [gap] if got != want else []
    assert type(got) is type(want), f"{path}: {got!r} vs {want!r}"
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [g for k in want for g in _gaps(got[k], want[k],
                                               f"{path}.{k}")]
    if isinstance(want, list):
        assert len(got) == len(want), path
        return [g for i, (a, b) in enumerate(zip(got, want))
                for g in _gaps(a, b, f"{path}[{i}]")]
    assert got == want, f"{path}: {got!r} vs {want!r}"
    return []


def test_golden_holds_under_the_float_rule():
    golden = json.loads(
        (REPO / "ci" / "golden" / "fleet_smoke.json").read_text())
    res = run_fleet(SMOKE, trace_path=TRACE)
    gaps = _gaps(_drop_version(res.doc), _drop_version(golden))
    assert len(gaps) <= 8

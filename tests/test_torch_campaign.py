"""The compound-fault campaign (``tpusim_torch.campaign``) against the
JAX package's, live and in the same process.

* the campaign and DCN smoke specs of ``ci/check_golden.py`` through
  ``run_campaign``: the report document and ``stats_dict()`` equal the
  JAX package's (``==``, ``model_version`` dropped: each package stamps
  its own) with scenario batching on (``None``), off (``False``) and on
  the card's route (``"cuda"``, its scans sent to the CPU through the
  kernel's wrappers, which are counted);
* ``spec_hash`` and every sampled schedule document of every slice;
* the seeded bad specs of ``tests/test_campaign.py``: the same codes,
  severities and messages;
* the CLI against ``python -m tpusim campaign`` (stdout line for line,
  the JSON report, exit codes 0 / 1 / 2 / 3);
* cancellation after scenario *n*: the journal prefix equals the JAX
  package's, and a resume gives the uninterrupted report by bytes;
  a journal of the other package is refused;
* no fallback: ``scenario_batch="cuda"`` without a card raises, while a
  failed warm on a host backend leaves the report unchanged;
* the committed goldens, under phase 9 (a)'s rule of ``chip_smoke.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.analysis.campaign_passes import (  # noqa: E402
    run_campaign_passes as ref_passes,
)
from tpusim.analysis.diagnostics import Diagnostics as RefDiags  # noqa: E402
from tpusim.campaign import Journal as RefJournal  # noqa: E402
from tpusim.campaign import JournalError as RefJournalError  # noqa: E402
from tpusim.campaign import load_campaign_spec as ref_load  # noqa: E402
from tpusim.campaign import percentile as ref_percentile  # noqa: E402
from tpusim.campaign import run_campaign as ref_run  # noqa: E402
from tpusim.campaign import sample_schedule_doc as ref_sample  # noqa: E402
from tpusim.campaign import spec_hash as ref_hash  # noqa: E402
from tpusim.guard.cancel import CancelToken as RefToken  # noqa: E402
from tpusim.guard.cancel import OperationCancelled as RefCancelled  # noqa: E402,E501
from tpusim.ici.topology import torus_for as ref_torus  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.analysis import ValidationError  # noqa: E402
from tpusim_torch.analysis.campaign_passes import (  # noqa: E402
    run_campaign_passes,
)
from tpusim_torch.analysis.diagnostics import Diagnostics  # noqa: E402
from tpusim_torch.campaign import (  # noqa: E402
    CampaignSpecError,
    Journal,
    JournalError,
    load_campaign_spec,
    percentile,
    run_campaign,
    sample_schedule_doc,
    spec_hash,
)
from tpusim_torch.fastpath import batch as port_batch  # noqa: E402
from tpusim_torch.guard.cancel import (  # noqa: E402
    CancelToken,
    OperationCancelled,
)
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402

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
SMOKES = {"campaign": CG.CAMPAIGN_SMOKE_SPEC, "dcn": CG.DCN_SMOKE_SPEC}
#: phase 9 (a)'s rule against the committed goldens: the goldens were
#: written by an interpreter whose float ``sum`` rounds differently from
#: Python 3.12's (the report's ``mean`` is ``sum(values) / len(values)``),
#: so the JAX package itself misses them by bytes in the last one or two
#: digits of ``mean``; every other value is equal
GOLDEN_RTOL = 1e-12


def base_spec(**over) -> dict:
    """``tests/test_campaign.py``'s base spec."""
    doc = {
        "name": "t", "seed": 11, "scenarios": 4,
        "arch": "v5p", "chips": 8, "tuned": False,
        "faults": {
            "count": {"dist": "uniform", "min": 0, "max": 2},
            "kinds": {"link_down": 1.0, "link_degraded": 1.0,
                      "chip_straggler": 0.5, "hbm_throttle": 0.5},
            "scale": {"min": 0.4, "max": 0.9},
        },
    }
    doc.update(over)
    return doc


def _drop_version(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "model_version"}


_REF: dict = {}


def _ref(name: str):
    """The JAX package's run of one smoke spec (computed once)."""
    if name not in _REF:
        _REF[name] = ref_run(SMOKES[name], trace_path=TRACE)
    return _REF[name]


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


# -- the smoke specs against the JAX package ----------------------------------


@pytest.mark.parametrize("batch", [None, False, "cuda"],
                         ids=["batched", "unbatched", "cuda"])
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_smoke_equals_reference(name, batch, request):
    calls = (request.getfixturevalue("cuda_route_on_cpu")
             if batch == "cuda" else None)
    ref = _ref(name)
    res = run_campaign(SMOKES[name], trace_path=TRACE, scenario_batch=batch)
    assert _drop_version(res.doc) == _drop_version(ref.doc)
    assert res.stats.stats_dict() == ref.stats.stats_dict()
    if batch is False:
        assert res.batch_stats is None
    else:
        assert res.batch_stats.stats_dict() == \
            ref.batch_stats.stats_dict()
    if calls is not None:
        # the campaign reached the kernel's wrapper
        assert calls and res.batch_stats.states > 0


def test_spec_hash_and_every_schedule_equal_reference():
    for doc in SMOKES.values():
        spec, rspec = load_campaign_spec(doc), ref_load(doc)
        assert spec_hash(spec) == ref_hash(rspec)
        for sl in spec.slices(4):
            topo, rtopo = torus_for(sl.chips, sl.arch), \
                ref_torus(sl.chips, sl.arch)
            for i in range(spec.scenarios):
                assert sample_schedule_doc(spec, topo, sl.label, i) == \
                    ref_sample(rspec, rtopo, sl.label, i)
    # key order in the document does not change the campaign
    shuffled = dict(reversed(list(SMOKES["campaign"].items())))
    assert spec_hash(load_campaign_spec(shuffled)) == \
        ref_hash(ref_load(SMOKES["campaign"]))


def test_percentile_equals_reference():
    values = [0.3, 1e-9, 5.0, 2.5, 2.5, 7.25, 1.0]
    for pct in (0.1, 1, 50, 90, 95, 99, 100):
        assert percentile(values, pct) == ref_percentile(values, pct)
    assert percentile([], 50) is None


# -- validation ---------------------------------------------------------------


def _diags(run, diags_cls, doc, default_chips=8):
    diags = diags_cls()
    run(doc, diags, default_chips=default_chips)
    return [(d.code, d.severity.value, d.message, d.file, d.line)
            for d in diags.sorted_items()]


@pytest.mark.parametrize("mutate", [
    {"faults": {"kinds": ["gamma_burst"]}},
    {"scenarios": 0},
    {"faults": {"count": {"dist": "gaussian"}}},
    {"faults": {"count": {"dist": "uniform", "min": 0, "max": 10 ** 9}}},
    {"faults": {"scale": {"min": 0.0, "max": 0.5}}},
    {"retries": 99},
    {"candidate_slices": []},
    {"candidate_slices": [{"arch": "v5p"}]},
    {"slo": {"step_time_ms": 1.0}},
    {"slo": {"step_time_ms": 1.0, "percentile": 0},
     "candidate_slices": [{"arch": "v5p", "chips": 4}]},
    {"slo": {"step_time_ms": 1.0, "percentile": 101},
     "candidate_slices": [{"arch": "v5p", "chips": 4}]},
    {"correlated_groups": [{"name": "ghost", "prob": 0.5,
                            "links": [[[0, 0, 0], [3, 0, 0]]]}]},
    {"correlated_groups": [{"name": "hyper", "prob": 0.5, "axis": 7}]},
    {"candidate_slices": [{"arch": "v9z", "chips": 4}]},
], ids=lambda m: json.dumps(m, sort_keys=True)[:40])
def test_bad_specs_give_reference_diagnostics(mutate):
    doc = base_spec(**mutate)
    got = _diags(run_campaign_passes, Diagnostics, doc)
    want = _diags(ref_passes, RefDiags, doc)
    assert got == want and got
    try:
        ref_load(doc)
    except ValueError as e:
        with pytest.raises(CampaignSpecError) as ei:
            load_campaign_spec(doc)
        assert (ei.value.code, str(ei.value)) == (e.code, str(e))


def test_runner_refuses_before_pricing_with_reference_message(tmp_path):
    doc = base_spec(correlated_groups=[
        {"name": "ghost", "prob": 0.5, "links": [[[0, 0, 0], [3, 0, 0]]]},
    ])
    with pytest.raises(ValidationError) as got:
        run_campaign(doc, trace_path=TRACE, out_dir=tmp_path / "p")
    with pytest.raises(ValueError) as want:
        ref_run(doc, trace_path=TRACE, out_dir=tmp_path / "r")
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "p" / "journal.jsonl").exists()
    with pytest.raises(ValueError, match="journal"):
        run_campaign(base_spec(), trace_path=TRACE, resume=True)


# -- the CLI against the JAX package's ----------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _masked(text: str, *paths) -> list[str]:
    for p in paths:
        text = text.replace(str(p), "PATH")
    return [re.sub(r"\((\d+\.\d+)s\)", "(Ts)", ln) for ln in
            text.splitlines()]


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_cli_matches_reference(name, tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SMOKES[name]))
    outs = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / tag
        rc, out, err = _cli(main, ["campaign", str(spec), "--trace",
                                   str(TRACE), "--out", str(d), "--json",
                                   str(d / "r.json")], capsys)
        assert rc == 0, err
        outs[tag] = (_masked(out, d),
                     _drop_version(json.loads((d / "r.json").read_text())),
                     _drop_version(json.loads(
                         (d / "report.json").read_text())))
    assert outs["port"] == outs["ref"]
    assert "  capacity: smallest slice meeting" in "\n".join(
        outs["port"][0]) or name == "dcn"


@pytest.mark.parametrize("case", ["validation", "bad_json", "cancel",
                                  "resume_without_out"])
def test_cli_exit_codes_match_reference(case, tmp_path, capsys):
    spec = tmp_path / "spec.json"
    extra = []
    if case == "validation":
        spec.write_text(json.dumps(base_spec(correlated_groups=[
            {"name": "hyper", "prob": 0.5, "axis": 7}])))
    elif case == "bad_json":
        spec.write_text("{not json")
    else:
        spec.write_text(json.dumps(base_spec()))
    if case == "cancel":
        extra = ["--max-wall-s", "1e-9"]
    if case == "resume_without_out":
        extra = ["--resume"]
    got = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        out_dir = [] if case == "resume_without_out" else \
            ["--out", str(tmp_path / tag)]
        rc, out, err = _cli(main, ["campaign", str(spec), "--trace",
                                   str(TRACE), *out_dir, *extra], capsys)
        # the port's messages carry its own prefix
        err = err.replace(str(tmp_path / tag), "DIR")
        got[tag] = (rc, out, re.sub(r"^tpusim(_torch)?[: ]", "", err,
                                    flags=re.M))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"validation": 1, "bad_json": 2, "cancel": 3,
                              "resume_without_out": 2}[case]


# -- cancellation, the journal and resume -------------------------------------


def _records(path: Path) -> list[dict]:
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("model_version", None)
        out.append(rec)
    return out


def _cancel_after(n: int):
    token = CancelToken()
    seen = []

    def progress(msg: str) -> None:
        seen.append(msg)
        if len(seen) == n:
            token.cancel(f"cancelled after scenario {n}")
    return token, progress


@pytest.mark.parametrize("n", [1, 7, 20])
def test_cancel_after_n_scenarios_then_resume(n, tmp_path):
    doc = SMOKES["campaign"]
    full = run_campaign(doc, trace_path=TRACE, out_dir=tmp_path / "full")
    token, progress = _cancel_after(n)
    with pytest.raises(OperationCancelled, match=f"scenario {n}"):
        run_campaign(doc, trace_path=TRACE, out_dir=tmp_path / "p",
                     cancel=token, progress=progress)
    rtoken = RefToken()
    rseen = []

    def rprogress(msg):
        rseen.append(msg)
        if len(rseen) == n:
            rtoken.cancel("x")
    with pytest.raises(RefCancelled):
        ref_run(doc, trace_path=TRACE, out_dir=tmp_path / "r",
                cancel=rtoken, progress=rprogress)
    prefix = _records(tmp_path / "p" / "journal.jsonl")
    assert prefix == _records(tmp_path / "r" / "journal.jsonl")
    assert sum(r["kind"] == "scenario" for r in prefix) == n
    res = run_campaign(doc, trace_path=TRACE, out_dir=tmp_path / "p",
                       resume=True)
    assert res.stats.resumed == n
    assert res.stats.priced + res.stats.partitioned == \
        full.stats.priced + full.stats.partitioned - n
    assert (tmp_path / "p" / "report.json").read_bytes() == \
        (tmp_path / "full" / "report.json").read_bytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_journal_of_the_other_package_is_refused(writer, tmp_path):
    doc = base_spec(scenarios=2)
    if writer == "ref":
        ref_run(doc, trace_path=TRACE, out_dir=tmp_path)
        with pytest.raises(JournalError, match="model_version .* refusing"):
            run_campaign(doc, trace_path=TRACE, out_dir=tmp_path,
                         resume=True)
    else:
        run_campaign(doc, trace_path=TRACE, out_dir=tmp_path)
        with pytest.raises(RefJournalError,
                           match="model_version .* refusing"):
            ref_run(doc, trace_path=TRACE, out_dir=tmp_path, resume=True)


def test_journal_torn_and_corrupt_lines_match_reference(tmp_path):
    for tag, cls in (("p", Journal), ("r", RefJournal)):
        j = cls(tmp_path / tag)
        j.append({"kind": "header", "spec_hash": "x", "seed": 1,
                  "model_version": "m"})
        j.append({"kind": "scenario", "slice": "s", "index": 0, "row": {}})
        j.close()
        with open(j.path, "ab") as f:
            f.write(b'{"kind": "scenario", "slice": "s", "ind')
    assert (tmp_path / "p" / "journal.jsonl").read_bytes() == \
        (tmp_path / "r" / "journal.jsonl").read_bytes()
    assert Journal(tmp_path / "p").read_records() == \
        RefJournal(tmp_path / "r").read_records()
    for tag in ("p", "r"):
        with open(tmp_path / tag / "journal.jsonl", "ab") as f:
            f.write(b"\ngarbage\n{\"kind\": \"scenario\"}\n")
    with pytest.raises(JournalError) as got:
        Journal(tmp_path / "p").read_records()
    with pytest.raises(RefJournalError) as want:
        RefJournal(tmp_path / "r").read_records()
    assert str(got.value).replace("/p/", "/r/") == str(want.value)


# -- no fallback that hides the card ------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the missing-card case")
def test_cuda_batch_without_a_card_raises():
    with pytest.raises(ValueError, match="'cuda' requested"):
        run_campaign(base_spec(), trace_path=TRACE, scenario_batch="cuda")


@pytest.mark.parametrize("batch", [None, "vectorized"])
def test_failed_host_warm_leaves_the_report(batch, monkeypatch):
    import tpusim_torch.fastpath.batch as fb

    want = run_campaign(base_spec(), trace_path=TRACE, scenario_batch=False)

    def boom(*a, **k):
        raise RuntimeError("warm failed")
    monkeypatch.setattr(fb, "warm_states", boom)
    got = run_campaign(base_spec(), trace_path=TRACE, scenario_batch=batch)
    assert json.dumps(got.doc, sort_keys=True) == \
        json.dumps(want.doc, sort_keys=True)


def test_failed_cuda_warm_raises(cuda_route_on_cpu, monkeypatch):
    def launch_failure(*args):
        raise RuntimeError("scan_segments: launch failed")
    monkeypatch.setattr(sr, "scan_segments", launch_failure)
    with pytest.raises(RuntimeError, match="launch failed"):
        run_campaign(base_spec(), trace_path=TRACE, scenario_batch="cuda")


# -- the committed goldens ----------------------------------------------------


def golden_gaps(got, want, path="") -> tuple[int, float]:
    """Phase 9 (a)'s rule: non-floats equal, floats within a relative
    ``GOLDEN_RTOL``; returns (floats that differ, largest relative gap)."""
    if isinstance(want, float) and isinstance(got, float):
        if got == want:
            return 0, 0.0
        gap = abs(got - want) / max(abs(got), abs(want))
        assert gap <= GOLDEN_RTOL, f"{path}: {got!r} vs {want!r}"
        return 1, gap
    assert type(got) is type(want), f"{path}: {got!r} vs {want!r}"
    if isinstance(want, dict):
        assert set(got) == set(want), path
        parts = [golden_gaps(got[k], want[k], f"{path}.{k}") for k in want]
    elif isinstance(want, list):
        assert len(got) == len(want), path
        parts = [golden_gaps(g, w, f"{path}[{i}]")
                 for i, (g, w) in enumerate(zip(got, want))]
    else:
        assert got == want, f"{path}: {got!r} vs {want!r}"
        return 0, 0.0
    return (sum(p[0] for p in parts), max((p[1] for p in parts),
                                           default=0.0))


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_goldens_hold_under_the_float_rule(name):
    golden = json.loads(
        (REPO / "ci" / "golden" / f"{name}_smoke.json").read_text())
    res = run_campaign(SMOKES[name], trace_path=TRACE)
    n, gap = golden_gaps(_drop_version(res.doc), _drop_version(golden))
    assert gap <= GOLDEN_RTOL and math.isfinite(gap)
    # the gaps sit in the means alone (the float ``sum`` of the report)
    assert n <= 8


# -- chip_smoke.py's phase 9 on the CPU host ----------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_carries_the_smoke_specs():
    smoke = _chip_smoke()
    assert smoke.CAMPAIGN_SMOKE_SPEC == CG.CAMPAIGN_SMOKE_SPEC
    assert smoke.DCN_SMOKE_SPEC == CG.DCN_SMOKE_SPEC
    assert smoke.FLEET_SMOKE_SPEC == CG.FLEET_SMOKE_SPEC
    assert smoke.SMOKE_RTOL == GOLDEN_RTOL
    with pytest.raises(AssertionError, match="golden"):
        smoke.golden_gaps({"a": [1.0, "x"]}, {"a": [1.0 + 1e-9, "x"]})
    with pytest.raises(AssertionError, match="golden"):
        smoke.golden_gaps({"a": 2}, {"a": 3})
    assert smoke.golden_gaps({"a": 1.0 + 2e-16}, {"a": 1.0})


def test_chip_smoke_campaign_fleet_on_cpu(tmp_path, capsys, monkeypatch):
    """Phase 9, rehearsed on the CPU host at a reduced size and with the
    host legs only (the ``cuda`` leg's launches need the card): the
    smokes under both host legs against their goldens and contracts, the
    runs cancelled mid-run on a journaled count and by the CLI's
    ``--max-wall-s``, each resumed through the CLI in a fresh process to
    the uninterrupted report by bytes, and (c) and (d) at a few
    scenarios and pods."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "BATCH_LEGS", (False, "vectorized"))
    monkeypatch.setattr(smoke, "CLI_CAMPAIGN_SCENARIOS", 64)
    monkeypatch.setattr(smoke, "BIG_CAMPAIGN_SCENARIOS", 24)
    monkeypatch.setattr(smoke, "BIG_FLEET_PODS", 2)
    monkeypatch.setattr(smoke, "BIG_FLEET_HORIZON_S", 60.0)
    monkeypatch.setattr(smoke, "BIG_FLEET_FRONTIER",
                        {"target_rps": [12.0, 48.0], "max_pods": 3})
    out = smoke.campaign_fleet("cpu", tmp_path)
    assert set(out["a"]) == {"campaign", "dcn", "fleet"}
    for cmd in ("campaign", "fleet"):
        b = out["b"][cmd]
        assert 0 < b["resumed"] < b["total"], b
        assert b["resumed"] == max(1, b["total"] // 2), b
    assert out["c"]["vectorized"]["launches"] == 0
    text = capsys.readouterr().out
    for part in ("(a) campaign smoke", "(a) dcn smoke", "(a) fleet smoke",
                 "(b) campaign CLI", "(b) fleet CLI", "(c) campaign v5p-64",
                 "(d) fleet 2 pods"):
        assert f"  {part}" in text
    assert "report equal by bytes" in text

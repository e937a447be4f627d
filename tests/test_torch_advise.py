"""The sharding advisor (``tpusim_torch.advise``) against the JAX
package's, live and in the same process.

* spec refusals: the same ``AdviseSpecError`` code and message; the
  TL22x (and TL23x) diagnostics of seeded bad specs equal the reference's;
  ``spec_hash`` gives the same 16 hex digits;
* the workload profile and the cell enumeration, pinned meshes
  de-duplicated;
* skipped cells (``ep`` without an expert capture, ``sp`` x ``tp``) and
  the pipeline bubble;
* the advise smoke of ``ci/check_golden.py``: its document equals the
  JAX package's live run with ``model_version`` dropped, and the
  committed golden under the float rule (``model_version`` masked,
  non-floats equal, floats within a relative 1e-12); a warm pass runs 0
  ``Engine.run`` walks; ``workers=2`` and a disk result cache give the
  same bytes;
* a spec with a ``dcn`` block, a cancel token at cell grain, and the
  v5p-64 sweep without ``sp`` (its ``sp64`` cell is ``chip_smoke.py``
  phase 10 (c)'s alone);
* the CLI against ``python -m tpusim advise`` (stdout line for line,
  the JSON report, exit code 1 on a bad spec);
* ``chip_smoke.py``'s phase 10, rehearsed on the CPU host.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.advise import load_advise_spec as ref_load  # noqa: E402
from tpusim.advise import run_advise as ref_run  # noqa: E402
from tpusim.advise import spec_hash as ref_hash  # noqa: E402
from tpusim.advise.runner import enumerate_cells as ref_cells  # noqa: E402
from tpusim.advise.transform import build_profile as ref_profile  # noqa: E402
from tpusim.analysis.advise_passes import (  # noqa: E402
    run_advise_passes as ref_passes,
)
from tpusim.analysis.diagnostics import Diagnostics as RefDiags  # noqa: E402
from tpusim.guard.cancel import CancelToken as RefToken  # noqa: E402
from tpusim.guard.cancel import OperationCancelled as RefCancelled  # noqa: E402,E501
from tpusim.perf.cache import ResultCache as RefCache  # noqa: E402
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.format import load_trace as ref_trace  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.advise import (  # noqa: E402
    ADVISE_FORMAT_VERSION,
    AdviseResult,
    AdviseSpecError,
    AdviseStats,
    build_profile,
    load_advise_spec,
    run_advise,
    spec_hash,
)
from tpusim_torch.advise.runner import (  # noqa: E402
    _unsupported_combo,
    enumerate_cells,
)
from tpusim_torch.analysis import (  # noqa: E402
    ValidationError,
    analyze_advise_spec,
)
from tpusim_torch.analysis.advise_passes import run_advise_passes  # noqa: E402,E501
from tpusim_torch.analysis.diagnostics import Diagnostics  # noqa: E402
from tpusim_torch.guard.cancel import (  # noqa: E402
    CancelToken,
    OperationCancelled,
)
from tpusim_torch.perf.cache import ResultCache  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRACE = REPO / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _check_golden()
SMOKE = CG.ADVISE_SMOKE_SPEC
#: the goldens' float rule (``tests/test_torch_campaign.py``): on Python
#: 3.12 the JAX package itself misses ``advise_smoke.json`` by bytes in the
#: last digits of the power columns
GOLDEN_RTOL = 1e-12
#: ``tests/test_advise.py``'s base spec
BASE_SPEC = {
    "name": "t",
    "strategies": ["dp", "tp", "dp_tp", "sp", "pp"],
    "slices": [{"arch": "v5p", "chips": 8}],
    "tuned": False,
}
#: phase 10 (c) of ``chip_smoke.py`` without ``sp`` (its sp64 cell alone
#: costs about 17 s on a CPU host)
V5P64_SPEC = {
    "name": "v5p-64",
    "strategies": ["dp", "tp", "dp_tp", "pp"],
    "slices": [{"arch": "v5p", "chips": 64}],
    "meshes": [{"dp": 4, "tp": 4, "pp": 4}],
    "tuned": False,
    "slo": {"step_time_ms": 1.0},
}


def _dcn_spec(nic_bandwidth: float, nics: int) -> dict:
    """``tests/test_dcn.py``'s advise spec."""
    return {
        "name": "dcn-advise", "strategies": ["dp", "dp_tp"],
        "slices": [{"arch": "v5p", "chips": 8}],
        "tuned": False,
        "dcn": {"num_slices": 4, "nics_per_slice": nics,
                "nic_bandwidth": nic_bandwidth, "hop_latency": 1e-5},
    }


def _drop_version(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "model_version"}


def _bytes(doc: dict) -> bytes:
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


_POD: dict = {}


def pods():
    """(port pod, reference pod) of the llama fixture, loaded once."""
    if not _POD:
        _POD["pods"] = (load_trace(TRACE), ref_trace(TRACE))
    return _POD["pods"]


_REF: dict = {}


def ref_smoke():
    """The JAX package's run of the advise smoke (computed once)."""
    if "smoke" not in _REF:
        _REF["smoke"] = ref_run(SMOKE, trace_path=TRACE)
    return _REF["smoke"]


@contextlib.contextmanager
def counting(engine_cls):
    """Count ``engine_cls.run`` walks while the block runs."""
    calls = {"n": 0}
    orig = engine_cls.run

    def run(self, module):
        calls["n"] += 1
        return orig(self, module)

    engine_cls.run = run
    try:
        yield calls
    finally:
        engine_cls.run = orig


# -- the spec -----------------------------------------------------------------

BAD_SPECS = [
    {"warp_drive": True},
    {"strategies": ["dp", "warp"]},
    {"strategies": []},
    {"slices": [], "slo": {"step_time_ms": 1.0}},
    {"slices": [{"arch": "v5p", "chips": 1 << 20}]},
    {"slices": [{"arch": "v5p"}]},
    {"slices": [{"arch": "v5p", "chips": 8, "color": "red"}]},
    {"meshes": [{"dp": 2, "zz": 4}]},
    {"meshes": [{"dp": 0}]},
    {"meshes": [{}]},
    {"microbatches": 65},
    {"tuned": "yes"},
    {"max_cells": 0},
    {"slo": {"step_time_ms": -1}},
    {"name": ""},
    {"dcn": {"num_slices": 1}},
    "[1, 2]",
    "{not json",
]


@pytest.mark.parametrize("doc", BAD_SPECS,
                         ids=lambda d: json.dumps(d, sort_keys=True)[:40])
def test_spec_refusals_equal_reference(doc):
    with pytest.raises(ValueError) as want:
        ref_load(doc)
    with pytest.raises(AdviseSpecError) as got:
        load_advise_spec(doc)
    assert (got.value.code, str(got.value)) == \
        (want.value.code, str(want.value))


def _diags(run, diags_cls, doc, default_chips=4):
    diags = diags_cls()
    run(doc, diags, default_chips=default_chips)
    return [(d.code, d.severity.value, d.message, d.file, d.line)
            for d in diags.sorted_items()]


PASS_SPECS = BAD_SPECS + [
    {"strategies": ["dp"], "slices": [{"arch": "v9z", "chips": 8}],
     "meshes": [{"dp": 3, "tp": 2}]},
    {"slices": [{"arch": "v5p", "chips": 8}, {"arch": "v5e", "chips": 16}],
     "meshes": [{"dp": 4, "tp": 2}, {"tp": 32}]},
    {"meshes": [{"dp": 2, "tp": 5}]},
    dict(_dcn_spec(25e9, 4), slices=[{"arch": "v5p", "chips": 2}]),
    dict(BASE_SPEC, meshes=[{"dp": 3, "tp": 2}]),
]


@pytest.mark.parametrize("doc", PASS_SPECS,
                         ids=lambda d: json.dumps(d, sort_keys=True)[:40])
def test_passes_equal_reference(doc):
    got = _diags(run_advise_passes, Diagnostics, doc)
    assert got == _diags(ref_passes, RefDiags, doc)
    assert got and all(re.fullmatch(r"TL2[23]\d", d[0]) for d in got)


def test_analyze_advise_spec_anchors_its_file(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"strategies": ["warp"]}))
    diags = analyze_advise_spec(str(path))
    assert diags.codes() == {"TL221"}
    assert [d.file for d in diags.sorted_items()] == [str(path)]
    assert not analyze_advise_spec(BASE_SPEC).has_errors


@pytest.mark.parametrize("doc", [SMOKE, BASE_SPEC, V5P64_SPEC,
                                 _dcn_spec(25e9, 4), {}],
                         ids=["smoke", "base", "v5p64", "dcn", "empty"])
def test_spec_hash_and_cells_equal_reference(doc):
    spec, rspec = load_advise_spec(doc), ref_load(doc)
    assert re.fullmatch(r"[0-9a-f]{16}", spec_hash(spec))
    assert spec_hash(spec) == ref_hash(rspec)
    assert spec.resolved_slices(4) == tuple(
        type(spec.resolved_slices(4)[0])(s.arch, s.chips)
        for s in rspec.resolved_slices(4))
    got = [(c.label, c.strategy, c.degrees, c.mesh)
           for c in enumerate_cells(spec, 4)]
    want = [(c.label, c.strategy, c.degrees, c.mesh)
            for c in ref_cells(rspec, 4)]
    assert got == want and got


def test_enumerate_cells_dedups_pinned():
    spec = load_advise_spec({
        "strategies": ["dp_tp"],
        "slices": [{"arch": "v5p", "chips": 8}],
        "meshes": [{"dp": 4, "tp": 2}],   # an enumerated cell again
    })
    labels = [c.label for c in enumerate_cells(spec, 4)]
    assert labels == ["v5p-8/dp2xtp4", "v5p-8/dp4xtp2"]


def test_profile_equals_reference():
    pod, rpod = pods()
    got, want = build_profile(pod), ref_profile(rpod)
    assert (got.chips0, got.dp0, got.tp0) == (want.chips0, want.dp0,
                                              want.tp0) == (4, 2, 2)
    assert got.module_name == want.module_name
    assert got.capture_fp == want.capture_fp
    assert got.param_bytes_total == want.param_bytes_total
    assert (len(got.tp_sites), len(got.dp_sites), len(got.ep_sites)) == \
        (len(want.tp_sites), len(want.dp_sites), len(want.ep_sites)) == \
        (13, 1, 0)


# -- cells the transform cannot synthesize; the pipeline bubble ---------------

@pytest.mark.parametrize("doc", [
    dict(BASE_SPEC, strategies=["dp", "ep"]),
    {"name": "t", "strategies": ["dp"], "tuned": False,
     "slices": [{"arch": "v5p", "chips": 8}],
     "meshes": [{"tp": 2, "sp": 4}, {"sp": 2, "pp": 4}]},
], ids=["ep", "sp_x_tp"])
def test_skipped_cells_equal_reference(doc):
    pod, rpod = pods()
    got = run_advise(doc, pod=pod)
    want = ref_run(doc, pod=rpod)
    assert _drop_version(got.doc) == _drop_version(want.doc)
    assert got.stats == AdviseStats(**vars(want.stats))
    assert len(got.doc["skipped"]) == got.stats.skipped >= 1
    reasons = {s["reason"] for s in got.doc["skipped"]}
    assert reasons <= {"capture has no expert-parallel (all-to-all) "
                       "collectives to re-shard",
                       "sp composes with a dp axis only"}


def test_unsupported_combo_guard():
    assert _unsupported_combo({"ep": 2, "pp": 4}) == \
        "ep composes with a dp axis only"
    assert _unsupported_combo({"dp": 2, "ep": 4}) is None
    assert _unsupported_combo({"dp": 2, "tp": 2, "pp": 2}) is None


def test_pipeline_bubble_shows_in_step_time():
    pod, rpod = pods()
    doc = dict(BASE_SPEC, strategies=["dp", "pp"], microbatches=4)
    got = run_advise(doc, pod=pod).doc
    assert _drop_version(got) == _drop_version(ref_run(doc, pod=rpod).doc)
    by = {r["strategy"]: r for r in got["cells"]}
    assert by["pp"]["step_ms"] > by["dp"]["step_ms"]
    assert by["pp"]["launches"] == 4


# -- the smoke: live reference, golden, warm pass, workers, disk cache --------

def test_smoke_equals_reference():
    res = run_advise(SMOKE, trace_path=TRACE)
    ref = ref_smoke()
    assert isinstance(res, AdviseResult)
    assert _drop_version(res.doc) == _drop_version(ref.doc)
    assert res.stats.stats_dict() == ref.stats.stats_dict()
    assert res.doc["format_version"] == ADVISE_FORMAT_VERSION
    cells = res.doc["cells"]
    assert len(cells) >= 12 and res.doc["recommendation"] is not None
    dp4tp2 = [r for r in cells if r["mesh"] == {"dp": 4, "tp": 2}]
    assert dp4tp2 and dp4tp2[0]["collectives_per_chip"] == 14
    assert [r["rank"] for r in cells] == list(range(1, len(cells) + 1))
    for r in cells:
        assert math.isfinite(r["exposed_comm_frac"])
        assert 0 < r["hbm_resident_gib"] < 1


def _gaps(got, want, path=""):
    """Relative gaps of the floats that differ; raises on any other
    difference (``chip_smoke.golden_gaps``'s rule)."""
    if isinstance(want, float) and isinstance(got, float):
        if got == want:
            return []
        gap = abs(got - want) / max(abs(got), abs(want))
        assert gap <= GOLDEN_RTOL, f"{path}: {got!r} vs {want!r}"
        return [gap]
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [g for k in want for g in _gaps(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        assert len(got) == len(want), path
        return [g for i, (a, b) in enumerate(zip(got, want))
                for g in _gaps(a, b, f"{path}[{i}]")]
    assert got == want, path
    return []


def test_smoke_holds_the_golden_under_the_float_rule():
    golden = json.loads(
        (REPO / "ci" / "golden" / "advise_smoke.json").read_text())
    got = _drop_version(run_advise(SMOKE, trace_path=TRACE).doc)
    gaps = _gaps(got, _drop_version(golden))
    # the reference on this interpreter misses the golden the same way
    assert gaps == _gaps(_drop_version(ref_smoke().doc),
                         _drop_version(golden))


def test_warm_pass_runs_zero_engine_walks():
    cache = ResultCache()
    with counting(Engine) as cold_walks:
        cold = run_advise(SMOKE, trace_path=TRACE, result_cache=cache)
    with counting(Engine) as warm_walks:
        warm = run_advise(SMOKE, trace_path=TRACE, result_cache=cache)
    assert warm_walks["n"] == 0 < cold_walks["n"]
    assert _bytes(cold.doc) == _bytes(warm.doc)
    # the reference walks as often cold
    with counting(RefEngine) as ref_walks:
        ref_run(SMOKE, trace_path=TRACE, result_cache=RefCache())
    assert cold_walks["n"] == ref_walks["n"]


def test_workers_and_disk_cache_equal_by_bytes(tmp_path):
    base = _bytes(run_advise(SMOKE, trace_path=TRACE).doc)
    assert _bytes(run_advise(SMOKE, trace_path=TRACE, workers=2).doc) == base
    disk = tmp_path / "rc"
    cold = run_advise(SMOKE, trace_path=TRACE, result_cache=str(disk))
    assert any(disk.rglob("*"))
    with counting(Engine) as walks:
        warm = run_advise(SMOKE, trace_path=TRACE, result_cache=str(disk))
    assert walks["n"] == 0
    assert _bytes(cold.doc) == _bytes(warm.doc) == base


def test_cells_share_engine_walks_per_scale():
    pod, _ = pods()
    with counting(Engine) as walks:
        run_advise(dict(BASE_SPEC, strategies=["dp", "tp", "sp", "dp_tp"]),
                   pod=pod)
    assert walks["n"] == 1


# -- DCN, cancellation, a sweep at a size users run ---------------------------

@pytest.mark.parametrize("fabric", [(25e9, 4), (2e8, 1)],
                         ids=["fast", "slow"])
def test_dcn_spec_equals_reference(fabric):
    pod, rpod = pods()
    doc = _dcn_spec(*fabric)
    got = run_advise(doc, pod=pod).doc
    assert _drop_version(got) == _drop_version(ref_run(doc, pod=rpod).doc)
    by_cell = {r["cell"]: r for r in got["cells"]}
    assert by_cell["v5p-8/dp4xtp2"]["dcn"] == {
        "slices": 4, "dp_over_dcn": True, "spanning_axes": ["dp"]}


def _cancel_after(token_cls, n: int):
    token = token_cls()
    seen = []

    def progress(msg: str) -> None:
        seen.append(msg)
        if len(seen) == n:
            token.cancel(f"cancelled after cell {n}")
    return token, progress, seen


@pytest.mark.parametrize("n", [1, 5])
def test_cancel_at_cell_grain(n):
    pod, rpod = pods()
    cache, rcache = ResultCache(), RefCache()
    token, progress, seen = _cancel_after(CancelToken, n)
    with pytest.raises(OperationCancelled) as got:
        run_advise(BASE_SPEC, pod=pod, result_cache=cache,
                   progress=progress, cancel=token)
    rtoken, rprogress, rseen = _cancel_after(RefToken, n)
    with pytest.raises(RefCancelled) as want:
        ref_run(BASE_SPEC, pod=rpod, result_cache=rcache,
                progress=rprogress, cancel=rtoken)
    assert str(got.value) == str(want.value)
    assert seen == rseen and len(seen) == n
    # the cells priced before the cancel sit warm in the shared cache
    with counting(Engine) as walks:
        rerun = run_advise(BASE_SPEC, pod=pod, result_cache=cache)
    with counting(RefEngine) as rwalks:
        ref_run(BASE_SPEC, pod=rpod, result_cache=rcache)
    assert walks["n"] == rwalks["n"]
    assert _bytes(rerun.doc) == _bytes(run_advise(BASE_SPEC, pod=pod).doc)


def test_v5p64_sweep_equals_reference():
    pod, rpod = pods()
    got = run_advise(V5P64_SPEC, pod=pod)
    want = ref_run(V5P64_SPEC, pod=rpod)
    assert _drop_version(got.doc) == _drop_version(want.doc)
    assert got.stats.stats_dict() == want.stats.stats_dict()
    assert len(got.doc["cells"]) == 9


def test_refuses_before_pricing_with_reference_message():
    doc = dict(BASE_SPEC, meshes=[{"dp": 3, "tp": 2}])
    with counting(Engine) as walks, pytest.raises(ValidationError) as got:
        run_advise(doc, trace_path=TRACE)
    with pytest.raises(ValueError) as want:
        ref_run(doc, trace_path=TRACE)
    assert str(got.value) == str(want.value)
    assert walks["n"] == 0
    with pytest.raises(ValueError, match="trace_path or pod"):
        run_advise(BASE_SPEC)


# -- the CLI against the JAX package's ----------------------------------------

def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [[], ["--top", "3", "--verbose"]],
                         ids=["all", "top3"])
def test_cli_matches_reference(flags, tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SMOKE))
    got = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        out_json = tmp_path / f"{tag}.json"
        rc, out, err = _cli(main, ["advise", str(spec), "--trace",
                                   str(TRACE), "--json", str(out_json),
                                   *flags], capsys)
        assert rc == 0, err
        got[tag] = (out.replace(str(out_json), "OUT").splitlines(),
                    err.splitlines(),
                    _drop_version(json.loads(out_json.read_text())))
    assert got["port"] == got["ref"]
    lines = got["port"][0]
    assert lines[-1] == "  report written to OUT"
    assert "  recommendation: v5p-8/dp8 (dp, mesh {'dp': 8}) at " \
        "0.1368ms/step" in lines


@pytest.mark.parametrize("doc", [{"strategies": ["warp"]},
                                 dict(BASE_SPEC, meshes=[{"dp": 3}])],
                         ids=["spec_error", "validation"])
def test_cli_exit_code_1_on_a_bad_spec(doc, tmp_path, capsys):
    spec = tmp_path / "bad.json"
    spec.write_text(json.dumps(doc))
    got = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        rc, out, err = _cli(main, ["advise", str(spec), "--trace",
                                   str(TRACE)], capsys)
        # the port's messages carry its own prefix
        got[tag] = (rc, out, re.sub(r"^tpusim(_torch)? advise", "advise",
                                    err, flags=re.M))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1 and "spec refused" in got["port"][2]


# -- chip_smoke.py's phase 10 on the CPU host ---------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_carries_the_advise_specs():
    smoke = _chip_smoke()
    assert smoke.ADVISE_SMOKE_SPEC == SMOKE
    big = smoke.big_advise_spec()
    assert {k: v for k, v in big.items() if k != "strategies"} == \
        {k: v for k, v in V5P64_SPEC.items() if k != "strategies"}
    assert big["strategies"] == ["dp", "tp", "dp_tp", "sp", "pp"]
    assert len(enumerate_cells(load_advise_spec(big), 4)) == 10


def test_chip_smoke_advisor_on_cpu(tmp_path, capsys, monkeypatch):
    """Phase 10, rehearsed on the CPU host with (c) cut to the sweep
    without ``sp`` and (d) to the two fixtures."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "BIG_ADVISE_STRATEGIES",
                        ["dp", "tp", "dp_tp", "pp"])
    monkeypatch.setattr(smoke, "BIG_ADVISE_WORKERS", 2)
    monkeypatch.setattr(smoke, "critpath_corpus",
                        lambda: smoke.FIXTURES_CORPUS)
    out = smoke.advisor("cpu", tmp_path)
    assert out["a"]["cells"] >= 12 and out["a"]["warm_walks"] == 0
    assert out["c"]["cells"] == 9
    assert out["d"]["modules"] == 2
    text = capsys.readouterr().out
    for part in ("(a) advise smoke", "(b) advise CLI", "(c) advise v5p-64",
                 "(d) critical path"):
        assert f"  {part}" in text

"""The port's static analyzer (``tpusim_torch.analysis``: the trace,
config, schedule, memory, collective, perf, stats-key and self-audit
passes and their runner; ``lint``, ``perf-report`` and ``simulate
--validate``) against the JAX package, all on the CPU:

(i)   the seeded-defect corpus of ``tests/test_lint.py`` (imported
      read-only): each builder runs the reference's analyzer, and the
      port's analyzer runs on the same files with the same arguments;
      the two ``Diagnostics.to_doc()`` are equal, and every code of the
      port's registry fires on some case;
(ii)  the 12-trace corpus (``tests/fixtures/traces/*`` and
      ``reports/silicon/*``) at v5e, v5p and v6e: ``lint --format json``,
      ``lint --perf --format json``, ``lint`` and ``perf-report`` (text
      and JSON) print what the reference's CLI prints, byte for byte,
      with its exit code;
(iii) the nine ``ubench`` traces the port captures lint with zero errors
      in both packages, as equal documents;
(iv)  ``--list-codes``, ``lint`` / ``lint --strict`` exit codes,
      ``simulate --validate[=strict]`` refusals, and the self-audit and
      stats-key audit of ``tpusim_torch/`` itself (clean);
(v)   the ``--dataflow-smoke`` and ``--perf-lint-smoke`` contracts of
      ``ci/check_golden.py``, reproduced on the port (but for the
      strict-lint serve leg, which waits for the serving tier).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpusim.analysis as ref_an  # noqa: E402
import tpusim_torch.analysis as port_an  # noqa: E402
from tpusim.__main__ import main as ref_cli  # noqa: E402
from tpusim.ici.topology import torus_for as ref_torus_for  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.ici.topology import torus_for as port_torus_for  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402

TESTS = Path(__file__).parent
REPO = TESTS.parent
FIXTURES = TESTS / "fixtures" / "traces"
CORPUS = sorted(p for p in FIXTURES.iterdir() if p.is_dir()) + sorted(
    p for p in (REPO / "reports" / "silicon").iterdir()
    if (p / "modules").is_dir())
ARCHES = ("v5e", "v5p", "v6e")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the reference's seeded-defect corpus, read-only
REF_LINT = _load("_ref_lint_corpus", TESTS / "test_lint.py")
#: ``ci/check_golden.py`` (its golden matrix and the TL501 seed)
CG = _load("_check_golden_for_lint", REPO / "ci" / "check_golden.py")
SEEDED = REF_LINT.SEEDED_DEFECTS


def _run(cli, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# (i) the seeded-defect corpus
# ---------------------------------------------------------------------------


def _twin_build(build, tmp_path: Path, monkeypatch) -> tuple[list, list]:
    """Run one corpus builder; each analyzer call it makes runs the
    reference's analyzer, then the port's on the same files and
    arguments (a reference topology becomes the port's torus of the same
    chips and arch; the source audits name the reference's ``tpusim``
    tree).  Returns the (reference, port) diagnostics of each call."""
    refs: list = []
    ports: list = []
    topo_args: dict[int, tuple] = {}

    def torus(*a):
        topo = ref_torus_for(*a)
        topo_args[id(topo)] = a
        return topo

    def twin(name: str, translate=None):
        ref_fn, port_fn = getattr(ref_an, name), getattr(port_an, name)

        def call(*a, **kw):
            refs.append(ref_fn(*a, **kw))
            if translate is not None:
                a, kw = translate(a, kw)
            ports.append(port_fn(*a, **kw))
            return refs[-1]
        return call

    def port_topology(a, kw):
        return (a[0], port_torus_for(*topo_args[id(a[1])]), *a[2:]), kw

    def reference_tree(a, kw):
        return a, {**kw, "package": "tpusim"}

    monkeypatch.setattr(REF_LINT, "torus_for", torus)
    for name, translate in (("analyze_trace_dir", None),
                            ("analyze_schedule", port_topology),
                            ("analyze_stats_keys", reference_tree)):
        monkeypatch.setattr(REF_LINT, name, twin(name, translate))
    for name, translate in (("analyze_campaign_spec", None),
                            ("analyze_advise_spec", None),
                            ("analyze_fleet_spec", None),
                            ("analyze_self_audit", reference_tree)):
        monkeypatch.setattr(ref_an, name, twin(name, translate))
    build(tmp_path)
    return refs, ports


@pytest.mark.parametrize("name, codes, build", SEEDED,
                         ids=[s[0] for s in SEEDED])
def test_seeded_defect_documents_equal(name, codes, build, tmp_path,
                                       monkeypatch):
    refs, ports = _twin_build(build, tmp_path, monkeypatch)
    assert len(refs) == len(ports) == 1
    ref, port = refs[0], ports[0]
    assert codes <= port.codes(), "\n".join(port.text_lines())
    assert port.to_doc() == ref.to_doc()
    for d in port.items:
        assert d.severity is port_an.CODES[d.code].severity


def test_seeded_corpus_covers_the_port_registry(tmp_path, monkeypatch):
    fired: set[str] = set()
    for i, (_, _, build) in enumerate(SEEDED):
        with monkeypatch.context() as m:
            _, ports = _twin_build(build, tmp_path / str(i), m)
        fired |= ports[0].codes()
    assert fired == set(port_an.CODES)
    assert len(SEEDED) == 63


# ---------------------------------------------------------------------------
# (ii) the 12-trace corpus through both CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("trace", CORPUS, ids=[p.name for p in CORPUS])
def test_corpus_lint_and_perf_report_equal_the_reference(trace, arch):
    assert len(CORPUS) == 12
    base = [str(trace), "--arch", arch]
    for argv in (["lint", *base, "--format", "json"],
                 ["lint", *base, "--perf", "--format", "json"],
                 ["lint", *base],
                 ["perf-report", *base],
                 ["perf-report", *base, "--format", "json"]):
        got, want = _run(port_cli, argv), _run(ref_cli, argv)
        assert got == want, argv
    assert json.loads(got[1])["perf"], "perf-report printed no module"


def test_perf_report_module_filter_and_top():
    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    for argv in (["perf-report", trace, "--arch", "v5p", "--top", "3",
                  "--module", "llama_tiny_tp2dp2"],
                 ["perf-report", trace, "--arch", "v5p", "--module",
                  "nope"]):
        rc, out, err = _run(port_cli, argv)
        ref_rc, ref_out, ref_err = _run(ref_cli, argv)
        assert (rc, out) == (ref_rc, ref_out)
        assert err == ref_err.replace("tpusim perf-report",
                                      "tpusim_torch perf-report")
    assert rc == 2 and "no module 'nope'" in err


# ---------------------------------------------------------------------------
# (iii) the nine ubench traces
# ---------------------------------------------------------------------------

UBENCH = {
    "matmul": dict(m=64, n=48, k=32),
    "small_matmul_chain": dict(size=32, depth=3),
    "op_overhead_chain": dict(depth=16),
    "dynamic_loop": dict(elems=1024),
    "softmax_narrow": dict(batch=2, seq=64, heads=8),
    "relayout_copy": dict(rows=64, cols=32),
    "matmul_int8": dict(m=32, n=16, k=64),
    "reduce_lane_wide": dict(rows=64, cols=256),
    "reduce_major_acc": dict(rows=64, cols=256),
}


@pytest.mark.parametrize("name", list(UBENCH))
def test_ubench_trace_lints_clean_in_both_packages(name, tmp_path):
    from tpusim_torch.models import get_workload
    from tpusim_torch.tracer.capture import capture_to_dir

    module, args = get_workload(name).build(device="cpu", **UBENCH[name])
    capture_to_dir(tmp_path, module, *args, name=name, launches=2)
    for perf in (False, True):
        port = port_an.analyze_trace_dir(tmp_path, perf=perf)
        ref = ref_an.analyze_trace_dir(tmp_path, perf=perf)
        assert not port.has_errors, "\n".join(port.text_lines())
        assert port.to_doc() == ref.to_doc()
    rc, out, _ = _run(port_cli, ["lint", str(tmp_path)])
    assert rc == 0 and out.endswith("tpusim lint: 0 error(s), "
                                    "0 warning(s), 0 info\n")


# ---------------------------------------------------------------------------
# (iv) codes, exit codes, --validate, the audits of the port itself
# ---------------------------------------------------------------------------


def test_list_codes_equal_the_reference():
    rc, out, _ = _run(port_cli, ["lint", "--list-codes"])
    ref_rc, ref_out, _ = _run(ref_cli, ["lint", "--list-codes"])
    assert rc == ref_rc == 0
    # the owning pass module of each family is the port's
    assert out == ref_out.replace("tpusim/", "tpusim_torch/")
    assert out.splitlines() == port_an.list_code_lines()


def _warning_trace(tmp_path: Path) -> Path:
    """A trace whose only finding is a warning (TL015)."""
    return REF_LINT.make_trace(tmp_path, commands=[
        {"kind": "kernel_launch", "module": "good", "device": 0},
        {"kind": "collective", "device": 0, "bytes": 0,
         "collective": {"kind": "all-reduce",
                        "replica_groups": [[0, 1], [2, 3]]}},
    ])


def test_lint_exit_codes_equal_the_reference(tmp_path):
    clean = REF_LINT.make_trace(tmp_path / "clean")
    broken = REF_LINT.make_trace(tmp_path / "broken", commands=[
        {"kind": "kernel_launch", "module": "zzz", "device": 0}])
    warned = _warning_trace(tmp_path / "warned")
    seen = {}
    for trace in (clean, broken, warned):
        for extra in ([], ["--strict"], ["--format", "json"]):
            argv = ["lint", str(trace), "--arch", "v5e", *extra]
            got, want = _run(port_cli, argv), _run(ref_cli, argv)
            assert got == want, argv
            seen[(trace.parent.name, tuple(extra))] = got[0]
    assert seen[("clean", ())] == seen[("clean", ("--strict",))] == 0
    assert seen[("broken", ())] == 1
    assert (seen[("warned", ())], seen[("warned", ("--strict",))]) == (0, 1)
    for argv in (["lint"], ["lint", "--faults", "f.json"]):
        rc, out, err = _run(port_cli, argv)
        ref_rc, _, ref_err = _run(ref_cli, argv)
        assert rc == ref_rc == 2 and out == ""
        assert err == ref_err.replace("tpusim lint", "tpusim_torch lint")


def _refusal(simulate, trace, **kw):
    """The diagnostics document ``simulate(validate=...)`` refuses with,
    or None when it prices."""
    try:
        simulate(trace, arch="v5e", tuned=False, **kw)
    except (ref_an.ValidationError, port_an.ValidationError) as e:
        return e.diags.to_doc()
    return None


def test_validate_refuses_as_the_reference(tmp_path):
    broken = REF_LINT.make_trace(tmp_path / "broken", commands=[
        {"kind": "kernel_launch", "module": "nope", "device": 0},
        {"kind": "kernel_launch", "module": "good", "device": 0}])
    warned = _warning_trace(tmp_path / "warned")
    clean = REF_LINT.make_trace(tmp_path / "clean")
    cases = {(broken, "on"): True, (broken, "strict"): True,
             (warned, "on"): False, (warned, "strict"): True,
             (clean, "strict"): False}
    for (trace, mode), refused in cases.items():
        got = _refusal(port_simulate, trace, validate=mode)
        want = _refusal(ref_simulate, trace, validate=mode)
        assert got == want, (trace.name, mode)
        assert (got is not None) == refused, (trace.name, mode)
    port_report = port_simulate(warned, arch="v5e", tuned=False,
                                validate="on")
    ref_report = ref_simulate(warned, arch="v5e", tuned=False,
                              validate="on")
    assert port_report.cycles == ref_report.cycles > 0


def test_validate_analyzes_explicit_config(tmp_path):
    import dataclasses

    from tpusim_torch.timing.config import SimConfig

    broken = dataclasses.replace(
        SimConfig(), arch=dataclasses.replace(SimConfig().arch,
                                              clock_ghz=0.0))
    with pytest.raises(port_an.ValidationError, match="TL101"):
        port_simulate(REF_LINT.make_trace(tmp_path), config=broken,
                      validate="on")


def test_simulate_validate_cli_equals_the_reference(tmp_path):
    warned = str(_warning_trace(tmp_path))
    for flag, refused in (("--validate", False),
                          ("--validate=strict", True)):
        argv = ["simulate", warned, "--arch", "v5e", flag]
        rc, out, err = _run(port_cli, argv)
        ref_rc, ref_out, ref_err = _run(ref_cli, argv)
        assert rc == ref_rc == (2 if refused else 0)
        assert err == ref_err.replace("tpusim: error:",
                                      "tpusim_torch: error:")
        if refused:
            assert "TL015" in err and out == ref_out == ""


def test_audits_of_the_port_are_clean():
    assert port_an.analyze_self_audit().items == []
    assert port_an.analyze_stats_keys().items == []
    for flag in ("--self-audit", "--stats-keys"):
        rc, out, _ = _run(port_cli, ["lint", flag])
        assert rc == 0 and out == ("tpusim lint: 0 error(s), 0 warning(s),"
                                   " 0 info\n")
    # the audits read the port's tree, not the reference's
    from tpusim_torch.analysis import selfaudit, statskeys

    assert statskeys._audit_files(REPO)
    assert all(p.relative_to(REPO).parts[0] == "tpusim_torch"
               for p in statskeys._audit_files(REPO))
    assert selfaudit._globbed(REPO, selfaudit.SEEDED_SUBSYSTEM_GLOBS,
                              "tpusim_torch")


def test_durable_stores_fsync_before_each_publish(tmp_path, monkeypatch):
    """The publishes the self-audit holds to fsync-before-replace:
    ``durable=True`` (the reference's mode) syncs each staged record
    before its rename and the directory after it; the default syncs
    nothing."""
    import os

    from tpusim_torch.fastpath.store import CompileStore, set_compile_store
    from tpusim_torch.perf.cache import ResultCache, clear_compiled_cache

    synced: list[str] = []
    fsync = os.fsync

    def counting(fd):
        synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        return fsync(fd)

    monkeypatch.setattr(os, "fsync", counting)
    for durable in (False, True):
        synced.clear()
        rc, cc = tmp_path / f"rc_{durable}", tmp_path / f"cc_{durable}"
        clear_compiled_cache()      # compile, and so publish, anew
        try:
            port_simulate(FIXTURES / "matmul_512", arch="v5e", tuned=False,
                          result_cache=ResultCache(disk_dir=rc,
                                                   durable=durable),
                          compile_cache=CompileStore(cc, durable=durable))
        finally:
            set_compile_store(None)
            clear_compiled_cache()
        assert list(rc.glob("*.json")) and list(cc.glob("*.cmod"))
        if durable:
            assert len([p for p in synced if p.endswith(".tmp")]) == 2
            assert {str(rc), str(cc)} <= set(synced)
        else:
            assert synced == []


def test_stats_namespaces_are_the_references_in_the_port_tree():
    assert set(port_an.STATS_NAMESPACES) == set(ref_an.STATS_NAMESPACES)
    for prefix, owners in ref_an.STATS_NAMESPACES.items():
        assert port_an.STATS_NAMESPACES[prefix] == tuple(
            "tpusim_torch/" + o[len("tpusim/"):] if o.startswith("tpusim/")
            else o for o in owners)


# ---------------------------------------------------------------------------
# (v) the --dataflow-smoke and --perf-lint-smoke contracts on the port
# ---------------------------------------------------------------------------


def test_dataflow_smoke_contract(tmp_path):
    from tpusim_torch.analysis.dataflow import analyze_module
    from tpusim_torch.timing.engine import (
        _vmem_peak_live_bytes, _vmem_resident_bytes,
    )
    from tpusim_torch.trace.format import load_trace

    fixtures = sorted({m[0] for m in CG.MATRIX})
    arches = sorted({m[1] for m in CG.MATRIX})
    for fixture in fixtures:
        for arch in arches:
            diags = port_an.analyze_trace_dir(FIXTURES / fixture,
                                              arch=arch, tuned=False)
            assert not [d for d in diags.errors
                        if d.code.startswith("TL4")], (fixture, arch)
    agreed = 0
    for trace in CORPUS:
        for name, module in load_trace(trace).modules.items():
            df = analyze_module(module)
            assert df.alloc_total("vmem") == _vmem_resident_bytes(module)
            assert df.peak_live("vmem") == _vmem_peak_live_bytes(module)
            agreed += 1
    assert agreed >= 12
    # the seeded mismatched-collective trace is refused
    trace = REF_LINT.make_trace(tmp_path, hlo=(
        "HloModule tiny, num_partitions=4\n\n"
        "ENTRY %main (p0: f32[8]) -> f32[8] {\n"
        "  %p0 = f32[8]{0} parameter(0)\n"
        "  ROOT %r = f32[8]{0} negate(%p0)\n"
        "}\n"), name="tiny", commands=[
        {"kind": "kernel_launch", "module": "tiny", "device": 0},
        {"kind": "kernel_launch", "module": "tiny", "device": 1},
        {"kind": "collective", "device": 0, "bytes": 1024,
         "collective": {"kind": "all-reduce", "replica_groups": [[0, 1]]}},
        {"kind": "collective", "device": 1, "bytes": 1024,
         "collective": {"kind": "all-gather", "replica_groups": [[0, 1]]}},
    ])
    diags = port_an.analyze_trace_dir(trace, arch="v5p", tuned=False)
    assert [d for d in diags.errors if d.code.startswith("TL41")]
    with pytest.raises(port_an.ValidationError, match="TL41"):
        port_simulate(trace, arch="v5p", tuned=False, validate="on")
    assert port_an.analyze_self_audit().items == []


def test_perf_lint_smoke_contract(tmp_path):
    from tpusim_torch.analysis.critpath import analyze_module_perf
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.trace.format import load_trace

    fixtures = sorted({m[0] for m in CG.MATRIX})
    arches = sorted({m[1] for m in CG.MATRIX})
    for fixture in fixtures:
        for arch in arches:
            diags = port_an.analyze_trace_dir(FIXTURES / fixture,
                                              arch=arch, tuned=False,
                                              perf=True)
            assert "TL500" in diags.codes()
            assert not [d for d in diags.errors
                        if d.code.startswith("TL5")]
    bracketed = 0
    for trace in CORPUS:
        pod = load_trace(trace)
        for arch in arches:
            cfg = load_config(arch=arch, tuned=False)
            for name, module in sorted(pod.modules.items()):
                mp = analyze_module_perf(module, cfg)
                eng = Engine(cfg).run(module).cycles
                tol = 1e-6 * max(eng, 1.0)
                assert (mp.critical_path_cycles <= eng + tol
                        <= mp.serial_cycles + 2 * tol), (trace.name, arch)
                for cp in mp.comps.values():
                    for e in cp.exposures:
                        assert e.exposed_cycles <= e.priced_cycles + tol
                bracketed += 1
    assert bracketed >= 12 * len(arches)
    # the seeded TL501 module trips through both front doors
    trace = REF_LINT.make_trace(tmp_path, hlo=CG.PERF_LINT_TL501_HLO,
                                name="seeded501")
    diags = port_an.analyze_trace_dir(trace, arch="v5e", tuned=False,
                                      perf=True)
    assert "TL501" in diags.codes()
    rc, out, _ = _run(port_cli, ["perf-report", str(trace), "--arch", "v5e"])
    assert rc == 0 and "TL501" in out
    assert port_an.analyze_self_audit().items == []


def test_chip_smoke_lint_digests_are_the_cpu_run(capsys):
    """``chip_smoke.py`` phase 14 (g) holds the card host's ``lint
    --perf`` and ``perf-report`` of llama_tiny_tp2dp2 to digests of what
    the CPU prints; here the CPU run meets them, and the reference's CLI
    prints the same bytes."""
    smoke = _load("_chip_smoke_for_lint", REPO / "chip_smoke.py")
    out = smoke.ubench_lint_llama("cpu")
    assert set(out["host_s"]) == {" ".join(f) for f in smoke.LINT_DIGESTS}
    assert "equal the CPU's by bytes" in capsys.readouterr().out
    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    for flags in smoke.LINT_DIGESTS:
        argv = [flags[0], trace, "--arch", "v5p", *flags[1:]]
        assert _run(port_cli, argv) == _run(ref_cli, argv)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))

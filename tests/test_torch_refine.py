"""The port's offline harness (``tpusim_torch.harness.correl_ops``,
``async_observable``, ``refine``), ``tpusim_torch.timing.derive`` and A1's
tail of ``tpusim_torch.trace.format`` against a live JAX package run.

Documents are compared with ``==`` after masking the two keys that name
each package (``model_version``, ``tpusim_version``): the offline
correlation regenerated from ``reports/correl_ops.json``'s device rows,
the async-observable demonstration built from it, the replay refiner's
overlay lines, and the two-fold leave-one-out of
``tests/test_loo_artifact.py``.  ``derive_overlay`` writes the bytes of
``configs/v5p.derived.flags``; ``select_module`` resolves a manifest
entry as the reference does, its ambiguity error included.  The CLI's
defaults write under ``build/tpusim_torch_reports/``, never into
``reports/``.  Every output goes to ``tmp_path``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.harness import async_observable as ref_async  # noqa: E402
from tpusim.harness import correl_ops as ref_correl  # noqa: E402
from tpusim.harness import refine as ref_refine  # noqa: E402
from tpusim.timing import derive as ref_derive  # noqa: E402
from tpusim.trace import format as ref_format  # noqa: E402
from tpusim_torch.harness import async_observable as port_async  # noqa: E402
from tpusim_torch.harness import correl_ops as port_correl  # noqa: E402
from tpusim_torch.harness import refine as port_refine  # noqa: E402
from tpusim_torch.ir import ModuleTrace, PodTrace  # noqa: E402
from tpusim_torch.timing import derive as port_derive  # noqa: E402
from tpusim_torch.trace import format as port_format  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SILICON = REPO / "reports" / "silicon"
ARTIFACT = REPO / "reports" / "correl_ops.json"
CONFIGS = REPO / "configs"
MASKED = ("model_version", "tpusim_version")


def _masked(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in MASKED}


@pytest.fixture
def committed_overlays(monkeypatch):
    """The committed tuned overlays (``configs/``), which the committed
    artifacts were generated with (conftest pins an empty dir)."""
    monkeypatch.setenv("TPUSIM_TUNED_DIR", str(CONFIGS))


@pytest.mark.parametrize("tuned", [False, True], ids=["preset", "tuned"])
def test_regenerate_offline_equals_the_references(tuned, tmp_path,
                                                  monkeypatch):
    """The offline correlation document equals the JAX package's, key for
    key, under the presets and under the committed overlays (where it is
    the committed artifact but for the two package keys)."""
    if tuned:
        monkeypatch.setenv("TPUSIM_TUNED_DIR", str(CONFIGS))
    # the document records the artifact path as given: the CLI's default
    monkeypatch.chdir(REPO)
    artifact = ARTIFACT.relative_to(REPO)
    kw = dict(fixture_dir=SILICON, arch="v5e")
    ref = ref_correl.regenerate_offline(artifact, **kw)
    port = port_correl.regenerate_offline(
        artifact, out_path=tmp_path / "c.json", **kw)
    assert _masked(port) == _masked(ref)
    assert json.loads((tmp_path / "c.json").read_text()) == port
    assert port["tpusim_version"] == __import__("tpusim_torch").__version__
    assert port["model_version"] != ref["model_version"]
    if tuned:
        assert _masked(port) == _masked(json.loads(ARTIFACT.read_text()))


def test_regenerate_offline_pooled_equals_serial(tmp_path):
    """``workers=`` fans the replays over the pool; the document is the
    serial one."""
    kw = dict(fixture_dir=SILICON, arch="v5e")
    assert port_correl.regenerate_offline(ARTIFACT, workers=2, **kw) == \
        port_correl.regenerate_offline(ARTIFACT, **kw)


def test_analyze_async_observable_equals_the_references(committed_overlays):
    kw = dict(fixture_dir=SILICON, arch="v5e")
    manifest = SILICON / "manifest.json"
    port = port_async.analyze_async_observable(ARTIFACT, manifest, **kw)
    assert port == ref_async.analyze_async_observable(
        ARTIFACT, manifest, **kw)
    assert port == json.loads(
        (REPO / "reports" / "async_observable.json").read_text())


def test_correlation_pieces_equal_the_references():
    """Rows, counters and the document of one workload, and the
    known-outlier matcher, in both packages."""
    rows = port_refine.load_per_op_rows(ARTIFACT)
    assert rows == ref_refine.load_per_op_rows(ARTIFACT)
    assert port_refine.load_per_op_rows(REPO / "nope.json") == {}
    name = "matmul_chain"
    sil = port_correl.silicon_from_artifact_rows(rows[name])
    ref_sil = ref_correl.silicon_from_artifact_rows(rows[name])
    assert {k: (v.count, v.total_ns) for k, v in sil.items()} == \
        {k: (v.count, v.total_ns) for k, v in ref_sil.items()}
    from tpusim.timing.config import load_config as ref_config
    from tpusim.timing.engine import Engine as RefEngine
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine

    mod = port_format.select_module(port_format.load_trace(SILICON / name),
                                    None)
    ref_mod = ref_format.select_module(ref_format.load_trace(SILICON / name),
                                       None)
    cfg, rcfg = load_config(arch="v5e"), ref_config(arch="v5e")
    res, rres = Engine(cfg).run(mod), RefEngine(rcfg).run(ref_mod)
    corr = port_correl.correlate_ops(
        res, sil, clock_hz=cfg.arch.clock_hz, workload=name,
        xla_estimates=port_correl.xla_op_estimates(mod))
    ref_corr = ref_correl.correlate_ops(
        rres, ref_sil, clock_hz=rcfg.arch.clock_hz, workload=name,
        xla_estimates=ref_correl.xla_op_estimates(ref_mod))
    assert corr.to_json() == ref_corr.to_json()
    assert port_correl.correlate_counters(
        res, sil, clock_hz=cfg.arch.clock_hz, arch=cfg.arch) == \
        ref_correl.correlate_counters(
            rres, ref_sil, clock_hz=rcfg.arch.clock_hz, arch=rcfg.arch)
    outliers = port_correl.load_known_outliers()
    assert outliers == ref_correl.load_known_outliers()
    for wl, err in ((name, 5.0), ("embedding_lookup", 1e9), ("x", None)):
        assert port_correl.match_known_outlier(outliers, wl,
                                               abs_error_pct=err) == \
            ref_correl.match_known_outlier(outliers, wl, abs_error_pct=err)
    assert _masked(port_correl.build_correl_doc([corr])) == \
        _masked(ref_correl.build_correl_doc([ref_corr]))


def _train_entries():
    man = json.loads((SILICON / "manifest.json").read_text())
    return ref_refine.split_held_out(
        man["workloads"], ref_refine.load_per_op_rows(ARTIFACT))


def test_split_held_out_equals_the_references():
    man = json.loads((SILICON / "manifest.json").read_text())
    entries = man["workloads"] + [dict(man["workloads"][0], name="held",
                                       held_out=True)]
    rows = dict(port_refine.load_per_op_rows(ARTIFACT), held=[{}])
    assert port_refine.split_held_out(entries, rows) == \
        ref_refine.split_held_out(entries, rows)


def test_refine_arch_on_fixtures_equals_the_references(committed_overlays):
    """The joint fit of the committed fixtures (per-op rows joined, the
    anchor on): the same knob vector, the same objective and parts, the
    same overlay lines."""
    train, rows, _ = _train_entries()
    kw = dict(per_op_rows=rows, anchor_weight=1.0, max_sweeps=2)
    port = port_refine.refine_arch_on_fixtures("v5e", train, SILICON, **kw)
    ref = ref_refine.refine_arch_on_fixtures("v5e", train, SILICON, **kw)
    assert port.overlay_lines("TPU v5 lite") == \
        ref.overlay_lines("TPU v5 lite")
    assert (port.values, port.changed, port.parts, port.evals,
            port.replayed, port.skipped) == \
        (ref.values, ref.changed, ref.parts, ref.evals, ref.replayed,
         ref.skipped)


def test_mini_loo_equals_the_references():
    """``tests/test_loo_artifact.py``'s two-fold LOO, in both packages."""
    man = json.loads((SILICON / "manifest.json").read_text())
    entries = [
        e for e in man["workloads"]
        if e["name"] in ("reduction", "transcendental")
    ]
    kw = dict(per_op_rows=port_refine.load_per_op_rows(ARTIFACT),
              max_sweeps=1, anchor_weight=1.0)
    port = port_refine.leave_one_out("v5e", entries, SILICON, **kw)
    ref = ref_refine.leave_one_out("v5e", entries, SILICON, **kw)
    assert len(port["folds"]) == 2
    assert port["mean_loo_abs_err_pct"] is not None
    assert _masked(port) == _masked(ref)


def test_derive_overlay_writes_the_committed_flags(committed_overlays,
                                                   tmp_path):
    out = tmp_path / "v5p.derived.flags"
    lines = port_derive.derive_overlay("v5e", "v5p", out_path=out)
    assert out.read_bytes() == (CONFIGS / "v5p.derived.flags").read_bytes()
    assert lines == ref_derive.derive_overlay("v5e", "v5p")
    assert port_derive.TRANSFERABLE_KNOBS == ref_derive.TRANSFERABLE_KNOBS
    assert port_derive.NON_TRANSFERABLE_KNOBS == \
        ref_derive.NON_TRANSFERABLE_KNOBS
    assert set(port_refine.KNOBS) <= (set(port_derive.TRANSFERABLE_KNOBS)
                                      | set(port_derive.NON_TRANSFERABLE_KNOBS))


def test_select_module_and_trace_dir_accessors(tmp_path):
    pod = port_format.load_trace(SILICON / "lstm_layer")
    assert port_format.select_module(pod, None) is pod.modules["lstm_layer"]
    assert port_format.select_module(pod, "lstm_layer") is \
        pod.modules["lstm_layer"]
    with pytest.raises(KeyError):
        port_format.select_module(pod, "nope")
    two = PodTrace()
    two.modules["b"] = ModuleTrace(name="b")
    two.modules["a"] = ModuleTrace(name="a")
    with pytest.raises(ValueError) as got:
        port_format.select_module(two, None)
    ref_two = ref_format.PodTrace()
    ref_two.modules.update(b=None, a=None)
    with pytest.raises(ValueError) as want:
        ref_format.select_module(ref_two, None)
    assert str(got.value) == str(want.value)
    assert "must name one via 'module'" in str(got.value)
    # accessors: the plain and gzipped module names, sorted
    shutil.copytree(SILICON / "lstm_layer", tmp_path / "t")
    shutil.copy(REPO / "tests" / "fixtures" / "traces" / "matmul_512"
                / "modules" / "matmul_512.hlo",
                tmp_path / "t" / "modules" / "a_first.hlo")
    import gzip

    with gzip.open(tmp_path / "t" / "modules" / "z_gz.hlo.gz", "wt") as f:
        f.write("HloModule z\n")
    td = port_format.TraceDir(path=tmp_path / "t")
    ref_td = ref_format.TraceDir(path=tmp_path / "t")
    assert td.modules_dir == ref_td.modules_dir == tmp_path / "t" / "modules"
    assert td.commandlist_path == ref_td.commandlist_path
    assert td.module_names() == ref_td.module_names() == \
        ["a_first", "lstm_layer", "z_gz"]
    assert port_format.TraceDir(path=tmp_path / "none").module_names() == []


def _cli(pkg: str, *args: str, cwd: Path, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", pkg, *args], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=300,
    )


def _env(**kw) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), **kw)
    env.pop("TPUSIM_WORKERS", None)
    return env


def test_cli_defaults_write_under_build_never_into_reports(tmp_path):
    """``correl-regen`` and ``loo`` with no ``--out`` write under
    ``build/tpusim_torch_reports/`` of the working directory; their
    stdout is the reference's but for the paths and the version."""
    fixtures = tmp_path / "silicon"
    fixtures.mkdir()
    man = json.loads((SILICON / "manifest.json").read_text())
    man["workloads"] = [e for e in man["workloads"]
                        if e["name"] in ("reduction", "transcendental")]
    (fixtures / "manifest.json").write_text(json.dumps(man))
    for e in man["workloads"]:
        (fixtures / e["trace"]).symlink_to(SILICON / e["trace"])
    before = {p: p.read_bytes() for p in (REPO / "reports").glob("*.json")}
    env = _env(TPUSIM_TUNED_DIR=str(CONFIGS))
    args = ["--artifact", str(ARTIFACT), "--fixtures", str(fixtures)]
    port = _cli("tpusim_torch", "correl-regen", *args, cwd=tmp_path,
                env=env)
    assert port.returncode == 0, port.stderr
    out = tmp_path / "build" / "tpusim_torch_reports"
    ref = _cli("tpusim", "correl-regen", *args, "--out",
               str(tmp_path / "ref" / "correl_ops.json"), cwd=tmp_path,
               env=env)
    assert ref.returncode == 0, ref.stderr
    for name in ("correl_ops.json", "async_observable.json"):
        assert _masked(json.loads((out / name).read_text())) == _masked(
            json.loads((tmp_path / "ref" / name).read_text()))

    def scrub(text, where, version):
        return text.replace(str(where), "OUT").replace(version, "MV")

    pdoc = json.loads((out / "correl_ops.json").read_text())
    rdoc = json.loads((tmp_path / "ref" / "correl_ops.json").read_text())
    assert scrub(port.stdout, Path("build") / "tpusim_torch_reports",
                 pdoc["model_version"]) == \
        scrub(ref.stdout, tmp_path / "ref", rdoc["model_version"])
    loo_args = ["--fixtures", str(fixtures), "--per-op-artifact",
                str(ARTIFACT), "--sweeps", "1"]
    port = _cli("tpusim_torch", "loo", *loo_args, cwd=tmp_path, env=env)
    assert port.returncode == 0, port.stderr
    ref = _cli("tpusim", "loo", *loo_args, "--out",
               str(tmp_path / "ref" / "loo.json"), cwd=tmp_path, env=env)
    assert ref.returncode == 0, ref.stderr
    assert _masked(json.loads((out / "loo.json").read_text())) == _masked(
        json.loads((tmp_path / "ref" / "loo.json").read_text()))
    assert port.stdout.splitlines()[:-1] == ref.stdout.splitlines()[:-1]
    assert port.stdout.splitlines()[-1] == \
        f"written to {Path('build') / 'tpusim_torch_reports' / 'loo.json'}"
    assert {p: p.read_bytes() for p in (REPO / "reports").glob("*.json")} \
        == before


def test_refine_and_derive_cli_equal_the_references(tmp_path):
    """``refine --seed --out`` writes the reference's overlay (the seed's
    non-knob lines merged) and prints its lines; ``derive-arch --out``
    writes ``configs/v5p.derived.flags``."""
    env = _env(TPUSIM_TUNED_DIR=str(CONFIGS))
    seed = tmp_path / "seed.flags"
    seed.write_text("-arch.clock_ghz 1.7\n-arch.host_bandwidth 2e10\n")
    outs = {}
    for pkg in ("tpusim", "tpusim_torch"):
        out = tmp_path / pkg / "refined.flags"
        p = _cli(pkg, "refine", "--fixtures", str(SILICON), "--sweeps", "1",
                 "--seed", str(seed), "--per-op-artifact", str(ARTIFACT),
                 "--out", str(out), cwd=tmp_path, env=env)
        assert p.returncode == 0, p.stderr
        outs[pkg] = (p.stdout.replace(str(out), "OUT"), out.read_bytes())
    assert outs["tpusim_torch"] == outs["tpusim"]
    assert b"-arch.host_bandwidth 2e10\n" in outs["tpusim"][1]
    out = tmp_path / "derived.flags"
    p = _cli("tpusim_torch", "derive-arch", "--out", str(out), cwd=tmp_path,
             env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout == f"derive-arch: 16 knobs v5e -> v5p, written to {out}\n"
    assert out.read_bytes() == (CONFIGS / "v5p.derived.flags").read_bytes()
    missing = _cli("tpusim_torch", "refine", "--fixtures",
                   str(tmp_path / "none"), cwd=tmp_path, env=env)
    assert missing.returncode == 1
    assert "no fixture manifest at" in missing.stderr

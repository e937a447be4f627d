"""The port's pricing fastpath against its serial walk and the JAX package.

Over the 12-trace corpus (``reports/silicon/*`` plus
``tests/fixtures/traces/*``, built as ``tests/test_fastpath.py`` builds
it), each held byte for byte:

* every computation's compiled columns equal ``tpusim.fastpath.compile``'s
  by ``tobytes()``, and the step programs are equal;
* ``result_to_doc`` of the port's ``vectorized`` and ``serial``
  ``Engine.run`` equals the JAX ``Engine.run``'s, as JSON strings, on v4,
  v5e, v5p and v6e, under the degraded launch classes (clock_scale,
  hbm_scale) in {(1, 1), (0.5, 1), (1, 0.5), (0.7, 0.8)} and under vmem
  spill;
* the fastpath disengages under timeline recording and op-granularity
  checkpoint/resume; the backend resolution contract; the
  ``--pricing-backend`` CLI stamps ``fastpath_backend``; golden cells 1-5
  pass under ``vectorized``;
* ``torch.cumsum`` on the CPU equals ``numpy.cumsum`` by bytes on seeded
  float64 matrices, the invariant every scan of the fastpath leans on.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpusim.fastpath.compile import compile_module as ref_compile  # noqa: E402
from tpusim.perf import cache as ref_cache  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.timing.cost import CostModel as RefCostModel  # noqa: E402
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.fastpath import compile as port_compile_mod  # noqa: E402
from tpusim_torch.fastpath import price as port_price  # noqa: E402
from tpusim_torch.perf import cache as port_cache  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.timing import model_version as port_mv  # noqa: E402
from tpusim_torch.timing.config import load_config as port_config  # noqa: E402
from tpusim_torch.timing.cost import CostModel as PortCostModel  # noqa: E402
from tpusim_torch.timing.engine import Engine as PortEngine  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SILICON = REPO / "reports" / "silicon"
CI_TRACES = REPO / "tests" / "fixtures" / "traces"
ARCHES = ("v4", "v5e", "v5p", "v6e")
SCALE_CLASSES = ((1.0, 1.0), (0.5, 1.0), (1.0, 0.5), (0.7, 0.8))
STARVED_VMEM = {"arch": {"vmem_bytes": 64 * 1024}}


def _trace_dirs() -> list[Path]:
    manifest = json.loads((SILICON / "manifest.json").read_text())
    dirs = [SILICON / e["trace"] for e in manifest["workloads"]]
    return dirs + sorted(p for p in CI_TRACES.iterdir() if p.is_dir())


@pytest.fixture(scope="module")
def corpus() -> list[tuple[str, object, object]]:
    """(label, JAX module, port module) for every committed fixture
    module."""
    out = []
    for tdir in _trace_dirs():
        ref_pod, port_pod = ref_load(tdir), port_load(tdir)
        assert sorted(ref_pod.modules) == sorted(port_pod.modules)
        for name in sorted(ref_pod.modules):
            out.append((f"{tdir.name}/{name}", ref_pod.modules[name],
                        port_pod.modules[name]))
    return out


def _doc(result, cache) -> str:
    return json.dumps(cache.result_to_doc(result), sort_keys=False)


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(x):
    """A step program with tensors/arrays as lists and collective infos as
    dicts, for comparison across the two packages."""
    if isinstance(x, torch.Tensor) or isinstance(x, np.ndarray):
        return ("array", x.tolist())
    if isinstance(x, (tuple, list)):
        return type(x)(_plain(v) for v in x)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.asdict(x))
    return x


# ---------------------------------------------------------------------------
# The invariant: torch.cumsum on CPU float64 is NumPy's serial scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (47,), (100_003,), (1, 4096),
                                   (64, 4096), (4096, 47), (257, 1000)])
def test_torch_cumsum_equals_numpy_bytes(shape):
    rng = np.random.default_rng(sum(shape))
    m = np.exp(rng.uniform(np.log(1e-3), np.log(1e9), size=shape))
    m[..., ::7] = 0.0  # the columns hold exact zeros for non-sync rows
    for dim in range(len(shape)):
        want = np.cumsum(m, axis=dim)
        got = torch.cumsum(torch.from_numpy(m), dim=dim).numpy()
        assert got.tobytes() == want.tobytes()
        inplace = torch.from_numpy(m.copy())
        inplace.cumsum_(dim)
        assert inplace.numpy().tobytes() == want.tobytes()


def test_scalar_over_tensor_is_not_a_division():
    """Why the fastpath never computes scalar / tensor: torch takes it as
    a reciprocal times the scalar, which is not the serial walk's
    division.  tensor / scalar and tensor / tensor are divisions."""
    x = np.exp(np.random.default_rng(3).uniform(-20, 20, size=10_000))
    t = torch.from_numpy(x)
    assert (t / 0.7).numpy().tobytes() == (x / 0.7).tobytes()
    assert (t / torch.full_like(t, 0.7)).numpy().tobytes() == (x / 0.7).tobytes()
    assert (0.7 / t).numpy().tobytes() != (0.7 / x).tobytes()


# ---------------------------------------------------------------------------
# Compiled columns and step programs
# ---------------------------------------------------------------------------

_COLUMNS = ("cycles", "compute", "hbm", "vmem", "hrs", "vrs", "flops", "mxu",
            "trans", "ici_bytes")


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_compiled_columns_equal_reference(corpus, arch):
    ref_cfg, port_cfg = ref_config(arch=arch), port_config(arch=arch)
    checked = 0
    for label, ref_mod, port_mod in corpus:
        ref_cm = ref_compile(ref_mod, RefCostModel(ref_cfg.arch), ref_cfg)
        port_cm = port_compile_mod.compile_module(
            port_mod, PortCostModel(port_cfg.arch), port_cfg)
        for cname in ref_mod.computations:
            want, got = ref_cm.comp(cname), port_cm.comp(cname)
            for col in _COLUMNS:
                w, g = getattr(want, col), getattr(got, col)
                assert g.dtype == torch.float64 and g.device.type == "cpu"
                assert g.numpy().tobytes() == w.tobytes(), (label, cname, col)
            assert got.names == want.names and got.bases == want.bases
            assert got.units == want.units
            assert got.any_vmem == want.any_vmem
            assert _plain(got.steps) == _plain(want.steps), (label, cname)
            checked += 1
    assert checked > 100


def test_run_and_crun_blocks_follow_dma_in_flight(corpus):
    """The static split: a computation with an async DMA start in flight
    prices its sync ops as ``crun`` and the rest as ``run``; the corpus
    has both kinds and all scalar step kinds but ``cond``."""
    cfg = port_config(arch="v5e")
    kinds = set()
    for _, _, port_mod in corpus:
        cm = port_compile_mod.compile_module(
            port_mod, PortCostModel(cfg.arch), cfg)
        for cname in port_mod.computations:
            kinds.update(step[0] for step in cm.comp(cname).steps)
    assert {"run", "crun", "dma", "done", "coll", "while"} <= kinds


# ---------------------------------------------------------------------------
# Engine.run: vectorized == serial == the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs,hs", SCALE_CLASSES,
                         ids=[f"{c}-{h}" for c, h in SCALE_CLASSES])
def test_engine_run_equals_reference(corpus, cs, hs):
    """Every corpus module x every arch under one launch class: the port's
    vectorized fastpath, its serial walk and the JAX ``Engine.run`` give
    the same result document."""
    for arch in ARCHES:
        ref_cfg, port_cfg = ref_config(arch=arch), port_config(arch=arch)
        for label, ref_mod, port_mod in corpus:
            want = _doc(RefEngine(ref_cfg, clock_scale=cs, hbm_scale=hs)
                        .run(ref_mod), ref_cache)
            for backend in ("vectorized", "serial"):
                eng = PortEngine(port_cfg, clock_scale=cs, hbm_scale=hs,
                                 pricing_backend=backend)
                got = _doc(eng.run(port_mod), port_cache)
                assert got == want, f"{label} @ {arch} ({cs},{hs}) {backend}"


def test_degraded_class_prices_slower(corpus):
    """The multipliers move the price: a straggler or a throttled HBM never
    makes a module faster, and both slow the corpus down overall."""
    cfg = port_config(arch="v5e")
    total = {}
    for cs, hs in SCALE_CLASSES:
        total[(cs, hs)] = sum(
            PortEngine(cfg, clock_scale=cs, hbm_scale=hs).run(m).cycles
            for _, _, m in corpus)
    healthy = total[(1.0, 1.0)]
    for key, cycles in total.items():
        assert cycles >= healthy
        if key != (1.0, 1.0):
            assert cycles > healthy


@pytest.mark.parametrize("cs,hs", [(1.0, 1.0), (0.7, 0.8)])
def test_vmem_spill_equals_reference(corpus, cs, hs):
    """A starved vmem budget exercises the spill transform (bytes migrate
    vmem->HBM) on top of the degraded one."""
    ref_cfg = ref_config(arch="v5e", overlays=[STARVED_VMEM])
    port_cfg = port_config(arch="v5e", overlays=[STARVED_VMEM])
    spilled = 0
    for label, ref_mod, port_mod in corpus:
        ref_res = RefEngine(ref_cfg, clock_scale=cs, hbm_scale=hs).run(ref_mod)
        spilled += ref_res.vmem_spill_bytes > 0
        want = _doc(ref_res, ref_cache)
        for backend in ("vectorized", "serial"):
            eng = PortEngine(port_cfg, clock_scale=cs, hbm_scale=hs,
                             pricing_backend=backend)
            assert _doc(eng.run(port_mod), port_cache) == want, (label, backend)
    assert spilled >= len(corpus) // 2, (
        "the corpus barely spilled; shrink the vmem overlay")


@pytest.mark.parametrize("cs,hs", [(0.0, 1.0), (1.0, 1.5), (-0.5, 0.5)])
def test_scales_outside_unit_interval_raise(cs, hs):
    with pytest.raises(ValueError, match="clock_scale/hbm_scale"):
        RefEngine(ref_config(arch="v5e"), clock_scale=cs, hbm_scale=hs)
    with pytest.raises(ValueError, match="clock_scale/hbm_scale"):
        PortEngine(port_config(arch="v5e"), clock_scale=cs, hbm_scale=hs)


# ---------------------------------------------------------------------------
# Engagement / disengagement
# ---------------------------------------------------------------------------


def _count_price_module(monkeypatch) -> list:
    called = []
    real = port_price.price_module
    monkeypatch.setattr(port_price, "price_module",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    return called


def test_fastpath_disengages_under_timeline(monkeypatch):
    called = _count_price_module(monkeypatch)
    mod = next(iter(port_load(SILICON / "matmul_chain").modules.values()))
    cfg = port_config(arch="v5e")
    res = PortEngine(cfg, record_timeline=True).run(mod)
    assert not called, "fastpath engaged under timeline recording"
    ref_mod = next(iter(ref_load(SILICON / "matmul_chain").modules.values()))
    want = RefEngine(ref_config(arch="v5e"), record_timeline=True).run(ref_mod)
    assert res.timeline
    assert [dataclasses.astuple(e) for e in res.timeline] == \
        [dataclasses.astuple(e) for e in want.timeline]
    healthy = PortEngine(cfg).run(mod)
    assert called and not healthy.timeline
    assert _doc(res, port_cache) == _doc(healthy, port_cache)


@pytest.mark.parametrize("overlay", [{"resume_op": 100},
                                     {"checkpoint_op": 200}])
def test_fastpath_disengages_under_checkpoint_resume(monkeypatch, overlay):
    called = _count_price_module(monkeypatch)
    tdir = CI_TRACES / "llama_tiny_tp2dp2"
    [ref_mod] = ref_load(tdir).modules.values()
    [port_mod] = port_load(tdir).modules.values()
    ref_cfg = ref_config(arch="v5p", overlays=[overlay])
    port_cfg = port_config(arch="v5p", overlays=[overlay])
    got = PortEngine(port_cfg, pricing_backend="vectorized").run(port_mod)
    assert not called, "fastpath engaged under op-granularity " + str(overlay)
    want = RefEngine(ref_cfg, pricing_backend="vectorized").run(ref_mod)
    assert _doc(got, port_cache) == _doc(want, ref_cache)


def test_compile_shared_across_launch_classes():
    """Every degraded class of one module shares ONE compile: the columns
    are healthy, the transforms are per class."""
    mod = next(iter(port_load(SILICON / "mlp_train_step").modules.values()))
    cfg = port_config(arch="v5e")
    before = port_cache.compiled_cache_stats()
    for cs, hs in SCALE_CLASSES:
        PortEngine(cfg, clock_scale=cs, hbm_scale=hs).run(mod)
    after = port_cache.compiled_cache_stats()
    assert after["compile_misses"] - before["compile_misses"] <= 1
    assert after["compile_hits"] - before["compile_hits"] >= 3
    # a fresh parse of the same text hits the same compile
    again = next(iter(port_load(SILICON / "mlp_train_step").modules.values()))
    PortEngine(cfg).run(again)
    assert port_cache.compiled_cache_stats()["compile_misses"] == \
        after["compile_misses"]


def test_compiled_tier_bounds_and_clears():
    cfg = port_config(arch="v5e")
    mods = [next(iter(port_load(SILICON / n).modules.values()))
            for n in ("matmul_chain", "reduction", "mlp_train_step")]
    try:
        port_cache.clear_compiled_cache()
        for m in mods:
            PortEngine(cfg).run(m)
        assert port_cache.compiled_cache_stats()["compiled_modules"] == 3
        port_cache.set_compiled_cache_max(2)
        assert port_cache.compiled_cache_stats()["compiled_modules"] == 2
        assert port_cache.clear_compiled_cache() == 2
        assert port_cache.compiled_cache_stats()["compiled_modules"] == 0
    finally:
        port_cache.set_compiled_cache_max(256)


def test_module_without_fingerprint_compiles_once_per_object():
    mod = next(iter(port_load(SILICON / "reduction").modules.values()))
    mod.meta.pop("content_hash")
    eng = PortEngine(port_config(arch="v5e"))
    first = port_cache.compiled_for(mod, eng)
    assert port_cache.compiled_for(mod, eng) is first
    # the structural fingerprint of an in-memory module keys the tier
    assert mod._fingerprint_cache == port_cache._structural_fingerprint(mod)


# ---------------------------------------------------------------------------
# Keys, fingerprints, documents
# ---------------------------------------------------------------------------


def test_fingerprints_equal_reference(corpus):
    for label, ref_mod, port_mod in corpus:
        assert port_cache.module_fingerprint(port_mod) == \
            ref_cache.module_fingerprint(ref_mod), label
    for arch in ARCHES:
        assert port_cache.config_fingerprint(port_config(arch=arch)) == \
            ref_cache.config_fingerprint(ref_config(arch=arch))
    from tpusim.ici.topology import torus_for as ref_torus
    from tpusim_torch.ici.topology import torus_for as port_torus

    for n, arch in ((4, "v5p"), (8, "v6e"), (1, "v5e")):
        assert port_cache.topology_signature(port_torus(n, arch)) == \
            ref_cache.topology_signature(ref_torus(n, arch))
    assert port_cache.topology_signature(None) == "none"


def test_compiled_key_names_the_ports_sources(corpus):
    """The key's version hashes the port's files (not the JAX package's):
    an edit to the port's parser or fastpath orphans old columns."""
    for rel in port_cache._PARSER_FILES + port_mv.MODEL_FILES:
        assert (REPO / rel).is_file(), rel
        assert not rel.startswith("tpusim/"), rel
    assert "tpusim_torch/fastpath/price.py" in port_cache._PARSER_FILES
    _, _, port_mod = corpus[0]
    key = port_cache._compiled_key(port_mod, port_config(arch="v5e"))
    mfp, platform, cfg_fp, version = key
    assert version == (f"{port_mv.model_version()}+"
                       f"{port_cache.parser_version()}")
    assert port_cache.compiled_key_str(key) == \
        f"{mfp}|p={platform}|{cfg_fp}|{version}"
    assert port_mv.model_version() != \
        __import__("tpusim.timing.model_version",
                   fromlist=["model_version"]).model_version()


def test_result_to_doc_has_the_references_fields():
    ref_doc = ref_cache.result_to_doc(RefEngine(ref_config()).run(
        next(iter(ref_load(SILICON / "reduction").modules.values()))))
    port_doc = port_cache.result_to_doc(PortEngine(port_config()).run(
        next(iter(port_load(SILICON / "reduction").modules.values()))))
    assert list(port_doc) == list(ref_doc)
    assert "timeline" not in port_doc


# ---------------------------------------------------------------------------
# Backend resolution, driver and CLI
# ---------------------------------------------------------------------------


def test_resolve_backend_contract(monkeypatch):
    monkeypatch.delenv("TPUSIM_PRICING_BACKEND", raising=False)
    assert port_price.BACKENDS == ("auto", "serial", "vectorized", "native")
    assert port_price.resolve_backend("serial") == "serial"
    assert port_price.resolve_backend("vectorized") == "vectorized"
    assert port_price.resolve_backend(None) == "vectorized"
    assert port_price.resolve_backend("auto") == "vectorized"
    monkeypatch.setenv("TPUSIM_PRICING_BACKEND", "serial")
    assert port_price.resolve_backend(None) == "serial"
    assert PortEngine(port_config()).pricing_backend is None
    monkeypatch.delenv("TPUSIM_PRICING_BACKEND")
    with pytest.raises(ValueError, match="unknown pricing backend"):
        port_price.resolve_backend("warp-speed")


def test_explicit_native_raises():
    """Pinning a backend the port does not have fails loudly, never
    silently prices through something else."""
    with pytest.raises(ValueError, match="pricing backend 'native' requested"):
        port_price.resolve_backend("native")
    mod = next(iter(port_load(SILICON / "reduction").modules.values()))
    with pytest.raises(ValueError, match="native"):
        PortEngine(port_config(), pricing_backend="native").run(mod)


def _stats(report) -> dict:
    return json.loads(report.stats.to_json())


_VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}


def _steady(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k not in _VOLATILE and not k.startswith("fastpath_")}


@pytest.mark.parametrize("backend", ["vectorized", "serial"])
def test_driver_stamps_fastpath_keys_only_on_request(backend):
    tdir = CI_TRACES / "llama_tiny_tp2dp2"
    plain = _stats(port_simulate(tdir, arch="v5p", tuned=False))
    assert not any(k.startswith("fastpath_") for k in plain)
    got = _stats(port_simulate(tdir, arch="v5p", tuned=False,
                               pricing_backend=backend))
    want = _stats(ref_simulate(tdir, arch="v5p", tuned=False,
                               pricing_backend=backend))
    assert got["fastpath_backend"] == want["fastpath_backend"] == backend
    assert sorted(k for k in got if k.startswith("fastpath_")) == [
        "fastpath_backend", "fastpath_compile_hits",
        "fastpath_compile_misses", "fastpath_compiled_modules"]
    assert list(_steady(got)) == list(_steady(want)) == list(_steady(plain))
    assert _steady(got) == _steady(want) == _steady(plain)


def test_checkpoint_op_stamps_the_serial_walk():
    overlays = [{"checkpoint_op": 100}]
    got = _stats(port_simulate(CI_TRACES / "llama_tiny_tp2dp2", arch="v5p",
                               overlays=overlays, pricing_backend="vectorized"))
    assert got["fastpath_backend"] == "serial"


def test_cli_pricing_backend_stamps_fastpath_backend(capsys):
    trace = str(CI_TRACES / "matmul_512")
    assert port_main(["simulate", trace, "--arch", "v5e"]) == 0
    plain = capsys.readouterr().out.splitlines()
    assert not any(ln.startswith("tpusim_fastpath_") for ln in plain)
    for backend in ("vectorized", "serial", "auto"):
        assert port_main(["simulate", trace, "--arch", "v5e",
                          "--pricing-backend", backend]) == 0
        out = capsys.readouterr().out.splitlines()
        resolved = "serial" if backend == "serial" else "vectorized"
        assert f"tpusim_fastpath_backend = {resolved}" in out
        keep = [ln for ln in out if not ln.startswith("tpusim_fastpath_")
                and not ln.startswith(("tpusim_simulation_rate_kops",
                                       "tpusim_silicon_slowdown"))]
        assert keep == [ln for ln in plain if not ln.startswith(
            ("tpusim_simulation_rate_kops", "tpusim_silicon_slowdown"))]
    assert port_main(["simulate", trace, "--pricing-backend", "native"]) == 2
    assert "pricing backend 'native'" in capsys.readouterr().err


@pytest.mark.parametrize("case", range(5))
def test_golden_cells_pass_under_vectorized(case):
    cg = _check_golden()
    fixture, arch, overlays = cg.MATRIX[case]
    name = f"{fixture}__{arch}" + (f"__{cg._overlay_tag(overlays)}"
                                   if overlays else "")
    report = port_simulate(CI_TRACES / fixture, arch=arch,
                           overlays=list(overlays), tuned=False,
                           pricing_backend="vectorized")
    stats = _stats(report)
    assert stats["fastpath_backend"] == "vectorized"
    # the fastpath_* accounting keys are the request's only additions
    assert cg.compare({name: _steady(stats)}) == []

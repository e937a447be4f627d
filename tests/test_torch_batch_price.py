"""The port's lane-batched pricing against the JAX package's per-state walk.

Counterparts of ``tests/test_batch_price.py``'s byte-identity tests: every
lane of ``price_module_batch`` equals the JAX package's ``Engine.run`` for
that lane's launch class, byte for byte, over the 12-trace corpus at v5e
and v5p, through the host row scans (``vectorized``) and through the
``cuda`` backend's route (ops-major matrices into the ``scan_rows``
wrapper), which on the CPU takes the kernel's plain version.  Also:
single-lane and serial degeneration, ``BatchStats``' keys, the
``scan_rows`` wrapper and its plain version, and ``backend="cuda"``
raising without a card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpusim.fastpath.batch import BatchStats as RefBatchStats  # noqa: E402
from tpusim.perf.cache import result_to_doc as ref_doc  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.fastpath import (  # noqa: E402
    BATCH_BACKENDS,
    BatchStats,
    price_module_batch,
    resolve_batch_backend,
    resolve_engine_scales,
)
from tpusim_torch.fastpath import batch as port_batch  # noqa: E402
from tpusim_torch.fastpath.price import price_module  # noqa: E402
from tpusim_torch.kernels import build  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402
from tpusim_torch.perf.cache import result_to_doc as port_doc  # noqa: E402
from tpusim_torch.timing.config import load_config as port_config  # noqa: E402
from tpusim_torch.timing.engine import Engine as PortEngine  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SILICON = REPO / "reports" / "silicon"
FIXTURES = REPO / "tests" / "fixtures" / "traces"
TRACE = FIXTURES / "llama_tiny_tp2dp2"

# the campaign-style launch classes of tests/test_batch_price.py: healthy
# + a derate ladder
LANES = [(1.0, 1.0)] + [
    (round(0.4 + 0.05 * i, 10), round(0.9 - 0.03 * i, 10))
    for i in range(7)
]


@pytest.fixture(scope="module")
def corpus() -> list[tuple[str, object, object]]:
    manifest = json.loads((SILICON / "manifest.json").read_text())
    dirs = [SILICON / e["trace"] for e in manifest["workloads"]]
    dirs += sorted(p for p in FIXTURES.iterdir() if p.is_dir())
    out = []
    for tdir in dirs:
        ref_pod, port_pod = ref_load(tdir), port_load(tdir)
        for name in sorted(ref_pod.modules):
            out.append((f"{tdir.name}/{name}", ref_pod.modules[name],
                        port_pod.modules[name]))
    return out


def _docs(results, to_doc) -> list[str]:
    return [json.dumps(to_doc(r), sort_keys=False) for r in results]


def _engines(cfg, lanes=LANES):
    return [PortEngine(cfg, clock_scale=cs, hbm_scale=hs) for cs, hs in lanes]


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


# -- byte-identity ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["vectorized", "cuda"])
@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_batched_matches_reference_per_state(corpus, arch, backend,
                                             request):
    """Every lane of every corpus module equals the JAX package's
    per-state ``Engine.run`` byte for byte (and the port's serial walk)."""
    calls = (request.getfixturevalue("cuda_route_on_cpu")
             if backend == "cuda" else None)
    ref_cfg, port_cfg = ref_config(arch=arch), port_config(arch=arch)
    for label, ref_mod, port_mod in corpus:
        want = _docs([RefEngine(ref_cfg, clock_scale=cs, hbm_scale=hs)
                      .run(ref_mod) for cs, hs in LANES], ref_doc)
        got = _docs(price_module_batch(port_mod, _engines(port_cfg),
                                       backend=backend), port_doc)
        assert got == want, f"{label} @ {arch} ({backend})"
    serial = _docs([e._run_serial(port_mod) for e in _engines(port_cfg)],
                   port_doc)
    assert got == serial
    if calls is not None:
        # ops-major [k, S] matrices, one lane per column
        assert calls and all(shape[1] == len(LANES) for shape in calls)


def _divergent_cond_text(n: int = 4096) -> str:
    """A module whose conditional's worst branch depends on the lane: a
    matrix product (slower under a straggler clock) or a chain of adds
    (slower under a throttled HBM), followed by a run of 60 ops."""
    sh = f"f32[{n},{n}]{{1,0}}"
    tail = "\n".join(f"  %m{i} = {sh} multiply(%m{i - 1}, %m{i - 1})"
                     for i in range(1, 60))
    return f"""HloModule cond_lanes, is_scheduled=true

%compute_branch (p0: f32[{n},{n}]) -> f32[{n},{n}] {{
  %p0 = {sh} parameter(0)
  ROOT %dot.1 = {sh} dot(%p0, %p0), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}

%memory_branch (p1: f32[{n},{n}]) -> f32[{n},{n}] {{
  %p1 = {sh} parameter(0)
  %s1 = {sh} add(%p1, %p1)
  %s2 = {sh} add(%s1, %p1)
  %s3 = {sh} add(%s2, %s1)
  ROOT %s4 = {sh} add(%s3, %s2)
}}

ENTRY %main (a: f32[{n},{n}], pred: pred[]) -> f32[{n},{n}] {{
  %a = {sh} parameter(0)
  %pred = pred[] parameter(1)
  %e0 = {sh} add(%a, %a)
  %cond = {sh} conditional(%pred, %e0, %e0), true_computation=%compute_branch, false_computation=%memory_branch
  %m0 = {sh} multiply(%cond, %cond)
{tail}
  ROOT %out = {sh} add(%m59, %m0)
}}
"""


@pytest.mark.parametrize("backend", ["vectorized", "cuda"])
def test_lane_divergent_conditional_matches_reference(backend, request):
    """Lanes whose worst conditional branch differs carry different
    accumulators out of the ``cond`` step, so the runs after it take the
    per-lane-seeded row scans (``_acc_shared``'s divergent path) — on the
    host, or through the ``cuda`` route's ops-major scans."""
    from tpusim.trace.hlo_text import parse_hlo_module as ref_parse
    from tpusim_torch.trace.hlo_text import parse_hlo_module as port_parse

    if backend == "cuda":
        request.getfixturevalue("cuda_route_on_cpu")
    text = _divergent_cond_text()
    ref_mod = ref_parse(text, name_hint="cond_lanes")
    port_mod = port_parse(text, name_hint="cond_lanes")
    lanes = [(1.0, 1.0), (0.5, 1.0), (1.0, 0.3), (0.7, 0.3), (0.3, 0.9)]
    ref_cfg, port_cfg = ref_config(arch="v5e"), port_config(arch="v5e")
    want = [RefEngine(ref_cfg, clock_scale=cs, hbm_scale=hs).run(ref_mod)
            for cs, hs in lanes]
    assert len({r.flops for r in want}) == 2, "the branches did not diverge"
    got = price_module_batch(port_mod, _engines(port_cfg, lanes),
                             backend=backend)
    assert _docs(got, port_doc) == _docs(want, ref_doc)
    per_state = [PortEngine(port_cfg, clock_scale=cs, hbm_scale=hs).run(
        port_mod) for cs, hs in lanes]
    assert _docs(per_state, port_doc) == _docs(want, ref_doc)


def test_batched_under_vmem_spill_matches_reference(corpus):
    overlay = {"arch": {"vmem_bytes": 64 * 1024}}
    ref_cfg = ref_config(arch="v5e", overlays=[overlay])
    port_cfg = port_config(arch="v5e", overlays=[overlay])
    spilled = 0
    for label, ref_mod, port_mod in corpus:
        ref_res = [RefEngine(ref_cfg, clock_scale=cs, hbm_scale=hs)
                   .run(ref_mod) for cs, hs in LANES]
        spilled += ref_res[0].vmem_spill_bytes > 0
        got = _docs(price_module_batch(port_mod, _engines(port_cfg)),
                    port_doc)
        assert got == _docs(ref_res, ref_doc), label
    assert spilled


def test_single_lane_degenerates_to_per_state_fastpath():
    """S=1 batching equals the per-state fastpath (and the serial walk)
    for the same launch class — no special-casing."""
    cfg = port_config(arch="v5p")
    [mod] = port_load(TRACE).modules.values()
    [batched] = price_module_batch(
        mod, [PortEngine(cfg, clock_scale=0.77, hbm_scale=0.91)])
    ref = price_module(PortEngine(cfg, clock_scale=0.77, hbm_scale=0.91),
                       mod, "vectorized")
    serial = PortEngine(cfg, clock_scale=0.77,
                        hbm_scale=0.91)._run_serial(mod)
    assert _docs([batched], port_doc) == _docs([ref], port_doc) == \
        _docs([serial], port_doc)


def test_serial_backend_degenerates_to_per_lane_walk(monkeypatch):
    cfg = port_config(arch="v5e")
    [mod] = port_load(TRACE).modules.values()
    called = []
    monkeypatch.setattr(port_batch, "_price_comp_batch",
                        lambda *a: called.append(1))
    batched = _docs(price_module_batch(mod, _engines(cfg, LANES[:3]),
                                       backend="serial"), port_doc)
    serial = _docs([e._run_serial(mod) for e in _engines(cfg, LANES[:3])],
                   port_doc)
    assert batched == serial and not called
    assert price_module_batch(mod, []) == []


def test_resolve_engine_scales_shared_helper():
    eng = PortEngine(port_config(arch="v5p"), clock_scale=0.5,
                     hbm_scale=0.25)
    assert resolve_engine_scales(eng) == (0.5, 0.25)


def test_batch_stats_keys_match_reference():
    a, b = BatchStats(), BatchStats()
    b.states, b.groups, b.lanes_cached, b.skipped = 5, 1, 2, 3
    a.merge(b)
    a.merge(b)
    ref = RefBatchStats()
    ref.states, ref.groups, ref.lanes_cached, ref.skipped = 10, 2, 4, 6
    assert a.stats_dict() == ref.stats_dict()
    assert list(a.stats_dict()) == list(ref.stats_dict())


def test_resolve_batch_backend_contract(monkeypatch):
    monkeypatch.delenv("TPUSIM_PRICING_BACKEND", raising=False)
    assert BATCH_BACKENDS == ("vectorized", "cuda", "serial")
    assert resolve_batch_backend(None) == "vectorized"
    assert resolve_batch_backend("vectorized") == "vectorized"
    assert resolve_batch_backend("serial") == "serial"
    with pytest.raises(ValueError, match="native"):
        resolve_batch_backend("native")


def test_cuda_backend_raises_without_a_card(monkeypatch):
    """``backend="cuda"`` never quietly prices on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    [mod] = port_load(TRACE).modules.values()
    with pytest.raises(ValueError, match="'cuda' requested"):
        price_module_batch(mod, _engines(port_config(arch="v5p")),
                           backend="cuda")


def test_cuda_backend_raises_when_the_kernel_cannot_build(monkeypatch):
    """With a card reported but no nvcc, the build raises instead of the
    scans falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", REPO / "build" / "no-such-dir")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        sr._library()


# -- the scan_rows wrapper and its plain version ----------------------------


def _scan_inputs(lanes: int, ops: int, seed: int):
    vals = np.exp(np.random.default_rng(seed).uniform(
        np.log(1e-3), np.log(1e9), size=(ops + 1, lanes)))
    return vals[0].copy(), vals[1:].copy()


@pytest.mark.parametrize("lanes,ops", [(1, 1), (1, 4096), (64, 47),
                                       (64, 1000), (257, 0), (300, 300)])
def test_scan_rows_plain_version_is_the_reference_scan(lanes, ops):
    """Lane s of the plain version is NumPy's cumsum of [seed, *column s]
    by bytes — the JAX package's row scan (``_scan_rows_np``) — and the
    host row scan of the batch pricer gives the same bytes transposed."""
    seeds, mat = _scan_inputs(lanes, ops, lanes * 7 + ops)
    got = sr.scan_rows(torch.from_numpy(seeds), torch.from_numpy(mat))
    want = np.cumsum(np.concatenate([seeds[None], mat]), axis=0)
    assert got.shape == (ops + 1, lanes)
    assert got.numpy().tobytes() == want.tobytes()
    host = port_batch._scan_rows_host(list(seeds), torch.from_numpy(mat.T))
    assert host.t().contiguous().numpy().tobytes() == want.tobytes()


def test_scan_rows_checks_inputs():
    s, m = torch.zeros(4, dtype=torch.float64), torch.zeros(
        3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="ops-major"):
        sr.scan_rows(s, m.t())
    with pytest.raises(TypeError, match="float64"):
        sr.scan_rows(s.float(), m)
    with pytest.raises(ValueError, match="one lane"):
        sr.scan_rows(s[:0], m[:, :0])
    meta = torch.empty(3, 4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no scan_rows for device"):
        sr.scan_rows(s.to("meta"), meta)


def test_scan_rows_launch_counter_stays_zero_on_cpu():
    sr.reset_launch_count()
    seeds, mat = _scan_inputs(8, 16, 1)
    sr.scan_rows(torch.from_numpy(seeds), torch.from_numpy(mat))
    assert sr.launch_count() == 0


def test_scan_rows_source_and_build_command(tmp_path):
    src = build.CSRC_DIR / "scan_rows.cu"
    text = src.read_text()
    # the C interface the ctypes wrapper binds, and the note the source
    # owes its reader: what it replaces, what bounds it, what the design
    # does about it
    assert 'extern "C" int tpusim_scan_rows(' in text
    assert "tpusim/fastpath/jax_backend.py" in text
    assert "bound" in text
    assert 'extern "C" int tpusim_scan_segments(' in text
    # strict serial adds, one thread per lane of a segment, its rows
    # staged through shared memory by asynchronous copies
    assert "__dadd_rn" in text
    assert "fma" not in text
    assert "cp.async" in text
    cmd = build.nvcc_command("scan_rows", tmp_path / "lib.so", nvcc="nvcc")
    assert cmd[0] == "nvcc" and cmd[-1] == str(src)
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    so = build.library_path("scan_rows")
    assert so.parent.name.startswith("scan_rows-")


def test_chip_smoke_fastpath_phase_on_cpu(capsys, monkeypatch,
                                          cuda_route_on_cpu):
    """``chip_smoke.py``'s phase 6 (a) and (b) rehearsed on the CPU: the
    golden cells under both backends, and the 64-lane batched call through
    the ``cuda`` route, its launches read from the counters (here the plain
    version's calls, counted by the rehearsal)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seconds = smoke.fastpath_cells("cpu")
    assert len(seconds) == 3 * len(smoke.GOLDEN_CELLS)
    out = capsys.readouterr().out
    assert out.count("serial and vectorized pass, stats equal") == 5

    rows, segments = sr.scan_rows, sr.scan_segments

    def counted(real):
        def call(*args):
            sr._launches += 1
            return real(*args)
        return call

    monkeypatch.setattr(sr, "scan_rows", counted(rows))
    monkeypatch.setattr(sr, "scan_segments", counted(segments))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    module, engines = smoke.batch_module_and_engines()
    launches = smoke.batch_on_card(module, engines)
    assert launches["flash_attention"] == 0
    assert launches["scan_rows"] == len(cuda_route_on_cpu) > 0
    out = capsys.readouterr().out
    assert "every lane equals the host row scans and its serial walk" in out

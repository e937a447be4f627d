"""The port's native bridges against its Python paths and the JAX
package, on the CPU.

The port builds ``libtpusim_native.so`` from ``native/*.cpp`` with g++ at
first use, into ``build/tpusim_torch_native/<hash>/``
(:mod:`tpusim_torch.kernels.native_build`), and binds it through three
bridges: the HLO scanner (:mod:`tpusim_torch.trace.native`, mirroring
``tests/test_native.py``'s eleven tests, with the live JAX capture
replaced by the port's own CPU capture and the timing assertion kept as
it is), the pricing scan (:mod:`tpusim_torch.fastpath.native`) and the
packet network (:mod:`tpusim_torch.ici.detailed`).  Beyond the mirror:
a header wrapped over lines loads eagerly as in the reference; the five
golden cells price to the same stats bytes through ``native``,
``vectorized`` and the reference's ``native``; the detailed network's
cell equals its Python backend's; concurrent builds publish one whole
library; ``TPUSIM_NO_NATIVE`` turns every bridge off (and an explicit
request then raises); a failed build warns once and leaves the Python
paths running; a strided column never reaches the C scan.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.kernels import native_build  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.trace import native as tn  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402
from tpusim_torch.trace.native import (  # noqa: E402
    native_available,
    parse_hlo_module_fast,
    parse_hlo_module_native,
)

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).parent.parent
VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}


def _assert_same_module(a, b):
    assert a.name == b.name
    assert a.meta.get("num_partitions") == b.meta.get("num_partitions")
    assert set(a.computations) == set(b.computations)
    assert a.entry_name == b.entry_name
    for cname, comp_a in a.computations.items():
        comp_b = b.computations[cname]
        assert len(comp_a.ops) == len(comp_b.ops), cname
        for oa, ob in zip(comp_a.ops, comp_b.ops):
            assert oa.name == ob.name
            assert oa.opcode == ob.opcode
            assert oa.operands == ob.operands
            assert oa.is_root == ob.is_root
            assert str(oa.result) == str(ob.result)
            assert oa.result.nbytes == ob.result.nbytes
            assert oa.called == ob.called
            assert oa.fusion_kind == ob.fusion_kind
            if oa.collective or ob.collective:
                assert oa.collective == ob.collective
            assert oa.attrs.get("literal") == ob.attrs.get("literal")


def test_native_builds_and_loads():
    """Built from ``native/`` into ``build/``, never the reference's
    ``native/libtpusim_native.so``."""
    assert native_available()
    so = native_build.library_path()
    assert so.is_file()
    assert so.parent.parent == REPO / "build" / "tpusim_torch_native"
    loaded = Path(native_build.load_shared_lib()._name)
    assert loaded == so
    assert loaded != REPO / "native" / "libtpusim_native.so"


def test_parity_on_fixture():
    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    _assert_same_module(
        parse_hlo_module(text, "tiny"), parse_hlo_module_native(text, "tiny")
    )


def test_parity_on_live_capture():
    """The port's own CPU capture of ``relu(a @ b) ** 2`` mean, bf16."""
    from tpusim_torch.tracer.capture import capture

    class F(torch.nn.Module):
        def forward(self, a, b):
            return (torch.relu(a @ b) ** 2).mean()

    cap = capture(F(), torch.ones((128, 256), dtype=torch.bfloat16),
                  torch.ones((256, 64), dtype=torch.bfloat16), name="parity")
    _assert_same_module(
        parse_hlo_module(cap.hlo_text, "parity"),
        parse_hlo_module_native(cap.hlo_text, "parity"),
    )


def test_parity_engine_results():
    """Both parsers must produce identical simulated cycle counts."""
    from tpusim_torch.timing.config import SimConfig
    from tpusim_torch.timing.engine import Engine

    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    cfg = SimConfig()
    r_py = Engine(cfg).run(parse_hlo_module(text))
    r_nat = Engine(cfg).run(parse_hlo_module_native(text))
    assert r_py.cycles == pytest.approx(r_nat.cycles)
    assert r_py.flops == r_nat.flops


def test_fast_path_prefers_native():
    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    before = tn.NATIVE_PARSES
    mod = parse_hlo_module_fast(text)
    assert mod.entry_name is not None
    assert tn.NATIVE_PARSES == before + 1
    # salvage mode always takes the Python parser
    parse_hlo_module_fast(text, strict=False)
    assert tn.NATIVE_PARSES == before + 1


def test_native_speedup_on_large_module():
    """The native scanner should beat pure Python on a big module."""
    import time

    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    # synthesize a large module: many cloned computations
    body = text.split("ENTRY")[0]
    clones = []
    for i in range(300):
        clones.append(
            body.replace("region_add", f"region_add_{i}")
                .replace("fused_relu", f"fused_relu_{i}")
                .replace("HloModule jit_tiny_mlp, is_scheduled=true, num_partitions=4, replica_count=1", "")
        )
    big = text.split("ENTRY")[0] + "\n".join(clones) + "ENTRY" + text.split("ENTRY")[1]

    m_py = parse_hlo_module(big)  # warm both paths before timing
    m_nat = parse_hlo_module_native(big)
    assert len(m_py.computations) == len(m_nat.computations)

    def best_of(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(big)
            times.append(time.perf_counter() - t0)
        return min(times)

    t_py = best_of(parse_hlo_module)
    t_nat = best_of(parse_hlo_module_native)
    # native is usually ~5-10x faster; allow slack for noisy CI machines
    assert t_nat < t_py * 1.2, (t_nat, t_py)


def _assert_leaves_exact(a, b):
    """Full TensorSpec field equality (layout/tiling/memory_space
    included — the columns the v2 scan pre-parses in C++)."""
    from tpusim_torch.ir import leaves_of

    for cname, comp_a in a.computations.items():
        for oa, ob in zip(comp_a.ops, b.computations[cname].ops):
            la, lb = leaves_of(oa.result), leaves_of(ob.result)
            assert len(la) == len(lb), oa.name
            for x, y in zip(la, lb):
                assert (
                    x.dtype, x.shape, x.layout, x.tiling, x.memory_space
                ) == (
                    y.dtype, y.shape, y.layout, y.tiling, y.memory_space
                ), oa.name
            assert oa.attrs == ob.attrs, oa.name
            assert oa.metadata == ob.metadata, oa.name


def test_v2_scan_available():
    tn._load()
    assert tn._HAS_V2  # the library exports hlo_scan2


def _corpus() -> list[str]:
    corpus = [(FIXTURES / "tiny_mlp.hlo").read_text()]
    silicon = REPO / "reports" / "silicon"
    manifest = json.loads((silicon / "manifest.json").read_text())
    for e in manifest["workloads"]:
        for p in (silicon / e["trace"] / "modules").glob("*.hlo"):
            corpus.append(p.read_text())
    for tdir in sorted((FIXTURES / "traces").iterdir()):
        for p in (tdir / "modules").glob("*.hlo"):
            corpus.append(p.read_text())
    return corpus


def test_v2_parity_full_fields_on_corpus():
    """v2 (pre-parsed shapes + pre-split attrs) must equal the Python
    parser on every committed trace module, field for field."""
    for text in _corpus():
        m_py = parse_hlo_module(text, "x")
        m_v2 = parse_hlo_module_native(text, "x")
        _assert_same_module(m_py, m_v2)
        _assert_leaves_exact(m_py, m_v2)


def test_v2_shape_edge_cases_match_reference():
    """Fast-path and fallback ('!'-prefixed raw) shapes both land on
    the Python parser's exact TensorSpec — including the shapes the
    C++ mirror deliberately refuses (comments, odd layouts)."""
    tmpl = (
        "HloModule m\n\nENTRY %e (p: f32[2]) -> f32[2] {\n"
        "  %p = SHAPE parameter(0)\n"
        "  ROOT %r = f32[2]{0} add(%p, %p)\n}\n"
    )
    shapes = [
        "f32[2]", "f32[]", "pred[]", "u32[08]", "s32[<=128]",
        "bf16[256,512]{1,0:T(8,128)(2,1)}",
        "f32[8,128]{1,0:T(8,128)S(1)}",
        "f32[2,3]{1,0:T(2,1)(8,128)S(3)}",
        "(f32[2]{0}, u32[])",
        "((f32[2], s8[3,4]{1,0}), token[])",
        "(f32[2]{0:T(2)S(1)}, (u32[], pred[1]))",
        "f32[2]/*cmt*/", "c128[4]{0:T(4)}", "f8e4m3[16]{0}",
    ]
    for s in shapes:
        text = tmpl.replace("SHAPE", s)
        m_py = parse_hlo_module(text, "x")
        m_v2 = parse_hlo_module_native(text, "x")
        _assert_same_module(m_py, m_v2)
        _assert_leaves_exact(m_py, m_v2)


def test_v1_fallback_when_v2_absent(monkeypatch):
    """A library without hlo_scan2 still parses through the v1 record
    stream, byte-identically."""
    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    want = parse_hlo_module_native(text, "x")
    monkeypatch.setattr(tn, "_HAS_V2", False)
    got = parse_hlo_module_native(text, "x")
    _assert_same_module(want, got)
    _assert_leaves_exact(want, got)


def test_native_robust_to_line_ending_variants():
    """CRLF, trailing whitespace, and %-less headers must parse the same
    as the Python parser."""
    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    variants = {
        "crlf": text.replace("\n", "\r\n"),
        "trailing_space": text.replace("{\n", "{ \n"),
        "no_percent_headers": text.replace("\n%region_add", "\nregion_add"),
    }
    for label, variant in variants.items():
        m_py = parse_hlo_module(variant, "v")
        m_nat = parse_hlo_module_native(variant, "v")
        assert set(m_py.computations) == set(m_nat.computations), label
        assert len(m_py.computations) == 3, label
        _assert_same_module(m_py, m_nat)


# ---------------------------------------------------------------------------
# Beyond the mirror
# ---------------------------------------------------------------------------


_WRAPPED = """HloModule wrapped, is_scheduled=true

%body.1 (p0: (f32[8,128],
    s32[])) -> (f32[8,128], s32[]) {
  %p0 = (f32[8,128]{1,0}, s32[]) parameter(0)
  ROOT %t = (f32[8,128]{1,0}, s32[]) copy(%p0)
}

ENTRY %main (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  ROOT %out = f32[8,128]{1,0} add(%a, %a)
}
"""


def test_wrapped_header_loads_eagerly_as_the_reference(tmp_path):
    """A module whose computation header wraps over two lines loads
    eagerly through the native scanner in both packages, to the same
    computations and ops."""
    (tmp_path / "modules").mkdir()
    (tmp_path / "modules" / "w.hlo").write_text(_WRAPPED)
    (tmp_path / "commandlist.jsonl").write_text("")
    port = port_load(tmp_path).modules["w"]
    ref = ref_load(tmp_path).modules["w"]
    _assert_same_module(port, ref)
    assert port.computation(port.entry_name).ops[-1].name == "out"


def _cells():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py")
    cg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cg)
    return cg.MATRIX


def write_long_runs_trace(tdir: Path) -> Path:
    """``chip_smoke.py``'s module of long runs (phase 18 (d)): runs of
    400 synchronous ops, past the native scan's 192-op threshold, which
    no committed trace reaches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.write_long_runs_trace(tdir)


def _doc(simulate, trace, arch, overlays, backend):
    stats = json.loads(simulate(
        trace, arch=arch, overlays=overlays, tuned=False,
        pricing_backend=backend).stats.to_json())
    # the fastpath_* keys name the backend and count process-wide
    # compiles, which differ by history
    return {k: v for k, v in stats.items()
            if k not in VOLATILE and not k.startswith("fastpath_")}


@pytest.mark.parametrize("cell", list(range(5)) + ["long"])
def test_native_pricing_equals_python_and_reference(cell, tmp_path):
    """A golden cell, and a trace of long runs, priced through
    ``native`` equals ``vectorized`` and the reference's ``native`` by
    stats bytes; the long runs go through the C scan (no golden cell has
    a run past its threshold)."""
    from tpusim_torch.fastpath import native as fn

    if cell == "long":
        trace, arch, overlays = write_long_runs_trace(tmp_path), "v5e", []
    else:
        fixture, arch, overlays = _cells()[cell]
        trace = FIXTURES / "traces" / fixture
    before = fn.SCAN_CALLS
    got = _doc(port_simulate, trace, arch, overlays, "native")
    if cell == "long":
        assert fn.SCAN_CALLS > before
    python = _doc(port_simulate, trace, arch, overlays, "vectorized")
    ref = _doc(ref_simulate, trace, arch, overlays, "native")
    assert json.dumps(got) == json.dumps(python) == json.dumps(ref)


def test_native_ici_equals_python_backend(monkeypatch):
    """Golden cell 4 (the detailed network) through ``ici_net`` equals
    its Python backend's stats by bytes."""
    from tpusim_torch.ici import detailed

    fixture, arch, overlays = _cells()[3]
    trace = FIXTURES / "traces" / fixture
    before = detailed.NET_RUNS
    got = _doc(port_simulate, trace, arch, overlays, "serial")
    after = detailed.NET_RUNS
    assert after > before
    monkeypatch.setattr(detailed, "native_net_available", lambda: False)
    python = _doc(port_simulate, trace, arch, overlays, "serial")
    assert detailed.NET_RUNS == after
    assert json.dumps(got) == json.dumps(python)


def test_batch_native_equals_vectorized(tmp_path):
    """The lane-major native batch scan equals the host row scans on
    degraded lanes of the long runs, lane by lane."""
    from tpusim_torch.fastpath import native as fn
    from tpusim_torch.fastpath.batch import price_module_batch
    from tpusim_torch.perf.cache import result_to_doc
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine

    [mod] = port_load(write_long_runs_trace(tmp_path)).modules.values()
    cfg = load_config(arch="v5e", tuned=False)
    engines = [Engine(cfg, clock_scale=c, hbm_scale=h)
               for c, h in ((1.0, 1.0), (0.7, 1.0), (1.0, 0.5), (0.9, 0.8))]
    before = fn.SCAN_CALLS
    got = price_module_batch(mod, engines, backend="native")
    assert fn.SCAN_CALLS > before
    want = price_module_batch(mod, engines, backend="vectorized")
    serial = [e._run_serial(mod) for e in engines]
    for g, w, s in zip(got, want, serial):
        assert json.dumps(result_to_doc(g)) == json.dumps(result_to_doc(w)) \
            == json.dumps(result_to_doc(s))


def test_strided_column_is_refused():
    from tpusim_torch.fastpath.native import price_scan

    mat = torch.zeros((8, 2), dtype=torch.float64)
    col = torch.zeros(8, dtype=torch.float64)
    acc = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        price_scan(mat[:, 0], col, col, col, col, col, None, acc)
    with pytest.raises(ValueError, match="float64"):
        price_scan(col.float(), col, col, col, col, col, None, acc)
    price_scan(col, col, col, col, col, col, None, acc)
    assert acc.tolist() == [0.0] * 7


_BUILD_ONE = """
import sys
from pathlib import Path
from tpusim_torch.kernels import native_build as nb
nb.BUILD_DIR = Path(sys.argv[1])
so = nb.build_native()
lib = nb.load_shared_lib()
print(so, lib.hlo_scan_abi_version(), lib.op_price_abi_version(),
      lib.ici_net_abi_version())
"""


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Four processes building into one empty dir at once each load a
    whole library; one file is left, no temporary."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("TPUSIM_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    so, *abis = lines.pop().split()
    assert abis == ["1", "1", "2"]
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert files == ["libtpusim_native.so"]
    assert Path(so).parent.parent == tmp_path


_NO_NATIVE = """
import json, sys
from tpusim_torch.__main__ import main
from tpusim_torch.fastpath.price import resolve_backend
from tpusim_torch.fastpath.native import native_price_available
from tpusim_torch.ici import detailed, topology
from tpusim_torch.trace import native as tn
out = {"parse": tn.native_available(), "price": native_price_available(),
       "net": detailed.native_net_available(), "auto": resolve_backend(None)}
try:
    detailed.TorusNetwork(topology.Topology(dims=(4,), wrap=(True,)), 16.0, 3,
                          use_native=True)
    out["net_raise"] = None
except RuntimeError as e:
    out["net_raise"] = str(e)
out["cli_native"] = main(["simulate", sys.argv[1], "--pricing-backend",
                          "native"])
print(json.dumps(out))
"""


def test_no_native_env_turns_every_bridge_off():
    env = {**os.environ, "PYTHONPATH": str(REPO), "TPUSIM_NO_NATIVE": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_NATIVE,
         str(FIXTURES / "traces" / "matmul_512")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc == {"parse": False, "price": False, "net": False,
                   "auto": "vectorized",
                   "net_raise": "native ici_net requested but not built",
                   "cli_native": 2}
    assert "pricing backend 'native' requested" in proc.stderr
    # no build and no warning: the switch is not a failure
    assert "unavailable" not in proc.stderr


def test_failed_build_warns_once_and_python_paths_run(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed to build libtpusim_native.so")

    monkeypatch.setattr(native_build, "_TRIED", False)
    monkeypatch.setattr(native_build, "_LIB", None)
    monkeypatch.setattr(native_build, "build_native", broken)
    with pytest.warns(RuntimeWarning, match="Python paths run"):
        assert native_build.load_shared_lib() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the warning is not repeated
        assert native_build.load_shared_lib() is None
    monkeypatch.setattr(tn, "_LIB_TRIED", False)
    monkeypatch.setattr(tn, "_LIB", None)
    assert not native_available()
    text = (FIXTURES / "tiny_mlp.hlo").read_text()
    _assert_same_module(parse_hlo_module_fast(text, "x"),
                        parse_hlo_module(text, "x"))


"""The nine ``ubench`` workloads the port added last (``matmul``,
``small_matmul_chain``, ``op_overhead_chain``, ``dynamic_loop``,
``softmax_narrow``, ``relayout_copy``, ``matmul_int8``,
``reduce_lane_wide`` and ``reduce_major_acc``), against the JAX package,
all on the CPU at small shapes (``SMALL``):

(i)   registration: parameters, suite, devices and description equal the
      reference's, and the registry holds all 36 of its workloads;
(ii)  numerics: the port module and the JAX function agree on the same
      numpy inputs — float32 within rtol = atol = 1e-4, bfloat16 within
      2e-2, ``matmul_int8`` exactly; ``dynamic_loop`` within 1e-4, with
      both packages' trip counts printed;
(iii) ``commandlist.jsonl`` of a 2-launch capture equals the JAX
      capture's by bytes, and the port's trace prices the same in both
      packages;
(iv)  simulated at v5e against the JAX CPU capture: ``tot_mxu_flops``
      equal for the three matmuls (float32 and bfloat16),
      ``tot_hbm_bytes`` within ``BYTE_BAND`` at float32;
(v)   ``dynamic_loop`` is one ``while`` without ``known_trip_count``:
      ``tot_unknown_trip_loops`` is 1 in both packages' simulate of a
      1-launch capture;
(vi)  ``matmul`` at 512³ with two launches is the ``matmul_512`` fixture:
      command list by bytes, MXU flops at v5e and v5p.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ubench.py`` prints
the HBM ratios (float32 and the registered bfloat16, with the ops behind
the bfloat16 gap) and whether each package's pricing reaches the
relayout branch for ``relayout_copy`` and the lane-cross reduce term for
``reduce_lane_wide``: the record PERF.md keeps.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.models import list_workloads as ref_list_workloads  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.tracer.capture import capture_to_dir as ref_capture_to_dir  # noqa: E402
from tpusim_torch.models import get_workload, list_workloads  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.tracer.capture import capture_to_dir  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures" / "traces"

#: small shapes of each workload (its dtype parameter, where it has one,
#: is set per test)
SMALL = {
    "matmul": dict(m=64, n=48, k=32),
    "small_matmul_chain": dict(size=32, depth=3),
    "op_overhead_chain": dict(depth=16),
    "dynamic_loop": dict(elems=4096),
    "softmax_narrow": dict(batch=2, seq=64, heads=8),
    "relayout_copy": dict(rows=64, cols=32),
    "matmul_int8": dict(m=32, n=16, k=64),
    "reduce_lane_wide": dict(rows=64, cols=256),
    "reduce_major_acc": dict(rows=64, cols=256),
}
NAMES = list(SMALL)
#: the workloads whose MXU flops are held equal
MATMULS = ("matmul", "small_matmul_chain", "matmul_int8")

#: the [lo, hi] band of the port's simulated tot_hbm_bytes over the JAX
#: CPU capture's, for the workloads held at float32 (the registered bf16
#: ones through their dtype)
BYTE_BAND = {"matmul": (0.8, 1.25), "small_matmul_chain": (0.8, 1.25),
             "op_overhead_chain": (0.8, 1.25)}
# dynamic_loop: the loop body of XLA:CPU moves 2.6x the port's bytes a
# trip.  It keeps the divide apart and recomputes 0.5 * (x + a / x) in
# both of its consumers (two fusions that read x, a and the quotient),
# splits the max-reduce into reduce-window + reduce, and copies the
# carried x (copy insertion); the port fuses the update into one kLoop
# fusion and the error into one kInput reduce.  PERF.md records the
# per-op breakdown; the band's lower edge sits under the measured ratio
# (0.43 at 4096 elements), the upper edge is the others'.
BYTE_BAND["dynamic_loop"] = (0.4, 1.25)


@pytest.fixture(autouse=True)
def _jax_default_precision():
    """The JAX workloads are written for JAX's default 32-bit mode."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _has_dtype(name: str) -> bool:
    return "dtype" in ref_get_workload(name).params


def _kw(name: str, dtype: str | None = None) -> dict:
    kw = dict(SMALL[name])
    if dtype is not None and _has_dtype(name):
        kw["dtype"] = dtype
    return kw


def _stats(report) -> dict:
    stats = json.loads(report.stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        stats.pop(k)
    return stats


def _capture_pair(root: Path, name: str, dtype: str | None,
                  launches: int = 2) -> tuple[Path, Path]:
    """(port, ref) trace directories of one workload at its small shape."""
    kw = _kw(name, dtype)
    tag = f"{name}_{dtype}_{launches}"
    port, ref = root / f"port_{tag}", root / f"ref_{tag}"
    module, args = get_workload(name).build(device="cpu", **kw)
    capture_to_dir(port, module, *args, name=name, launches=launches)
    fn, ref_args = ref_get_workload(name).build(**kw)
    ref_capture_to_dir(ref, fn, *ref_args, name=name, launches=launches)
    return port, ref


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """(port, ref) trace dirs per (workload, dtype, launches), captured
    once."""
    root = tmp_path_factory.mktemp("ubench")
    cache: dict[tuple, tuple[Path, Path]] = {}

    def get(name: str, dtype: str | None = None,
            launches: int = 2) -> tuple[Path, Path]:
        key = (name, dtype, launches)
        if key not in cache:
            cache[key] = _capture_pair(root, name, dtype, launches)
        return cache[key]

    return get


def _ratios(port: Path, ref: Path) -> dict:
    got = _stats(port_simulate(port, arch="v5e", tuned=False))
    want = _stats(ref_simulate(ref, arch="v5e", tuned=False))
    return {"hbm": got["tot_hbm_bytes"] / want["tot_hbm_bytes"],
            "mxu": (got["tot_mxu_flops"], want["tot_mxu_flops"])}


# ---------------------------------------------------------------------------
# (i) registration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_the_reference(name):
    port, ref = get_workload(name), ref_get_workload(name)
    assert port.params == ref.params
    assert port.suite == ref.suite == "ubench"
    assert port.num_devices == ref.num_devices
    assert port.description == ref.description


def test_registry_holds_every_reference_workload():
    """All 36 of the reference's workloads, with its suites, parameters,
    devices and descriptions; ``flash_attention_pallas`` alone describes
    the port's own kernel (a CUDA kernel, not a Pallas one).  Beside them
    the port registers its own DeepSeek-V2 decoder
    (``tpusim_torch.models.deepseek_v2``), which the reference has not."""
    def table(workloads):
        return {w.name: (w.suite, w.params, w.num_devices, w.description)
                for w in workloads
                if w.builder.__module__ != "tpusim_torch.models.deepseek_v2"}

    port, ref = table(list_workloads()), table(ref_list_workloads())
    assert len(list_workloads()) == 36 + 2
    assert len(port) == 36 and port.keys() == ref.keys()
    own = "flash_attention_pallas"
    assert "CUDA kernel" in port[own][3] and "Pallas" in ref[own][3]
    assert port[own][:3] == ref[own][:3]
    assert {k: v for k, v in port.items() if k != own} == {
        k: v for k, v in ref.items() if k != own}
    # the microbenchmarks keep the reference's registration order
    def order(workloads, module):
        return [w.name for w in workloads if w.builder.__module__ == module]

    assert order(list_workloads(), "tpusim_torch.models.microbench") == \
        order(ref_list_workloads(), "tpusim.models.microbench")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        get_workload("matmul").build(m=8, n=8, k=8)


# ---------------------------------------------------------------------------
# (ii) numerics against the JAX function
# ---------------------------------------------------------------------------

_CASES = ([(n, "float32") for n in NAMES if _has_dtype(n)]
          + [(n, None) for n in NAMES])


def _run_both(name: str, dtype: str | None):
    fn, ref_args = ref_get_workload(name).build(**_kw(name, dtype))
    want = [np.asarray(jax.jit(fn)(*ref_args))]
    module, _ = get_workload(name).build(device="cpu", **_kw(name, dtype))
    args = module.from_numpy(*[np.asarray(a) for a in ref_args],
                             device="cpu")
    with torch.no_grad():
        got = [module(*args)]
    return got, want, ref_args


@pytest.mark.parametrize("name,dtype", _CASES)
def test_port_module_matches_jax(name, dtype):
    got, want, _ = _run_both(name, dtype)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if name == "matmul_int8":
            assert g.dtype == torch.int32 and w.dtype == np.int32
            np.testing.assert_array_equal(g.numpy(), w)
            continue
        bf16 = g.dtype == torch.bfloat16
        assert bf16 == (w.dtype.name == "bfloat16")
        tol = 2e-2 if bf16 else 1e-4
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=tol, atol=tol)


def _trip_counts(a: np.ndarray, tol: float) -> tuple[int, int]:
    """Trips of the Babylonian loop in each package on ``a``."""
    from jax import lax

    def cond(c):
        return c[1] > tol

    def body(c):
        x, _, n = c
        x = 0.5 * (x + a_j / x)
        return x, jnp.max(jnp.abs(x * x - a_j)), n + 1

    a_j = jnp.asarray(a)
    ref = int(jax.jit(lambda: lax.while_loop(
        cond, body, (jnp.ones_like(a_j), jnp.float32(jnp.inf), 0)))()[2])
    a_t = torch.from_numpy(np.array(a))
    x, err, port = torch.ones_like(a_t), torch.tensor(float("inf")), 0
    while err > tol:
        x = 0.5 * (x + a_t / x)
        err, port = (x * x - a_t).abs().amax(), port + 1
    return port, ref


def test_dynamic_loop_trip_counts_and_result(capsys):
    got, want, (a,) = _run_both("dynamic_loop", None)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy() ** 2, np.asarray(a),
                               rtol=0, atol=2e-4)
    port, ref = _trip_counts(np.asarray(a),
                             ref_get_workload("dynamic_loop").params["tol"])
    with capsys.disabled():
        print(f"\ndynamic_loop trips: port {port}, JAX {ref}")
    assert port > 1 and ref > 1


# ---------------------------------------------------------------------------
# (iii) commands and pricing in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_commandlist_equals_the_reference(name, traces):
    port, ref = traces(name)
    assert ((port / "commandlist.jsonl").read_bytes()
            == (ref / "commandlist.jsonl").read_bytes())


@pytest.mark.parametrize("name", NAMES)
def test_port_trace_prices_the_same_in_both_packages(name, traces):
    port, _ = traces(name)
    want = _stats(ref_simulate(port, arch="v5e", tuned=False))
    got = _stats(port_simulate(port, arch="v5e", tuned=False))
    assert got == want
    assert got["kernel_launches"] == 2


def test_fusion_shapes_follow_xla(traces):
    """``op_overhead_chain`` is one kLoop fusion and ``relayout_copy`` one
    kLoop fusion around a transpose, as XLA:CPU writes them;
    ``matmul_int8`` is an ``s8 × s8 → s32`` dot."""
    def entry(name):
        port, _ = traces(name)
        text = (port / "modules" / f"{name}.hlo").read_text()
        return text, text[text.index("ENTRY"):]

    text, main = entry("op_overhead_chain")
    assert main.count("fusion(") == 1 and "kind=kLoop" in main
    assert text.count(" multiply(") == text.count(" add(") == 8
    text, main = entry("relayout_copy")
    assert main.count("fusion(") == 1 and "kind=kLoop" in main
    assert " transpose(" in text and "dimensions={1,0}" in text
    text, main = entry("matmul_int8")
    assert ("s32[32,16]{1,0} dot(%a, %b), lhs_contracting_dims={1}, "
            "rhs_contracting_dims={0}") in main
    assert ("entry_computation_layout={(s8[32,64]{1,0}, s8[64,16]{1,0})"
            "->s32[32,16]{1,0}}") in text


# ---------------------------------------------------------------------------
# (iv) against the JAX capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,dtype", [(n, d) for n in MATMULS
                                        for d in ("float32", "bfloat16")
                                        if d == "float32" or _has_dtype(n)])
def test_mxu_flops_equal_the_jax_capture(name, dtype, traces):
    r = _ratios(*traces(name, dtype if _has_dtype(name) else None))
    port_mxu, ref_mxu = r["mxu"]
    assert port_mxu > 0
    assert port_mxu == pytest.approx(ref_mxu, rel=1e-9, abs=0), r


@pytest.mark.parametrize("name", list(BYTE_BAND))
def test_hbm_bytes_against_the_jax_capture_float32(name, traces):
    r = _ratios(*traces(name, "float32" if _has_dtype(name) else None))
    lo, hi = BYTE_BAND[name]
    assert lo <= r["hbm"] <= hi, r


#: the bf16-registered workloads whose HBM ratio is recorded, not held
BF16_RECORDED = ("softmax_narrow", "reduce_lane_wide", "reduce_major_acc")


@pytest.mark.parametrize("name", BF16_RECORDED)
def test_bf16_hbm_gap_is_xla_cpu_widening(name, traces):
    """At the registered bf16 the JAX CPU capture widens each bf16 reduce
    input to f32 in a fusion of its own (``wrapped_convert``) and splits
    the reduce into ``reduce-window`` + ``reduce``; the port reads the
    bf16 input inside the reduce's fusion.  The ratio is recorded
    (``python tests/test_torch_ubench.py``), the reason held here."""
    port, ref = traces(name)
    ref_hlo = (ref / "modules" / f"{name}.hlo").read_text()
    port_hlo = (port / "modules" / f"{name}.hlo").read_text()
    assert "wrapped_convert" in ref_hlo and "reduce-window(" in ref_hlo
    assert "reduce-window(" not in port_hlo
    assert _ratios(port, ref)["hbm"] > 0


# ---------------------------------------------------------------------------
# (v) the unknown trip count
# ---------------------------------------------------------------------------


def test_dynamic_loop_is_an_unknown_trip_while(traces):
    port, ref = traces("dynamic_loop", launches=1)
    text = (port / "modules" / "dynamic_loop.hlo").read_text()
    assert text.count(" while(") == 1 and "known_trip_count" not in text
    # the carry is (x, err, a): the captured input rides along
    assert "while(%tuple" in text and "f32[], f32[4096]{0}) while(" in text
    for trace in (port, ref):
        for simulate in (port_simulate, ref_simulate):
            stats = _stats(simulate(trace, arch="v5e", tuned=False))
            assert stats["tot_unknown_trip_loops"] == 1, (trace, simulate)


# ---------------------------------------------------------------------------
# (vi) the matmul_512 fixture
# ---------------------------------------------------------------------------


def test_matmul_512_is_the_fixture(tmp_path):
    module, args = get_workload("matmul").build(device="cpu", m=512, n=512,
                                                k=512)
    out = tmp_path / "matmul_512"
    capture_to_dir(out, module, *args, name="matmul_512", launches=2)
    fixture = FIXTURES / "matmul_512"
    assert ((out / "commandlist.jsonl").read_bytes()
            == (fixture / "commandlist.jsonl").read_bytes())
    for arch in ("v5e", "v5p"):
        got = _stats(port_simulate(out, arch=arch, tuned=False))
        want = _stats(ref_simulate(fixture, arch=arch, tuned=False))
        assert got["tot_mxu_flops"] == want["tot_mxu_flops"] > 0, arch


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14 (c), rehearsed on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_for_ubench", Path(__file__).parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_numerics_check_on_cpu(name):
    """Phase 14 (c)'s check, with the card's side also on the CPU: it
    passes at the tests' shapes (``small_matmul_chain`` at its registered
    ones, whose 64 squarings overflow to NaN), and refuses a result one
    tolerance off."""
    smoke = _chip_smoke()
    kw = ({} if name == "small_matmul_chain" else _kw(name))
    module, args = get_workload(name).build(device="cpu", **kw)
    out = smoke.ubench_numerics(name, module, args)
    assert out["worst_of_tol"] == 0.0
    if name == "small_matmul_chain":
        assert out["checked_depth"] == smoke.CHAIN_CHECK_DEPTH
        return

    class Off(torch.nn.Module):
        """The workload, off by three tolerances on its first call (the
        card's side)."""
        calls = 0

        def forward(self, *a):
            y = module(*a)
            Off.calls += 1
            if Off.calls > 1:
                return y
            if y.dtype == torch.int32:
                return y + 1
            return (y.double() + 3 * out["tol"] * (1 + y.double().abs())
                    + 3e-4).to(y.dtype)

    with pytest.raises(AssertionError, match="differ"):
        smoke.ubench_numerics(name, Off(), args)


# ---------------------------------------------------------------------------
# the record PERF.md keeps
# ---------------------------------------------------------------------------


def _branch_record(trace: Path) -> dict[str, dict[str, bool]]:
    """Whether each package's cost model reaches the relayout branch of
    copy pricing (``_is_relayout`` true) and the lane-cross reduce term
    (a lane-dim reduce: its cycles move with ``vpu_lane_cross_cycles``)
    on ``trace``."""
    import tpusim.timing.cost as ref_cost
    import tpusim_torch.timing.cost as port_cost

    out = {}
    for pkg, cost, simulate in (("jax", ref_cost, ref_simulate),
                                ("port", port_cost, port_simulate)):
        hits = []
        orig = cost._is_relayout

        def spy(*a, _orig=orig):
            r = _orig(*a)
            hits.append(bool(r))
            return r

        cost._is_relayout = spy
        try:
            base = _stats(simulate(trace, arch="v5e", tuned=False))
        finally:
            cost._is_relayout = orig
        bumped = _stats(simulate(trace, arch="v5e", tuned=False,
                                 overlays=[{"arch": {
                                     "vpu_lane_cross_cycles": 10.0}}]))
        out[pkg] = {"relayout": any(hits),
                    "lane_cross": bumped["tot_sim_cycles"]
                    != base["tot_sim_cycles"]}
    return out


if __name__ == "__main__":   # the tables of PERF.md
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        print("| workload | dtype | port / JAX tot_hbm_bytes |")
        print("|---|---|---|")
        for name in NAMES:
            dts = (["float32", "bfloat16"] if _has_dtype(name) else [None])
            for dt in dts:
                r = _ratios(*_capture_pair(root, name, dt))
                reg = {"matmul_int8": "int8", "op_overhead_chain": "float32",
                       "dynamic_loop": "float32"}.get(name, "bfloat16")
                print(f"| {name} | {dt or reg} | {r['hbm']:.4f} |")
        print()
        for name in ("relayout_copy", "reduce_lane_wide"):
            port, ref = _capture_pair(root, name, None)
            print(name, "port trace:", _branch_record(port),
                  "JAX trace:", _branch_record(ref))

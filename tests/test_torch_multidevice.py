"""Multi-device capture in the port against the JAX package, on the CPU.

The seven multi-device workloads of this slice (``ici_allreduce``,
``ulysses_attention_sp8``, ``moe_ep4``, ``llama_tiny``,
``llama_tiny_tp2dp2``, ``decode_step_tp8``, ``ring_attention_sp8``) at
small shapes (``SMALL``).  The JAX side runs in one subprocess per world
size (4 and 8) on a CPU mesh (``tpusim.envutil.cpu_mesh_env``), started
with the module's first test: it saves each workload's inputs and outputs
and writes its CPU capture, while the tests of the port's own traces
run.

(i)   registration: parameters, suite, devices and description equal the
      reference's, and so does the ``workloads`` line;
(ii)  numerics: the port's rank runner on the JAX inputs equals the JAX
      function — float32 within rtol = atol = 1e-4, bfloat16 within 2e-2;
      the gradients of ``llama_tiny_tp2dp2``'s step equal ``jax.grad`` of
      the reference step's loss, each within 2e-2 of its norm;
(iii) the yardstick, simulated at v5p against the JAX CPU capture of the
      same shapes: ``tot_mxu_flops`` equal (rel 1e-9) in float32 and
      bfloat16; the collective count, ``tot_ici_bytes`` and the command
      list equal at float32.  At bfloat16 XLA:CPU promotes every
      collective to float32 (a ``convert`` before it and a ``_promoted``
      region), so its ICI bytes are twice a TPU's: they are printed, not
      compared.  HBM bytes are printed;
(iv)  the fixture: the port's ``llama_tiny_tp2dp2`` at registered shapes
      with ``--launches 1`` has the fixture's ``commandlist.jsonl`` by
      bytes, 4 devices, the fixture's ``tot_mxu_flops`` and all-reduce
      count at v5p; the ICI bytes are printed beside the fixture's;
(v)   one rank a process (``tpusim_torch.spmd_procs.RankGroup``, four CPU
      processes over gloo): ``llama_tiny_tp2dp2`` and ``moe_ep4`` against
      the JAX function as (ii) holds the vmap runner, the step's
      ``loss_and_grads`` within 2e-2 of each leaf's norm, two launches'
      snapshots equal to the vmap runner's; ``loopify`` of
      ``ici_allreduce`` a 4-rank program on the group; the per-op profile
      of ``llama_tiny_tp2dp2`` on the group matched > 0.5 (the
      reference's own bound), and refused on the vmap runner.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_multidevice.py``
prints the yardstick table and the fixture comparison PERF.md records.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpusim.__main__ import main as ref_cli  # noqa: E402
from tpusim.envutil import REPO_ROOT, cpu_mesh_env  # noqa: E402
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.models.registry import tensor_from_numpy  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402

#: small shapes of each workload, and the world size its JAX run takes
SMALL = {
    "ici_allreduce": dict(elems=1024),
    "ulysses_attention_sp8": dict(batch=1, seq=8 * 16, heads=8,
                                  head_dim=16),
    "moe_ep4": dict(tokens=256, d_model=64, d_hidden=128),
    "llama_tiny": dict(seq=64),
    "llama_tiny_tp2dp2": dict(seq=64),
    "decode_step_tp8": dict(batch=2, seq_cache=64, heads=8, head_dim=16,
                            layers=2, pos=10),
    "ring_attention_sp8": dict(batch=1, seq=8 * 16, heads=2, head_dim=16),
}
NAMES = list(SMALL)
WORLD = {"ici_allreduce": 8, "ulysses_attention_sp8": 8, "moe_ep4": 4,
         "llama_tiny": 4, "llama_tiny_tp2dp2": 4, "decode_step_tp8": 8,
         "ring_attention_sp8": 8}
#: build-only overrides of the port (not registered parameters)
PORT_ONLY = {"ici_allreduce": {"world": 8}}
FIXTURE = REPO_ROOT / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"


def _has_dtype(name: str) -> bool:
    return "dtype" in ref_get_workload(name).params


#: (workload, dtype) runs: float32 and bfloat16 where a dtype is taken,
#: else the workload's own (bfloat16) as "native"
CASES = [(n, d) for n in NAMES for d in (("float32", "bfloat16")
                                         if _has_dtype(n) else ("native",))]


def _kw(name: str, dtype: str) -> dict:
    kw = dict(SMALL[name])
    if dtype != "native":
        kw["dtype"] = dtype
    return kw


#: run by each JAX subprocess: per (workload, dtype), the inputs and the
#: outputs as float32 .npy files with their dtypes, and the CPU capture
_JAX_SIDE = r"""
import json, sys
from pathlib import Path
import numpy as np
import jax
from tpusim.models import get_workload
from tpusim.tracer.capture import capture_to_dir

out = Path(sys.argv[1])
for name, dtype, kw in json.loads(sys.argv[2]):
    fn, args = get_workload(name).build(**kw)
    tag = f"{name}_{dtype}"
    res = jax.jit(fn)(*args)
    sides = [("in", args), ("out", res)]
    if name == "llama_tiny_tp2dp2":
        # the gradient of the reference step's own loss, its first output
        sides.append(("grad", jax.jit(jax.grad(
            lambda p, *rest: fn(p, *rest)[0]))(*args)))
    doc = {}
    for side, tree in sides:
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
        doc[side] = [str(a.dtype) for a in leaves]
        for i, a in enumerate(leaves):
            np.save(out / f"{tag}.{side}{i}.npy",
                    a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    (out / f"{tag}.json").write_text(json.dumps(doc))
    capture_to_dir(out / f"ref_{tag}", fn, *args, name=name, launches=1)
"""


class JaxSide:
    """One JAX subprocess per world size, started at once and run side by
    side with the port's own tests; :attr:`root` waits for them."""

    def __init__(self, out: Path):
        self.out = out
        self.procs = []
        for world in (4, 8):
            todo = [(n, d, _kw(n, d)) for n, d in CASES
                    if WORLD[n] == world]
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_SIDE, str(out),
                 json.dumps(todo)],
                env=cpu_mesh_env(world), cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    @property
    def root(self) -> Path:
        for p in self.procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
        return self.out

    def stop(self) -> None:
        """End a subprocess no test waited for (a ``-k`` selection)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Started with the module's first test (autouse), so the port-only
    tests below run while JAX works."""
    side = JaxSide(tmp_path_factory.mktemp("jax_side"))
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


def _load(root: Path, name: str, dtype: str, side: str) -> list[np.ndarray]:
    doc = json.loads((root / f"{name}_{dtype}.json").read_text())
    return [np.load(root / f"{name}_{dtype}.{side}{i}.npy")
            for i in range(len(doc[side]))], doc[side]


def _port_inputs(root: Path, name: str, dtype: str) -> tuple:
    arrays, dtypes = _load(root, name, dtype, "in")
    out = []
    for a, dt in zip(arrays, dtypes):
        t = tensor_from_numpy(a, torch.device("cpu"))
        out.append(t.to(torch.bfloat16) if dt == "bfloat16" else t)
    return tuple(out)


def _port_build(name: str, dtype: str):
    module, _ = get_workload(name).build(device="cpu", **_kw(name, dtype),
                                         **PORT_ONLY.get(name, {}))
    return module


def _stats(path: Path, simulate=port_simulate, arch: str = "v5p") -> dict:
    stats = json.loads(simulate(path, arch=arch, tuned=False).stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        stats.pop(k)
    return stats


def port_trace_maker(root: Path):
    """The port's CPU capture per (workload, dtype), through the CLI,
    each made once."""
    cache: dict[tuple[str, str], Path] = {}

    def get(name: str, dtype: str) -> Path:
        if (name, dtype) not in cache:
            out = root / f"{name}_{dtype}"
            sets = {**_kw(name, dtype), **PORT_ONLY.get(name, {})}
            assert port_cli(["capture", name, str(out), "--device", "cpu",
                             *(f"--set={k}={json.dumps(v)}"
                               for k, v in sets.items())]) == 0
            cache[(name, dtype)] = out
        return cache[(name, dtype)]

    return get


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    return port_trace_maker(tmp_path_factory.mktemp("port_side"))


# ---------------------------------------------------------------------------
# (i) registration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_the_reference(name):
    port, ref = get_workload(name), ref_get_workload(name)
    assert port.params == ref.params
    assert (port.suite, port.num_devices, port.description) == (
        ref.suite, ref.num_devices, ref.description)


def test_workloads_lines_of_the_seven_equal_the_reference(capsys):
    assert port_cli(["workloads"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert ref_cli(["workloads"]) == 0
    ref = capsys.readouterr().out.splitlines()

    def pick(lines):
        return [ln for ln in lines if ln.split()[1] in SMALL]

    assert pick(port) == pick(ref) and len(pick(port)) == len(NAMES)


def test_params_from_numpy_keeps_the_reference_leaf_order():
    import jax

    from tpusim.models.llama import PRESETS as REF_PRESETS
    from tpusim.models.llama import init_llama
    from tpusim_torch.models.llama import PRESETS, params_from_numpy

    tree = jax.tree_util.tree_map(
        np.asarray, init_llama(jax.random.PRNGKey(0), REF_PRESETS["tiny"]))
    flat = params_from_numpy(tree, device="cpu")
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(flat) == len(leaves) == 2 + 9 * PRESETS["tiny"].layers
    for t, a in zip(flat, leaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))


# ---------------------------------------------------------------------------
# the port's own traces (while the JAX side runs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,dtype", CASES)
def test_port_trace_prices_the_same_in_both_packages(name, dtype,
                                                     port_traces):
    path = port_traces(name, dtype)
    assert _stats(path) == _stats(path, ref_simulate)


@pytest.mark.parametrize("device", ["1", "3"])
def test_every_trace_device_holds_the_same_program(device, monkeypatch):
    """SPMD: the program of any device is the one of device 0, and the
    meta names the device traced."""
    from tpusim_torch.tracer.capture import capture

    module, args = get_workload("moe_ep4").build(
        device="cpu", **_kw("moe_ep4", "float32"))
    base = capture(module, *args, name="r")
    monkeypatch.setenv("TPUSIM_TRACE_DEVICE", device)
    other = capture(module, *args, name="r")
    assert other.hlo_text == base.hlo_text
    assert other.meta["trace_device"] == int(device)
    assert (other.in_bytes, other.out_bytes) == (base.in_bytes,
                                                 base.out_bytes)


def test_a_trace_device_outside_the_mesh_is_refused(monkeypatch):
    from tpusim_torch.tracer.capture import capture

    module, args = get_workload("moe_ep4").build(
        device="cpu", **_kw("moe_ep4", "float32"))
    monkeypatch.setenv("TPUSIM_TRACE_DEVICE", "4")
    with pytest.raises(ValueError, match="4-device mesh"):
        capture(module, *args, name="m")


def test_snapshots_and_timing_run_every_rank(tmp_path):
    """``snapshot_buffers`` and ``measure_wall_time`` run the whole mesh
    through the rank runner and keep its global outputs; a later launch
    starts from the step's updated parameters."""
    from tpusim_torch.tracer.capture import measure_wall_time, snapshot_buffers

    module, args = get_workload("llama_tiny_tp2dp2").build(
        device="cpu", **_kw("llama_tiny_tp2dp2", "native"))
    paths = snapshot_buffers(module, *args, out_dir=tmp_path, launches=2)
    with torch.no_grad():
        first = module.run(*args)
        second = module.run(*first[1:], *args[-2:])
    n = len(first)
    assert len(paths) == 2 * n
    for i, want in enumerate((first, second)):
        for j, w in enumerate(want):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"launch{i}_buf{j}.npy"),
                w.float().numpy())
    module, args = get_workload("ici_allreduce").build(
        device="cpu", **_kw("ici_allreduce", "float32"), world=8)
    calls = []
    run = module.run
    module.run = lambda *a: calls.append(a) or run(*a)
    times = measure_wall_time(module, *args, iters=1, warmup=1)
    assert times["median_s"] > 0 and len(calls) == 4


def test_ici_allreduce_on_one_device(tmp_path):
    """At world 1 (the default on a host with one card) ``ici_allreduce``
    is still an SPMD workload: ``--snapshot`` and the timing go through
    the rank runner, where its psum over one rank returns ``x``."""
    from tpusim_torch.tracer.capture import measure_wall_time

    out = tmp_path / "ar1"
    assert port_cli(["capture", "ici_allreduce", str(out), "--device", "cpu",
                     "--snapshot", "--set", "elems=256",
                     "--set", "world=1"]) == 0
    module, args = get_workload("ici_allreduce").build(
        device="cpu", elems=256, world=1)
    assert module.world == 1
    snap = np.load(out / "checkpoint_files" / "launch0_buf0.npy")
    np.testing.assert_array_equal(snap, args[0].float().numpy())
    meta = json.loads((out / "meta.json").read_text())
    assert meta["num_devices"] == 1
    assert _stats(out) == _stats(out, ref_simulate)
    assert measure_wall_time(module, *args, iters=1, warmup=1)["median_s"] > 0


# ---------------------------------------------------------------------------
# (iv) the golden fixture
# ---------------------------------------------------------------------------


def capture_at_registered_shapes(out: Path) -> Path:
    assert port_cli(["capture", "llama_tiny_tp2dp2", str(out), "--launches",
                     "1", "--device", "cpu"]) == 0
    return out


@pytest.fixture(scope="module")
def fixture_capture(tmp_path_factory) -> Path:
    return capture_at_registered_shapes(
        tmp_path_factory.mktemp("fixture") / "llama_tiny_tp2dp2")


def fixture_comparison(port: Path) -> dict:
    """The port's capture at registered shapes beside the fixture, v5p."""
    got, want = _stats(port), _stats(FIXTURE, ref_simulate)
    text = (port / "modules" / "llama_tiny_tp2dp2.hlo").read_text()
    ftext = (FIXTURE / "modules" / "llama_tiny_tp2dp2.hlo").read_text()
    return {
        "all_reduce": (text.count(" all-reduce("), ftext.count(" all-reduce(")),
        **{k: (got[k], want[k]) for k in (
            "tot_mxu_flops", "tot_collective_count", "tot_ici_bytes",
            "tot_hbm_bytes", "tot_sim_cycles", "num_devices")},
    }


def test_fixture_commandlist_by_bytes(fixture_capture):
    assert ((fixture_capture / "commandlist.jsonl").read_bytes()
            == (FIXTURE / "commandlist.jsonl").read_bytes())
    meta = json.loads((fixture_capture / "meta.json").read_text())
    assert meta["num_devices"] == 4 and meta["platform"] == "tpusim_torch"


def test_fixture_flops_and_all_reduces(fixture_capture):
    c = fixture_comparison(fixture_capture)
    print("llama_tiny_tp2dp2 port vs fixture @ v5p:", c)
    assert c["tot_mxu_flops"][0] == c["tot_mxu_flops"][1]
    assert c["num_devices"] == (4, 4)
    # 8 forward (embedding, 2 per layer, the vocab max, sum and target
    # pick), 5 backward (the f of each column-parallel input and of the
    # logits), 1 over dp (loss and float32 gradients in one tuple)
    assert c["all_reduce"] == (14, 14)
    assert c["tot_collective_count"][0] == c["tot_collective_count"][1]
    # the fixture's ICI bytes are larger: XLA:CPU promotes each bf16
    # all-reduce to f32, keeps the backward's partial input gradients
    # apart in tuples of 2-3 (the port sums them before its one
    # all-reduce), and all-reduces the embedding's two gradient parts
    # apart
    assert c["tot_ici_bytes"][0] < c["tot_ici_bytes"][1]


# ---------------------------------------------------------------------------
# (ii) numerics: the rank runner against the JAX function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,dtype", CASES)
def test_rank_runner_matches_jax(name, dtype, jax_side):
    module = _port_build(name, dtype)
    args = _port_inputs(jax_side, name, dtype)
    with torch.no_grad():
        out = (module.run(*args) if getattr(module, "world", 1) > 1
               else module(*args))
    got = list(out) if isinstance(out, (tuple, list)) else [out]
    want, dtypes = _load(jax_side, name, dtype, "out")
    assert len(got) == len(want)
    for g, w, dt in zip(got, want, dtypes):
        assert tuple(g.shape) == w.shape
        tol = 1e-4 if dtype == "float32" else 2e-2
        if dt.startswith("int"):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.float().numpy(), w, rtol=tol,
                                       atol=tol)


def _norm_err(got: torch.Tensor, want: np.ndarray) -> float:
    """``|got - want| / |want|`` over a whole array (Frobenius norms)."""
    w = torch.from_numpy(np.asarray(want, dtype=np.float64))
    return float((got.double() - w).norm() / w.norm())


def test_train_step_gradients_match_jax(jax_side):
    """The backward of ``llama_tiny_tp2dp2``: the float32 gradients the dp
    all-reduce carries, per parameter, against ``jax.grad`` of the
    reference step's loss on the same inputs.  A bf16 SGD step of 3e-4
    leaves most parameters unchanged, so the updated parameters alone
    cannot show a wrong gradient; a missing dp all-reduce (half the
    gradient) or a wrong backward collective is far outside 2e-2."""
    name = "llama_tiny_tp2dp2"
    module = _port_build(name, "native")
    loss, *grads = module.grads(*_port_inputs(jax_side, name, "native"))
    want, dtypes = _load(jax_side, name, "native", "grad")
    assert len(grads) == len(want) == len(module.in_specs) - 2
    assert set(dtypes) == {"bfloat16"}
    ref_loss = _load(jax_side, name, "native", "out")[0][0]
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.linalg.norm(w) > 0, i
        assert _norm_err(g, w) <= 2e-2, (i, _norm_err(g, w))


def test_sharded_gradients_equal_the_unsharded_step():
    """The 2x2 mesh's gradients against the one-rank step on the whole
    batch, in the port alone (``chip_smoke.py`` phase 12 holds the same on
    the card)."""
    kw = _kw("llama_tiny_tp2dp2", "native")
    sharded, args = get_workload("llama_tiny_tp2dp2").build(device="cpu",
                                                            **kw)
    single, _ = get_workload("llama_tiny_tp2dp2").build(device="cpu", dp=1,
                                                        tp=1, **kw)
    assert single.world == 1
    got, want = sharded.grads(*args), single.grads(*args)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-4)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert _norm_err(g, w.numpy()) <= 2e-2, i


# ---------------------------------------------------------------------------
# (iii) the yardstick: the JAX CPU capture of the same shapes
# ---------------------------------------------------------------------------


def _yardstick(port: Path, ref: Path) -> dict:
    got, want = _stats(port), _stats(ref, ref_simulate)
    keys = ("tot_mxu_flops", "tot_collective_count", "tot_ici_bytes",
            "tot_hbm_bytes", "num_devices")
    return {k: (got[k], want[k]) for k in keys}


@pytest.mark.parametrize("name,dtype", CASES)
def test_mxu_flops_equal_the_jax_capture(name, dtype, jax_side,
                                         port_traces):
    y = _yardstick(port_traces(name, dtype), jax_side / f"ref_{name}_{dtype}")
    port, ref = y["tot_mxu_flops"]
    assert port == pytest.approx(ref, rel=1e-9, abs=0), y


@pytest.mark.parametrize("name", [n for n in NAMES if _has_dtype(n)])
def test_collectives_equal_the_jax_capture_float32(name, jax_side,
                                                   port_traces):
    port = port_traces(name, "float32")
    ref = jax_side / f"ref_{name}_float32"
    y = _yardstick(port, ref)
    assert y["tot_collective_count"][0] == y["tot_collective_count"][1], y
    assert y["tot_ici_bytes"][0] == y["tot_ici_bytes"][1], y
    assert ((port / "commandlist.jsonl").read_text()
            == (ref / "commandlist.jsonl").read_text())
    meta = json.loads((port / "meta.json").read_text())
    assert meta["num_devices"] == WORLD[name] == _stats(port)["num_devices"]


# ---------------------------------------------------------------------------
# (v) one rank a process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks4():
    from tpusim_torch.spmd_procs import RankGroup

    with RankGroup(["cpu"] * 4) as group:
        yield group
    assert group.alive() == []


#: the two workloads (v) holds to the JAX function on the processes
PROCS = [(n, d) for n, d in CASES if n in ("llama_tiny_tp2dp2", "moe_ep4")]


@pytest.mark.parametrize("name,dtype", PROCS)
def test_rank_processes_match_jax(name, dtype, jax_side, ranks4):
    module = _port_build(name, dtype)
    args = _port_inputs(jax_side, name, dtype)
    with torch.no_grad():
        out = ranks4.run_module(module, *args)
    got = list(out) if isinstance(out, (tuple, list)) else [out]
    want, _ = _load(jax_side, name, dtype, "out")
    assert len(got) == len(want)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol)


def test_rank_processes_gradients_match_jax(jax_side, ranks4):
    name = "llama_tiny_tp2dp2"
    module = _port_build(name, "native")
    loss, *grads = ranks4.run(
        module.loss_and_grads, module.mesh,
        *_port_inputs(jax_side, name, "native"),
        in_specs=module.in_specs, out_specs=module.out_specs)
    want, _ = _load(jax_side, name, "native", "grad")
    assert len(grads) == len(want)
    np.testing.assert_allclose(loss.item(),
                               _load(jax_side, name, "native", "out")[0][0],
                               rtol=1e-4)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _norm_err(g, w) <= 2e-2, (i, _norm_err(g, w))


@pytest.mark.parametrize("name", ["llama_tiny_tp2dp2", "moe_ep4"])
def test_rank_process_snapshots_equal_the_vmap_runner(name, ranks4,
                                                      tmp_path):
    """Two launches, the second from the first's outputs; the sums of
    these meshes' groups of two are order-free, so the bytes agree."""
    from tpusim_torch.tracer.capture import snapshot_buffers

    module, args = get_workload(name).build(
        device="cpu", **_kw(name, "native" if name != "moe_ep4"
                            else "float32"))
    procs = snapshot_buffers(module, *args, out_dir=tmp_path / "procs",
                             launches=2, group=ranks4)
    vmap = snapshot_buffers(module, *args, out_dir=tmp_path / "vmap",
                            launches=2)
    assert [p.name for p in procs] == [p.name for p in vmap]
    assert len(procs) >= 2
    for p, v in zip(procs, vmap):
        np.testing.assert_array_equal(np.load(p), np.load(v))


def test_looped_ici_allreduce_stays_a_rank_program(ranks4):
    from tpusim_torch.harness.correlate import loopify
    from tpusim_torch.spmd import SpmdModule
    from tpusim_torch.tracer.capture import capture

    module, args = get_workload("ici_allreduce").build(
        device="cpu", elems=64, world=4)
    looped = loopify(module, 3)
    assert isinstance(looped, SpmdModule)
    assert (looped.mesh, looped.in_specs, looped.out_specs) == (
        module.mesh, module.in_specs, module.out_specs)
    text = capture(looped, *args, name="ar").hlo_text
    assert "num_partitions=4" in text.splitlines()[0]
    assert "(f32[64]{0})->f32[64]{0}" in text.splitlines()[0]
    assert text.count(" all-reduce(") == 1 and " while(" in text
    with torch.no_grad():
        got = ranks4.run_module(looped, *args)
        want = looped.run(*args)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the mean of the shards, three times over, is the mean
    mean = args[0].view(4, -1).mean(0).repeat(4)
    torch.testing.assert_close(got, mean, rtol=1e-5, atol=1e-6)


def test_per_op_profile_of_a_4_rank_step_on_rank_processes(ranks4):
    from tpusim_torch.harness.correl_ops import (
        correlate_workload_ops, profile_workload,
    )

    module, args = get_workload("llama_tiny_tp2dp2").build(
        device="cpu", **_kw("llama_tiny_tp2dp2", "native"))
    corr = correlate_workload_ops(module, args, name="llama_tiny_tp2dp2",
                                  arch="v5p", iters=1, group=ranks4)
    assert corr.matched_time_fraction > 0.5 and len(corr.rows) >= 2
    assert "all-reduce" in {r.opcode for r in corr.rows}
    # every rank's executions pooled: one execution of each of 4 ranks
    assert max(r.real_count for r in corr.rows) >= 1
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        profile_workload(module, args, iters=1)


if __name__ == "__main__":   # the yardstick table and the fixture line
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "jax").mkdir()
        (Path(tmp) / "port").mkdir()
        jax_dir = JaxSide(Path(tmp) / "jax").root
        traces = port_trace_maker(Path(tmp) / "port")
        print("| workload | dtype | MXU flops port = JAX | collectives "
              "port / JAX | ICI bytes port / JAX | HBM bytes port / JAX |")
        print("|---|---|---|---|---|---|")
        for name, dtype in CASES:
            y = _yardstick(traces(name, dtype),
                           jax_dir / f"ref_{name}_{dtype}")
            m, c, i, h = (y[k] for k in ("tot_mxu_flops",
                                         "tot_collective_count",
                                         "tot_ici_bytes", "tot_hbm_bytes"))
            print(f"| {name} | {dtype} | {m[0]:.0f} = {m[1]:.0f} | "
                  f"{c[0]} / {c[1]} | {i[0]:.0f} / {i[1]:.0f} | "
                  f"{h[0] / h[1]:.4f} |")
        print(fixture_comparison(capture_at_registered_shapes(
            Path(tmp) / "llama_tiny_tp2dp2")))

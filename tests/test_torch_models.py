"""The model suite's workloads in the port against the JAX package, on the
CPU: ``llama_tiny_train``, ``llama7b``, ``moe_ep8_train``,
``pipeline_pp4`` and ``llama7b_tp8dp8`` at small shapes (``SMALL``); the
helpers here serve ``tests/test_torch_llama_aot.py`` and
``tests/test_torch_resnet*.py`` as well.

The JAX side runs in one subprocess per world size (1, 4, 8, 64) on a CPU
mesh (``tpusim.envutil.cpu_mesh_env``), all started with the module's
first test: each saves its workloads' inputs, outputs and (train steps)
``jax.grad`` of the step's loss, and writes its CPU capture.  The AOT
step takes ``ShapeDtypeStruct`` arguments: its capture is of those, its
run of seeded arrays of the same shapes and shardings.  The Llama
workloads run at a small configuration (``LLAMA_SMALL``: 7B's structure
at dim 256, 8 heads, ffn 512, vocab 512, 2 layers), which the JAX side
adds to its ``PRESETS`` in its own memory and the port takes as build
overrides.

(i)   registration: parameters, suite, devices, description and the
      ``workloads`` line of every workload equal the reference's;
(ii)  numerics: the port on the JAX inputs equals the JAX function —
      float32 within rtol = atol = 1e-4, bfloat16 within 2e-2 — and a
      train step's gradients equal ``jax.grad``'s, each within 2e-2 of
      its norm; the sharded steps equal their unsharded counterparts in
      the port, and ``pipeline_pp4`` equals ``reference_forward``;
(iii) the yardstick, simulated at v5p (and v5e for the single-device
      ones) against the JAX CPU capture of the same shapes:
      ``tot_mxu_flops`` equal (rel 1e-9) in float32 and bfloat16; the
      collective count, ``tot_ici_bytes`` and the command list equal and
      ``tot_hbm_bytes`` within [0.8, 1.25] at float32;
(iv)  abstract capture: ``llama7b_tp8dp8`` at 7B's widths (cut to 2
      layers) is captured over meta tensors through the CLI, nothing
      materialised, and ``--snapshot`` and timing are refused; an
      explicit ``--device`` builds it there instead.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_models.py``
prints the yardstick table PERF.md records.
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

#: 7B's structure cut to size (what the 64-way and 7B workloads run at)
LLAMA_SMALL = dict(vocab=512, dim=256, layers=2, heads=8, kv_heads=8,
                   ffn=512)

#: small shapes: registered parameters, and (Llama) configuration fields
SMALL = {
    "llama_tiny_train": (dict(seq=64), {}),
    "llama7b": (dict(batch=1, seq=32), LLAMA_SMALL),
    "moe_ep8_train": (dict(tokens=256, d_model=64, d_hidden=128), {}),
    "pipeline_pp4": (dict(microbatches=4, microbatch=8, d_model=32), {}),
    "llama7b_tp8dp8": (dict(batch=16, seq=32), LLAMA_SMALL),
}
NAMES = list(SMALL)
WORLD = {"llama_tiny_train": 1, "llama7b": 1, "moe_ep8_train": 8,
         "pipeline_pp4": 4, "llama7b_tp8dp8": 64}
LLAMA = {"llama_tiny_train", "llama7b", "llama7b_tp8dp8"}
TRAIN = {"llama_tiny_train", "moe_ep8_train", "llama7b_tp8dp8"}
CASES = [(n, d) for n in NAMES for d in ("float32", "bfloat16")]
#: the registered workloads: all 36 of the reference's, and the
#: reference's workloads of suite ``models`` the port lacks
ALL_WORKLOADS = 36
MODELS_LEFT: set = set()


def _tol(dtype: str) -> float:
    return 1e-4 if dtype == "float32" else 2e-2


def _ref_kw(name: str, dtype: str) -> tuple[dict, dict | None]:
    """The JAX build's parameters and, for a Llama, the preset it adds."""
    kw, cfg = SMALL[name]
    kw = dict(kw)
    if name in LLAMA:
        base = ref_get_workload(name).params["preset"]
        kw["preset"] = f"{base}_{dtype}"
        return kw, {"base": base, "dtype": dtype, **cfg}
    return kw | {"dtype": dtype}, None


def _port_kw(name: str, dtype: str) -> dict:
    kw, cfg = SMALL[name]
    return {**kw, **cfg, "dtype": dtype}


#: run by each JAX subprocess: per case, the inputs, outputs and train
#: gradients as .npy files (bfloat16 as float32) with their dtypes, the
#: CPU capture, and where asked ResNet's batch-norm layers
#: (``tests/test_torch_resnet.py``, ``bn_layer``)
_JAX_SIDE = r"""
import dataclasses, json, sys
from pathlib import Path
import numpy as np
import jax
import jax.numpy as jnp
from tpusim.models import get_workload
from tpusim.models import llama, resnet
from tpusim.tracer.capture import capture_to_dir

def run(fn, args, train):
    sides = [("out", jax.jit(fn)(*args))]
    if train:
        sides.append(("grad", jax.jit(jax.grad(
            lambda p, *rest: fn(p, *rest)[0]))(*args)))
    return sides

def widen(args, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, args)

def bn_layers(fn, args, out, tag):
    # every batch-norm input of the forward (the network jitted once, its
    # _bn_train spied on), then per layer its output and the vjp of a
    # seeded cotangent in the inputs' dtype, and that vjp in float64
    bn, seen = resnet._bn_train, []
    def spy(x, scale, bias, eps=1e-5):
        seen.append((x, scale, bias))
        return bn(x, scale, bias, eps)
    def probe(*a):
        seen.clear()
        fn(*a)
        return list(seen)
    resnet._bn_train = spy
    try:
        layers = jax.jit(probe)(*args)
    finally:
        resnet._bn_train = bn
    step = jax.jit(lambda ct, *a: (lambda y, vjp: (y, *vjp(ct)))(
        *jax.vjp(bn, *a)))
    keys = jax.random.split(jax.random.PRNGKey(7), len(layers))
    done = []
    for i, (k, ins) in enumerate(zip(keys, layers)):
        ct = jax.random.normal(k, ins[0].shape, ins[0].dtype)
        done.append((ins, ct))
        for j, a in enumerate([*ins, ct, *step(ct, *ins)]):
            np.save(out / f"{tag}.bn{i}.{j}.npy", np.asarray(a, np.float32))
    jax.config.update("jax_enable_x64", True)
    for i, (ins, ct) in enumerate(done):
        _, *g = step(ct.astype(jnp.float64),
                     *(a.astype(jnp.float64) for a in ins))
        for j, a in enumerate(g):
            np.save(out / f"{tag}.bn{i}.{8 + j}.npy", np.asarray(a))
    jax.config.update("jax_enable_x64", False)
    return len(layers)

out = Path(sys.argv[1])
built = {}
for tag, name, kw, preset, train, layers, cast_from in json.loads(sys.argv[2]):
    if preset:
        base = preset.pop("base")
        llama.PRESETS[kw["preset"]] = dataclasses.replace(
            llama.PRESETS[base], **preset)
    if cast_from:
        # the same program on another build's arguments, cast
        fn, args = built[cast_from]
        args = widen(args, jnp.dtype(kw["dtype"]))
    else:
        fn, args = get_workload(name).build(**kw)
    built[tag] = fn, args
    cap_args = args
    leaves, tree = jax.tree_util.tree_flatten(args)
    if any(isinstance(x, jax.ShapeDtypeStruct) for x in leaves):
        # abstract (AOT) arguments: seeded arrays of their shapes and
        # shardings to run on; the capture keeps the abstract ones
        keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
        vocab = llama.PRESETS[kw["preset"]].vocab
        leaves = [jax.device_put(
            jax.random.normal(k, x.shape, x.dtype) * 0.02
            if jnp.issubdtype(x.dtype, jnp.floating)
            else jax.random.randint(k, x.shape, 0, vocab, x.dtype),
            x.sharding) for k, x in zip(keys, leaves)]
        args = jax.tree_util.tree_unflatten(tree, leaves)
    sides = [("in", args)] + run(fn, args, train)
    doc = {}
    for side, tree in sides:
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
        doc[side] = [str(a.dtype) for a in leaves]
        for i, a in enumerate(leaves):
            np.save(out / f"{tag}.{side}{i}.npy",
                    a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    if layers:
        doc["bn_layers"] = bn_layers(fn, args, out, tag)
    (out / f"{tag}.json").write_text(json.dumps(doc))
    capture_to_dir(out / f"ref_{tag}", fn, *cap_args, name=name, launches=1)
"""


class JaxSide:
    """One JAX subprocess per world size, started at once, run beside the
    port's own tests; :attr:`root` waits for them."""

    def __init__(self, out: Path, cases, world: dict, ref_kw, train: set,
                 bn_layers: set = frozenset(),
                 cast_from: dict | None = None):
        """``bn_layers``: the (ResNet forward, dtype) cases whose
        batch-norm layers are recorded;
        ``cast_from``: (workload, dtype) -> the dtype whose build's
        arguments, cast, a case takes instead of building anew (an earlier
        case of the same world)."""
        cast_from = cast_from or {}
        self.out = out
        self.procs = []
        for size in sorted(set(world.values())):
            todo = []
            for name, dtype in cases:
                if world[name] != size:
                    continue
                kw, preset = ref_kw(name, dtype)
                src = cast_from.get((name, dtype))
                todo.append((f"{name}_{dtype}", name, kw, preset,
                             name in train, (name, dtype) in bn_layers,
                             src and f"{name}_{src}"))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_SIDE, str(out),
                 json.dumps(todo)],
                env=cpu_mesh_env(size), cwd=REPO_ROOT,
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


def load(root: Path, tag: str, side: str) -> tuple[list[np.ndarray], list]:
    doc = json.loads((root / f"{tag}.json").read_text())
    return ([np.load(root / f"{tag}.{side}{i}.npy")
             for i in range(len(doc[side]))], doc[side])


def port_inputs(root: Path, tag: str) -> tuple:
    arrays, dtypes = load(root, tag, "in")
    out = []
    for a, dt in zip(arrays, dtypes):
        t = tensor_from_numpy(a, torch.device("cpu"))
        out.append(t.to(torch.bfloat16) if dt == "bfloat16" else t)
    return tuple(out)


def norm_err(got: torch.Tensor, want: np.ndarray) -> float:
    """``|got - want| / |want|`` over a whole array (Frobenius norms)."""
    w = torch.from_numpy(np.asarray(want, dtype=np.float64))
    return float((got.double() - w).norm() / w.norm())


def stats(path: Path, simulate=port_simulate, arch: str = "v5p") -> dict:
    st = json.loads(simulate(path, arch=arch, tuned=False).stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        st.pop(k)
    return st


def port_trace_maker(root: Path, port_kw):
    """The port's CPU capture per (workload, dtype) through the CLI, each
    made once."""
    cache: dict[tuple[str, str], Path] = {}

    def get(name: str, dtype: str) -> Path:
        if (name, dtype) not in cache:
            out = root / f"{name}_{dtype}"
            sets = [f"--set={k}={json.dumps(v)}"
                    for k, v in port_kw(name, dtype).items()]
            assert port_cli(["capture", name, str(out), "--device", "cpu",
                             *sets]) == 0
            cache[(name, dtype)] = out
        return cache[(name, dtype)]

    return get


YARD_KEYS = ("tot_mxu_flops", "tot_collective_count", "tot_ici_bytes",
             "tot_hbm_bytes", "num_devices")


def yardstick(port: Path, ref: Path, arch: str = "v5p") -> dict:
    got, want = stats(port, arch=arch), stats(ref, ref_simulate, arch)
    return {k: (got[k], want[k]) for k in YARD_KEYS}


def check_yardstick(port: Path, ref: Path, dtype: str, world: int,
                    archs=("v5p",)) -> None:
    """(iii): MXU flops equal; at float32 the collectives, ICI bytes,
    command list and the HBM band too."""
    for arch in archs:
        y = yardstick(port, ref, arch)
        assert y["tot_mxu_flops"][0] == pytest.approx(
            y["tot_mxu_flops"][1], rel=1e-9, abs=0), (arch, y)
        assert y["num_devices"] == (world, world), y
        if dtype != "float32":
            continue
        assert y["tot_collective_count"][0] == y["tot_collective_count"][1], y
        assert y["tot_ici_bytes"][0] == y["tot_ici_bytes"][1], y
        ratio = y["tot_hbm_bytes"][0] / y["tot_hbm_bytes"][1]
        assert 0.8 <= ratio <= 1.25, (arch, ratio, y)
    assert ((port / "commandlist.jsonl").read_text()
            == (ref / "commandlist.jsonl").read_text())


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    side = JaxSide(tmp_path_factory.mktemp("jax_side"), CASES, WORLD,
                   _ref_kw, TRAIN)
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    return port_trace_maker(tmp_path_factory.mktemp("port_side"), _port_kw)


def _build(name: str, dtype: str, **over):
    return get_workload(name).build(device="cpu",
                                    **(_port_kw(name, dtype) | over))


# ---------------------------------------------------------------------------
# (i) registration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_the_reference(name):
    port, ref = get_workload(name), ref_get_workload(name)
    assert port.params == ref.params
    assert (port.suite, port.num_devices, port.description) == (
        ref.suite, ref.num_devices, ref.description)


def test_every_workloads_line_equals_the_reference(capsys):
    assert port_cli(["workloads"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert ref_cli(["workloads"]) == 0
    ref = capsys.readouterr().out.splitlines()
    # the port's own DeepSeek-V2 decoder, which the reference has not
    own = {"deepseek_v2_lite", "deepseek_v2_tiny"}
    assert len(port) == ALL_WORKLOADS + len(own)
    models = [ln for ln in ref if ln.startswith("models ")
              and ln.split()[1] not in MODELS_LEFT]
    assert [ln for ln in port if ln.startswith("models ")
            and ln.split()[1] not in own] == models
    assert {ln.split()[1] for ln in port if ln.startswith("models ")} >= own


# ---------------------------------------------------------------------------
# (iv) abstract capture
# ---------------------------------------------------------------------------


def test_llama7b_tp8dp8_is_captured_abstractly(tmp_path, monkeypatch):
    """At 7B's widths (2 of its 32 layers), through the CLI: every input
    the step sees is a fake tensor on the meta device, and the trace is
    the 64-device program."""
    from torch._subclasses.fake_tensor import FakeTensor

    from tpusim_torch.models.llama import LlamaTrainStep

    seen: list[bool] = []
    forward = LlamaTrainStep.forward

    def spy(self, *a):
        seen.append(all(isinstance(t, FakeTensor) and t.device.type == "meta"
                        for t in a))
        return forward(self, *a)

    monkeypatch.setattr(LlamaTrainStep, "forward", spy)
    out = tmp_path / "t"
    assert port_cli(["capture", "llama7b_tp8dp8", str(out),
                     "--set", "layers=2"]) == 0
    assert seen and all(seen)
    meta = json.loads((out / "meta.json").read_text())
    assert meta["num_devices"] == 64 and meta["device_kind"] == "meta"
    st = stats(out)
    assert st["num_devices"] == 64 and st["tot_collective_count"] > 0
    assert st == stats(out, ref_simulate)


def test_abstract_workloads_refuse_snapshots_and_timing(tmp_path, capsys):
    from tpusim_torch.tracer.capture import measure_wall_time, snapshot_buffers

    module, args = get_workload("llama7b_tp8dp8").build(layers=1)
    assert {a.device.type for a in args} == {"meta"}
    with pytest.raises(ValueError, match="abstract"):
        snapshot_buffers(module, *args, out_dir=tmp_path / "s")
    with pytest.raises(ValueError, match="abstract"):
        measure_wall_time(module, *args)
    assert port_cli(["capture", "llama7b_tp8dp8", str(tmp_path / "c"),
                     "--snapshot", "--set", "layers=1"]) == 2
    assert "needs concrete inputs" in capsys.readouterr().err


def test_an_abstract_workload_honours_an_explicit_device(tmp_path):
    """``--device cpu`` builds ``llama7b_tp8dp8`` on the CPU (at the small
    configuration): concrete inputs, and ``--snapshot`` runs."""
    sets = [f"--set={k}={json.dumps(v)}"
            for k, v in _port_kw("llama7b_tp8dp8", "float32").items()]
    out = tmp_path / "c"
    assert port_cli(["capture", "llama7b_tp8dp8", str(out), "--device",
                     "cpu", "--snapshot", *sets, "--set", "layers=1",
                     "--set", "batch=8", "--set", "seq=8"]) == 0
    meta = json.loads((out / "meta.json").read_text())
    assert meta["device_kind"] != "meta" and meta["num_devices"] == 64
    assert any((out / "checkpoint_files").iterdir())


# ---------------------------------------------------------------------------
# (ii) numerics
# ---------------------------------------------------------------------------


def _run(module, args):
    with torch.no_grad():
        out = (module.run(*args) if getattr(module, "world", 1) > 1
               else module(*args))
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,dtype", CASES)
def test_port_matches_jax(name, dtype, jax_side):
    tag = f"{name}_{dtype}"
    module, _ = _build(name, dtype)
    got = _run(module, port_inputs(jax_side, tag))
    want, dtypes = load(jax_side, tag, "out")
    assert len(got) == len(want)
    tol = _tol(dtype)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,dtype", [c for c in CASES if c[0] in TRAIN])
def test_train_gradients_match_jax(name, dtype, jax_side):
    tag = f"{name}_{dtype}"
    module, _ = _build(name, dtype)
    loss, *grads = module.grads(*port_inputs(jax_side, tag))
    want, _ = load(jax_side, tag, "grad")
    assert len(grads) == len(want)
    np.testing.assert_allclose(loss.item(), load(jax_side, tag, "out")[0][0],
                               rtol=_tol(dtype))
    for i, (g, w) in enumerate(zip(grads, want)):
        assert tuple(g.shape) == w.shape and np.linalg.norm(w) > 0, i
        assert norm_err(g, w) <= 2e-2, (i, norm_err(g, w))


@pytest.mark.parametrize("name", ["moe_ep8_train", "llama7b_tp8dp8"])
def test_sharded_step_equals_the_unsharded_step(name):
    """The N ranks' gradients against the one-rank step on the whole
    batch, in the port alone (``chip_smoke.py`` holds the same on the
    card)."""
    from tpusim_torch.models.moe import MoeTrainStep

    sharded, args = _build(name, "float32")
    if name == "moe_ep8_train":
        single = MoeTrainStep(1, sharded.tokens, shards=sharded.world)
    else:
        single, _ = _build(name, "float32", dp=1, tp=1)
    assert sharded.world == WORLD[name]
    got, want = sharded.grads(*args), single.grads(*args)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-4)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert norm_err(g, w.numpy()) <= 2e-2, i


def test_sharded_forward_equals_the_single_chip_forward():
    """The reference's forward on a (dp, tp) mesh (``build_llama_sharded``
    with ``train=False``; no registered workload): each rank's logits are
    its vocab shard of its batch shard."""
    from tpusim_torch.models.llama import build_llama

    kw = dict(batch=4, seq=16, train=False, device="cpu", dtype="float32")
    sharded, args = build_llama("tiny", dp=2, tp=2, **kw)
    single, _ = build_llama("tiny", **kw)
    with torch.no_grad():
        np.testing.assert_allclose(sharded.run(*args).numpy(),
                                   single(*args).numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_equals_the_sequential_network(dtype):
    from tpusim_torch.models.pipeline import reference_forward

    module, args = _build("pipeline_pp4", dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(module.run(*args).float().numpy(),
                               reference_forward(*args).float().numpy(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (iii) the yardstick: the JAX CPU capture of the same shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,dtype", CASES)
def test_trace_holds_the_jax_capture(name, dtype, jax_side, port_traces):
    port = port_traces(name, dtype)
    archs = ("v5e", "v5p") if WORLD[name] == 1 else ("v5p",)
    check_yardstick(port, jax_side / f"ref_{name}_{dtype}", dtype,
                    WORLD[name], archs)


@pytest.mark.parametrize("name", NAMES)
def test_port_trace_prices_the_same_in_both_packages(name, port_traces):
    path = port_traces(name, "float32")
    assert stats(path) == stats(path, ref_simulate)


def test_pipeline_trace_shape(port_traces):
    """One ``while`` with the tick's ``collective-permute`` in its body,
    the injected microbatch read with a ``dynamic-slice`` (no gather), the
    emerging one written with a ``dynamic-update-slice``, and the last
    stage's slab sent out in ``pp - 1`` permutes."""
    text = (port_traces("pipeline_pp4", "float32") / "modules"
            / "pipeline_pp4.hlo").read_text()
    assert text.count(" while(") == 1 and "gather(" not in text
    assert "dynamic-slice(" in text and "dynamic-update-slice(" in text
    assert text.count(" collective-permute(") == 4
    assert "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}" in text
    for j in range(3):
        assert f"source_target_pairs={{{{3,{j}}}}}" in text


if __name__ == "__main__":   # the yardstick table of all nine
    import tempfile

    import test_torch_llama_aot as aot
    import test_torch_resnet as rn

    resnet_batch = {"resnet50_dp8": 16}

    def ref_kw(name, dtype):
        if name.startswith("resnet50"):
            return rn.resnet_kw(name, dtype, resnet_batch.get(name, 8)), None
        return (aot._ref_kw if name == aot.NAME else _ref_kw)(name, dtype)

    def port_kw(name, dtype):
        if name.startswith("resnet50"):
            return rn.resnet_kw(name, dtype, resnet_batch.get(name, 8))
        return (aot._port_kw if name == aot.NAME else _port_kw)(name, dtype)

    names = NAMES + [aot.NAME, "resnet50", "resnet50_train", "resnet50_dp8"]
    world = WORLD | {aot.NAME: 64, "resnet50": 1, "resnet50_train": 1,
                     "resnet50_dp8": 8}
    cases = [(n, d) for n in names for d in ("float32", "bfloat16")]
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "jax").mkdir()
        (Path(tmp) / "port").mkdir()
        jax_dir = JaxSide(Path(tmp) / "jax", cases, world, ref_kw, set()).root
        traces = port_trace_maker(Path(tmp) / "port", port_kw)
        print("| workload | dtype | MXU flops port = JAX | collectives "
              "port / JAX | ICI bytes port / JAX | HBM bytes port / JAX |")
        print("|---|---|---|---|---|---|")
        for name, dtype in cases:
            y = yardstick(traces(name, dtype),
                          jax_dir / f"ref_{name}_{dtype}")
            m, c, i, h = (y[k] for k in ("tot_mxu_flops",
                                         "tot_collective_count",
                                         "tot_ici_bytes", "tot_hbm_bytes"))
            print(f"| {name} | {dtype} | {m[0]:.0f} {'=' if m[0] == m[1] else '!='} "
                  f"{m[1]:.0f} | {c[0]} / {c[1]} | {i[0]:.0f} / {i[1]:.0f} | "
                  f"{h[0] / h[1]:.4f} |", flush=True)

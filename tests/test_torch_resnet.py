"""ResNet-50 in the port against the JAX package, on the CPU: the forward
``resnet50`` at batch 8, 32×32 images and 10 classes (all 16 blocks), the
helpers the train-step files share (``tests/test_torch_resnet_train.py``,
``tests/test_torch_resnet_dp8.py``), and the lowering ResNet needs.

The JAX side runs in one subprocess on a CPU mesh, started with the
module's first test (``test_torch_models.JaxSide``); it also records the
bfloat16 forward's batch-norm layers (``bn_layer``).

(i)   registration equals the reference's;
(ii)  numerics.  In float32 the port's logits meet JAX's within 1e-3 of
      their norm, and a train step's loss, gradients, updated
      parameters and velocities within 2e-2 (the gradients' tolerance).
      This network is badly conditioned at init: a batch-norm network's
      perturbations grow with depth, so at batch 8, 32², the elementwise
      1e-4 two float32 implementations could meet elsewhere is below the
      computation's own spread here, and in bfloat16 the port's and
      JAX's logits lie 72% apart and their gradients further apart than
      either lies from zeros.  So bfloat16 is held where it is well
      conditioned, each batch-norm layer on its own
      (:func:`test_batch_norms_match_jax_in_bfloat16`): the 53
      batch-norms' inputs of the JAX forward, and per layer the output
      within 2e-3 of its norm (half a bfloat16 rounding step; reading 0)
      and the vjp of a seeded cotangent within 2e-2 (the input's
      gradient against JAX's bfloat16 one, reading 4e-3; the scale's and
      bias's against the float64 vjp, reading 5e-3, since JAX's own
      bfloat16 ones lie up to 5.3% from it), on one device and
      synchronized over 8 ranks.  A wrong statistic, epsilon or scale
      fails there; a cast that moves a statistic by one bfloat16 ulp may
      stay below the limit.  End to end in bfloat16 every output has
      JAX's dtype and shape and is finite, a train step's loss lies
      within 0.2 of JAX's (readings 2.5%, and 9.6% for ``resnet50_dp8``),
      and every other output's norm within a factor 2 of JAX's (readings
      0.74-1.28): a zeroed or mis-scaled output fails.  ``python
      tests/test_torch_resnet.py`` prints these readings.  On the card
      ``chip_smoke.py`` phase 13 holds the bfloat16 forward at 224²
      against the CPU and the batch-norm layers the same way;
(iii) the yardstick as in ``tests/test_torch_models.py``: MXU flops equal
      in float32 and bfloat16 (v5e and v5p), the command list equal and
      HBM bytes within [0.8, 1.25] at float32;
(iv)  the lowering: every asymmetric ``SAME`` pad folded into a window
      (no ``pad`` left), the max pool a ``reduce-window`` and its
      backward a ``select-and-scatter``, the strided input gradients
      ``lhs_dilate``-d and the weight gradients ``rhs_dilate``-d, and
      each new op of the table priced alike by both packages.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from test_torch_models import (  # noqa: E402
    JaxSide,
    check_yardstick,
    load,
    norm_err,
    port_inputs,
    port_trace_maker,
    stats,
)
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.tracer.capture import capture_to_dir  # noqa: E402

SMALL = dict(batch=8, image=32, num_classes=10)
DTYPES = ("float32", "bfloat16")
#: bfloat16 limits, norm-wise (module docstring (ii)): a batch-norm
#: layer's output, its vjp, a train step's loss, and the factor every other
#: output's norm may lie from JAX's
BN_OUT, BN_GRAD, BF16_LOSS, BF16_NORM = 2e-3, 2e-2, 0.2, 2.0


def resnet_kw(name: str, dtype: str, batch: int = SMALL["batch"]) -> dict:
    return SMALL | {"batch": batch, "dtype": dtype}


def outputs(module, side: Path, tag: str) -> list[torch.Tensor]:
    """The module's outputs on the JAX inputs (a train step through the
    rank runner)."""
    args = port_inputs(side, tag)
    with torch.no_grad():
        out = module.run(*args) if hasattr(module, "run") else module(*args)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_outputs(got: list[torch.Tensor], side: Path, tag: str,
                  dtype: str, which=None, names=None,
                  loss: bool = False) -> None:
    """Outputs ``which`` (default all) held to the JAX outputs: each with
    JAX's shape and dtype and finite; in float32 the first (logits, or a
    train step's loss) within 1e-3 of its norm and the rest of a train
    step's (``(loss, *params', *velocities')``; one step from zero
    velocity, the velocities are the gradients) within 2e-2; in bfloat16
    a train step's ``loss`` within :data:`BF16_LOSS` and every other
    output's norm within a factor :data:`BF16_NORM` of JAX's."""
    want, dtypes = load(side, tag, "out")
    assert len(got) == len(want)
    for k, i in enumerate(which or range(len(got))):
        g, w = got[i], want[i]
        what = names[k] if names else i
        assert tuple(g.shape) == w.shape, what
        assert str(g.dtype).removeprefix("torch.") == dtypes[i], what
        assert bool(torch.isfinite(g).all()), what
        g = g.reshape(w.shape)
        if not np.linalg.norm(w):
            continue
        if dtype == "float32":
            tol = 2e-2 if i else 1e-3
            assert norm_err(g, w) <= tol, (what, norm_err(g, w))
        elif loss and i == 0:
            assert norm_err(g, w) <= BF16_LOSS, (what, norm_err(g, w))
        else:
            ratio = float(g.double().norm()) / float(np.linalg.norm(w))
            assert 1 / BF16_NORM <= ratio <= BF16_NORM, (what, ratio)


def check_step(got: list[torch.Tensor], side: Path, tag: str,
               dtype: str) -> None:
    """A train step's loss and updated parameters."""
    check_outputs(got, side, tag, dtype, range(1 + (len(got) - 1) // 2),
                  loss=True)


def check_gradients(got: list[torch.Tensor], side: Path, tag: str,
                    dtype: str, names: list[str]) -> None:
    """A train step's gradients, read as its velocities."""
    n = len(names)
    assert len(got) == 1 + 2 * n
    check_outputs(got, side, tag, dtype, range(1 + n, 1 + 2 * n), names)


def jax_side_for(factory, name: str, world: int, batch: int):
    return JaxSide(factory.mktemp("jax_side"),
                   [(name, d) for d in DTYPES], {name: world},
                   lambda n, d: (resnet_kw(n, d, batch), None), set(),
                   bn_layers={("resnet50", "bfloat16")},
                   cast_from={(name, "bfloat16"): "float32"})


def bn_layer(side: Path, tag: str, i: int) -> list[torch.Tensor]:
    """Batch-norm layer ``i`` of the JAX forward ``tag``, NHWC: input,
    scale, bias, seeded cotangent, output, the input's, scale's and
    bias's vjp in the input's dtype, and the same three in float64."""
    arrays = [np.load(side / f"{tag}.bn{i}.{j}.npy") for j in range(11)]
    return [torch.from_numpy(a).to(torch.bfloat16) if j < 8
            else torch.from_numpy(a) for j, a in enumerate(arrays)]


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    side = jax_side_for(tmp_path_factory, "resnet50", 1, SMALL["batch"])
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    return port_trace_maker(tmp_path_factory.mktemp("port_side"), resnet_kw)


def test_registered_as_the_reference():
    for name in ("resnet50", "resnet50_train", "resnet50_dp8"):
        port, ref = get_workload(name), ref_get_workload(name)
        assert port.params == ref.params
        assert (port.suite, port.num_devices, port.description) == (
            ref.suite, ref.num_devices, ref.description)


def test_params_from_numpy_keeps_the_reference_leaf_order():
    import jax

    from tpusim.models.resnet import init_resnet50
    from tpusim_torch.models.resnet import param_names, params_from_numpy

    # the reference's tree, its leaves numbered (no need to draw them)
    shapes = jax.eval_shape(lambda k: init_resnet50(k, 10, "float32"),
                            jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    leaves = [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    flat = params_from_numpy(tree, device="cpu")
    assert len(flat) == len(leaves) == len(param_names(10)) == 161
    for t, a in zip(flat, leaves):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype, jax_side):
    module, _ = get_workload("resnet50").build(
        device="cpu", **resnet_kw("resnet50", dtype))
    tag = f"resnet50_{dtype}"
    check_outputs(outputs(module, jax_side, tag), jax_side, tag, dtype)


def _port_bn(x, scale, bias, mesh=None, batch=None):
    """The port's batch-norm (``_Net.norm``: one device, or one rank's
    synchronized form) on an NHWC input."""
    from tpusim_torch.models.resnet import _Net

    net = _Net({"scale": scale, "bias": bias}, mesh, batch or x.shape[0])
    return net.norm(x.permute(0, 3, 1, 2), "scale", "bias").permute(
        0, 2, 3, 1)


def _bn_vjp(x, scale, bias, ct, mesh=None, batch=None):
    y, vjp = torch.func.vjp(
        lambda *a: _port_bn(*a, mesh=mesh, batch=batch), x, scale, bias)
    return (y, *vjp(ct))


@pytest.mark.parametrize("ranks", [1, 8])
def test_batch_norms_match_jax_in_bfloat16(ranks, jax_side):
    """Each of the 53 batch-norms of the bfloat16 forward on its JAX input,
    alone (module docstring (ii)): the output within 2e-3, the input's
    gradient within 2e-2 of JAX's, the scale's and bias's within 2e-2 of
    the float64 vjp; on one device, or synchronized over 8 ranks (one
    sample each; the bias's gradient summed over them)."""
    from tpusim_torch.spmd import Mesh, P, psum, run_ranks

    tag = "resnet50_bfloat16"
    n = json.loads((jax_side / f"{tag}.json").read_text())["bn_layers"]
    assert n == 53
    mesh = Mesh((ranks,), ("dp",))

    def rank(x, scale, bias, ct):
        y, dx, ds, db = _bn_vjp(x, scale, bias, ct, mesh, SMALL["batch"])
        return y, dx, ds, psum(db, mesh, "dp")

    for i in range(n):
        x, scale, bias, ct, y, dx, *_, ds64, db64 = bn_layer(jax_side, tag, i)
        if ranks == 1:
            got = _bn_vjp(x, scale, bias, ct)
        else:
            got = run_ranks(rank, mesh, x, scale, bias, ct,
                            in_specs=(P("dp"), P(), P(), P("dp")),
                            out_specs=(P("dp"), P("dp"), P(), P()))
        assert all(g.dtype == torch.bfloat16 for g in got), i
        errs = [norm_err(g, w.float().numpy()) for g, w in
                zip(got, (y, dx, ds64, db64))]
        assert errs[0] <= BN_OUT and max(errs[1:]) <= BN_GRAD, (i, errs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_trace_holds_the_jax_capture(dtype, jax_side, port_traces):
    check_yardstick(port_traces("resnet50", dtype),
                    jax_side / f"ref_resnet50_{dtype}", dtype, 1,
                    ("v5e", "v5p"))


def test_port_trace_prices_the_same_in_both_packages(port_traces):
    path = port_traces("resnet50", "float32")
    assert stats(path) == stats(path, ref_simulate)
    text = (path / "modules" / "resnet50.hlo").read_text()
    assert " pad(" not in text and text.count(" reduce-window(") == 1
    assert text.count(" convolution(") == 53


# ---------------------------------------------------------------------------
# (iv) the lowering
# ---------------------------------------------------------------------------


def train_trace_checks(text: str) -> None:
    """(iv) on a captured ``resnet50_train`` at the test's shapes."""
    assert " pad(" not in text
    assert text.count(" reduce-window(") == 1
    assert text.count(" select-and-scatter(") == 1
    # 53 forward, 52 input gradients (the stem's input takes none), 53
    # weight gradients
    assert text.count(" convolution(") == 158
    # the stem (7x7/2 on 32: SAME pads 2_3) and its weight gradient
    assert "window={size=7x7 stride=2x2 pad=2_3x2_3}" in text
    assert "window={size=16x16 pad=2_3x2_3 rhs_dilate=2x2}" in text
    # a 3x3/2 input gradient on 8: SAME pads 0_1 forward, 2_1 transposed
    assert "window={size=3x3 pad=2_1x2_1 lhs_dilate=2x2}" in text
    assert "dim_labels=fb01_io01->fb01" in text


class Fn(torch.nn.Module):
    def __init__(self, fn, train: bool = False):
        super().__init__()
        self.fn, self.train_step = fn, train

    def forward(self, *args):
        return self.fn(*args)


def _t(*shape):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g)


def _grad_of(loss):
    """A train-step function: the gradient of ``loss`` w.r.t. the first
    argument, and the loss."""
    def step(w, *rest):
        g, v = torch.func.grad_and_value(lambda w: loss(w, *rest))(w)
        return v, g
    return step


#: (case id, function, args, train step?, text its HLO must hold)
OP_CASES = [
    ("var", lambda a: a.var((0, 2), correction=0), (_t(4, 8, 6),), False,
     "reduce("),
    ("log_softmax", lambda a: torch.log_softmax(a, -1), (_t(4, 8),), False,
     "log("),
    ("gather", lambda a, i: torch.gather(a, 1, i[:, None].long()),
     (_t(4, 8), torch.arange(4, dtype=torch.int32)), False, "gather("),
    ("clamp", lambda a: a.clamp(-0.5, 0.5), (_t(4, 8),), False, "minimum("),
    ("pad_kept", lambda a: F.pad(a, (1, 2)) * 2, (_t(4, 8),), False,
     "pad("),
    ("max_pool", lambda a: F.max_pool2d(
        F.pad(a, (0, 1, 0, 1), value=float("-inf")), 3, 2),
     (_t(2, 4, 8, 8),), False, "reduce-window("),
    ("conv_backward", _grad_of(lambda w, x: F.conv2d(
        F.pad(x, (0, 1, 0, 1)), w, stride=2).square().sum()),
     (_t(6, 4, 3, 3), _t(2, 4, 8, 8)), True, "rhs_dilate=2x2"),
    ("conv_input_backward", _grad_of(lambda x, w: F.conv2d(
        x, w, stride=2, padding=1).square().sum()),
     (_t(2, 4, 9, 9), _t(6, 4, 3, 3)), True, "lhs_dilate=2x2"),
    ("max_pool_backward", _grad_of(lambda x: F.max_pool2d(
        F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2).square().sum()),
     (_t(2, 4, 8, 8),), True, "select-and-scatter("),
    ("log_softmax_gather_backward", _grad_of(lambda z, i: -torch.gather(
        torch.log_softmax(z, -1), 1, i[:, None].long()).mean()),
     (_t(4, 8), torch.arange(4, dtype=torch.int32)), True, "scatter("),
    ("slice_backward", _grad_of(lambda a: a[:3].exp().sum()),
     (_t(4, 8),), True, "dynamic-update-slice("),
]


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_new_op_prices_the_same_in_both_packages(case, tmp_path):
    name, fn, args, train, text_in = case
    out = tmp_path / name
    capture_to_dir(out, Fn(fn, train), *args, name=name)
    text = (out / "modules" / f"{name}.hlo").read_text()
    assert text_in in text
    if name.startswith(("max_pool", "conv")):
        assert " pad(" not in text      # folded into the window
    got, want = stats(out, arch="v5e"), stats(out, ref_simulate, "v5e")
    assert got == want


def test_a_crop_of_a_pad_returns_its_operand(tmp_path):
    """A pad's own backward (a crop) of the re-padded input gradient
    cancels: the gradient of a padded convolution's input holds no pad."""
    fn = _grad_of(lambda x, w: F.conv2d(F.pad(x, (2, 3, 2, 3)), w,
                                        stride=2).square().sum())
    out = tmp_path / "crop"
    capture_to_dir(out, Fn(fn, True), _t(2, 3, 16, 16), _t(4, 3, 7, 7),
                   name="crop")
    text = (out / "modules" / "crop.hlo").read_text()
    assert " pad(" not in text and " slice(" not in text
    assert "window={size=7x7 pad=4_3x4_3 lhs_dilate=2x2}" in text


if __name__ == "__main__":   # the bfloat16 readings the limits are set from
    import tempfile

    from tpusim_torch.spmd import Mesh, P, psum, run_ranks

    def rank_step(mesh):
        def step(x, scale, bias, ct):
            y, dx, ds, db = _bn_vjp(x, scale, bias, ct, mesh, SMALL["batch"])
            return y, dx, ds, psum(db, mesh, "dp")
        return step

    runs = {"resnet50": (1, 8), "resnet50_train": (1, 8),
            "resnet50_dp8": (8, 16)}
    with tempfile.TemporaryDirectory() as tmp:
        sides = {}
        for name, (world, batch) in runs.items():
            (Path(tmp) / name).mkdir()
            sides[name] = JaxSide(
                Path(tmp) / name, [(name, d) for d in DTYPES], {name: world},
                lambda n, d, b=batch: (resnet_kw(n, d, b), None), set(),
                bn_layers={("resnet50", "bfloat16")},
                cast_from={(name, "bfloat16"): "float32"})
        root, tag = sides["resnet50"].root, "resnet50_bfloat16"
        n = json.loads((root / f"{tag}.json").read_text())["bn_layers"]
        for ranks in (1, 8):
            mesh = Mesh((ranks,), ("dp",))
            worst = np.zeros(6)
            for i in range(n):
                x, scale, bias, ct, y, dx, ds, db, _, ds64, db64 = bn_layer(
                    root, tag, i)
                got = (_bn_vjp(x, scale, bias, ct) if ranks == 1 else
                       run_ranks(rank_step(mesh), mesh, x, scale, bias, ct,
                                 in_specs=(P("dp"), P(), P(), P("dp")),
                                 out_specs=(P("dp"), P("dp"), P(), P())))
                errs = [norm_err(g, w.float().numpy()) for g, w in
                        zip(got, (y, dx, ds64, db64))]
                errs += [norm_err(ds.double(), ds64.numpy()),
                         norm_err(db.double(), db64.numpy())]
                worst = np.maximum(worst, errs)
            print(f"{n} batch-norms, {ranks} rank(s), largest norm-wise "
                  f"error: output {worst[0]:.3g}, input gradient "
                  f"{worst[1]:.3g} (vs JAX bf16), scale {worst[2]:.3g} and "
                  f"bias {worst[3]:.3g} (vs the f64 vjp); JAX's own bf16 "
                  f"scale {worst[4]:.3g}, bias {worst[5]:.3g}")
        for name, (world, batch) in runs.items():
            root, tag = sides[name].root, f"{name}_bfloat16"
            module, _ = get_workload(name).build(
                device="cpu", **resnet_kw(name, "bfloat16", batch))
            got = outputs(module, root, tag)
            want, _ = load(root, tag, "out")
            errs = [norm_err(g.reshape(w.shape), w) for g, w in
                    zip(got, want) if np.linalg.norm(w)]
            ratios = [float(g.double().norm()) / float(np.linalg.norm(w))
                      for g, w in zip(got, want) if np.linalg.norm(w)]
            print(f"{name} bf16 vs JAX bf16: first output (logits or loss) "
                  f"error {errs[0]:.3g}, norm ratio {ratios[0]:.3g}; other "
                  f"outputs' error median {np.median(errs[1:] or [0]):.3g}, "
                  f"norm ratios {min(ratios):.3g}-{max(ratios):.3g}")

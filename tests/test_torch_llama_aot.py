"""``llama7b_aot_v5p64`` in the port against the JAX package, on the CPU:
the Llama-2-7B train step with its layers stacked and scanned, on a 64-
device ``(dp, tp)`` mesh, at the small configuration of
``tests/test_torch_models.py`` (``LLAMA_SMALL``).

The reference takes ``ShapeDtypeStruct`` arguments; the JAX side (one
subprocess on a 64-device CPU mesh) captures those and runs the step on
seeded arrays of the same shapes and shardings.  Held: numerics, the
gradients of ``jax.grad``, the yardstick (MXU flops in float32 and
bfloat16; collectives, ICI bytes, command list and the HBM band in
float32), the 64 ranks against the one-rank step, the reversed scan of
hand-written layer backwards against autograd of the same layers
unrolled, and the abstract capture at registered width: two ``while``
loops of 32 trips, nothing materialised, ``--snapshot`` refused.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import (  # noqa: E402
    LLAMA_SMALL,
    JaxSide,
    _tol,
    check_yardstick,
    load,
    norm_err,
    port_inputs,
    port_trace_maker,
)
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim_torch.__main__ import main as port_cli  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402

NAME = "llama7b_aot_v5p64"
SMALL = dict(batch=16, seq=32)
DTYPES = ("float32", "bfloat16")


def _ref_kw(name: str, dtype: str):
    base = ref_get_workload(name).params["preset"]
    return (dict(SMALL, preset=f"{base}_{dtype}"),
            {"base": base, "dtype": dtype, **LLAMA_SMALL})


def _port_kw(name: str, dtype: str) -> dict:
    return {**SMALL, **LLAMA_SMALL, "dtype": dtype}


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    side = JaxSide(tmp_path_factory.mktemp("jax_side"),
                   [(NAME, d) for d in DTYPES], {NAME: 64}, _ref_kw, {NAME})
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    return port_trace_maker(tmp_path_factory.mktemp("port_side"), _port_kw)


def _build(dtype: str, **over):
    return get_workload(NAME).build(device="cpu",
                                    **(_port_kw(NAME, dtype) | over))


def test_registered_as_the_reference():
    port, ref = get_workload(NAME), ref_get_workload(NAME)
    assert port.params == ref.params and port.abstract
    assert (port.suite, port.num_devices, port.description) == (
        ref.suite, ref.num_devices, ref.description)


def test_captured_abstractly_at_registered_width(tmp_path, capsys):
    """7B, 32 layers, batch 8, seq 2048, through the CLI over meta
    tensors: the layer scan is one forward and one backward ``while``, 32
    trips each, with 2 all-reduces in the forward body and 3 in the
    backward's (6 outside); ``--snapshot`` is refused."""
    from tpusim_torch.trace.format import load_trace

    module, args = get_workload(NAME).build()
    assert {a.device.type for a in args} == {"meta"}
    out = tmp_path / "aot"
    assert port_cli(["capture", NAME, str(out)]) == 0
    mod = load_trace(out).modules[NAME]
    whiles = [o for c in mod.computations.values() for o in c.ops
              if o.opcode == "while"]
    assert len(whiles) == 2
    assert all(re.search(r'known_trip_count[^0-9]*32"', o.attrs.get(
        "backend_config", "")) for o in whiles)
    colls = {c.name: sum(o.opcode == "all-reduce" for o in c.ops)
             for c in mod.computations.values()}
    bodies = sorted(colls[o.attrs["body"].lstrip("%")] for o in whiles)
    assert bodies == [2, 3] and colls[mod.entry_name] == 6
    assert json.loads((out / "meta.json").read_text())["num_devices"] == 64
    assert port_cli(["capture", NAME, str(tmp_path / "s"),
                     "--snapshot"]) == 2
    assert "needs concrete inputs" in capsys.readouterr().err


@pytest.fixture(scope="module")
def port_grads(jax_side):
    """``(loss, *grads)`` of the port's step on the JAX inputs, once per
    (dtype, ranks): the 64-rank step, or the one-rank one (``dp = tp =
    1``)."""
    cache = {}

    def get(dtype: str, ranks: int = 64):
        if (dtype, ranks) not in cache:
            over = {} if ranks == 64 else dict(dp=1, tp=1)
            module, _ = _build(dtype, **over)
            assert module.world == ranks
            cache[(dtype, ranks)] = module.grads(
                *port_inputs(jax_side, f"{NAME}_{dtype}"))
        return cache[(dtype, ranks)]

    return get


def test_aot_scan_backward_equals_autograd_of_the_unrolled_layers(
        jax_side, port_grads):
    """The AOT step's reversed scan of hand-written layer backwards against
    autograd (``torch.func.vjp``) of the same layers unrolled
    (``LlamaTrainStep``), one rank, float32: each gradient within 1e-5 of
    its norm."""
    from tpusim_torch.models.llama import LAYER_KEYS, LlamaTrainStep

    aot, _ = _build("float32", dp=1, tp=1)
    args = port_inputs(jax_side, f"{NAME}_float32")
    embed, final_norm, *stacked = args[:-2]
    layers = aot.cfg.layers
    flat = [embed, final_norm] + [stacked[j][i] for i in range(layers)
                                  for j in range(len(LAYER_KEYS))]
    want = LlamaTrainStep(aot.cfg, None, aot.batch).grads(*flat, *args[-2:])
    got = port_grads("float32", 1)
    got_flat = list(got[:3]) + [got[3 + j][i] for i in range(layers)
                                for j in range(len(LAYER_KEYS))]
    assert len(got_flat) == len(want)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-6)
    for i, (g, w) in enumerate(zip(got_flat[1:], want[1:])):
        assert norm_err(g, w.numpy()) <= 1e-5, i


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_matches_jax(dtype, jax_side):
    tag = f"{NAME}_{dtype}"
    module, _ = _build(dtype)
    with torch.no_grad():
        got = module.run(*port_inputs(jax_side, tag))
    want, _ = load(jax_side, tag, "out")
    assert len(got) == len(want)
    tol = _tol(dtype)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_match_jax(dtype, jax_side, port_grads):
    tag = f"{NAME}_{dtype}"
    loss, *grads = port_grads(dtype)
    want, _ = load(jax_side, tag, "grad")
    assert len(grads) == len(want) == 11
    np.testing.assert_allclose(loss.item(), load(jax_side, tag, "out")[0][0],
                               rtol=_tol(dtype))
    for i, (g, w) in enumerate(zip(grads, want)):
        assert tuple(g.shape) == w.shape and np.linalg.norm(w) > 0, i
        assert norm_err(g, w) <= 2e-2, (i, norm_err(g, w))


def test_64_ranks_equal_the_one_rank_step(port_grads):
    """On the JAX inputs, float32."""
    got, want = port_grads("float32"), port_grads("float32", 1)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-5)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert norm_err(g, w.numpy()) <= 1e-5, i


@pytest.mark.parametrize("dtype", DTYPES)
def test_trace_holds_the_jax_capture(dtype, jax_side, port_traces):
    port = port_traces(NAME, dtype)
    check_yardstick(port, jax_side / f"ref_{NAME}_{dtype}", dtype, 64)
    from tpusim_torch.trace.format import load_trace

    for path in (port, jax_side / f"ref_{NAME}_{dtype}"):
        mod = load_trace(path).modules[NAME]
        assert sum(o.opcode == "while" for c in mod.computations.values()
                   for o in c.ops) == 2

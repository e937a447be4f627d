"""``resnet50_train`` in the port against the JAX package, on the CPU, at
batch 8, 32×32 images and 10 classes: the train step's outputs and
gradients held to the JAX step's and their float64 evaluation, its trace
to the JAX CPU capture, and the convolution gradients, pad folding and
pooling backward of its lowering (the helpers and their reasons are in
``tests/test_torch_resnet.py``).
"""

from __future__ import annotations

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_models import check_yardstick, port_trace_maker, stats  # noqa: E402
from test_torch_resnet import (  # noqa: E402
    DTYPES,
    SMALL,
    check_gradients,
    check_step,
    jax_side_for,
    outputs,
    resnet_kw,
    train_trace_checks,
)
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402

NAME = "resnet50_train"


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    side = jax_side_for(tmp_path_factory, NAME, 1, SMALL["batch"])
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    """The port's captures, both dtypes made at once: the first test
    takes them while the JAX side still runs."""
    get = port_trace_maker(tmp_path_factory.mktemp("port_side"), resnet_kw)
    for dtype in DTYPES:
        get(NAME, dtype)
    return get


def test_trace_prices_alike_and_writes_xla_transposes(port_traces):
    path = port_traces(NAME, "float32")
    assert stats(path) == stats(path, ref_simulate)
    train_trace_checks((path / "modules" / f"{NAME}.hlo").read_text())


def _module(dtype: str):
    return get_workload(NAME).build(device="cpu", **resnet_kw(NAME, dtype))[0]


@pytest.fixture(scope="module")
def steps(jax_side):
    """The port's step on the JAX inputs, once per dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = outputs(_module(dtype), jax_side, f"{NAME}_{dtype}")
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_matches_jax(dtype, jax_side, steps):
    check_step(steps(dtype), jax_side, f"{NAME}_{dtype}", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_match_jax(dtype, jax_side, steps):
    check_gradients(steps(dtype), jax_side, f"{NAME}_{dtype}", dtype,
                    _module(dtype).names)


@pytest.mark.parametrize("dtype", DTYPES)
def test_trace_holds_the_jax_capture(dtype, jax_side, port_traces):
    check_yardstick(port_traces(NAME, dtype), jax_side / f"ref_{NAME}_{dtype}",
                    dtype, 1, ("v5e", "v5p"))

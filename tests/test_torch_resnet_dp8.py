"""``resnet50_dp8`` in the port against the JAX package, on the CPU, on an
8-device mesh at 10 classes and 32×32 images: its outputs and gradients
held to the JAX step's and their float64 evaluation (the helpers and
their reasons are in ``tests/test_torch_resnet.py``), the 8 ranks held to
the one-rank step on the whole batch, and its trace to the JAX CPU-mesh
capture (206 all-reduces, their bytes and the command list equal at
float32).

The global batch is 16, two samples per rank: at one sample per rank
(batch 8) XLA:CPU rewrites the statistics of the last stage's 1×1
batch-norms (sums over a single element) into bitcasts that then
coincide and count once in its all-reduce tuples, and the head's one-row
products into non-MXU ops in bfloat16 — rewrites of size-1 dims, not of
the model, which the port's lowering does not make.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import (  # noqa: E402
    check_yardstick,
    norm_err,
    port_trace_maker,
    stats,
)
from test_torch_resnet import (  # noqa: E402
    DTYPES,
    SMALL,
    check_gradients,
    check_step,
    jax_side_for,
    outputs,
    resnet_kw,
)
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402

NAME = "resnet50_dp8"
BATCH = 16


def _kw(name: str, dtype: str) -> dict:
    return resnet_kw(name, dtype, BATCH)


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    side = jax_side_for(tmp_path_factory, NAME, 8, BATCH)
    yield side
    side.stop()


@pytest.fixture(scope="module")
def jax_side(jax_runs) -> Path:
    return jax_runs.root


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    """The port's captures, both dtypes made at once: the first test
    takes them while the JAX side still runs."""
    get = port_trace_maker(tmp_path_factory.mktemp("port_side"), _kw)
    for dtype in DTYPES:
        get(NAME, dtype)
    return get


def test_trace_prices_alike_with_the_captures_all_reduces(port_traces):
    path = port_traces(NAME, "float32")
    st = stats(path)
    assert st == stats(path, ref_simulate)
    assert st["tot_collective_count"] == 206


def _module(dtype: str, **over):
    return get_workload(NAME).build(device="cpu", **(_kw(NAME, dtype) | over))


@pytest.fixture(scope="module")
def steps(jax_side):
    """The port's 8 ranks on the JAX inputs, once per dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = outputs(_module(dtype)[0], jax_side,
                                   f"{NAME}_{dtype}")
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_matches_jax(dtype, jax_side, steps):
    check_step(steps(dtype), jax_side, f"{NAME}_{dtype}", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_match_jax(dtype, jax_side, steps):
    check_gradients(steps(dtype), jax_side, f"{NAME}_{dtype}", dtype,
                    _module(dtype)[0].names)


def test_eight_ranks_equal_the_one_rank_step():
    """In float64, where the statistics are float64 too: the 8 ranks'
    synchronized batch-norms and all-reduced gradients against the
    one-rank step on the whole batch (in float32 the network's
    conditioning spreads them by up to 2e-2)."""
    from tpusim_torch.models.resnet import ResNet50Train

    sharded, args = _module("float32")
    args = tuple(a.double() if a.is_floating_point() else a for a in args)
    single = ResNet50Train(SMALL["num_classes"], BATCH)
    assert sharded.world == 8 and single.world == 1
    got, want = sharded.grads(*args), single.grads(*args)
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-12)
    for name, g, w in zip(sharded.names, got[1:], want[1:]):
        assert g.dtype == torch.float64, name
        assert norm_err(g, w.numpy()) <= 1e-10, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_trace_holds_the_jax_capture(dtype, jax_side, port_traces):
    check_yardstick(port_traces(NAME, dtype), jax_side / f"ref_{NAME}_{dtype}",
                    dtype, 8)


#: 108 independent all-reduces of 4 MiB each (432 MiB) on a 2-device mesh,
#: compiled over abstract arguments
_COMBINER = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
k, n = 108, 1 << 20
f = jax.shard_map(lambda *xs: tuple(jax.lax.psum(x * 2, "dp") for x in xs),
                  mesh=mesh, in_specs=(P("dp"),) * k, out_specs=(P(),) * k)
text = jax.jit(f).lower(
    *[jax.ShapeDtypeStruct((2 * n,), jnp.float32)] * k).compile().as_text()
print(sum(" all-reduce(" in ln for ln in text.splitlines()))
"""


def test_the_yardsticks_combiner_splits_no_tuple_by_bytes(cpu_mesh_runner):
    """The all-reduce tuples read off the JAX capture at test shapes are
    those at registered width: XLA:CPU's combiner merges independent
    all-reduces into one tuple past 432 MiB, four times the ~102 MB of
    ``resnet50_dp8``'s float32 gradients at 1000 classes, and as many
    operands (108) as its main tuple."""
    assert cpu_mesh_runner(_COMBINER, 2).split() == ["1"]

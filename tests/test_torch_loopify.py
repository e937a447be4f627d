"""``loopify`` in the port against the JAX package's, on the CPU.

For ``matmul_chain`` (m = k = 256, depth 2), ``mlp_train_step`` (a small
width) and ``flash_attention_pallas`` ([2, 128, 32] f32; the port's plain
route, the JAX side through Pallas interpret mode), with the same
numpy-seeded inputs in both packages:

* the K = 4 looped outputs agree within rtol 1e-4 (atol 1e-4 of the
  output's largest magnitude) at float32;
* the captured loop's recovered trip count is K in both packages;
* the engine's MXU flops of the looped capture over K equal one step's in
  each package, and the port's equal the JAX package's where both price
  the work (the JAX CPU capture of the Pallas kernel is its interpreted
  grid, the port's one ``custom-call`` with no cost estimate).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpusim.harness.correlate import loopify as ref_loopify  # noqa: E402
from tpusim.models import get_workload as ref_get_workload  # noqa: E402
from tpusim.timing.config import load_config as ref_load_config  # noqa: E402
from tpusim.timing.cost import (  # noqa: E402
    while_trip_count as ref_known_trips,
)
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.loop_analysis import (  # noqa: E402
    infer_trip_count as ref_trip_count,
)
from tpusim.tracer.capture import capture as ref_capture  # noqa: E402
from tpusim_torch.harness.correlate import Looped, loopify  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.cost import while_trip_count  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.loop_analysis import infer_trip_count  # noqa: E402
from tpusim_torch.tracer.capture import capture  # noqa: E402

K = 4
SMALL = {
    "matmul_chain": dict(m=256, k=256, depth=2, dtype="float32"),
    "mlp_train_step": dict(batch=16, width=32, depth=2, dtype="float32",
                           lr=1e-2),
    "flash_attention_pallas": dict(batch=1, heads=2, seq=128, head_dim=32,
                                   dtype="float32"),
}
NAMES = list(SMALL)
#: workloads whose one step both packages price with the same MXU flops
SAME_WORK = ("matmul_chain", "mlp_train_step")


@pytest.fixture(autouse=True)
def _jax_default_precision():
    """The JAX workloads are written for JAX's 32-bit mode; another test in
    the same process may have switched x64 on."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(JAX fn, JAX args, port module, port args) on the same numpy
    inputs: each leaf N(0, 1) / sqrt(its last dim), seed 0."""
    fn, ref_args = ref_get_workload(name).build(**SMALL[name])
    leaves, treedef = jax.tree_util.tree_flatten(ref_args)
    rng = np.random.default_rng(0)
    arrays = [(rng.standard_normal(np.shape(leaf))
               / np.sqrt(np.shape(leaf)[-1])).astype(np.float32)
              for leaf in leaves]
    module, _ = get_workload(name).build(device="cpu", **SMALL[name])
    return (fn, jax.tree_util.tree_unflatten(treedef, arrays), module,
            tuple(torch.from_numpy(a.copy()) for a in arrays))


@functools.lru_cache(maxsize=None)
def _captures(name: str):
    fn, ref_args, module, args = _case(name)
    cfg, ref_cfg = load_config(arch="v5e"), ref_load_config(arch="v5e")
    looped = capture(loopify(module, K), *args, name=name)
    one = capture(module, *args, name=name)
    ref_looped = ref_capture(ref_loopify(fn, K), *ref_args, name=name)
    ref_one = ref_capture(fn, *ref_args, name=name)
    return {
        "port": (looped.module, Engine(cfg).run(looped.module),
                 Engine(cfg).run(one.module)),
        "jax": (ref_looped.module, RefEngine(ref_cfg).run(ref_looped.module),
                RefEngine(ref_cfg).run(ref_one.module)),
    }


@pytest.mark.parametrize("name", NAMES)
def test_looped_outputs_equal_the_jax_loop(name):
    fn, ref_args, module, args = _case(name)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.jit(ref_loopify(fn, K))(*ref_args))]
    with torch.no_grad():
        got = loopify(module, K)(*args)
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def _trips(module, known, infer) -> int:
    """The entry's one loop's trip count as the engine resolves it: the
    recorded ``known_trip_count``, else the induction-variable pattern."""
    entry = module.computation(module.entry_name)
    whiles = [op for op in entry.ops if op.opcode == "while"]
    assert len(whiles) == 1, [op.name for op in whiles]
    trips = known(whiles[0], 0)
    return trips if trips > 0 else infer(module, entry, whiles[0], -1)


@pytest.mark.parametrize("name", NAMES)
def test_captured_loop_recovers_k_trips(name):
    caps = _captures(name)
    assert _trips(caps["port"][0], while_trip_count, infer_trip_count) == K
    assert _trips(caps["jax"][0], ref_known_trips, ref_trip_count) == K
    assert caps["port"][1].unknown_trip_loops == 0
    assert caps["jax"][1].unknown_trip_loops == 0


@pytest.mark.parametrize("name", NAMES)
def test_looped_flops_over_k_equal_one_step(name):
    caps = _captures(name)
    for pkg in ("port", "jax"):
        _, looped, one = caps[pkg]
        assert looped.mxu_flops / K == one.mxu_flops, pkg
    if name in SAME_WORK:
        assert caps["port"][1].mxu_flops == caps["jax"][1].mxu_flops
        assert caps["port"][1].mxu_flops > 0


def test_carry_rules():
    """A matching output is threaded; with none, the carry still depends
    on the output (the int8 product feeds its first operand), and a
    train step threads all its parameters (``carry_leaves``)."""
    mod, args = get_workload("matmul_int8").build(device="cpu", m=32, n=32,
                                                  k=32)
    looped = loopify(mod, 3)
    assert isinstance(looped, Looped) and looped.carry_leaves == 1
    with torch.no_grad():
        out = looped(*args)
    assert out.dtype == torch.int8 and torch.equal(out, args[0])
    text = capture(looped, *args, name="i8").hlo_text
    assert "dynamic-update-slice(" in text and " while(" in text
    step, _ = get_workload("mlp_train_step").build(
        device="cpu", batch=4, width=8, depth=3, dtype="float32", lr=1e-2)
    assert loopify(step, 2).carry_leaves == 6
    assert loopify(step, 2).train_step

"""The port's SPMD layer, ``tpusim_torch.spmd``, on the CPU.

(i)   each collective's vmap rule equals a plain loop over the ranks, on
      1-D and 2-D meshes and on every axis of them;
(ii)  gradients through the differentiable wrappers equal ``torch.func``
      on the unsharded function: Megatron's f/g pair (``pvary``/``psum``)
      on a column- then row-parallel MLP, and the data-movement ops
      (``all_to_all``, ``ppermute``, ``all_gather`` / ``psum_scatter``)
      under the sum of every rank's loss;
(iii) ``make_fx`` over fake tensors keeps one graph node per collective,
      in a forward and in a ``torch.func.grad_and_value`` train step;
(iv)  the shards: ``shard`` / ``unshard`` round trips, ``run_ranks`` on
      global arrays, replicas of an output that disagree raise, and a
      collective outside ``run_ranks`` raises.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch._decomp import core_aten_decompositions  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from tpusim_torch import spmd  # noqa: E402
from tpusim_torch.spmd import Mesh, P, groups, run_ranks  # noqa: E402

MESHES = {"1d": Mesh((4,), ("x",)), "2d": Mesh((2, 3), ("dp", "tp"))}
#: (mesh id, axis) pairs: every axis of each mesh, and both axes at once
AXES = [("1d", "x"), ("2d", "dp"), ("2d", "tp"), ("2d", ("dp", "tp"))]


def _t(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _group_of(mesh: Mesh, axis, rank: int) -> list[int]:
    return next(g for g in groups(mesh.shape, mesh.axes(axis)) if rank in g)


def _per_rank(x: torch.Tensor, mesh: Mesh, axis, op: str, *a):
    """The collective computed rank by rank from the definition."""
    out = []
    for r in range(mesh.size):
        grp = _group_of(mesh, axis, r)
        pos = grp.index(r)
        g = len(grp)
        if op == "psum":
            out.append(sum(x[q] for q in grp))
        elif op == "pmax":
            out.append(torch.stack([x[q] for q in grp]).amax(0))
        elif op == "all_gather":
            out.append(torch.cat([x[q] for q in grp], a[0]))
        elif op == "psum_scatter":
            out.append(sum(x[q] for q in grp).chunk(g, a[0])[pos])
        elif op == "all_to_all":
            split, concat = a
            out.append(torch.cat([x[q].chunk(g, split)[pos] for q in grp],
                                 concat))
        elif op == "ppermute":
            src = [s for s, d in a[0] if d == pos]
            out.append(x[grp[src[0]]] if src else torch.zeros_like(x[r]))
        elif op == "axis_index":
            out.append(torch.tensor(pos, dtype=torch.int32))
    return torch.stack(out)


def _shift(g):
    return [(j, (j + 1) % g) for j in range(g - 1)]


@pytest.mark.parametrize("mesh_id,axis", AXES)
@pytest.mark.parametrize("op", ["psum", "pmax", "all_gather", "psum_scatter",
                                "all_to_all", "ppermute", "axis_index"])
def test_vmap_rule_equals_a_loop_over_the_ranks(op, mesh_id, axis):
    mesh = MESHES[mesh_id]
    g = len(_group_of(mesh, axis, 0))
    x = _t(mesh.size, 2 * g, 3 * g)
    extra = {"all_gather": (1,), "psum_scatter": (0,), "all_to_all": (1, 0),
             "ppermute": (_shift(g),)}.get(op, ())
    fn = getattr(spmd, op)
    got = torch.func.vmap(lambda v: fn(v, mesh, axis, *extra))(x)
    want = _per_rank(x, mesh, axis, op, *extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_psum_coalesced_equals_one_psum_each():
    mesh = MESHES["2d"]
    a, b = _t(6, 4, 5), _t(6, 7, seed=1)
    got = torch.func.vmap(
        lambda u, v: spmd.psum_coalesced([u, v], mesh, "dp"))(a, b)
    for g, x in zip(got, (a, b)):
        torch.testing.assert_close(g, _per_rank(x, mesh, "dp", "psum"))


def test_bf16_sums_accumulate_in_f32():
    mesh = MESHES["1d"]
    x = torch.full((4, 8), 1.0, dtype=torch.bfloat16)
    x[0] = 256.0
    got = torch.func.vmap(lambda v: spmd.psum(v, mesh, "x"))(x)
    # 256 + 1 + 1 + 1 = 259 rounds to 260 in bf16; adding in bf16 from
    # the left would stick at 256
    assert float(got[0, 0]) == 260.0 and got.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (ii) gradients against torch.func on the unsharded function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_id,axis", [("1d", "x"), ("2d", "tp")])
def test_megatron_f_and_g_give_the_unsharded_gradients(mesh_id, axis):
    mesh = MESHES[mesh_id]
    w0, w1, x = _t(8, 24), _t(24, 8, seed=1), _t(5, 8, seed=2)

    def loss(ws, xs):
        h = spmd.pvary(xs, mesh, axis) @ ws[0]
        y = spmd.psum(torch.relu(h) @ ws[1], mesh, axis)
        return (y ** 2).sum()

    def step(a, b, xs):
        (ga, gb), gx = torch.func.grad(loss, argnums=(0, 1))((a, b), xs)
        return ga, gb, gx

    # the weights split over `axis`, replicated over any other axis (whose
    # replicas compute the same; unshard reads coordinate 0 of it)
    got = run_ranks(step, mesh, w0, w1, x,
                    in_specs=(P(None, axis), P(axis, None), P()),
                    out_specs=(P(None, axis), P(axis, None), P()))

    def unsharded(a, b, xs):
        return ((torch.relu(xs @ a) @ b) ** 2).sum()

    want = torch.func.grad(unsharded, argnums=(0, 1, 2))(w0, w1, x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _sum_of_rank_losses(fn, mesh, x, c, spec_x, spec_c):
    """d/dx of sum_r <c_r, fn(x_r)> through run_ranks."""
    def step(xs, cs):
        return torch.func.grad(lambda v: (fn(v) * cs).sum())(xs)

    return run_ranks(step, mesh, x, c, in_specs=(spec_x, spec_c),
                     out_specs=spec_x)


@pytest.mark.parametrize("op", ["all_to_all", "ppermute", "all_gather",
                                "psum_scatter"])
def test_data_movement_gradients_equal_the_unsharded(op):
    """The rank program's gradient of its own loss, through the transpose
    collective, is the gradient of the sum of every rank's loss."""
    mesh = MESHES["1d"]
    n = mesh.size
    x = _t(4 * n, 8)
    extra = {"all_to_all": (1, 0), "ppermute": ([(j, (j + 1) % n)
                                                  for j in range(n)],),
             "all_gather": (0,), "psum_scatter": (1,)}[op]

    def fn(v):
        return getattr(spmd, op)(v, mesh, "x", *extra)

    # each rank's output from the global input, and a cotangent weight
    # per rank, passed as one global array sharded the same way
    outs = torch.func.vmap(fn)(spmd.shard(x, mesh, P("x")))
    c = _t(*outs.shape, seed=3)
    got = _sum_of_rank_losses(fn, mesh, x, c.reshape(-1, *c.shape[2:]),
                              P("x"), P("x"))

    def unsharded(glob):
        # the collective from its definition, rank by rank: no custom op
        per = _per_rank(spmd.shard(glob, mesh, P("x")), mesh, "x", op,
                        *extra)
        return (per * c).sum()

    want = torch.func.grad(unsharded)(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (iii) one graph node per collective
# ---------------------------------------------------------------------------


def _collective_nodes(gm) -> list[str]:
    return [str(n.target).split(".")[1] for n in gm.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("tpusim_torch.")]


def test_make_fx_keeps_one_node_per_collective():
    mesh = MESHES["2d"]

    def fwd(x):
        y = spmd.all_to_all(x, mesh, "tp", 1, 0)
        y = spmd.ppermute(y, mesh, "tp", [(0, 1)])
        y = spmd.all_gather(y, mesh, "dp", 1)
        y = spmd.psum_scatter(y, mesh, "dp", 1)
        i = spmd.axis_index(x, mesh, "tp").float()
        return spmd.psum(y + i, mesh, "tp") + spmd.pmax(y, mesh, "dp")

    gm = make_fx(fwd, decomposition_table=core_aten_decompositions(),
                 tracing_mode="fake")(_t(6, 9))
    assert sorted(_collective_nodes(gm)) == sorted([
        "all_to_all", "collective_permute", "all_gather", "reduce_scatter",
        "axis_index", "all_reduce", "all_reduce"])


def test_make_fx_of_a_train_step_holds_the_backward_collectives():
    mesh = MESHES["2d"]

    def loss(ws, x):
        h = spmd.pvary(x, mesh, "tp") @ ws[0]
        y = spmd.psum(torch.relu(h) @ ws[1], mesh, "tp")
        return (y ** 2).sum()

    def step(a, b, x):
        (ga, gb, gx), val = torch.func.grad_and_value(
            lambda p: loss(p[:2], p[2]))((a, b, x))
        ga, gb = spmd.psum_coalesced([ga, gb], mesh, "dp")
        return val, ga, gb, gx

    gm = make_fx(step, decomposition_table=core_aten_decompositions(),
                 tracing_mode="fake")(_t(8, 4), _t(4, 8), _t(5, 8))
    # forward g, backward f (x's gradient), and the dp all-reduce
    assert sorted(_collective_nodes(gm)) == [
        "all_reduce", "all_reduce", "all_reduce_coalesced"]


# ---------------------------------------------------------------------------
# (iv) shards and the runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [P("dp", "tp"), P(None, "tp"), P("tp"),
                                  P(("dp", "tp")), P()])
def test_shard_unshard_round_trip(spec):
    mesh = MESHES["2d"]
    x = _t(6, 12)
    stacked = spmd.shard(x, mesh, spec)
    assert stacked.shape[0] == mesh.size
    torch.testing.assert_close(spmd.unshard(stacked, mesh, spec), x,
                               rtol=0, atol=0)


def test_run_ranks_on_global_arrays():
    mesh = MESHES["2d"]
    x = _t(4, 6)
    out = run_ranks(lambda v: spmd.psum(v, mesh, "tp") / 3, mesh, x,
                    in_specs=(P("dp", "tp"),), out_specs=P("dp", None))
    want = x.reshape(4, 3, 2).sum(1) / 3
    torch.testing.assert_close(out, want)


def test_a_collective_outside_run_ranks_raises():
    with pytest.raises(RuntimeError, match="outside run_ranks"):
        spmd.psum(_t(4), MESHES["1d"], "x")


def test_a_shard_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        spmd.shard(_t(5, 4), MESHES["1d"], P("x"))


@pytest.mark.parametrize("spec,axis", [(P(), "tp"), (P("dp", None), "dp"),
                                       (P(None, "tp"), ("dp", "tp"))])
def test_replicas_that_disagree_raise(spec, axis):
    """An output claimed replicated over an axis it varies over (a missing
    psum) is refused, as ``shard_map``'s replication check refuses it."""
    mesh = MESHES["2d"]
    x = _t(4, 6)
    with pytest.raises(RuntimeError, match="disagrees with rank 0"):
        run_ranks(lambda v: v * 2, mesh, x,
                  in_specs=(P("dp", "tp"),), out_specs=spec)
    # summed over the axis the spec leaves out, the replicas agree
    rest = tuple(n for n in mesh.names
                 if n not in [a for e in spec if e
                              for a in ((e,) if isinstance(e, str) else e)])
    run_ranks(lambda v: spmd.psum(v, mesh, rest), mesh, x,
              in_specs=(P("dp", "tp"),), out_specs=spec)

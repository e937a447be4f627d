"""One rank a process, ``tpusim_torch.spmd_procs``, on the CPU (gloo).

A :class:`RankGroup` of four CPU processes (one module-scoped group, each
rank on one intra-op thread) against the vmap runner
(``tpusim_torch.spmd.run_ranks``) on the same global arrays:

(i)   every collective (``psum``, ``pmax``, ``psum_coalesced``,
      ``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute`` with
      a rank no pair targets, ``axis_index``) over a ``(2, 2)`` mesh on
      each axis, on both axes in either order, and over a 1-D mesh of 4:
      data movement and ``pmax`` equal by bits, float32 sums within 1e-6;
(ii)  bfloat16 sums accumulated in float32 and rounded once: within one
      bf16 rounding of the exact sum, and the value a bf16 ring would
      round away kept;
(iii) gradients through each differentiable wrapper within 1e-5;
(iv)  the replica check raising for a rank that disagrees; a rank that
      raises (its peers blocked in a collective), and one that hangs
      past the group's timeout, surfacing in the parent with no process
      left; two groups started at once not colliding;
(v)   the routing: no card, no group; a group of another size refused;
      the backend follows from the devices.

The rank programs are module-level classes, so each rank process
imports them by name.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpusim_torch import spmd, spmd_procs  # noqa: E402
from tpusim_torch.spmd import Mesh, P, SpmdModule  # noqa: E402
from tpusim_torch.spmd_procs import (  # noqa: E402
    RankFailure,
    RankGroup,
    backend_for,
    ranks_for,
    runner_text,
)

MESHES = {"2x2": Mesh((2, 2), ("a", "b")), "4": Mesh((4,), ("d",))}
#: (mesh id, axis): each axis of the 2x2 mesh, both in either order (the
#: group order then differs from the process group's ascending one), and
#: the 1-D mesh
AXES = [("2x2", "a"), ("2x2", "b"), ("2x2", ("b", "a")), ("2x2", ("a", "b")),
        ("4", "d")]
OPS = ["psum", "pmax", "psum_coalesced", "all_gather", "psum_scatter",
       "all_to_all", "ppermute", "axis_index"]
#: ops that only move data: equal by bits
MOVES = {"all_gather", "all_to_all", "ppermute", "axis_index", "pmax"}
#: every rank's local block: [4, 3, 4]
LOCAL = (4, 3, 4)


def _names(mesh: Mesh, axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _rest(mesh: Mesh, axis) -> tuple:
    """The spec of an output replicated over ``axis``: sharded over the
    mesh's other axes."""
    rest = tuple(n for n in mesh.names if n not in _names(mesh, axis))
    return P(rest if rest else None)


class Collective(SpmdModule):
    """One collective on a local block ``[4, 3, 4]``: each rank holds its
    own block of ``x`` (sharded over every mesh axis on dim 0)."""

    def __init__(self, mesh: Mesh, axis, op: str):
        super().__init__()
        self.mesh, self.axis, self.op = mesh, axis, op
        every = P(mesh.names)
        self.in_specs = (every,)
        replicated = op in ("psum", "pmax", "psum_coalesced", "all_gather")
        out = _rest(mesh, axis) if replicated else every
        self.out_specs = (out, out) if op == "psum_coalesced" else out

    def forward(self, x):
        m, a, g = self.mesh, self.axis, _size(self.mesh, self.axis)
        if self.op == "psum":
            return spmd.psum(x, m, a)
        if self.op == "pmax":
            return spmd.pmax(x, m, a)
        if self.op == "psum_coalesced":
            return spmd.psum_coalesced([x, x * 2], m, a)
        if self.op == "all_gather":
            return spmd.all_gather(x, m, a, 2)
        if self.op == "psum_scatter":
            return spmd.psum_scatter(x, m, a, 0)
        if self.op == "all_to_all":
            return spmd.all_to_all(x, m, a, 0, 2)
        if self.op == "ppermute":
            # position 0 is no pair's target: it receives zeros
            return spmd.ppermute(x, m, a, [(j, j + 1) for j in range(g - 1)])
        return spmd.axis_index(x, m, a).reshape(1)


def _size(mesh: Mesh, axis) -> int:
    return int(np.prod([mesh.shape[i] for i in mesh.axes(axis)]))


def _weights(t: torch.Tensor) -> torch.Tensor:
    """The same cotangent weights on every rank."""
    return torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape).sin()


class GradOf(SpmdModule):
    """The gradient of ``sum(w * op(x))`` through one differentiable
    wrapper, per rank."""

    def __init__(self, mesh: Mesh, axis, op: str):
        super().__init__()
        self.mesh, self.axis, self.op = mesh, axis, op
        self.in_specs = (P(mesh.names),)
        self.out_specs = P(mesh.names)

    def forward(self, x):
        m, a, g = self.mesh, self.axis, _size(self.mesh, self.axis)
        ops = {
            "psum": lambda t: [spmd.psum(t * t, m, a)],
            "pvary": lambda t: [spmd.pvary(t, m, a) * t],
            "psum_coalesced": lambda t: list(
                spmd.psum_coalesced([t * t, t.sin()], m, a)),
            "pvary_coalesced": lambda t: [
                y * t for y in spmd.pvary_coalesced([t, t.cos()], m, a)],
            "all_gather": lambda t: [spmd.all_gather(t * t, m, a, 1)],
            "psum_scatter": lambda t: [spmd.psum_scatter(t * t, m, a, 0)],
            "all_to_all": lambda t: [spmd.all_to_all(t * t, m, a, 2, 0)],
            "ppermute": lambda t: [spmd.ppermute(
                t * t, m, a, [(j, (j + 1) % g) for j in range(g)])],
        }

        def loss(t):
            return sum((_weights(y) * y).sum() for y in ops[self.op](t))

        return torch.func.grad(loss)(x)


class RankVaries(SpmdModule):
    """Returns its rank's position under a replicated out-spec."""

    def __init__(self):
        super().__init__()
        self.mesh = MESHES["4"]
        self.in_specs = (P("d"),)
        self.out_specs = P()

    def forward(self, x):
        return spmd.axis_index(x, self.mesh, "d").float().reshape(1)


class RaisesOnRank2(SpmdModule):
    """Rank 2 raises; its peers wait for it in an all-reduce."""

    def __init__(self):
        super().__init__()
        self.mesh = MESHES["4"]
        self.in_specs = (P("d"),)
        self.out_specs = P("d")

    def forward(self, x):
        if int(spmd.axis_index(x, self.mesh, "d")) == 2:
            raise ValueError("boom on rank 2")
        return spmd.psum(x, self.mesh, "d")


class HangsOnRank1(SpmdModule):
    def __init__(self, world: int = 2):
        super().__init__()
        self.mesh = Mesh((world,), ("d",))
        self.in_specs = (P("d"),)
        self.out_specs = P("d")

    def forward(self, x):
        if int(spmd.axis_index(x, self.mesh, "d")) == 1:
            time.sleep(120)
        return x * 2


def _x(n: int = 4, dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n * LOCAL[0], *LOCAL[1:])).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


@pytest.fixture(scope="module")
def group4(pair):
    with RankGroup(["cpu"] * 4) as g:
        yield g
    assert g.alive() == []


@pytest.fixture(scope="module", autouse=True)
def pair():
    """Two groups of two, started at once with the module (beside
    ``group4``)."""
    groups = [RankGroup(["cpu"] * 2).start(), RankGroup(["cpu"] * 2).start()]
    yield groups
    for g in groups:
        g.close()
    assert all(g.alive() == [] for g in groups)


def _listed(out) -> list[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("mesh_id,axis", AXES)
@pytest.mark.parametrize("op", OPS)
def test_every_collective_equals_the_vmap_runner(op, mesh_id, axis, group4):
    module = Collective(MESHES[mesh_id], axis, op)
    x = _x()
    with torch.no_grad():
        got = _listed(group4.run_module(module, x))
        want = _listed(module.run(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if op in MOVES:
            assert torch.equal(g, w), (op, axis)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    if op == "ppermute":
        # the group position no pair targets received zeros
        assert (got[0] == 0).all(dim=(1, 2)).any()


@pytest.mark.parametrize("mesh_id,axis", [("2x2", ("b", "a")), ("4", "d")])
def test_bf16_sums_accumulate_in_f32_once(mesh_id, axis, group4):
    module = Collective(MESHES[mesh_id], axis, "psum")
    x = _x(dtype=torch.bfloat16, seed=3)
    with torch.no_grad():
        got = group4.run_module(module, x)
        want = module.run(x)
    exact = module.run(x.double())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the exact sum (half an ulp, <= 2^-8 relative)
    tol = exact.abs() * (2.0 ** -8 + 1e-6)
    assert ((got.double() - exact).abs() <= tol).all()
    assert ((want.double() - exact).abs() <= tol).all()
    # 1 + 3 x 2^-9: a ring of bf16 adds rounds each 2^-9 away (1.0); one
    # rounding of the float32 sum gives 1 + 2^-7
    ring = torch.full((16, 3, 4), 2.0 ** -9, dtype=torch.bfloat16)
    ring[0:4] = 1.0
    one = Collective(MESHES["4"], "d", "psum")
    with torch.no_grad():
        kept = group4.run_module(one, ring)
    assert (kept == 1 + 2.0 ** -7).all()


@pytest.mark.parametrize("axis", ["a", ("b", "a")])
@pytest.mark.parametrize("op", ["psum", "pvary", "psum_coalesced",
                                "pvary_coalesced", "all_gather",
                                "psum_scatter", "all_to_all", "ppermute"])
def test_gradients_through_each_wrapper_equal_the_vmap_runner(op, axis,
                                                              group4):
    module = GradOf(MESHES["2x2"], axis, op)
    x = _x(seed=5)
    got, want = group4.run_module(module, x), module.run(x)
    assert got.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_large_shards_travel_through_files(group4):
    """Shards and outputs of 4 MiB a rank go through the group's
    directory, which keeps nothing after the call."""
    import os

    module = Collective(MESHES["4"], "d", "all_gather")
    x = torch.randn((4 * 1024, 256, 4),
                    generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = group4.run_module(module, x)
        want = module.run(x)
    assert torch.equal(got, want)
    assert x[:1024].numel() * 4 > spmd_procs._INLINE_BYTES
    assert not [f for f in os.listdir(group4._spool) if f.endswith(".pkl")]


def lossy_profile(rank, fn, args):
    """A rank's profile in which rank 1 loses its first session's
    executions (as the profiler can on the card)."""
    from tpusim_torch.harness import correl_ops

    real, sessions = correl_ops._parse_profile, []

    def lossy(prof, device):
        execs = real(prof, device)
        sessions.append(len(execs))
        if rank.rank == 1 and len(sessions) == 1:
            for e in execs:
                e["lost"] = True
        return execs

    correl_ops._parse_profile = lossy
    try:
        prof = correl_ops._profile_rank(rank, fn, args, None, 1, 2, False)
    finally:
        correl_ops._parse_profile = real
    return len(sessions), prof.lost, len(prof.execs)


def test_ranks_run_the_same_profiler_sessions(group4):
    """One rank short of whole executions makes every rank run another
    session (a rank alone would wait in its collectives for peers)."""
    module = Collective(MESHES["4"], "d", "psum")
    group4.timeout, timeout = 60, group4.timeout
    try:
        got = group4.call(lossy_profile, [
            (module, s) for s in group4.shards(module.mesh, (_x(),),
                                               module.in_specs)])
    finally:
        group4.timeout = timeout
    assert got == [(2, 0, 2), (2, 2, 2), (2, 0, 2), (2, 0, 2)]


def test_replicas_that_disagree_raise(group4):
    with pytest.raises(RuntimeError, match="rank 1 .* disagrees"):
        group4.run_module(RankVaries(), _x())
    # the check runs in the parent: the group lives on
    assert len(group4.alive()) == 4
    with torch.no_grad():
        out = group4.run_module(Collective(MESHES["4"], "d", "psum"), _x())
    assert out.shape == (4, 3, 4)


def test_routing_on_the_cpu():
    module = Collective(MESHES["4"], "d", "psum")
    cpu = torch.device("cpu")
    with ranks_for(module, cpu) as ranks:
        assert ranks is None
    assert runner_text(module, cpu) == "the vmap runner, all 4 ranks on cpu"
    with pytest.raises(ValueError, match="4 ranks on a group of 2"):
        with ranks_for(module, cpu, RankGroup(["cpu"] * 2)):
            pass
    group = RankGroup(["cpu"] * 4)
    assert runner_text(module, cpu, group) == (
        "4 rank processes over gloo on cpu x4")
    assert group.alive() == []           # describing starts nothing


@pytest.mark.parametrize("devices,backend", [
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cuda:0"], "gloo"),
    (["cuda", "cuda:1"], "nccl"), (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cpu"], "gloo")])
def test_the_backend_follows_from_the_devices(devices, backend):
    assert backend_for(devices) == backend


def test_two_groups_started_at_once_do_not_collide(pair):
    module = Collective(Mesh((2,), ("d",)), "d", "psum")
    xs = [_x(2, seed=7), _x(2, seed=8)]
    with ThreadPoolExecutor(2) as pool, torch.no_grad():
        outs = list(pool.map(lambda gx: gx[0].run_module(module, gx[1]),
                             zip(pair, xs)))
    for out, x in zip(outs, xs):
        with torch.no_grad():
            torch.testing.assert_close(out, module.run(x), rtol=1e-6,
                                       atol=1e-6)


def test_a_hung_rank_is_killed_at_the_timeout(pair):
    group = pair[0]
    group.start()
    procs = list(group._procs)
    group.timeout = 3
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match=r"ranks \[1\] of 2 did not answer"):
        group.run_module(HangsOnRank1(), torch.ones(4))
    assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in procs) and group.alive() == []


def test_a_rank_that_raises_surfaces_and_leaves_no_process(group4):
    """Rank 2 raises while its peers wait for it in an all-reduce: the
    parent gets rank 2's traceback and ends every rank.  (Last: it ends
    the module's group, which starts afresh if used again.)"""
    group4.start()
    procs = list(group4._procs)
    with pytest.raises(RankFailure) as err:
        group4.run_module(RaisesOnRank2(), _x())
    text = str(err.value)
    assert "rank 2 of 4" in text and "ValueError: boom on rank 2" in text
    assert "Traceback" in text and "forward" in text
    assert not any(p.is_alive() for p in procs) and group4.alive() == []

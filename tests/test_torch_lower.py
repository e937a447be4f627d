"""The core ATen → HLO lowering and its fusion pass, op by op.

Each entry of the op table gets a small graph (the collectives of
``tpusim_torch.spmd`` one each, over meshes of 4 and 8 devices).  The graph is captured on
the CPU, its trace dir loaded by both ``tpusim.trace.format.load_trace``
and the port's loader and simulated in both packages at v5e, and the
stats must be equal (``simulation_rate_kops`` and ``silicon_slowdown``
dropped); the HLO must hold the opcode the entry lowers to.  Fusion unit
cases check what fuses and what stays top level, and a scan's ``while``
resolves its trip count both from ``known_trip_count`` and from the
condition's ``compare`` alone.
"""

from __future__ import annotations

import json
import re

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch import spmd  # noqa: E402
from tpusim_torch.models.decode import dynamic_update_slice  # noqa: E402
from tpusim_torch.spmd import Mesh  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402
from tpusim_torch.trace.loop_analysis import infer_trip_count  # noqa: E402
from tpusim_torch.tracer.capture import capture, capture_to_dir  # noqa: E402


class Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _scan_cell(xs, w):
    from torch._higher_order_ops.scan import scan

    def cell(h, x):
        h = torch.tanh(x @ w + h)
        return h, h.clone()

    return scan(cell, torch.zeros(xs.shape[1], w.shape[1]), xs)[1]


def _t(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _ids(n, hi):
    return torch.arange(n, dtype=torch.int32) % hi


#: (case id, function, args, an opcode its HLO must hold)
CASES = [
    ("mm", lambda a, b: a @ b, (_t(16, 32), _t(32, 8)), "dot("),
    ("bmm", torch.bmm, (_t(2, 16, 32), _t(2, 32, 8)), "lhs_batch_dims={0}"),
    ("addmm", F.linear, (_t(16, 32), _t(8, 32), _t(8)), "dot("),
    ("mm_transposed", lambda a, b: a.t() @ b, (_t(32, 16), _t(32, 8)),
     "lhs_contracting_dims={0}"),
    ("conv2d", lambda x, w: F.conv2d(x, w, padding=1),
     (_t(2, 4, 8, 8), _t(6, 4, 3, 3)), "dim_labels=bf01_oi01->bf01"),
    ("conv2d_strided_bias", lambda x, w, b: F.conv2d(x, w, b, stride=2),
     (_t(2, 4, 9, 9), _t(6, 4, 3, 3), _t(6)), "stride=2x2"),
    ("conv2d_dilated_grouped", lambda x, w: F.conv2d(x, w, dilation=2,
                                                     groups=2),
     (_t(2, 4, 9, 9), _t(6, 2, 3, 3)), "feature_group_count=2"),
    ("conv2d_nhwc", lambda x, w: F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1), (_t(2, 8, 8, 4), _t(3, 3, 4, 6)),
     "dim_labels=b01f_01io->b01f"),
    ("add_broadcast", lambda a, b: a + b, (_t(4, 8), _t(8)), "add("),
    ("sub_alpha", lambda a, b: torch.sub(a, b, alpha=2), (_t(4, 8), _t(4, 8)),
     "subtract("),
    ("mul_scalar", lambda a: a * 3.0, (_t(4, 8),), "multiply("),
    ("div", lambda a, b: a / b, (_t(4, 8), _t(4, 1)), "divide("),
    ("maximum", torch.maximum, (_t(4, 8), _t(4, 8)), "maximum("),
    ("minimum", torch.minimum, (_t(4, 8), _t(4, 8)), "minimum("),
    ("exp", torch.exp, (_t(4, 8),), "exponential("),
    ("tanh", torch.tanh, (_t(4, 8),), "tanh("),
    ("sigmoid", torch.sigmoid, (_t(4, 8),), "logistic("),
    ("relu", torch.relu, (_t(4, 8),), "maximum("),
    ("neg", torch.neg, (_t(4, 8),), "negate("),
    ("rsqrt", lambda a: torch.rsqrt(a.abs() + 1), (_t(4, 8),), "rsqrt("),
    ("sqrt_log", lambda a: torch.log(torch.sqrt(a.abs() + 1)), (_t(4, 8),),
     "log("),
    ("pow2", lambda a: a ** 2, (_t(4, 8),), "multiply("),
    ("pow3", lambda a: a ** 3, (_t(4, 8),), "multiply("),
    ("pow_float", lambda a: a.abs() ** 1.7, (_t(4, 8),), "power("),
    ("where", lambda a, b: torch.where(a > 0, a, b), (_t(4, 8), _t(4, 8)),
     "select("),
    ("compare", lambda a, b: (a <= b).float(), (_t(4, 8), _t(4, 8)),
     "direction=LE"),
    ("to_bf16", lambda a: a.to(torch.bfloat16), (_t(4, 8),), "convert("),
    ("gelu_tanh", lambda a: F.gelu(a, approximate="tanh"), (_t(4, 8),),
     "tanh("),
    ("gelu_erf", F.gelu, (_t(4, 8),), "erf("),
    ("softmax", lambda a: torch.softmax(a, -1), (_t(4, 8),), "reduce("),
    ("sum", lambda a: a.sum(1), (_t(16, 32),), "to_apply="),
    ("sum_keepdim", lambda a: a.sum(0, keepdim=True), (_t(16, 32),),
     "reduce("),
    ("mean", lambda a: a.mean(), (_t(16, 32),), "reduce("),
    ("amax", lambda a: a.amax(-1), (_t(16, 32),), "maximum"),
    ("view", lambda a: a.reshape(8, 4) * 2, (_t(4, 8),), "bitcast("),
    ("permute", lambda a: a.permute(1, 0, 2), (_t(4, 8, 2),), "transpose("),
    ("expand", lambda a: a.expand(4, 8) + 1, (_t(1, 8),), "broadcast("),
    ("full", lambda a: a + torch.full((4, 8), 2.0), (_t(4, 8),),
     "constant("),
    ("arange", lambda a: a + torch.arange(8, dtype=torch.int32), (
        torch.zeros(4, 8, dtype=torch.int32),), "iota("),
    ("index_select", lambda t, i: torch.index_select(t, 0, i),
     (_t(64, 16), _ids(10, 64)), "slice_sizes={1,16}"),
    ("embedding", F.embedding, (_ids(10, 64), _t(64, 16)), "gather("),
    ("slice", lambda a: a[:, 2:6] * 2, (_t(4, 8),), "slice={[0:4], [2:6]}"),
    ("split", lambda a: torch.split(a, 4, dim=1)[1] + 1, (_t(4, 8),),
     "slice("),
    ("select", lambda a: a[1] + 1, (_t(4, 8),), "slice("),
    ("cat", lambda a, b: torch.cat([a, b], 1), (_t(4, 8), _t(4, 2)),
     "concatenate("),
    ("dynamic_update_slice", lambda c, u, p: dynamic_update_slice(c, u, p, 1),
     (_t(2, 16, 4), _t(2, 1, 4), torch.tensor(3, dtype=torch.int32)),
     "dynamic-update-slice("),
    ("tuple_output", lambda a: (a * 2, a.sum()), (_t(4, 8),), "tuple("),
    ("cos_sin", lambda a: torch.cos(a) * torch.sin(a), (_t(4, 8),),
     "cosine("),
    ("pow_scalar_base", lambda a: torch.pow(10000.0, a), (_t(4, 8),),
     "power("),
    ("bitwise_and", lambda a: torch.where((a > 0) & (a < 1), a, 0.0),
     (_t(4, 8),), "and("),
    ("bitwise_not", lambda a: torch.where(~(a > 0), a, 1.0), (_t(4, 8),),
     "not("),
    ("scatter_add_rows", lambda g, i: torch.ops.tpusim_torch.scatter_add_rows(
        g, i, 64), (_t(2, 5, 16), _ids(10, 64).reshape(2, 5)),
     "scatter("),
    ("scan", _scan_cell, (_t(5, 2, 4), _t(4, 4)), "while("),
]


def _stats(report) -> dict:
    stats = json.loads(report.stats.to_json())
    for k in ("simulation_rate_kops", "silicon_slowdown"):
        stats.pop(k)
    return stats


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowered_graph_prices_the_same_in_both_packages(case, tmp_path):
    name, fn, args, opcode = case
    module = Fn(fn)
    out = tmp_path / name
    capture_to_dir(out, module, *args, name=name)
    text = (out / "modules" / f"{name}.hlo").read_text()
    assert opcode in text
    ref, port = ref_load(out), port_load(out)
    assert ([o.opcode for o in ref.modules[name].entry.ops]
            == [o.opcode for o in port.modules[name].entry.ops])
    want = _stats(ref_simulate(out, arch="v5e", tuned=False))
    got = _stats(port_simulate(out, arch="v5e", tuned=False))
    assert got == want
    assert got["tot_unknown_trip_loops"] == 0


#: (case id, function, args, text its HLO must hold): one collective each
_M4 = Mesh((4,), ("x",))
_M22 = Mesh((2, 2), ("dp", "tp"))
_M8 = Mesh((2, 4), ("dp", "tp"))
COLLECTIVE_CASES = [
    ("psum", lambda a: spmd.psum(a, _M4, "x"), (_t(4, 8),),
     "all-reduce(%args_0), channel_id=1, replica_groups=[1,4]<=[4], "
     "use_global_device_ids=true, to_apply="),
    ("psum_tp", lambda a: spmd.psum(a, _M22, "tp"), (_t(4, 8),),
     "replica_groups=[2,2]<=[4]"),
    ("psum_dp", lambda a: spmd.psum(a, _M22, "dp"), (_t(4, 8),),
     "replica_groups=[2,2]<=[2,2]T(1,0)"),
    ("psum_both_axes", lambda a: spmd.psum(a, _M8, ("dp", "tp")),
     (_t(4, 8),), "replica_groups=[1,8]<=[8]"),
    ("pmax_bf16", lambda a: spmd.pmax(a, _M8, "tp"),
     (_t(4, 8, dtype=torch.bfloat16),), "bf16[4,8]{1,0} all-reduce("),
    ("psum_coalesced", lambda a, b: spmd.psum_coalesced([a, b], _M22, "dp"),
     (_t(4, 8), _t(16)), "(f32[4,8]{1,0}, f32[16]{0}) all-reduce(%args_0, %args_1)"),
    ("all_gather", lambda a: spmd.all_gather(a, _M8, "tp", 1), (_t(4, 8),),
     "f32[4,32]{1,0} all-gather(%args_0), channel_id=1, "
     "replica_groups=[2,4]<=[8], dimensions={1}"),
    ("psum_scatter", lambda a: spmd.psum_scatter(a, _M4, "x", 0),
     (_t(8, 8),), "f32[2,8]{1,0} reduce-scatter(%args_0)"),
    ("all_to_all_same_dim", lambda a: spmd.all_to_all(a, _M4, "x", 0, 0),
     (_t(8, 8),), "all-to-all(%args_0), channel_id=1, replica_groups=[1,4]<=[4], "
     "dimensions={0}"),
    ("all_to_all_heads", lambda a: spmd.all_to_all(a, _M8, "tp", 2, 1) * 2,
     (_t(1, 4, 8, 16),), "dimensions={2}"),
    ("ppermute_ring", lambda a: spmd.ppermute(
        a, _M4, "x", [(j, (j + 1) % 4) for j in range(4)]), (_t(4, 8),),
     "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}"),
    ("ppermute_tp", lambda a: spmd.ppermute(a, _M22, "tp", [(0, 1)]),
     (_t(4, 8),), "source_target_pairs={{0,1},{2,3}}"),
    ("axis_index", lambda a: a + spmd.axis_index(a, _M8, "dp"),
     (torch.zeros(4, 8, dtype=torch.int32),), "partition-id()"),
    ("axis_index_minor", lambda a: a * spmd.axis_index(a, _M8, "tp"),
     (torch.zeros(4, 8, dtype=torch.int32),), "remainder("),
]


@pytest.mark.parametrize("case", COLLECTIVE_CASES,
                         ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_is_read_and_priced_alike_by_both_packages(case,
                                                               tmp_path):
    """Both parsers read what the lowering writes — kind, replica groups,
    channel, pairs, the header's ``num_partitions`` — and both packages
    price it the same on the ICI model."""
    name, fn, args, want_text = case
    out = tmp_path / name
    capture_to_dir(out, Fn(fn), *args, name=name)
    text = (out / "modules" / f"{name}.hlo").read_text()
    assert want_text in text
    n = int(re.search(r"num_partitions=(\d+)", text).group(1))
    ref, port = ref_load(out).modules[name], port_load(out).modules[name]
    assert ref.num_devices == port.num_devices == n

    def colls(mod):
        return [(op.opcode, op.collective.replica_groups,
                 op.collective.channel_id,
                 op.collective.source_target_pairs,
                 op.collective.use_global_device_ids)
                for op in mod.entry.ops if op.collective is not None]

    assert colls(ref) == colls(port)
    assert ([o.opcode for o in ref.entry.ops]
            == [o.opcode for o in port.entry.ops])
    want = _stats(ref_simulate(out, arch="v5p", tuned=False))
    got = _stats(port_simulate(out, arch="v5p", tuned=False))
    assert got == want
    assert got["num_devices"] == n
    if name.startswith("axis_index"):
        assert got["tot_collective_count"] == 0
    else:
        assert got["tot_collective_count"] == 1
        assert got["tot_ici_bytes"] > 0


@pytest.mark.parametrize("shape,axes", [
    ((8,), (0,)), ((2, 2), (1,)), ((2, 2), (0,)), ((2, 4), (0, 1)),
    ((2, 3, 4), (1,)), ((2, 3, 4), (0, 2)), ((2, 3, 4), (2, 0)),
])
def test_replica_groups_text_names_the_rank_runners_groups(shape, axes):
    """The iota text the lowering writes, read by both parsers, holds the
    groups ``run_ranks`` exchanges data in."""
    from tpusim.trace.hlo_text import _parse_replica_groups as ref_parse
    from tpusim_torch.trace.hlo_text import _parse_replica_groups
    from tpusim_torch.tracer.lower import _replica_groups

    text = _replica_groups(shape, axes).split("=", 1)[1]
    want = tuple(tuple(g) for g in spmd.groups(shape, axes))
    assert _parse_replica_groups(text) == ref_parse(text) == want


def test_collectives_inside_a_scan_land_in_the_while_body():
    mesh = Mesh((4,), ("x",))

    def ring(a, xs):
        from torch._higher_order_ops.scan import scan

        def body(c, x):
            c = spmd.ppermute(c, mesh, "x", [(j, (j + 1) % 4)
                                             for j in range(4)])
            return spmd.psum(c * x, mesh, "x"), x.clone()

        return scan(body, a, xs)[0]

    mod, text = _entry(ring, _t(4, 8), _t(3, 4, 8))
    entry_ops = {o.opcode for o in mod.entry.ops}
    assert "while" in entry_ops and not entry_ops & {"all-reduce",
                                                     "collective-permute"}
    body = [c for name, c in mod.computations.items() if "body" in name]
    assert {o.opcode for c in body for o in c.ops} >= {
        "all-reduce", "collective-permute"}
    assert "channel_id=1" in text and "channel_id=2" in text


def test_collectives_and_partition_id_stay_top_level():
    mod, text = _entry(lambda a: spmd.psum(
        a * 2 + spmd.axis_index(a, _M4, "x").float(), _M4, "x") + 1,
        _t(4, 8))
    for comp in mod.computations.values():
        if comp.name != mod.entry_name:
            assert not {o.opcode for o in comp.ops} & {
                "all-reduce", "partition-id"}
    assert {"all-reduce", "partition-id"} <= {o.opcode
                                             for o in mod.entry.ops}


def test_a_mesh_of_another_size_is_refused():
    with pytest.raises(NotImplementedError, match="devices"):
        capture(Fn(lambda a: spmd.psum(spmd.psum(a, _M4, "x"), _M8, "tp")),
                _t(4, 8))


def _entry(fn, *args):
    text = capture(Fn(fn), *args, name="m").hlo_text
    mod = parse_hlo_module(text)
    return mod, text


def test_a_chain_becomes_one_kloop_fusion():
    mod, text = _entry(lambda a: torch.exp(a * 2.0 + 1.0), _t(64, 64))
    ops = [o.opcode for o in mod.entry.ops]
    assert ops == ["parameter", "fusion"]
    assert mod.entry.ops[-1].fusion_kind == "kLoop"
    fused = mod.computation(mod.entry.ops[-1].called[0])
    assert {o.opcode for o in fused.ops} >= {"multiply", "add",
                                             "exponential", "broadcast"}


def test_a_reduce_roots_a_kinput_fusion():
    mod, _ = _entry(lambda a: (a * 2.0).sum(1), _t(64, 64))
    root = mod.entry.ops[-1]
    assert root.opcode == "fusion" and root.fusion_kind == "kInput"
    fused = mod.computation(root.called[0])
    assert fused.root.opcode == "reduce"
    assert "multiply" in {o.opcode for o in fused.ops}


def test_a_two_user_producer_stays_unfused():
    def fn(a):
        e = torch.exp(a)
        return e * 2.0 + e.sum()

    mod, _ = _entry(fn, _t(64, 64))
    ops = [o.opcode for o in mod.entry.ops]
    assert "exponential" in ops          # not fused into either user
    fusions = [o for o in mod.entry.ops if o.opcode == "fusion"]
    assert sorted(f.fusion_kind for f in fusions) == ["kInput", "kLoop"]
    for f in fusions:
        fused = mod.computation(f.called[0])
        assert "exponential" not in {o.opcode for o in fused.ops}


def test_constant_broadcasts_are_copied_into_each_fusion():
    def fn(a, b):
        c = torch.full((64, 64), 3.0)
        return torch.exp(a * c), torch.tanh(b * c)

    mod, _ = _entry(fn, _t(64, 64), _t(64, 64))
    fusions = [o for o in mod.entry.ops if o.opcode == "fusion"]
    assert len(fusions) == 2
    assert "broadcast" not in [o.opcode for o in mod.entry.ops]


def test_dots_and_gathers_stay_top_level():
    mod, _ = _entry(lambda a, b, t, i: torch.relu(a @ b)
                    + torch.index_select(t, 0, i),
                    _t(8, 16), _t(16, 4), _t(32, 4), _ids(8, 32))
    ops = [o.opcode for o in mod.entry.ops]
    assert "dot" in ops and "gather" in ops


def test_a_scan_while_resolves_its_trip_count():
    mod, text = _entry(_scan_cell, _t(7, 2, 4), _t(4, 4))
    (w,) = [o for o in mod.entry.ops if o.opcode == "while"]
    assert '"known_trip_count":{"n":"7"}' in w.attrs["backend_config"]
    # the condition's compare(iv, 7) alone gives the count too
    w.attrs.pop("backend_config")
    assert infer_trip_count(mod, mod.entry, w, -1) == 7
    # the pass ran inside the body
    body = mod.computation(w.attrs["body"].lstrip("%"))
    assert "fusion" in [o.opcode for o in body.ops]


def test_a_node_outside_the_table_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="cumsum"):
        capture(Fn(lambda a: torch.cumsum(a, 0)), _t(4, 8))


def test_an_int64_tensor_is_refused():
    with pytest.raises(NotImplementedError, match="int64"):
        capture(Fn(lambda a: a + 1), torch.zeros(4, dtype=torch.int64))


def test_lowering_is_deterministic():
    args = (_t(5, 2, 4), _t(4, 4))
    a = capture(Fn(_scan_cell), *args, name="m").hlo_text
    b = capture(Fn(_scan_cell), *args, name="m").hlo_text
    assert a == b
    assert re.search(r"ENTRY %main \(", a)

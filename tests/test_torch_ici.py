"""The port's ICI and DCN models against the JAX package.

* ``torus_for`` and ``Topology``: for 1..64 chips of every generation,
  dims, wrap, hop distances, neighbors and undirected links are equal;
* ``CollectiveModel.seconds`` is exactly equal (``==``) for every kind on
  seeded payloads, replica groups and topologies, under the default
  ``IciConfig``, with ``chips_per_slice`` alone (the flat DCN term) and
  with ``chips_per_slice`` + ``dcn_nics_per_slice`` (the fabric);
* ``TorusNetwork.run_phases`` (Python backend) equals the JAX package's
  ``use_native=False`` result exactly on the seeded phases of
  ``tests/test_detailed_net.py``, and ``DetailedCollectiveModel.seconds``
  matches on the same topologies.
"""

from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")

from tpusim.ici import collectives as ref_coll  # noqa: E402
from tpusim.ici import detailed as ref_det  # noqa: E402
from tpusim.ici import topology as ref_topo  # noqa: E402
from tpusim import ir as ref_ir  # noqa: E402
from tpusim.dcn import fabric as ref_fabric  # noqa: E402
from tpusim.dcn import topology as ref_slices  # noqa: E402
from tpusim.timing import config as ref_config  # noqa: E402
from tpusim_torch.ici import collectives as port_coll  # noqa: E402
from tpusim_torch.ici import detailed as port_det  # noqa: E402
from tpusim_torch.ici import topology as port_topo  # noqa: E402
from tpusim_torch import ir as port_ir  # noqa: E402
from tpusim_torch.dcn import fabric as port_fabric  # noqa: E402
from tpusim_torch.dcn import topology as port_slices  # noqa: E402
from tpusim_torch.timing import config as port_config  # noqa: E402

ARCHES = ("v4", "v5e", "v5p", "v6e")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast")
#: the three IciConfig shapes: default; chips_per_slice alone (the flat
#: scalar DCN term); chips_per_slice + NICs (the hierarchical fabric)
ICI_CONFIGS = {
    "default": {},
    "flat_dcn": {"chips_per_slice": 4},
    "fabric": {"chips_per_slice": 4, "dcn_nics_per_slice": 8,
               "dcn_oversubscription": 1.5},
}


def _pair(n: int, gen: str):
    return ref_topo.torus_for(n, gen), port_topo.torus_for(n, gen)


# -- topology ----------------------------------------------------------------

@pytest.mark.parametrize("gen", ARCHES)
def test_torus_for_matches_reference(gen):
    rng = random.Random(f"torus:{gen}")
    for n in range(1, 65):
        r, p = _pair(n, gen)
        assert (p.dims, p.wrap) == (r.dims, r.wrap), n
        assert p.num_chips == r.num_chips == n
        assert p.links_per_chip == r.links_per_chip
        assert p.bisection_links() == r.bisection_links()
        assert p.undirected_links() == r.undirected_links()
        assert list(p.directed_links()) == list(r.directed_links())
        for _ in range(40):
            a, b = rng.randrange(n), rng.randrange(n)
            assert p.hop_distance(a, b) == r.hop_distance(a, b), (n, a, b)
        for chip in range(n):
            assert p.coords(chip) == r.coords(chip)
            assert p.chip_at(p.coords(chip)) == chip
            for axis in range(p.ndims):
                assert p.axis_is_ring(axis) == r.axis_is_ring(axis)
                assert p.axis_ring_intact(axis) == r.axis_ring_intact(axis)
                for direction in (0, 1):
                    assert p.neighbor(chip, axis, direction) == \
                        r.neighbor(chip, axis, direction)


def test_healthy_topology_link_queries():
    p = port_topo.Topology(dims=(2, 4), wrap=(False, True))
    assert not p.has_faults
    assert p.link_alive(0, 1) and p.link_scale(0, 1) == 1.0
    assert p.with_faults(None) == p
    with pytest.raises(ValueError):
        port_topo.Topology(dims=(2, 2), wrap=(True,))


# -- DCN slice layer ---------------------------------------------------------

def test_slice_topology_and_fabric_match_reference():
    for kw in ({}, {"chips_per_slice": 4},
               {"chips_per_slice": 4, "dcn_nics_per_slice": 8},
               {"chips_per_slice": 3, "dcn_nics_per_slice": 2,
                "dcn_hop_bandwidth": 40e9, "dcn_hop_latency": 3e-6,
                "dcn_oversubscription": 2.0}):
        rc, pc = ref_config.IciConfig(**kw), port_config.IciConfig(**kw)
        for n in (1, 4, 8, 10, 16):
            r = ref_slices.slice_topology_for(n, rc)
            p = port_slices.slice_topology_for(n, pc)
            if r is None:
                assert p is None
                continue
            assert vars(p) == vars(r)
            assert p.slice_bandwidth() == r.slice_bandwidth()
            rf, pf = ref_fabric.DcnFabric(r), port_fabric.DcnFabric(p)
            for s_count in range(0, r.num_slices + 1):
                for b in (0.0, 1e3, 7.5e6):
                    assert pf.cross_allreduce_seconds(b, s_count) == \
                        rf.cross_allreduce_seconds(b, s_count)
                    assert pf.cross_allgather_seconds(b, s_count) == \
                        rf.cross_allgather_seconds(b, s_count)
                    assert pf.cross_alltoall_seconds(b, 3, s_count) == \
                        rf.cross_alltoall_seconds(b, 3, s_count)
            for chip in range(2 * n):
                assert p.slice_of(chip) == r.slice_of(chip)
            assert p.slices_for_group(n) == r.slices_for_group(n)
            assert pf.transfer_seconds(1e6, 0) == rf.transfer_seconds(1e6, 0)


# -- analytic collective model ------------------------------------------------

def _groups(rng: random.Random, n: int) -> tuple[tuple[int, ...], ...]:
    """Seeded replica groups over ``n`` chips: contiguous or strided
    partitions, or one group that spans past the chip count (the
    multi-slice aliasing case)."""
    sizes = [g for g in (1, 2, 4, 8, 16, 32) if n % g == 0]
    g = rng.choice(sizes)
    shape = rng.choice(("contiguous", "strided", "wide"))
    if shape == "contiguous":
        return tuple(tuple(range(i, i + g)) for i in range(0, n, g))
    if shape == "strided":
        k = n // g
        return tuple(tuple(range(i, n, k)) for i in range(k))
    return (tuple(range(2 * n)),)


def _infos(rng: random.Random, kind: str, n: int):
    """The same seeded CollectiveInfo in both packages."""
    kw = {"replica_groups": _groups(rng, n)}
    if kind == "collective-permute":
        m = max(n, 2)
        shift = rng.randrange(1, m)
        kw = {"source_target_pairs": tuple(
            (i, (i + shift) % m) for i in range(m) if rng.random() < 0.8
        )}
    return ref_ir.CollectiveInfo(kind, **kw), port_ir.CollectiveInfo(kind, **kw)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cfg_name", sorted(ICI_CONFIGS))
def test_collective_seconds_exactly_equal(cfg_name, kind):
    kw = ICI_CONFIGS[cfg_name]
    rc, pc = ref_config.IciConfig(**kw), port_config.IciConfig(**kw)
    rng = random.Random(f"coll:{cfg_name}:{kind}")
    cases = 0
    for gen in ("v5p", "v5e"):
        for n in (1, 2, 4, 8, 16, 32, 64):
            r_topo, p_topo = _pair(n, gen)
            rm = ref_coll.CollectiveModel(r_topo, rc)
            pm = port_coll.CollectiveModel(p_topo, pc)
            for _ in range(6):
                r_info, p_info = _infos(rng, kind, n)
                payload = rng.choice((0.0, 1.0, 4096.0)) if rng.random() < 0.2 \
                    else rng.uniform(1e3, 5e8)
                got = pm.seconds(p_info, payload)
                want = rm.seconds(r_info, payload)
                assert got == want, (gen, n, p_info, payload)
                assert port_coll.collective_seconds(
                    p_info, payload, p_topo, pc) == want
                cases += 1
    assert cases == 2 * 7 * 6


def test_fabric_path_engages_and_differs_from_flat():
    # a 16-chip group over 4-chip slices prices through the hierarchical
    # fabric only when NICs are configured
    topo = port_topo.torus_for(16, "v5p")
    info = port_ir.CollectiveInfo("all-reduce",
                                  replica_groups=(tuple(range(16)),))
    flat = port_coll.CollectiveModel(
        topo, port_config.IciConfig(**ICI_CONFIGS["flat_dcn"]))
    fab = port_coll.CollectiveModel(
        topo, port_config.IciConfig(**ICI_CONFIGS["fabric"]))
    assert flat._dcn_fabric() is None
    assert isinstance(fab._dcn_fabric(), port_fabric.DcnFabric)
    assert fab.seconds(info, 64e6) != flat.seconds(info, 64e6)


# -- detailed network ---------------------------------------------------------

def _net_topologies():
    return (
        ((4,), (True,)),
        ((4, 4), (True, True)),
        ((2, 2, 4), (False, True, True)),
    )


def _seeded_phases(rng: random.Random, n: int):
    """The seeded phases of tests/test_detailed_net.py's native parity
    check: 3 phases of 20 random transfers."""
    phases = []
    for _ in range(3):
        phase = []
        for _ in range(20):
            s, d = rng.randrange(n), rng.randrange(n)
            phase.append((s, d, float(rng.randrange(1, 5)) * 512.0))
        phases.append(phase)
    return phases


@pytest.mark.parametrize("dims,wrap", _net_topologies(),
                         ids=["ring4", "torus4x4", "2x2x4"])
def test_torus_network_equals_reference_python_backend(dims, wrap):
    rng = random.Random(7)
    r_topo = ref_topo.Topology(dims=dims, wrap=wrap)
    p_topo = port_topo.Topology(dims=dims, wrap=wrap)
    for trial in range(4):
        phases = _seeded_phases(rng, r_topo.num_chips)
        # with direction hints on some transfers, as the grid schedules
        # emit them
        if trial % 2:
            phases = [[tr + (rng.randrange(-1, 2 * len(dims)),) for tr in ph]
                      for ph in phases]
        for flit, hop, pkt in ((16.0, 3, 1024.0), (8.0, 10, 1e9),
                               (1.0, 5, 700.0)):
            want = ref_det.TorusNetwork(
                r_topo, flit, hop, use_native=False
            ).run_phases(phases, packet_bytes=pkt)
            got = port_det.TorusNetwork(p_topo, flit, hop).run_phases(
                phases, packet_bytes=pkt)
            assert got == want, (dims, trial, flit)


def test_torus_network_refuses_native_backend(monkeypatch):
    """``use_native=True`` raises without the library, as the
    reference's does; with it (built here) the native backend runs."""
    topo = port_topo.Topology(dims=(4,), wrap=(True,))
    assert port_det.TorusNetwork(topo, 16.0, 3, use_native=True)._native
    monkeypatch.setattr(port_det, "native_net_available", lambda: False)
    with pytest.raises(RuntimeError, match="not built"):
        port_det.TorusNetwork(topo, 16.0, 3, use_native=True)
    assert not port_det.TorusNetwork(topo, 16.0, 3)._native
    with pytest.raises(ValueError):
        port_det.TorusNetwork(topo, 0.0, 3)
    assert port_det.TorusNetwork(topo, 16.0, 3).run_phases([]) == 0.0


def _detailed_cfg_kw(**kw):
    base = dict(
        link_bandwidth=100e9, efficiency=1.0, hop_latency=1e-9,
        launch_latency=0.0, network_mode="detailed",
    )
    base.update(kw)
    return base


@pytest.mark.parametrize("kind", KINDS + ("ragged-all-to-all",))
def test_detailed_collective_seconds_equal(kind):
    rng = random.Random(f"detailed:{kind}")
    for dims, wrap in _net_topologies():
        r_topo = ref_topo.Topology(dims=dims, wrap=wrap)
        p_topo = port_topo.Topology(dims=dims, wrap=wrap)
        n = r_topo.num_chips
        for cfg_kw in (_detailed_cfg_kw(),
                       _detailed_cfg_kw(packet_bytes=4096.0,
                                        links_per_axis=2),
                       {"network_mode": "detailed", "chips_per_slice": 2}):
            rm = ref_det.DetailedCollectiveModel(
                r_topo, ref_config.IciConfig(**cfg_kw))
            rm.net = ref_det.TorusNetwork(
                r_topo, rm.net.flit_bytes, rm.net.hop_cycles,
                use_native=False)
            pm = port_det.DetailedCollectiveModel(
                p_topo, port_config.IciConfig(**cfg_kw))
            for _ in range(4):
                r_info, p_info = _infos(rng, kind, n)
                payload = rng.uniform(1e3, 1e6)
                assert pm.seconds(p_info, payload) == \
                    rm.seconds(r_info, payload), (dims, p_info, payload)


def test_make_collective_model_dispatch():
    topo = port_topo.torus_for(8, "v5p")
    assert isinstance(
        port_det.make_collective_model(topo, port_config.IciConfig()),
        port_coll.CollectiveModel)
    assert isinstance(
        port_det.make_collective_model(
            topo, port_config.IciConfig(network_mode="detailed")),
        port_det.DetailedCollectiveModel)
    with pytest.raises(ValueError, match="network_mode"):
        port_det.make_collective_model(
            topo, port_config.IciConfig(network_mode="booksim"))

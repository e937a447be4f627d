"""``warm_states`` (``tpusim_torch.fastpath.batch``) against the per-state
walk and against the JAX package's ``warm_states``.

Over seeded chip-degradation states of ``llama_tiny_tp2dp2`` @ v5p (its
one module holds 14 collectives, so every state's faulted topology joins
the key) and of ``matmul_512`` (collective-free: states share keys), each
lane ``warm_states`` publishes equals what the per-state
``CachedEngine.run`` computes — in memory as a result document and on
disk as a record, by bytes — and equals the JAX package's lane through
``result_to_doc``.  Windowed states and groups with a partitioned lane
are left to the per-state walk, and ``BatchStats`` counts as the
reference's does.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpusim.fastpath.batch import warm_states as ref_warm_states  # noqa: E402
from tpusim.faults import load_fault_schedule as ref_schedule  # noqa: E402
from tpusim.ici.topology import torus_for as ref_torus  # noqa: E402
from tpusim.perf.cache import ResultCache as RefCache  # noqa: E402
from tpusim.perf.cache import result_to_doc as ref_doc  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.fastpath import batch as port_batch  # noqa: E402
from tpusim_torch.fastpath.batch import warm_states  # noqa: E402
from tpusim_torch.faults import load_fault_schedule  # noqa: E402
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.kernels import scan_rows as sr  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    CachedEngine,
    ResultCache,
    clear_compiled_cache,
    result_to_doc,
)
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
LLAMA = FIXTURES / "llama_tiny_tp2dp2"
MATMUL = FIXTURES / "matmul_512"
STATES = 16
SEED = 19


def _docs(states_doc, chips, seed=SEED, n=STATES) -> list[dict]:
    rng = random.Random(seed)
    return [{"faults": [
        {"kind": "chip_straggler", "chip": rng.randrange(chips),
         "clock_scale": 1.0 - 0.5 * rng.random()},
        {"kind": "hbm_throttle", "chip": rng.randrange(chips),
         "hbm_scale": 1.0 - 0.5 * rng.random()},
    ]} for _ in range(n)] + states_doc


def _setup(trace, arch, docs, chips=4, overlays=()):
    """The port's and the reference's (pod, config, topology, states):
    ``llama_tiny_tp2dp2``'s 4-chip torus (its trace records device 0's
    stream only), which ``matmul_512``'s states are bound to as well."""
    out = []
    for load, config, torus, sched in (
            (load_trace, load_config, torus_for, load_fault_schedule),
            (ref_load, ref_config, ref_torus, ref_schedule)):
        pod = load(trace)
        topo = torus(chips, arch)
        states = [None if d is None else sched(d).bind(topo) for d in docs]
        out.append((pod, config(arch=arch, tuned=False,
                                overlays=list(overlays)), topo, states))
    return out


def _per_state(pod, cfg, topo, states, cache) -> None:
    """The walk ``warm_states`` stands in for: each non-windowed state's
    launch classes through ``CachedEngine.run``."""
    for state in states:
        if state is not None and state.windowed:
            continue
        view = state.view_at(0.0) if state is not None else None
        topo_k = topo.with_faults(view) if view is not None else topo
        for dev_id in sorted(pod.devices):
            cs, hs = view.chip_scales(dev_id) if view else (1.0, 1.0)
            engine = CachedEngine(cfg, topology=topo_k, clock_scale=cs,
                                  hbm_scale=hs, result_cache=cache)
            for cmd in pod.devices[dev_id].commands:
                if cmd.module in pod.modules:
                    engine.run(pod.modules[cmd.module])


def _stats(stats) -> dict:
    return stats.stats_dict()


@pytest.fixture(autouse=True)
def _fresh_tier():
    clear_compiled_cache()
    yield
    clear_compiled_cache()


@pytest.fixture
def cuda_route_on_cpu(monkeypatch):
    """``backend="cuda"`` with its scans sent to the CPU: the same route
    (columns staged ops-major, a run step's scans packed into one call of
    ``scan_segments``) into the kernel's wrappers, whose plain versions
    run for CPU tensors (launching nothing).  Records the matrix shape of
    every call of either wrapper entry."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_batch, "_SCAN_DEVICE", "cpu")
    calls = []
    rows, segments = sr.scan_rows, sr.scan_segments
    monkeypatch.setattr(sr, "scan_rows",
                        lambda s, m: calls.append(m.shape) or rows(s, m))
    monkeypatch.setattr(sr, "scan_segments", lambda m, *a: calls.append(
        m.shape) or segments(m, *a))
    return calls


@pytest.mark.parametrize("backend", ["vectorized", "cuda"])
@pytest.mark.parametrize("trace,arch", [(LLAMA, "v5p"), (MATMUL, "v5e")],
                         ids=["llama_v5p", "matmul_v5e"])
def test_lanes_equal_per_state_walk_and_reference(trace, arch, backend,
                                                  request, tmp_path):
    calls = (request.getfixturevalue("cuda_route_on_cpu")
             if backend == "cuda" else None)
    docs = _docs([None], chips=4)
    (pod, cfg, topo, states), (rpod, rcfg, rtopo, rstates) = _setup(
        trace, arch, docs)
    warmed = ResultCache(disk_dir=tmp_path / "warmed")
    stats = warm_states(pod, cfg, topo, states, warmed, backend=backend)
    walked = ResultCache(disk_dir=tmp_path / "walked")
    _per_state(pod, cfg, topo, states, walked)
    assert set(warmed._mem) == set(walked._mem)
    for key, result in walked._mem.items():
        assert json.dumps(result_to_doc(warmed._mem[key])) == \
            json.dumps(result_to_doc(result)), key
    records = lambda d: {p.name: p.read_bytes()  # noqa: E731
                         for p in sorted(d.glob("*.json"))}
    assert records(tmp_path / "warmed") == records(tmp_path / "walked")
    assert stats.states == len(walked._mem) and stats.groups == 1

    ref_cache = RefCache()
    ref_stats = ref_warm_states(rpod, rcfg, rtopo, rstates, ref_cache,
                                backend="vectorized")
    assert _stats(stats) == _stats(ref_stats)
    got = sorted(json.dumps(result_to_doc(r)) for r in warmed._mem.values())
    want = sorted(json.dumps(ref_doc(r)) for r in ref_cache._mem.values())
    assert got == want
    if calls is not None:
        assert calls  # the row scans took the kernel's route


def test_llama_states_get_one_lane_each():
    """The module's collectives put each state's topology in its key: 16
    degraded states and the healthy one are 17 lanes; ``matmul_512``'s
    states share keys by their scales alone."""
    docs = _docs([None], chips=4)
    (pod, cfg, topo, states), _ = _setup(LLAMA, "v5p", docs)
    stats = warm_states(pod, cfg, topo, states, ResultCache())
    assert (stats.states, stats.groups) == (STATES + 1, 1)


def test_cached_lanes_windowed_states_and_skips_match_reference():
    window = {"faults": [{"kind": "chip_straggler", "chip": 0,
                          "clock_scale": 0.7, "start_cycle": 0,
                          "end_cycle": 1000.0}]}
    docs = _docs([None, window, None], chips=4, n=4)
    (pod, cfg, topo, states), (rpod, rcfg, rtopo, rstates) = _setup(
        LLAMA, "v5p", docs)
    port_cache, ref_cache = ResultCache(), RefCache()
    # one state's lane already cached before the batch
    _per_state(pod, cfg, topo, states[:1], port_cache)
    from tpusim.perf.cache import CachedEngine as RefCachedEngine

    view = rstates[0].view_at(0.0)
    rtopo_0 = rtopo.with_faults(view)
    cs, hs = view.chip_scales(0)
    RefCachedEngine(rcfg, topology=rtopo_0, clock_scale=cs, hbm_scale=hs,
                    result_cache=ref_cache).run(
        next(iter(rpod.modules.values())))
    stats = warm_states(pod, cfg, topo, states, port_cache)
    ref_stats = ref_warm_states(rpod, rcfg, rtopo, rstates, ref_cache)
    assert _stats(stats) == _stats(ref_stats)
    assert (stats.lanes_cached, stats.skipped) == (1, 1)
    assert stats.states == 4  # 3 more degraded states and the healthy one


def test_partitioned_group_is_left_to_the_walk():
    """On the detailed network, a state whose dead links cut chip 0 off
    partitions the module's collectives: the whole group is skipped and
    nothing is published."""
    topo = torus_for(4, "v5p")
    cut = {"faults": [{"kind": "link_down", "src": a, "dst": b}
                      for a, b in topo.undirected_links() if 0 in (a, b)]}
    docs = _docs([cut], chips=4, n=3)
    (pod, cfg, topo, states), (rpod, rcfg, rtopo, rstates) = _setup(
        LLAMA, "v5p", docs,
        overlays=[{"arch": {"ici": {"network_mode": "detailed"}}}])
    cache = ResultCache()
    stats = warm_states(pod, cfg, topo, states, cache)
    ref_stats = ref_warm_states(rpod, rcfg, rtopo, rstates, RefCache())
    assert _stats(stats) == _stats(ref_stats)
    assert (stats.states, stats.groups, stats.skipped) == (0, 0, 4)
    assert not cache._mem


def test_declines_without_cache_serial_or_op_resume(monkeypatch):
    docs = _docs([None], chips=4, n=2)
    (pod, cfg, topo, states), _ = _setup(LLAMA, "v5p", docs)
    assert warm_states(pod, cfg, topo, states, None).skipped == 3
    assert warm_states(pod, cfg, topo, states, ResultCache(),
                       backend="serial").skipped == 3
    resumed = load_config(arch="v5p", tuned=False,
                          overlays=[{"resume_op": 2}])
    assert warm_states(pod, resumed, topo, states,
                       ResultCache()).skipped == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="'cuda' requested"):
        warm_states(pod, cfg, topo, states, ResultCache(), backend="cuda")


# -- chip_smoke.py's phase 8 on the CPU host ---------------------------------


def test_chip_smoke_durable_store_on_cpu(tmp_path, capsys):
    """Phase 8's parts, rehearsed on the CPU host at a reduced size: one
    golden cell cold then warm in fresh processes, ``warm_states`` on the
    host backend, the ``cache`` CLI over the store, and phase 7 (e)'s legs
    each in a fresh process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    store = tmp_path / "store"
    cells = smoke.store_cells("cpu", tmp_path, store,
                              cells=smoke.GOLDEN_CELLS[2:3])
    assert set(cells["seconds"]) == {("llama_tiny_tp2dp2__v5p", "cold"),
                                     ("llama_tiny_tp2dp2__v5p", "warm")}
    warm = smoke.warm_states_phase("cpu", tmp_path, backends=("vectorized",))
    assert warm["vectorized"]["launches"] == {"flash_attention": 0,
                                              "scan_rows": 0}
    cli = smoke.cache_cli("cpu", store)
    assert cli["compiled"] == 1 and cli["results"] == 1
    assert cli["left"] <= cli["quota"]
    legs = smoke.fresh_sweeps("cpu", tmp_path)
    assert set(legs) == {"e_serial", "e_pooled", "e_cached_cold",
                         "e_cached_warm"}
    text = capsys.readouterr().out
    for part in ("(a)", "(b)", "(c)", "(d)", "(e)"):
        assert f"  {part} " in text
    assert "warm store_hits 1, compile_misses 0, ir_ops_built 0" in text
    assert "64 records equal by bytes" in text

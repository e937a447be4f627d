"""The port's link sweeps, engine-result cache and ordered worker pool.

* sweeps: ``single_link_sweep(...).to_doc()`` equals the JAX package's
  (``==``) at v5p and v4 with 64 chips and at v5e with 16;
  ``trace_step_sweep`` on ``llama_tiny_tp2dp2`` @ v5p over
  ``torus_for(8, "v5p")`` equals it for ``max_scenarios`` 6 and None;
* the port's versions of ``tests/test_perf.py``'s contracts: serial,
  pooled and cached sweeps give byte-identical reports; the driver's pool
  engages on a two-module trace and gives the serial stats (and the JAX
  package's); the healthy-kernel class is priced once per sweep; a
  healthy run carries no ``cache_*``/``pool_*``/``faults_*`` key; a warm
  disk cache reproduces the stats and prices nothing; ``simulate
  --faults`` with ``--workers 2 --result-cache DIR`` through the CLI
  equals the serial run apart from ``pool_*`` and ``cache_*``;
* the pool's and the cache's own contracts (order, fork, serial short
  circuit, exceptions, keys, quarantine of a corrupt record, a full disk);
* ``chip_smoke.py``'s phase 7 on the CPU host.

Every test that forks runs under a time limit of its own
(``time_limit``), so a hung child fails that test instead of stalling
the suite.
"""

from __future__ import annotations

import errno
import importlib.util
import json
import os
import signal
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.faults.sweep import single_link_sweep as ref_link_sweep  # noqa: E402
from tpusim.faults.sweep import trace_step_sweep as ref_trace_sweep  # noqa: E402
from tpusim.ici.topology import torus_for as ref_torus  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.timing.config import load_config as ref_load  # noqa: E402
from tpusim_torch.faults.sweep import single_link_sweep  # noqa: E402
from tpusim_torch.faults.sweep import trace_step_sweep  # noqa: E402
from tpusim_torch.ici.topology import torus_for  # noqa: E402
from tpusim_torch.perf import cache as port_cache  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    CachedEngine,
    ResultCache,
    result_from_doc,
    result_to_doc,
)
from tpusim_torch.perf.pool import (  # noqa: E402
    map_ordered,
    pool_context,
    resolve_workers,
)
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402
from tpusim_torch.timing.config import load_config, overlay  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
LLAMA = FIXTURES / "llama_tiny_tp2dp2"
#: host-time stats and the perf layer's own accounting
VOLATILE = ("simulation_rate_kops", "silicon_slowdown")
PERF_PREFIXES = ("cache_", "pool_")
#: seconds a forking test may take before it fails (each takes a few)
FORK_LIMIT_S = 120


@pytest.fixture
def time_limit():
    """Fail the test, rather than hang the suite, if it runs past
    ``FORK_LIMIT_S`` (a forked child that never answers)."""
    def expire(signum, frame):
        raise TimeoutError(f"forking test ran past {FORK_LIMIT_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(FORK_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _stats(report) -> dict:
    return {k: v for k, v in json.loads(report.stats.to_json()).items()
            if k not in VOLATILE and not k.startswith(PERF_PREFIXES)}


def _dumps(result) -> str:
    return json.dumps(result.to_doc())


def _count_engine_runs(monkeypatch):
    """Count the engine's pricing walks (cache hits return before them)."""
    calls = {"n": 0}
    orig = Engine.run

    def counting(self, module):
        calls["n"] += 1
        return orig(self, module)

    monkeypatch.setattr(Engine, "run", counting)
    return calls


# -- sweeps against the JAX package ------------------------------------------

@pytest.mark.parametrize("arch,chips", [("v5p", 64), ("v4", 64),
                                        ("v5e", 16)])
def test_single_link_sweep_matches_reference(arch, chips):
    want = ref_link_sweep(ref_torus(chips, arch),
                          ref_load(arch=arch).arch.ici)
    got = single_link_sweep(torus_for(chips, arch),
                            load_config(arch=arch).arch.ici)
    assert got.to_doc() == want.to_doc()
    assert len(got.rows) == len(torus_for(chips, arch).undirected_links())


@pytest.mark.parametrize("max_scenarios", [6, None])
def test_trace_step_sweep_matches_reference(max_scenarios):
    want = ref_trace_sweep(LLAMA, ref_torus(8, "v5p"), arch="v5p",
                           max_scenarios=max_scenarios, tuned=False)
    got = trace_step_sweep(LLAMA, torus_for(8, "v5p"), arch="v5p",
                           max_scenarios=max_scenarios, tuned=False)
    assert got.to_doc() == want.to_doc()
    assert len(got.rows) == (max_scenarios or 12)
    assert got.worst.inflation > 1.0


# -- the perf contracts ------------------------------------------------------

def test_sweeps_serial_pooled_cached_byte_identical(time_limit, tmp_path):
    topo = torus_for(8, "v5p")
    kw = dict(arch="v5p", max_scenarios=6, tuned=False)
    serial = _dumps(trace_step_sweep(LLAMA, topo, **kw))
    assert _dumps(trace_step_sweep(LLAMA, topo, workers=2, **kw)) == serial
    cache_dir = tmp_path / "cache"
    for _ in range(2):  # cold, then warm from the disk tier
        assert _dumps(trace_step_sweep(LLAMA, topo, result_cache=cache_dir,
                                       **kw)) == serial
    ici = load_config(arch="v5p", tuned=False).arch.ici
    assert _dumps(single_link_sweep(topo, ici, workers=2)) == \
        _dumps(single_link_sweep(topo, ici))


def test_driver_pool_engages_and_matches_serial(time_limit, tmp_path):
    trace = _smoke().two_module_trace(tmp_path / "two_mod")
    serial = simulate_trace(trace, arch="v5e", tuned=False)
    pooled = simulate_trace(trace, arch="v5e", tuned=False, workers=4)
    assert pooled.stats.get("pool_workers") == 4
    assert pooled.stats.get("pool_parallel_segments") == 2
    assert serial.stats.get("pool_workers") is None
    assert _stats(pooled) == _stats(serial)
    assert _stats(pooled) == _stats(ref_simulate(trace, arch="v5e",
                                                 tuned=False, workers=4))


def test_sweep_prices_healthy_class_exactly_once(monkeypatch):
    calls = _count_engine_runs(monkeypatch)
    result = trace_step_sweep(FIXTURES / "matmul_512", torus_for(8, "v5p"),
                              arch="v5p", max_scenarios=8, tuned=False)
    assert len(result.rows) == 8
    assert calls["n"] == 1
    assert all(r.inflation == 1.0 for r in result.rows)


def test_healthy_run_adds_no_perf_or_fault_keys():
    report = simulate_trace(LLAMA, arch="v5p", tuned=False)
    assert [k for k in report.stats.values
            if k.startswith(("cache_", "pool_", "faults_"))] == []


def test_warm_disk_cache_prices_nothing(tmp_path, monkeypatch):
    cache_dir = tmp_path / "cache"
    cold = simulate_trace(LLAMA, arch="v5p", tuned=False,
                          result_cache=cache_dir)
    assert list(cache_dir.glob("*.json"))
    calls = _count_engine_runs(monkeypatch)
    warm = simulate_trace(LLAMA, arch="v5p", tuned=False,
                          result_cache=cache_dir)
    assert calls["n"] == 0
    assert _stats(warm) == _stats(cold)
    assert warm.stats.get("cache_hits") == 1
    assert warm.stats.get("cache_disk_hits") == 1
    assert cold.stats.get("cache_misses") == 1


def test_cli_faults_workers_cache_match_serial(time_limit, tmp_path, capsys):
    from tpusim_torch.__main__ import main

    trace = _smoke().two_module_trace(tmp_path / "two_mod")
    sched = tmp_path / "straggler.json"
    sched.write_text(json.dumps({"faults": [
        {"kind": "chip_straggler", "chip": 0, "clock_scale": 0.7}]}))
    runs = {}
    for label, extra in (("serial", []),
                         ("pooled", ["--workers", "2", "--result-cache",
                                     str(tmp_path / "cache")]),
                         ("warm", ["--workers", "2", "--result-cache",
                                   str(tmp_path / "cache")])):
        out = tmp_path / f"{label}.json"
        assert main(["simulate", str(trace), "--arch", "v5e", "--faults",
                     str(sched), "--json", str(out), *extra]) == 0
        capsys.readouterr()
        runs[label] = json.loads(out.read_text())
    assert runs["pooled"]["pool_parallel_segments"] == 2
    assert runs["pooled"]["cache_misses"] == 2
    # a warm cache forks nothing: every class is a disk hit in the parent
    assert "pool_workers" not in runs["warm"]
    assert runs["warm"]["cache_disk_hits"] == 2
    strip = [{k: v for k, v in r.items()
              if k not in VOLATILE and not k.startswith(PERF_PREFIXES)}
             for r in runs.values()]
    assert strip[0] == strip[1] == strip[2]
    assert strip[0]["faults_chips_degraded"] == 1


# -- the pool ----------------------------------------------------------------

def _double(x):
    return x * 2


def _pid_of(x):
    return os.getpid()


def _context_plus(x):
    return pool_context() + x


def _boom(x):
    raise OSError(f"task {x} failed")


def test_pool_preserves_order_and_forks(time_limit):
    assert map_ordered(_double, list(range(20)), workers=4) == \
        [x * 2 for x in range(20)]
    assert os.getpid() not in map_ordered(_pid_of, list(range(8)),
                                          workers=4)
    assert map_ordered(_context_plus, [1, 2, 3], workers=2,
                       context=10) == [11, 12, 13]


def test_pool_task_exception_propagates(time_limit):
    with pytest.raises(OSError, match="task"):
        map_ordered(_boom, [0, 1, 2, 3], workers=2)


def test_workers_one_short_circuits_pool():
    seen = []
    out = map_ordered(lambda x: seen.append(x) or x + 1, [1, 2, 3],
                      workers=1)
    assert out == [2, 3, 4] and seen == [1, 2, 3]
    assert set(map_ordered(_pid_of, [0, 1], workers=1)) == {os.getpid()}
    # a closure cannot be pickled: the pool falls back to the serial loop
    assert map_ordered(lambda x: x, [5, 6], workers=2) == [5, 6]


def test_nested_serial_map_preserves_outer_context():
    def outer(x):
        ctx = pool_context()
        map_ordered(lambda y: y, [1, 2], workers=1, context="inner")
        assert pool_context() == ctx
        return ctx

    assert map_ordered(outer, [1, 2, 3], workers=1,
                       context="outer") == ["outer"] * 3


def test_resolve_workers_env(monkeypatch):
    monkeypatch.delenv("TPUSIM_WORKERS", raising=False)
    assert resolve_workers(None) == 1
    assert resolve_workers(3) == 3
    monkeypatch.setenv("TPUSIM_WORKERS", "5")
    assert resolve_workers(None) == 5
    assert resolve_workers(2) == 2
    monkeypatch.setenv("TPUSIM_WORKERS", "garbage")
    assert resolve_workers(None) == 1


# -- the cache ---------------------------------------------------------------

def _matmul():
    pod = load_trace(FIXTURES / "matmul_512")
    return next(iter(pod.modules.values())), load_config(arch="v5e",
                                                         tuned=False)


def test_cache_keys_hit_and_invalidate():
    mod, cfg = _matmul()
    cache = ResultCache()
    r1 = CachedEngine(cfg, result_cache=cache).run(mod)
    assert CachedEngine(cfg, result_cache=cache).run(mod) is r1
    assert (cache.hits, cache.misses) == (1, 1)
    cfg2 = overlay(cfg, {"arch": {"hbm_efficiency": 0.5}})
    assert CachedEngine(cfg2, result_cache=cache).run(mod).cycles != \
        r1.cycles
    CachedEngine(cfg, result_cache=cache, clock_scale=0.5).run(mod)
    assert cache.misses == 3
    # a collective-free module ignores the topology; a collective one
    # keys on the (faulted) topology's signature
    assert cache.key_for(mod, cfg, topology=torus_for(8, "v5p")) == \
        cache.key_for(mod, cfg)
    [llama] = load_trace(LLAMA).modules.values()
    topo = torus_for(4, "v5p")
    from tpusim_torch.faults import link_down_schedule

    faulted = topo.with_faults(link_down_schedule(topo, 0, 1).bind(topo)
                               .view_at(0.0))
    assert cache.key_for(llama, cfg, topology=topo) != \
        cache.key_for(llama, cfg, topology=faulted)
    # a timeline run prices live
    timed = CachedEngine(cfg, result_cache=cache, record_timeline=True)
    assert timed.run(mod) is not r1


def test_result_doc_round_trip_is_exact():
    mod, cfg = _matmul()
    r = Engine(cfg).run(mod)
    doc = json.loads(json.dumps(result_to_doc(r)))
    assert result_to_doc(result_from_doc(doc)) == result_to_doc(r)
    with pytest.raises(ValueError, match="field mismatch"):
        result_from_doc({**doc, "extra": 1})


def test_lru_eviction_counts():
    mod, cfg = _matmul()
    cache = ResultCache(max_entries=1)
    cfg_b = overlay(cfg, {"arch": {"hbm_efficiency": 0.5}})
    CachedEngine(cfg, result_cache=cache).run(mod)
    CachedEngine(cfg_b, result_cache=cache).run(mod)
    CachedEngine(cfg, result_cache=cache).run(mod)
    assert (cache.evictions, cache.misses) == (2, 3)
    assert cache.stats_dict()["entries"] == 1


def test_corrupt_disk_entry_is_quarantined_once(tmp_path):
    mod, cfg = _matmul()
    cache_dir = tmp_path / "cache"
    r1 = CachedEngine(cfg, result_cache=ResultCache(disk_dir=cache_dir)
                      ).run(mod)
    [entry] = cache_dir.glob("*.json")
    entry.write_text(entry.read_text()[:40])
    c2 = ResultCache(disk_dir=cache_dir)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r2 = CachedEngine(cfg, result_cache=c2).run(mod)
        c3 = ResultCache(disk_dir=cache_dir)
        r3 = CachedEngine(cfg, result_cache=c3).run(mod)
    assert len([w for w in caught
                if "corrupt result-cache" in str(w.message)]) == 1
    assert (c2.disk_errors, c2.quarantined, c2.misses) == (1, 1, 1)
    assert len(list((cache_dir / "quarantine").iterdir())) == 1
    assert c3.disk_hits == 1
    assert r1.cycles == r2.cycles == r3.cycles


def test_stale_format_version_is_silent_miss(tmp_path):
    mod, cfg = _matmul()
    cache_dir = tmp_path / "cache"
    CachedEngine(cfg, result_cache=ResultCache(disk_dir=cache_dir)).run(mod)
    [entry] = cache_dir.glob("*.json")
    doc = json.loads(entry.read_text())
    entry.write_text(json.dumps({**doc, "format_version": 999}))
    c2 = ResultCache(disk_dir=cache_dir)
    CachedEngine(cfg, result_cache=c2).run(mod)
    assert (c2.disk_errors, c2.misses) == (0, 1)


def test_full_disk_disables_writes_with_one_warning(tmp_path, monkeypatch):
    def full(tmp, text):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(port_cache, "_stage_write", full)
    mod, cfg = _matmul()
    cache = ResultCache(disk_dir=tmp_path / "store")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r1 = CachedEngine(cfg, result_cache=cache).run(mod)
        assert CachedEngine(cfg, result_cache=cache).run(mod) is r1
        cfg2 = overlay(cfg, {"arch": {"hbm_efficiency": 0.5}})
        CachedEngine(cfg2, result_cache=cache).run(mod)
        assert cache.flush() == 0
    assert len([w for w in caught
                if "disabling further" in str(w.message)]) == 1
    assert cache.disk_errors == 1
    assert not list((tmp_path / "store").glob("*.json*"))


def test_cache_keys_differ_from_reference_keys():
    """The port keys on its own sources, so the two packages never read
    each other's records."""
    from tpusim.perf.cache import ResultCache as RefCache
    from tpusim.trace.format import load_trace as ref_trace

    mod, cfg = _matmul()
    ref_mod = next(iter(ref_trace(FIXTURES / "matmul_512").modules.values()))
    ref_key = RefCache().key_for(ref_mod, ref_load(arch="v5e", tuned=False))
    assert ResultCache().key_for(mod, cfg) != ref_key


# -- chip_smoke.py's phase 7 on the CPU host ---------------------------------

def test_chip_smoke_degraded_pods_on_cpu(time_limit, tmp_path, capsys):
    out = _smoke().degraded_pods("cpu", tmp_path)
    assert out["launches"] == {"flash_attention": 0, "scan_rows": 0}
    text = capsys.readouterr().out
    for part in ("(a)", "(b)", "(c)", "(d)", "(e)"):
        assert f"  {part} " in text
    assert "pool_parallel_segments 2" in text
    assert "'e_cached_warm': 0" in text

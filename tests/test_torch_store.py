"""The port's durable compile store and the store's governance against
the JAX package (``tests/test_compile_store.py`` and the store cases of
``tests/test_guard.py``, run on the port).

* **the record** — a ``.cmod`` written by the port holds the columns of
  ``compile_module`` byte for byte, and its blob and header equal the JAX
  package's record of the same module and config (apart from ``key`` and
  ``model_version``), over the 12-trace corpus x 4 arches; each package's
  ``verify_store`` reads the other's records as well-formed and stale;
* **durability** — a torn record quarantines once and heals; a record of
  another version is a plain miss; racing processes converge; a full
  disk disables writes with one warning;
* **the cold path** — a warm store prices a deferred-parse trace with
  zero IR ops built and no computation parsed, through the API, the CLI
  (``simulate --compile-cache``) and the golden matrix;
* **governance** — GC, quotas (result and compiled tiers in one
  directory), ``guard_*`` keys only under a quota, and the ``cache`` CLI
  printing what ``python -m tpusim cache`` prints.
"""

from __future__ import annotations

import errno
import importlib.util
import json
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpusim.fastpath.store as ref_store  # noqa: E402
import tpusim.guard.store as ref_guard  # noqa: E402
from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.perf.cache import ResultCache as RefResultCache  # noqa: E402
from tpusim.perf.cache import clear_compiled_cache as ref_clear  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.timing.engine import Engine as RefEngine  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
import tpusim_torch.fastpath.store as port_store  # noqa: E402
import tpusim_torch.guard.store as port_guard  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.fastpath.compile import compile_module  # noqa: E402
from tpusim_torch.ir import ir_build_counter  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    CACHE_FORMAT_VERSION,
    CachedEngine,
    ResultCache,
    clear_compiled_cache,
    compiled_cache_stats,
    compiled_for,
    result_to_doc,
)
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine, EngineResult  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
CORPUS = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [p for p in FIXTURES.iterdir() if p.is_dir()]
)
ARCHES = ("v4", "v5e", "v5p", "v6e")
FIRST = CORPUS[0]
#: seconds a forking test may take before it fails
FORK_LIMIT_S = 120
VOLATILE = ("simulation_rate_kops", "silicon_slowdown", "wall_seconds")
PERF_KEY_PREFIXES = ("cache_", "pool_", "guard_", "fastpath_")


@pytest.fixture(autouse=True)
def _clean_tiers():
    """Every test starts and ends with no process-wide compiled state in
    either package."""
    for mod, clear in ((port_store, clear_compiled_cache),
                       (ref_store, ref_clear)):
        mod.set_compile_store(None)
        clear()
    yield
    for mod, clear in ((port_store, clear_compiled_cache),
                       (ref_store, ref_clear)):
        mod.set_compile_store(None)
        clear()


@pytest.fixture
def time_limit():
    """Fail the test, rather than hang the suite, if a forked child never
    answers."""
    def expire(signum, frame):
        raise TimeoutError(f"forking test ran past {FORK_LIMIT_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(FORK_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _module(trace: Path, defer: bool | None = None):
    [module] = load_trace(trace, defer_parse=defer).modules.values()
    return module


def _engine(arch="v5e", backend=None):
    return Engine(load_config(arch=arch, tuned=False),
                  pricing_backend=backend)


def _doc(result) -> str:
    return json.dumps(result_to_doc(result))


def _use(directory, **kw):
    return port_store.set_compile_store(
        port_store.CompileStore(directory, **kw))


def _split(path: Path) -> tuple[dict, bytes]:
    """A record's header and the bytes after it (blob and tail)."""
    raw = path.read_bytes()
    n = int.from_bytes(raw[8:16], "little")
    start = 16 + n
    start += (-start) % 8
    return json.loads(raw[16:16 + n]), raw[start:]


def _tensor_bytes(t) -> bytes:
    return t.contiguous().numpy().tobytes()


def _step_key(step):
    return tuple(
        _tensor_bytes(x) if isinstance(x, torch.Tensor)
        else [(a, _tensor_bytes(b)) for a, b in x] if isinstance(x, list)
        else x
        for x in step
    )


# -- the record --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHES)
def test_record_round_trip_equals_compile_module(arch, tmp_path):
    """Columns and steps loaded from a ``.cmod`` equal a fresh
    ``compile_module`` by bytes, and price to the serial walk's bytes."""
    for trace in CORPUS:
        store_dir = tmp_path / trace.name
        _use(store_dir)
        serial = _doc(_engine(arch, "serial").run(_module(trace)))
        assert _doc(_engine(arch).run(_module(trace))) == serial
        clear_compiled_cache()
        store = _use(store_dir)
        module = _module(trace)
        engine = _engine(arch)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            loaded = compiled_for(module, engine)
        assert store.hits == 1 and loaded._store_key is not None
        eager = _module(trace, defer=False)
        fresh = compile_module(eager, engine.cost, engine.config)
        for name, cc in loaded.comps.items():
            want = fresh.comp(name)
            for attr in port_store._COLUMN_ATTRS:
                got = getattr(cc, attr)
                assert got.is_contiguous() and got.dtype == torch.float64
                assert _tensor_bytes(got) == _tensor_bytes(getattr(want, attr))
            assert (cc.names, cc.bases, cc.units, cc.any_vmem) == \
                (want.names, want.bases, want.units, want.any_vmem)
            assert [_step_key(s) for s in cc.steps] == \
                [_step_key(s) for s in want.steps]
        assert loaded.entry_name == eager.entry_name
        assert _doc(engine.run(module)) == serial
        assert module.parsed_count == 0


@pytest.mark.parametrize("arch", ARCHES)
def test_record_equals_the_reference_record(arch, tmp_path):
    """One layout: the port's record of a module equals the JAX
    package's byte for byte past the header, and the headers are equal
    without ``key`` and ``model_version``."""
    for trace in CORPUS:
        ref_dir, port_dir = tmp_path / "ref" / trace.name, \
            tmp_path / "port" / trace.name
        # the JAX package memoizes the peak-live refinement per text;
        # prime it with the eager walk, whose value the port's lazy
        # module reproduces
        [ref_eager] = ref_load(trace, defer_parse=False).modules.values()
        RefEngine(ref_config(arch=arch, tuned=False),
                  pricing_backend="serial").run(ref_eager)
        ref_store.set_compile_store(ref_store.CompileStore(ref_dir))
        [ref_mod] = ref_load(trace).modules.values()
        RefEngine(ref_config(arch=arch, tuned=False)).run(ref_mod)
        ref_store.set_compile_store(None)
        _use(port_dir)
        _engine(arch).run(_module(trace))
        [ref_rec] = ref_dir.glob("*.cmod")
        [port_rec] = port_dir.glob("*.cmod")
        ref_hdr, ref_blob = _split(ref_rec)
        port_hdr, port_blob = _split(port_rec)
        assert port_blob == ref_blob, trace.name
        assert port_hdr["key"] != ref_hdr["key"]
        assert port_hdr["model_version"] != ref_hdr["model_version"]
        for hdr in (ref_hdr, port_hdr):
            del hdr["key"], hdr["model_version"]
        assert port_hdr == ref_hdr, trace.name


def test_each_package_reads_the_others_records_as_stale(tmp_path):
    """Both packages in one store directory: each one's verify counts the
    other's records (compiled and result) as stale and quarantines
    none; neither loads the other's columns."""
    _use(tmp_path)
    module = _module(FIRST)
    CachedEngine(load_config(arch="v5e"),
                 result_cache=ResultCache(disk_dir=tmp_path)).run(module)
    port_store.set_compile_store(None)
    ref_store.set_compile_store(ref_store.CompileStore(tmp_path))
    [ref_mod] = ref_load(FIRST).modules.values()
    from tpusim.perf.cache import CachedEngine as RefCachedEngine

    RefCachedEngine(ref_config(arch="v5e"),
                    result_cache=RefResultCache(disk_dir=tmp_path)).run(ref_mod)
    ref_store.set_compile_store(None)
    assert len(list(tmp_path.glob("*.cmod"))) == 2
    assert len(list(tmp_path.glob("*.json"))) == 2
    for verify in (port_guard.verify_store, ref_guard.verify_store):
        res = verify(tmp_path)
        assert (res.checked, res.compiled_checked, res.ok) == (4, 2, 4)
        assert res.stale_model == 2
        assert res.quarantined_corrupt == res.quarantined_stale_format == 0
    assert not (tmp_path / "quarantine").exists()


def test_record_carries_module_scalars(tmp_path):
    _use(tmp_path)
    module = _module(FIRST)
    _engine().run(module)
    [record] = tmp_path.glob("*.cmod")
    header = port_store.read_record_header(record)
    assert header["module"]["entry_name"] == module.entry_name
    assert header["module"]["residency_kind"] == "text"
    assert header["lean"] is False
    clear_compiled_cache()
    _use(tmp_path)
    cm = compiled_for(_module(FIRST), _engine())
    assert cm.entry_name == module.entry_name and cm.comps


def test_read_record_header_refuses_damage(tmp_path):
    _use(tmp_path)
    _engine().run(_module(FIRST))
    [record] = tmp_path.glob("*.cmod")
    raw = record.read_bytes()
    for bad, why in ((b"TPUCMODX" + raw[8:], "bad magic"),
                     (raw[: len(raw) - 9], "truncated"),
                     (raw[:20], "out of bounds")):
        record.write_bytes(bad)
        with pytest.raises(ValueError, match=why):
            port_store.read_record_header(record)
    moved = tmp_path / ("0" * 24 + ".cmod")
    record.write_bytes(raw)
    record.rename(moved)
    with pytest.raises(ValueError, match="name"):
        port_store.read_record_header(moved)


# -- durability --------------------------------------------------------------


def test_corrupt_record_quarantines_once_and_heals(tmp_path):
    _use(tmp_path)
    want = _doc(_engine().run(_module(FIRST)))
    [record] = tmp_path.glob("*.cmod")
    raw = record.read_bytes()
    record.write_bytes(raw[: len(raw) // 2])  # torn write
    clear_compiled_cache()
    store = _use(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert _doc(_engine().run(_module(FIRST))) == want
    assert len([w for w in caught
                if "compiled-module" in str(w.message)]) == 1
    assert store.quarantined == 1 and store.stores == 1
    assert (tmp_path / "quarantine").is_dir()
    clear_compiled_cache()
    healed = _use(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _doc(_engine().run(_module(FIRST))) == want
    assert healed.hits == 1


def test_stale_model_version_is_a_plain_miss(tmp_path):
    store = _use(tmp_path)
    store._model_version = "ancient+parser"
    _engine().run(_module(FIRST))
    assert store.stores == 1
    res = port_guard.verify_store(tmp_path)
    assert (res.compiled_checked, res.stale_model,
            res.quarantined_corrupt) == (1, 1, 0)
    clear_compiled_cache()
    live = _use(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _engine().run(_module(FIRST))
    assert (live.hits, live.quarantined, live.stores) == (0, 0, 1)
    res = port_guard.verify_store(tmp_path)
    assert (res.stale_model, res.ok) == (0, 1)


def test_enospc_disables_store_writes_with_one_warning(tmp_path,
                                                       monkeypatch):
    def boom(tmp, payload):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(port_store, "_stage_bytes", boom)
    store = _use(tmp_path)
    serial = [_doc(_engine(backend="serial").run(_module(t)))
              for t in CORPUS[:2]]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        priced = [_doc(_engine().run(_module(t))) for t in CORPUS[:2]]
    assert len([w for w in caught if "disabling further store writes"
                in str(w.message)]) == 1
    assert store._write_disabled and store.stores == 0
    assert priced == serial
    assert not list(tmp_path.glob("*.cmod"))


def _race_child(trace_dir: str, store_dir: str, q) -> None:
    try:
        torch.set_num_threads(1)  # a forked child must not enter OpenMP
        port_store.set_compile_store(port_store.CompileStore(store_dir))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            doc = _doc(_engine().run(_module(Path(trace_dir))))
        q.put(("ok", doc))
    except BaseException as e:  # noqa: BLE001 - report, don't hang
        q.put(("err", f"{type(e).__name__}: {e}"))


def test_processes_racing_one_cold_key_converge(time_limit, tmp_path):
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=_race_child,
                         args=(str(FIRST), str(tmp_path), q))
             for _ in range(3)]
    for p in procs:
        p.start()
    results = [q.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive()
    assert {s for s, _ in results} == {"ok"}, results
    docs = {doc for _, doc in results}
    assert len(docs) == 1
    assert len(list(tmp_path.glob("*.cmod"))) == 1
    assert not (tmp_path / "quarantine").exists()
    store = _use(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _doc(_engine().run(_module(FIRST))) in docs
    assert store.hits == 1


# -- the cold path -----------------------------------------------------------


def test_warm_store_prices_with_zero_ir_construction(tmp_path):
    _use(tmp_path)
    want = _doc(_engine().run(_module(FIRST)))
    clear_compiled_cache()
    _use(tmp_path)
    module = _module(FIRST)  # defer_parse engages: a store is active
    before = ir_build_counter["ops"]
    assert _doc(_engine().run(module)) == want
    assert ir_build_counter["ops"] == before
    assert module.parsed_count == 0
    assert module._spans_cache is None  # not even the span index


def test_late_activation_is_adopted(tmp_path):
    """A compiled module minted before a store was active adopts the
    store at its next tier hit and publishes its columns then, once."""
    module = _module(FIRST, defer=False)
    _engine().run(module)
    assert compiled_for(module, _engine())._store_key is None
    assert not list(tmp_path.glob("*.cmod"))
    store = _use(tmp_path)
    _engine().run(module)
    assert compiled_for(module, _engine())._store_key is not None
    assert store.stores == 1 and len(list(tmp_path.glob("*.cmod"))) == 1
    _engine().run(module)  # nothing new compiled: nothing to publish
    assert store.stores == 1


def test_store_stats_ride_only_while_active(tmp_path):
    assert "store_hits" not in compiled_cache_stats()
    assert "ir_ops_built" not in compiled_cache_stats()
    plain = json.loads(simulate_trace(
        FIXTURES / "matmul_512", arch="v5e", tuned=False).stats.to_json())
    assert not any(k.startswith("fastpath_") for k in plain)
    got = json.loads(simulate_trace(
        FIXTURES / "matmul_512", arch="v5e", tuned=False,
        compile_cache=tmp_path).stats.to_json())
    # auto: the native scan, whose library builds with g++ here
    assert got["fastpath_backend"] == "native"
    assert got["fastpath_store_writes"] == 1
    assert "fastpath_ir_ops_built" in got
    assert {k: v for k, v in got.items()
            if not k.startswith("fastpath_") and k not in VOLATILE} == \
        {k: v for k, v in plain.items() if k not in VOLATILE}


def test_compile_cache_cli_end_to_end(tmp_path):
    """``simulate --compile-cache``, two fresh processes: the second maps
    what the first compiled and builds no IR; stats equal."""
    store_dir = tmp_path / "store"
    env = {k: v for k, v in os.environ.items()
           if k != "TPUSIM_COMPILE_CACHE"}

    def run(out):
        return subprocess.run(
            [sys.executable, "-m", "tpusim_torch", "simulate",
             str(FIXTURES / "llama_tiny_tp2dp2"), "--arch", "v5p",
             "--compile-cache", str(store_dir), "--json", str(out)],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=300)

    for name in ("a", "b"):
        r = run(tmp_path / f"{name}.json")
        assert r.returncode == 0, r.stderr
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    assert a["fastpath_store_writes"] == 1 and a["fastpath_ir_ops_built"] > 0
    assert b["fastpath_store_hits"] == 1
    assert b["fastpath_compile_misses"] == 0
    assert b["fastpath_ir_ops_built"] == 0
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if not k.startswith("fastpath_")
                       and k not in VOLATILE}
    assert strip(a) == strip(b)


def _check_golden():
    spec = importlib.util.spec_from_file_location(
        "check_golden", REPO / "ci" / "check_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_durable_leg(tmp_path):
    """``ci/check_golden.py``'s durable leg (fastpath parity), on the
    port: columns persisted by one pass over the golden matrix serve a
    second pass (compiled tier cleared, traces reloaded with a deferred
    parse) that passes every golden with zero recompiles."""
    cg = _check_golden()

    def run_matrix() -> dict:
        out = {}
        for fixture, arch, overlays in cg.MATRIX:
            name = f"{fixture}__{arch}"
            tag = cg._overlay_tag(overlays)
            if tag:
                name += "__" + tag
            report = simulate_trace(FIXTURES / fixture, arch=arch,
                                    overlays=list(overlays), tuned=False)
            out[name] = {k: v for k, v in
                         json.loads(report.stats.to_json()).items()
                         if not k.startswith(PERF_KEY_PREFIXES)}
        return out

    _use(tmp_path)
    assert cg.compare(run_matrix()) == []
    clear_compiled_cache()
    store = _use(tmp_path)
    misses = compiled_cache_stats()["compile_misses"]
    before = ir_build_counter["ops"]
    assert cg.compare(run_matrix()) == []
    assert compiled_cache_stats()["compile_misses"] == misses
    assert store.hits == len(cg.MATRIX) and store.misses == 0
    assert ir_build_counter["ops"] == before


# -- governance --------------------------------------------------------------


def test_sizes_match_the_reference():
    for text in (None, 4096, "65536", "64K", "512M", "2G", "1.5g", "2GB"):
        assert port_guard.parse_size(text) == ref_guard.parse_size(text)
    for bad in ("zero", "-4K", "0", ""):
        with pytest.raises(ValueError):
            port_guard.parse_size(bad)
    for n in (0, 512, 64 * 1024, 3 << 30, 5 << 40):
        assert port_guard.format_size(n) == ref_guard.format_size(n)


def _write_record(d: Path, name: str, nbytes: int, mtime: float) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"{name}.json"
    p.write_text(json.dumps({
        "format_version": CACHE_FORMAT_VERSION, "model_version": "m",
        "key": name, "result": {"pad": "x" * max(nbytes - 120, 0)}}))
    os.utime(p, (mtime, mtime))
    return p


@pytest.mark.parametrize("guard", [port_guard, ref_guard],
                         ids=["port", "reference"])
def test_gc_store_lru_quota_and_tmp_reaping(guard, tmp_path):
    now = time.time()
    for i in range(8):
        _write_record(tmp_path, f"r{i}", 1024, now - 100 + i)
    stale_tmp = tmp_path / "w.123.tmp"
    stale_tmp.write_text("half a record")
    os.utime(stale_tmp, (now - 7200, now - 7200))
    fresh_tmp = tmp_path / "w.456.tmp"
    fresh_tmp.write_text("a publish in flight")
    total = guard.store_bytes(tmp_path)
    res = guard.gc_store(tmp_path, quota_bytes=total // 2)
    assert guard.store_bytes(tmp_path) <= total // 2
    assert not (tmp_path / "r0.json").exists()
    assert (tmp_path / "r7.json").exists()
    assert res.tmp_reaped == 1 and not stale_tmp.exists()
    assert fresh_tmp.exists()
    res = guard.gc_store(tmp_path, max_entries=2)
    assert sorted(p.name for p in tmp_path.glob("*.json")) == \
        ["r6.json", "r7.json"]
    assert res.remaining_entries == 2


def test_verify_store_quarantines_damage_once(tmp_path):
    now = time.time()
    _write_record(tmp_path, "good", 512, now)
    (tmp_path / "trunc.json").write_text('{"format_version":')
    (tmp_path / "stale.json").write_text(json.dumps({
        "format_version": CACHE_FORMAT_VERSION + 999,
        "model_version": "m", "key": "s", "result": {}}))
    (tmp_path / "oldmodel.json").write_text(json.dumps({
        "format_version": CACHE_FORMAT_VERSION,
        "model_version": "ancient", "key": "o", "result": {}}))
    res = port_guard.verify_store(tmp_path, model_version="m")
    assert (res.quarantined_corrupt, res.quarantined_stale_format,
            res.stale_model, res.ok) == (1, 1, 1, 2)
    again = port_guard.verify_store(tmp_path, model_version="m")
    assert again.quarantined_corrupt == again.quarantined_stale_format == 0
    stats = port_guard.scan_store(tmp_path)
    assert stats.entries == 2 and stats.quarantined == 2
    assert port_guard.clear_store(tmp_path) == 4
    assert not (tmp_path / port_guard.QUARANTINE_DIR).exists()


def test_result_cache_quota_keeps_store_bounded(tmp_path):
    cache_dir = tmp_path / "cache"
    cache = ResultCache(disk_dir=cache_dir, quota_bytes=6 * 1024)
    for i in range(24):
        cache.put(f"key-{i}", EngineResult(cycles=float(i), op_count=i))
        assert port_guard.store_bytes(cache_dir) <= 6 * 1024
    assert cache.gc_runs >= 1 and cache.gc_deleted > 0
    g = cache.guard_stats_dict()
    assert g["store_quota_bytes"] == 6 * 1024
    assert g["store_gc_deleted_total"] == cache.gc_deleted
    ref = RefResultCache(quota_bytes=1).guard_stats_dict()
    assert list(g) == list(ref)


def test_hits_refresh_lru_recency(tmp_path):
    cache_dir = tmp_path / "cache"
    writer = ResultCache(disk_dir=cache_dir)
    writer.put("old-but-used", EngineResult(cycles=1.0))
    writer.put("newer-unused", EngineResult(cycles=2.0))
    used, unused = (writer._path_for(k)
                    for k in ("old-but-used", "newer-unused"))
    now = time.time()
    os.utime(used, (now - 2000, now - 2000))
    os.utime(unused, (now - 1000, now - 1000))
    reader = ResultCache(disk_dir=cache_dir)
    assert reader.get("old-but-used") is not None  # disk hit touches
    assert used.stat().st_mtime > now - 10
    port_guard.gc_store(cache_dir, max_entries=1)
    assert [p.name for p in cache_dir.glob("*.json")] == [used.name]
    # a memory hit touches the record only under a quota
    governed = ResultCache(disk_dir=cache_dir, quota_entries=8)
    governed.get("old-but-used")
    os.utime(used, (now - 500, now - 500))
    reader.get("old-but-used")
    assert used.stat().st_mtime < now - 100
    governed.get("old-but-used")
    assert used.stat().st_mtime > now - 10


def test_compile_store_quota_governs_both_tiers(tmp_path):
    """One quota, one directory: the compile store's publishes GC result
    and compiled records alike, and ``scan_store`` splits the tiers."""
    _use(tmp_path)
    module = _module(FIRST)
    CachedEngine(load_config(arch="v5e"),
                 result_cache=ResultCache(disk_dir=tmp_path)).run(module)
    stats = port_guard.scan_store(tmp_path)
    assert (stats.result_entries, stats.compiled_entries,
            stats.entries) == (1, 1, 2)
    assert stats.bytes == stats.result_bytes + stats.compiled_bytes
    assert port_guard.gc_store(tmp_path, max_entries=0).deleted == 2
    clear_compiled_cache()
    store = _use(tmp_path, quota_entries=2)
    for trace in CORPUS[:4]:
        _engine().run(_module(trace))
    assert store.stores == 4
    assert port_guard.scan_store(tmp_path).entries <= 2


def test_guard_stats_ride_reports_only_under_quota(tmp_path):
    def stats(cache):
        report = simulate_trace(FIXTURES / "matmul_512", arch="v5e",
                                tuned=False, result_cache=cache)
        return {k: v for k, v in json.loads(report.stats.to_json()).items()
                if k not in VOLATILE}

    plain = stats(ResultCache(disk_dir=tmp_path / "a"))
    assert not any(k.startswith("guard_") for k in plain)
    governed = stats(ResultCache(disk_dir=tmp_path / "b",
                                 quota_bytes=1 << 20))
    assert governed["guard_store_quota_bytes"] == 1 << 20
    assert "guard_store_gc_runs_total" in governed
    assert {k: v for k, v in governed.items()
            if not k.startswith(("guard_", "cache_"))} == \
        {k: v for k, v in plain.items() if not k.startswith("cache_")}


def _chaos_worker(idx: int, cache_dir: str, quota: int, q) -> None:
    try:
        cache = ResultCache(disk_dir=cache_dir, quota_bytes=quota)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(40):
                cache.put(f"w{idx}-{i}",
                          EngineResult(cycles=float(i), op_count=i))
                for peer in range(3):
                    cache.get(f"w{peer}-{max(i - 2, 0)}")
                if i % 16 == 0:
                    port_guard.gc_store(cache_dir, quota_bytes=quota)
        torn = sum(1 for w in caught
                   if "corrupt result-cache" in str(w.message))
        q.put((idx, torn, cache.quarantined, cache.gc_runs))
    except Exception as e:  # noqa: BLE001 - report, don't hang
        q.put((idx, f"{type(e).__name__}: {e}", -1, -1))


def test_multiprocess_gc_chaos_zero_torn_reads(time_limit, tmp_path):
    cache_dir = tmp_path / "shared"
    quota = 8 * 1024
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=_chaos_worker,
                         args=(i, str(cache_dir), quota, q))
             for i in range(3)]
    for p in procs:
        p.start()
    results = [q.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    for idx, torn, quarantined, _ in results:
        assert (torn, quarantined) == (0, 0), idx
    assert sum(r[3] for r in results) >= 1
    port_guard.gc_store(cache_dir, quota_bytes=quota)
    assert port_guard.store_bytes(cache_dir) <= quota
    assert not (cache_dir / port_guard.QUARANTINE_DIR).exists()


def _cli(main, argv, capsys) -> tuple[int, list[str]]:
    rc = main(argv)
    out = capsys.readouterr().out
    # the age of the oldest record moves with the clock between the runs
    return rc, [re.sub(r"record: \d+s ago", "record: Ns ago", line)
                for line in out.splitlines()]


def test_cache_cli_prints_what_the_reference_prints(tmp_path, capsys):
    """``cache stats|verify|gc|clear`` over one store (the port's compiled
    and result records) print the reference's lines, apart from verify's
    stale count: each package counts the other's version stamps stale."""
    _use(tmp_path)
    module = _module(FIRST)
    CachedEngine(load_config(arch="v5e"),
                 result_cache=ResultCache(disk_dir=tmp_path)).run(module)
    for trace in CORPUS[1:4]:
        _engine().run(_module(trace))
    port_store.set_compile_store(None)
    d = ["--dir", str(tmp_path)]

    port = _cli(port_main, ["cache", "stats", *d], capsys)
    assert port == _cli(ref_main, ["cache", "stats", *d], capsys)
    assert "    compiled: 4 " in "\n".join(port[1]) + " "
    assert any(ln.startswith("  model_version ") for ln in port[1])

    stale = "  stale model_version (evictable, left in place): "
    port = _cli(port_main, ["cache", "verify", *d], capsys)
    ref = _cli(ref_main, ["cache", "verify", *d], capsys)
    assert port[0] == ref[0] == 0
    assert [ln for ln in port[1] if not ln.startswith(stale)] == \
        [ln for ln in ref[1] if not ln.startswith(stale)]
    assert stale + "0" in port[1] and stale + "5" in ref[1]

    victim = sorted(tmp_path.glob("*.cmod"))[0]
    victim.write_bytes(b"TPUCMODX garbage")
    port = _cli(port_main, ["cache", "verify", *d], capsys)
    assert "  quarantined (corrupt): 1" in port[1] and not victim.exists()

    quota = str(port_guard.store_bytes(tmp_path) // 2)
    (tmp_path.parent / "copy").mkdir()
    for p in tmp_path.glob("*.*"):
        (tmp_path.parent / "copy" / p.name).write_bytes(p.read_bytes())
        os.utime(tmp_path.parent / "copy" / p.name,
                 (p.stat().st_atime, p.stat().st_mtime))
    port = _cli(port_main, ["cache", "gc", *d, "--quota", quota], capsys)
    ref = _cli(ref_main, ["cache", "gc", "--dir", str(tmp_path.parent /
                                                      "copy"),
                          "--quota", quota], capsys)
    assert port[0] == ref[0] == 0
    assert port[1][1:] == ref[1][1:]
    assert port_guard.store_bytes(tmp_path) <= int(quota)

    for argv in (["gc", *d], ["gc", *d, "--quota", "nonsense"]):
        assert port_main(["cache", *argv]) == ref_main(["cache", *argv]) == 2
        capsys.readouterr()
    port = _cli(port_main, ["cache", "clear", *d], capsys)
    assert port[0] == 0 and port[1][1].startswith("  removed: ")
    assert not list(tmp_path.iterdir())
    missing = str(tmp_path / "nowhere")
    assert port_main(["cache", "verify", "--dir", missing]) == \
        ref_main(["cache", "verify", "--dir", missing]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == [f"tpusim_torch cache: no store at {missing}",
                   f"tpusim cache: no store at {missing}"]


def test_simulate_cache_quota_flag(tmp_path, capsys):
    """``--cache-quota`` implies the result cache, stamps ``guard_*`` and
    governs the compile store too; a nonsense size is refused."""
    out = tmp_path / "s.json"
    store = tmp_path / "store"
    assert port_main(["simulate", str(FIXTURES / "matmul_512"), "--arch",
                      "v5e", "--result-cache", str(store), "--compile-cache",
                      str(store), "--cache-quota", "1M", "--json",
                      str(out)]) == 0
    stats = json.loads(out.read_text())
    assert stats["guard_store_quota_bytes"] == 1 << 20
    assert stats["cache_misses"] == 1
    assert port_store.get_compile_store().quota_bytes == 1 << 20
    assert port_main(["simulate", str(FIXTURES / "matmul_512"),
                      "--cache-quota", "lots"]) == 2
    assert "tpusim_torch: error: cannot parse size" in capsys.readouterr().err


def test_faults_compile_cache_flag(tmp_path, capsys):
    argv = ["faults", "--arch", "v5p", "--chips", "8", "--trace",
            str(FIXTURES / "llama_tiny_tp2dp2"), "--max-scenarios", "2",
            "--compile-cache", str(tmp_path)]
    assert port_main(argv) == 0
    assert len(list(tmp_path.glob("*.cmod"))) == 1
    capsys.readouterr()

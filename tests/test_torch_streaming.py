"""The port's file-backed streaming module and its lean pricing
(``tpusim_torch.trace.lazy.StreamingModuleTrace``, the streaming branch
of ``load_trace``, lean compiles, lean results and records) against the
JAX package's.

* **the index** — over ``reports/silicon/{matmul_chain, decode_step,
  lstm_layer}`` the streaming index finds the full parse's computations,
  the JAX package's spans, entry and module attributes, and the eager
  ``content_hash``; a header wrapped over several lines and an
  unterminated last computation index as in the JAX package;
* **the price** — a streaming module prices to the same stats bytes
  under ``serial`` and ``vectorized`` (lean) as the in-memory module and
  as the JAX package's streaming module; compile-then-release keeps at
  most ``parsed_cap`` computations parsed and the lean result carries no
  per-op aggregates; its result-cache key ends in ``|lean``;
* **the record** — a lean ``.cmod`` equals the JAX package's record of
  the same streamed module past the header, and the headers are equal
  without ``key`` and ``model_version``; it loads back lean, and a warm
  store prices the module with zero IR ops built;
* **load_trace** — at ``TPUSIM_STREAM_THRESHOLD=0`` a plain module loads
  streaming (lenient and gzipped modules stay in memory) and simulates to
  the JAX package's stats.

The JAX package's streaming module reads the peak-live refinement of a
vmem-oversubscribed module from a process-wide memo (its lazy dict's
``get`` does not parse), so the reference side is primed with an eager
walk of the same text first, as ``tests/test_torch_store.py`` does.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import tpusim.fastpath.store as ref_store  # noqa: E402
import tpusim.timing.engine as ref_engine_mod  # noqa: E402
from tpusim.perf.cache import ResultCache as RefResultCache  # noqa: E402
from tpusim.perf.cache import clear_compiled_cache as ref_clear  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.trace import lazy as ref_lazy  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
import tpusim_torch.fastpath.store as port_store  # noqa: E402
from tpusim_torch.ir import ir_build_counter  # noqa: E402
from tpusim_torch.perf.cache import (  # noqa: E402
    ResultCache,
    clear_compiled_cache,
    compiled_for,
)
from tpusim_torch.sim.driver import simulate_trace  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace import lazy as port_lazy  # noqa: E402
from tpusim_torch.trace.format import load_trace, select_module  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SILICON = REPO / "reports" / "silicon"
TRACES = ("matmul_chain", "decode_step", "lstm_layer")
BACKENDS = ("serial", "vectorized")
PERF_KEY_PREFIXES = ("fastpath_",)


@pytest.fixture(autouse=True)
def _clean_tiers():
    """No process-wide compiled state, store or scalar memo in either
    package before or after a test."""
    def clean():
        for mod, clear in ((port_store, clear_compiled_cache),
                           (ref_store, ref_clear)):
            mod.set_compile_store(None)
            clear()
        ref_engine_mod._SCALAR_MEMO.clear()

    clean()
    yield
    clean()


def _hlo(name: str) -> Path:
    return next((SILICON / name / "modules").glob("*.hlo"))


def _stamped(cls, name: str, **kw):
    """A streaming module of a silicon trace, stamped with the capture
    platform as ``load_trace`` stamps it."""
    meta = json.loads((SILICON / name / "meta.json").read_text())
    module = cls(_hlo(name), name_hint=name, **kw)
    for k in ("platform", "device_kind"):
        if k in meta:
            module.meta.setdefault(k, meta[k])
    return module


def _engine(backend=None, arch="v5e"):
    return Engine(load_config(arch=arch, tuned=False),
                  pricing_backend=backend)


def _ref_engine(backend=None, arch="v5e"):
    return ref_engine_mod.Engine(ref_config(arch=arch, tuned=False),
                                 pricing_backend=backend)


def _prime_reference(name: str, arch: str = "v5e") -> None:
    [eager] = ref_load(SILICON / name, defer_parse=False).modules.values()
    _ref_engine("serial", arch).run(eager)


def _stats(result) -> str:
    return json.dumps(result.stats_dict())


# -- the index ---------------------------------------------------------------


@pytest.mark.parametrize("name", TRACES)
def test_index_equals_the_full_parse_and_the_reference(name):
    full = select_module(load_trace(SILICON / name), None)
    port = _stamped(port_lazy.StreamingModuleTrace, name)
    ref = _stamped(ref_lazy.StreamingModuleTrace, name)
    assert set(port._spans) == set(full.computations)
    assert port._spans == ref._spans
    assert port.entry_name == ref.entry_name == full.entry_name
    assert port.meta == ref.meta
    assert port.meta["content_hash"] == full.meta["content_hash"]
    assert port.name == ref.name
    assert port._uses_ici_cache is ref._uses_ici_cache is False
    assert port.parsed_count == 0
    # computations parse on demand into the eager parse's ops
    entry = port.computations[port.entry_name]
    assert [op.name for op in entry.ops] == \
        [op.name for op in full.computation(full.entry_name).ops]
    assert entry.is_entry
    assert port.vmem_resident_bytes() == ref.vmem_resident_bytes()


def _write(path: Path, text: str) -> Path:
    path.write_text(text)
    return path


_WRAPPED = """HloModule wrapped, is_scheduled=true

%body.1 (p0: (f32[8,128],
    s32[])) -> (f32[8,128], s32[]) {
  %p0 = (f32[8,128]{1,0}, s32[]) parameter(0)
  ROOT %t = (f32[8,128]{1,0}, s32[]) copy(%p0)
}

%not_a_header (x) = 3
ENTRY %main (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  %all-reduce.1 = f32[8,128]{1,0} all-reduce(%a), replica_groups={{0,1}}, to_apply=%body.1
  ROOT %out = f32[8,128]{1,0} add(%all-reduce.1, %a)
}

%tail (q: f32[4]) -> f32[4] {
  ROOT %q = f32[4]{0} parameter(0)"""


def test_wrapped_header_and_unterminated_computation(tmp_path):
    """A parameter list wrapped over two lines opens its computation at
    the header's first line; a column-0 line whose parameter list never
    closes into ``->`` is no header; a last computation without its
    closing brace spans to the end of the file; the collective marker
    sets the ICI flag."""
    hlo = _write(tmp_path / "w.hlo", _WRAPPED)
    port = port_lazy.StreamingModuleTrace(hlo, name_hint="w")
    ref = ref_lazy.StreamingModuleTrace(hlo, name_hint="w")
    assert port._spans == ref._spans
    assert list(port._spans) == ["body.1", "main", "tail"]
    assert port._spans["tail"][1] == len(_WRAPPED.encode())
    assert port.entry_name == ref.entry_name == "main"
    assert port._uses_ici_cache is ref._uses_ici_cache is True
    assert port.meta == ref.meta
    assert [op.name for op in port.computations["body.1"].ops] == \
        ["p0", "t"]
    assert [op.name for op in port.computations["tail"].ops] == ["q"]
    lazy = port_lazy.LazyModuleTrace(_WRAPPED)
    assert [op.name for op in lazy.computations["body.1"].ops] == \
        ["p0", "t"]
    # one chunk per byte boundary: the index does not depend on where a
    # chunk ends
    small = port_lazy._INDEX_CHUNK
    try:
        for chunk in (7, 64):
            port_lazy._INDEX_CHUNK = chunk
            again = port_lazy.StreamingModuleTrace(hlo, name_hint="w")
            assert again._spans == port._spans
            assert again.meta == port.meta
            assert again._uses_ici_cache is True
            assert again.vmem_resident_bytes() == ref.vmem_resident_bytes()
    finally:
        port_lazy._INDEX_CHUNK = small


# -- the price ---------------------------------------------------------------


@pytest.mark.parametrize("name", TRACES)
def test_streaming_stats_equal_in_memory_and_reference(name):
    """Stats bytes: streaming under ``serial`` and ``vectorized`` (lean)
    == the in-memory module == the JAX package's streaming module."""
    _prime_reference(name)
    ref = _stats(_ref_engine("serial").run(
        _stamped(ref_lazy.StreamingModuleTrace, name)))
    assert _stats(_ref_engine("vectorized").run(
        _stamped(ref_lazy.StreamingModuleTrace, name))) == ref
    in_memory = select_module(load_trace(SILICON / name), None)
    assert _stats(_engine("serial").run(in_memory)) == ref
    for backend in BACKENDS:
        got = _engine(backend).run(
            _stamped(port_lazy.StreamingModuleTrace, name))
        assert _stats(got) == ref, (name, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compile_then_release_keeps_parses_bounded(backend):
    module = _stamped(port_lazy.StreamingModuleTrace, "decode_step",
                      parsed_cap=4)
    result = _engine(backend).run(module)
    assert result.cycles > 0
    assert module.parsed_count <= 4
    if backend == "vectorized":
        # lean: the per-op name table is the O(trace) memory term
        assert not result.per_op_cycles and not result.per_op_count
        cm = compiled_for(module, _engine(backend))
        assert cm.lean and cm.release_ir
        assert all(cc.names is None for cc in cm.comps.values())
    ref = _ref_engine(backend).run(
        _stamped(ref_lazy.StreamingModuleTrace, "decode_step",
                 parsed_cap=4))
    assert bool(result.per_op_cycles) == bool(ref.per_op_cycles)


def test_streaming_eviction_reparses(tmp_path):
    module = _stamped(port_lazy.StreamingModuleTrace, "lstm_layer",
                      parsed_cap=1)
    names = list(module._spans)
    first = module.computations[names[0]]
    module.computations[names[1]]
    assert module.parsed_count == 1
    again = module.computations[names[0]]
    assert again is not first
    assert [op.name for op in again.ops] == [op.name for op in first.ops]
    module.release_computation(names[0])
    assert module.parsed_count == 0
    for _ in range(16):   # every 8th release trims the heap
        module.release_computation("absent")


def test_lean_result_key(tmp_path):
    """A streaming module's result-cache key is the in-memory module's
    with ``|lean`` appended, as in the JAX package."""
    name = "matmul_chain"
    cfg, rcfg = load_config(arch="v5e", tuned=False), \
        ref_config(arch="v5e", tuned=False)
    port_key = ResultCache().key_for(
        _stamped(port_lazy.StreamingModuleTrace, name), cfg)
    full_key = ResultCache().key_for(
        select_module(load_trace(SILICON / name), None), cfg)
    ref_key = RefResultCache().key_for(
        _stamped(ref_lazy.StreamingModuleTrace, name), rcfg)
    assert port_key == full_key + "|lean"
    assert ref_key.endswith("|lean")
    # the same fields but each package's model version
    drop = 4   # mfp|p=|cfg|arch|model_version|scales|topo|lean
    assert port_key.split("|")[:drop] == ref_key.split("|")[:drop]
    assert port_key.split("|")[drop + 1:] == ref_key.split("|")[drop + 1:]
    cache = ResultCache()
    module = _stamped(port_lazy.StreamingModuleTrace, name)
    from tpusim_torch.perf.cache import CachedEngine

    eng = CachedEngine(cfg, result_cache=cache, pricing_backend="vectorized")
    first = eng.run(module)
    assert eng.run(module).cycles == first.cycles
    assert cache.stats_dict()["hits"] == 1
    assert not first.per_op_cycles


# -- the record --------------------------------------------------------------


def _split(path: Path) -> tuple[dict, bytes]:
    raw = path.read_bytes()
    n = int.from_bytes(raw[8:16], "little")
    start = 16 + n
    start += (-start) % 8
    return json.loads(raw[16:16 + n]), raw[start:]


@pytest.mark.parametrize("name", TRACES)
def test_lean_record_equals_the_references(name, tmp_path):
    _prime_reference(name)
    ref_store.set_compile_store(ref_store.CompileStore(tmp_path / "ref"))
    _ref_engine("vectorized").run(
        _stamped(ref_lazy.StreamingModuleTrace, name))
    ref_store.set_compile_store(None)
    port_store.set_compile_store(port_store.CompileStore(tmp_path / "port"))
    cold = _engine("vectorized").run(
        _stamped(port_lazy.StreamingModuleTrace, name))
    [ref_rec] = (tmp_path / "ref").glob("*.cmod")
    [port_rec] = (tmp_path / "port").glob("*.cmod")
    ref_hdr, ref_blob = _split(ref_rec)
    port_hdr, port_blob = _split(port_rec)
    assert port_blob == ref_blob
    assert port_hdr["lean"] is True
    assert port_hdr["key"].endswith("|lean")
    assert all(c["names"] is None for c in port_hdr["comps"])
    for hdr in (ref_hdr, port_hdr):
        del hdr["key"], hdr["model_version"]
    assert port_hdr == ref_hdr
    # a warm store prices the streamed module from the record alone
    clear_compiled_cache()
    store = port_store.set_compile_store(
        port_store.CompileStore(tmp_path / "port"))
    module = _stamped(port_lazy.StreamingModuleTrace, name)
    before = ir_build_counter["ops"]
    warm = _engine("vectorized").run(module)
    assert ir_build_counter["ops"] == before
    assert store.hits == 1 and module.parsed_count == 0
    assert _stats(warm) == _stats(cold)
    cm = compiled_for(module, _engine("vectorized"))
    assert cm.lean and cm.release_ir


def _compared(stats: dict) -> dict:
    """Stats without the host clock's keys and the ``fastpath_``
    counters (each package counts its own process's compiles)."""
    return {
        k: v for k, v in stats.items()
        if not k.startswith(PERF_KEY_PREFIXES)
        and k not in ("simulation_rate_kops", "silicon_slowdown",
                      "wall_seconds")
    }


# -- load_trace --------------------------------------------------------------


def test_load_trace_streams_at_the_threshold(tmp_path, monkeypatch):
    """``TPUSIM_STREAM_THRESHOLD=0``: a plain module loads streaming with
    the in-memory load's meta and simulates to the JAX package's stats;
    lenient and gzipped modules stay in memory; module order follows C1
    (plain sorted, then gzipped)."""
    name = "decode_step"
    want_meta = select_module(load_trace(SILICON / name), None).meta
    _prime_reference(name)
    monkeypatch.setenv("TPUSIM_STREAM_THRESHOLD", "0")
    pod = load_trace(SILICON / name)
    module = select_module(pod, None)
    assert isinstance(module, port_lazy.StreamingModuleTrace)
    assert module.meta == want_meta
    assert not isinstance(
        select_module(load_trace(SILICON / name, lenient=True), None),
        port_lazy.StreamingModuleTrace)
    ref_pod = ref_load(SILICON / name)
    assert select_module(ref_pod, None).meta == module.meta
    for backend in BACKENDS:
        got = simulate_trace(SILICON / name, arch="v5e", tuned=False,
                             pricing_backend=backend)
        ref = ref_simulate(SILICON / name, arch="v5e", tuned=False,
                           pricing_backend=backend)
        assert _compared(got.stats.values) == _compared(ref.stats.values)
    # gzipped modules decompress to memory; order is plain then gzipped
    trace = tmp_path / "mixed"
    shutil.copytree(SILICON / "lstm_layer", trace)
    src = trace / "modules" / "lstm_layer.hlo"
    with gzip.open(trace / "modules" / "a_gz.hlo.gz", "wt") as f:
        f.write(src.read_text())
    pod = load_trace(trace)
    assert list(pod.modules) == ["lstm_layer", "a_gz"] == \
        list(ref_load(trace).modules)
    assert isinstance(pod.modules["lstm_layer"],
                      port_lazy.StreamingModuleTrace)
    assert not isinstance(pod.modules["a_gz"],
                          port_lazy.StreamingModuleTrace)
    assert pod.modules["a_gz"].meta["content_hash"] == \
        pod.modules["lstm_layer"].meta["content_hash"]
    monkeypatch.setenv("TPUSIM_STREAM_THRESHOLD",
                       str(src.stat().st_size + 1))
    assert not isinstance(select_module(load_trace(SILICON / "lstm_layer"),
                                        None),
                          port_lazy.StreamingModuleTrace)


# -- bounded RSS (slow) ------------------------------------------------------


_GEN_SNIPPET = r'''
import json, resource, sys
from tpusim_torch.sim.driver import simulate_trace
from tpusim_torch.trace.lazy import StreamingModuleTrace

if sys.argv[1] == "--baseline":
    # same imports, zero trace work: the interpreter + torch floor
    print(json.dumps({
        "peak_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    }))
    raise SystemExit(0)
report = simulate_trace(sys.argv[1], arch="v5e", tuned=False)
peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({
    "peak_kb": peak_kb,
    "sim_cycle": report.stats.get("sim_cycle"),
    "ops": report.totals.op_count,
}))
'''


def write_giant_trace(tdir: Path, n_comps: int, n_ops: int = 1000) -> Path:
    """The synthetic trace of ``tests/test_fastpath.py``'s RSS test:
    ``n_comps`` called computations of ``n_ops`` adds with long metadata
    (about 0.7 MB of text each)."""
    pad = "x" * 580
    (tdir / "modules").mkdir(parents=True)
    (tdir / "meta.json").write_text(json.dumps({
        "format_version": 1, "platform": "tpu",
        "device_kind": "TPU v5 lite",
    }))
    hlo = tdir / "modules" / "giant.hlo"
    with open(hlo, "w") as f:
        f.write("HloModule giant_stream, is_scheduled=true\n\n")
        for c in range(n_comps):
            f.write(f"%body_{c} (p0: f32[512,512]) -> f32[512,512] {{\n")
            f.write("  %p0 = f32[512,512]{1,0:T(8,128)} parameter(0)\n")
            prev = "%p0"
            for i in range(n_ops):
                f.write(
                    f"  %add_{i} = f32[512,512]{{1,0:T(8,128)}} "
                    f"add({prev}, %p0), metadata={{op_name="
                    f"\"layer{c}/add{i}/{pad}\" source_file=\"g.py\" "
                    f"source_line={i}}}\n"
                )
                prev = f"%add_{i}"
            f.write(f"  ROOT %root = f32[512,512]{{1,0:T(8,128)}} "
                    f"copy({prev})\n}}\n\n")
        f.write("ENTRY %main (p0: f32[512,512]) -> f32[512,512] {\n")
        f.write("  %p0 = f32[512,512]{1,0:T(8,128)} parameter(0)\n")
        prev = "%p0"
        for c in range(n_comps):
            f.write(f"  %call_{c} = f32[512,512]{{1,0:T(8,128)}} "
                    f"call({prev}), to_apply=%body_{c}\n")
            prev = f"%call_{c}"
        f.write(f"  ROOT %out = f32[512,512]{{1,0:T(8,128)}} "
                f"copy({prev})\n}}\n")
    return hlo


@pytest.mark.slow
def test_streaming_bounded_rss_on_200mb_trace(tmp_path):
    """A synthetic trace of 200 MB or more prices to completion in
    streaming mode with peak RSS above the import floor well below the
    trace size (the reference's bound, 0.35 x the file).  Runs in a
    subprocess so ru_maxrss measures this pricing run only."""
    n_comps, n_ops = 300, 1000
    hlo = write_giant_trace(tmp_path / "giant", n_comps, n_ops)
    size = hlo.stat().st_size
    assert size >= 200 * 1024 * 1024, f"generator produced {size} bytes"
    # no TPUSIM_ state may leak in and flip the streaming mode
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUSIM_")}
    env["PYTHONPATH"] = str(REPO)
    base = subprocess.run(
        [sys.executable, "-c", _GEN_SNIPPET, "--baseline"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
    )
    assert base.returncode == 0, base.stderr[-2000:]
    baseline = json.loads(base.stdout.strip().splitlines()[-1])["peak_kb"]
    proc = subprocess.run(
        [sys.executable, "-c", _GEN_SNIPPET, str(tmp_path / "giant")],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["sim_cycle"] > 0
    assert out["ops"] >= n_comps * n_ops
    added = (out["peak_kb"] - baseline) * 1024
    assert added < 0.35 * size, (
        f"streaming pricing added {added / 1e6:.0f} MB over the "
        f"{baseline * 1024 / 1e6:.0f} MB import floor — not well below "
        f"the {size / 1e6:.0f} MB trace"
    )

"""The port's lazy module (``tpusim_torch.trace.lazy``) against its eager
parse and against the JAX package's lazy module.

Over the 12-trace corpus (``reports/silicon/*`` and the two fixtures) a
lazily loaded module has the eager module's computations, op for op, the
same ``content_hash`` and the same raw-text residency as the eager IR
walk; it prices to the eager module's bytes under every arch; a walk
parses only the computations it reaches.  ``load_trace(defer_parse=)``
follows the JAX package's rule: ``None`` defers exactly when a compile
store is active and the parse is not lenient, and large modules always
parse lazily.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.timing.engine import _vmem_resident_bytes as ref_resident  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch import ir as port_ir  # noqa: E402
from tpusim_torch.fastpath.store import (  # noqa: E402
    CompileStore,
    set_compile_store,
)
from tpusim_torch.perf import cache as port_cache  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine, _vmem_resident_bytes  # noqa: E402
from tpusim_torch.trace import lazy as port_lazy  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORPUS = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [p for p in (REPO / "tests" / "fixtures" / "traces").iterdir()
       if p.is_dir()]
)
ARCHES = ("v4", "v5e", "v5p", "v6e")


@pytest.fixture(autouse=True)
def _no_store():
    set_compile_store(None)
    yield
    set_compile_store(None)


def _only(pod):
    [module] = pod.modules.values()
    return module


def _op(op):
    return (
        op.name, op.opcode, str(op.result), op.operands, op.called,
        op.fusion_kind,
        dataclasses.astuple(op.collective) if op.collective else None,
        op.attrs, op.metadata, op.is_root, op.flops, op.transcendentals,
    )


def _comp(c):
    return c.name, c.is_entry, [_op(o) for o in c.ops]


def _doc(result) -> str:
    return json.dumps(port_cache.result_to_doc(result))


def _reachable(module) -> set[str]:
    """Computations a schedule walk can reach from the entry."""
    seen, todo = set(), [module.entry_name]
    while todo:
        name = todo.pop()
        if name in seen or name not in module.computations:
            continue
        seen.add(name)
        for op in module.computations[name].ops:
            todo.extend(op.called)
            body = op.attrs.get("body", "").lstrip("%") if op.attrs else ""
            if body:
                todo.append(body)
    return seen


def test_corpus_has_twelve_traces():
    assert len(CORPUS) == 12


@pytest.mark.parametrize("trace", CORPUS, ids=lambda p: p.name)
def test_lazy_equals_eager_computation_for_computation(trace):
    eager = _only(load_trace(trace, defer_parse=False))
    lazy = _only(load_trace(trace, defer_parse=True))
    ref_lazy = _only(ref_load(trace, defer_parse=True))
    assert isinstance(lazy, port_lazy.LazyModuleTrace)
    assert not isinstance(eager, port_lazy.LazyModuleTrace)
    # nothing parses until asked, not even the span index
    assert lazy.parsed_count == 0 and lazy._spans_cache is None
    assert lazy.meta == eager.meta
    assert lazy.meta["content_hash"] == ref_lazy.meta["content_hash"]
    assert lazy.name == eager.name == ref_lazy.name
    assert lazy.entry_name == eager.entry_name == ref_lazy.entry_name
    assert list(lazy.computations) == list(ref_lazy.computations)
    assert sorted(lazy.computations) == sorted(eager.computations)
    for name in eager.computations:
        assert _comp(lazy.computations[name]) == \
            _comp(eager.computations[name]), name
    assert lazy.parsed_count == len(eager.computations)


@pytest.mark.parametrize("trace", CORPUS, ids=lambda p: p.name)
def test_residency_scan_equals_the_eager_walk(trace):
    eager = _only(load_trace(trace, defer_parse=False))
    lazy = _only(load_trace(trace, defer_parse=True))
    got = lazy.vmem_resident_bytes()
    assert got == _vmem_resident_bytes(eager)
    assert got == _only(ref_load(trace, defer_parse=True)).vmem_resident_bytes()
    assert got == ref_resident(_only(ref_load(trace, defer_parse=False)))
    assert lazy.parsed_count == 0  # the scan parses nothing


@pytest.mark.parametrize("arch", ARCHES)
def test_lazy_prices_to_the_eager_bytes(arch):
    """Every corpus module, lazily loaded, prices to the eager module's
    document under the fastpath — residency and the peak-live refinement
    included — and parses only computations its walk reaches."""
    cfg = load_config(arch=arch, tuned=False)
    for trace in CORPUS:
        eager = _only(load_trace(trace, defer_parse=False))
        lazy = _only(load_trace(trace, defer_parse=True))
        port_cache.clear_compiled_cache()
        want = _doc(Engine(cfg).run(eager))
        port_cache.clear_compiled_cache()
        assert _doc(Engine(cfg).run(lazy)) == want, (trace.name, arch)
        parsed = set(dict.keys(lazy.computations))
        assert parsed <= set(eager.computations)
    port_cache.clear_compiled_cache()


def test_serial_walk_of_lazy_equals_eager_over_cap():
    """``decode_step``'s residency is over v5e's vmem, so the walk takes
    the peak-live refinement, which reads computations through
    ``computations.get``: a lazy module must parse there, not return
    None (the eager walk's 119685120 bytes, not 0)."""
    trace = REPO / "reports" / "silicon" / "decode_step"
    cfg = load_config(arch="v5e", tuned=False)
    eager = Engine(cfg, pricing_backend="serial").run(
        _only(load_trace(trace, defer_parse=False)))
    lazy = Engine(cfg, pricing_backend="serial").run(
        _only(load_trace(trace, defer_parse=True)))
    assert eager.vmem_resident_bytes == 119685120.0
    assert _doc(lazy) == _doc(eager)


def _synthetic_module(n_unreachable: int) -> str:
    """ENTRY, one reachable fusion and ``n_unreachable`` dead
    computations."""
    parts = ["HloModule synthetic, is_scheduled=true", ""]
    parts.append(
        "%live_fusion (p0: f32[256,256]) -> f32[256,256] {\n"
        "  %p0 = f32[256,256]{1,0} parameter(0)\n"
        "  %czero = f32[] constant(0)\n"
        "  %bz = f32[256,256]{1,0} broadcast(%czero), dimensions={}\n"
        "  ROOT %mx = f32[256,256]{1,0} maximum(%p0, %bz)\n"
        "}\n"
    )
    for i in range(n_unreachable):
        parts.append(
            f"%dead.{i} (a: f32[128,128]) -> f32[128,128] {{\n"
            f"  %a = f32[128,128]{{1,0}} parameter(0)\n"
            f"  ROOT %r.{i} = f32[128,128]{{1,0}} add(%a, %a)\n"
            "}\n"
        )
    parts.append(
        "ENTRY %main (x: f32[256,256], w: f32[256,256]) -> f32[256,256] {\n"
        "  %x = f32[256,256]{1,0} parameter(0)\n"
        "  %w = f32[256,256]{1,0} parameter(1)\n"
        "  %dot.0 = f32[256,256]{1,0} dot(%x, %w), "
        "lhs_contracting_dims={1}, rhs_contracting_dims={0}\n"
        "  ROOT %f = f32[256,256]{1,0} fusion(%dot.0), kind=kLoop, "
        "calls=%live_fusion\n"
        "}\n"
    )
    return "\n".join(parts)


@pytest.mark.parametrize("backend", ["serial", "vectorized"])
def test_walk_parses_only_reachable_computations(backend):
    text = _synthetic_module(n_unreachable=50)
    mod = port_lazy.parse_hlo_module_lazy(text)
    assert len(mod.computations) == 52
    assert mod.parsed_count == 0
    port_cache.clear_compiled_cache()
    lazy_doc = _doc(Engine(load_config(arch="v5e"),
                           pricing_backend=backend).run(mod))
    assert set(dict.keys(mod.computations)) == {"main", "live_fusion"}
    assert "dead.0" in mod.computations  # membership parses nothing
    assert mod.parsed_count == 2
    port_cache.clear_compiled_cache()
    assert lazy_doc == _doc(Engine(load_config(arch="v5e"),
                                   pricing_backend=backend).run(
        parse_hlo_module(text)))
    port_cache.clear_compiled_cache()


@pytest.mark.parametrize("trace", CORPUS, ids=lambda p: p.name)
def test_corpus_walk_stays_within_reachable(trace):
    eager = _only(load_trace(trace, defer_parse=False))
    lazy = _only(load_trace(trace, defer_parse=True))
    Engine(load_config(arch="v5p", tuned=False),
           pricing_backend="serial").run(lazy)
    assert set(dict.keys(lazy.computations)) <= _reachable(eager)


def test_cache_identity_does_not_parse():
    """Fingerprint and collective scan of a lazy module read its text,
    never its IR, and agree with the eager module's."""
    llama = REPO / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"
    for trace, uses in ((llama, True), (CORPUS[0], False)):
        eager = _only(load_trace(trace, defer_parse=False))
        lazy = _only(load_trace(trace, defer_parse=True))
        assert port_cache.module_fingerprint(lazy) == \
            port_cache.module_fingerprint(eager)
        assert port_cache.module_uses_ici(lazy) is \
            port_cache.module_uses_ici(eager) is uses
        assert lazy.parsed_count == 0
    text = _synthetic_module(1)
    bare = port_lazy.parse_hlo_module_lazy(text)  # no content_hash stamp
    assert port_cache.module_fingerprint(bare) == port_cache._sha(text)
    assert bare.parsed_count == 0


def test_defer_parse_rule(tmp_path, monkeypatch):
    trace = REPO / "tests" / "fixtures" / "traces" / "matmul_512"
    lazy_cls = port_lazy.LazyModuleTrace
    assert not isinstance(_only(load_trace(trace)), lazy_cls)
    set_compile_store(CompileStore(tmp_path))
    assert isinstance(_only(load_trace(trace)), lazy_cls)
    assert not isinstance(_only(load_trace(trace, lenient=True)), lazy_cls)
    assert not isinstance(_only(load_trace(trace, defer_parse=False)),
                          lazy_cls)
    set_compile_store(None)
    assert isinstance(_only(load_trace(trace, defer_parse=True)), lazy_cls)
    # modules at or above the threshold parse lazily in any case
    monkeypatch.setattr(port_lazy, "LAZY_THRESHOLD_BYTES", 1024)
    assert isinstance(_only(load_trace(trace, defer_parse=False)), lazy_cls)
    assert not isinstance(_only(load_trace(trace, lenient=True)), lazy_cls)


def test_ir_build_counter_counts_parsed_ops():
    text = (REPO / "tests" / "fixtures" / "traces" / "matmul_512" /
            "modules" / "matmul_512.hlo").read_text()
    before = port_ir.ir_build_counter["ops"]
    eager = parse_hlo_module(text)
    n_ops = sum(len(c.ops) for c in eager.computations.values())
    assert n_ops > 0
    assert port_ir.ir_build_counter["ops"] - before == n_ops
    lazy = port_lazy.parse_hlo_module_lazy(text)
    mid = port_ir.ir_build_counter["ops"]
    assert lazy.entry_name == eager.entry_name
    assert port_ir.ir_build_counter["ops"] == mid  # the index builds no IR
    list(lazy.computations.values())
    assert port_ir.ir_build_counter["ops"] - mid == n_ops

"""The critical-path analyzer (``tpusim_torch.analysis.critpath``)
against the JAX package's, live and in the same process.

* 12 traces x {v5e, v5p}: ``module_perf_doc(analyze_module_perf(...))``
  equals the JAX package's by ``==``, and in the port the critical path
  is at most the engine's cycles, which are at most the serial sum
  (with every collective's exposed cycles within its priced cycles);
* the streaming mode (``CritBuilder.feed`` in dump order, then
  ``finish``) equals the JAX package's streaming result;
* the diamond, async-window and while/call cases of
  ``tests/test_critpath.py``, in the port and equal to the reference;
* the helpers it reads from the cost model (``classify_bound``,
  ``shape_memory_bytes``) equal the reference's on every op.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.analysis import critpath as ref_cp  # noqa: E402
from tpusim.timing import cost as ref_cost  # noqa: E402
from tpusim.timing.config import load_config as ref_config  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim.trace.hlo_text import parse_hlo_module as ref_parse  # noqa: E402
from tpusim_torch.analysis import (  # noqa: E402
    CritBuilder,
    analyze_module_perf,
    module_perf_doc,
)
from tpusim_torch.analysis import critpath as cp_mod  # noqa: E402
from tpusim_torch.timing import cost  # noqa: E402
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402
from tpusim_torch.trace.format import load_trace  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
SILICON = REPO / "reports" / "silicon"


def corpus_dirs() -> list[Path]:
    return [FIXTURES / "llama_tiny_tp2dp2", FIXTURES / "matmul_512"] + \
        sorted(d for d in SILICON.iterdir() if (d / "modules").is_dir())


_PODS: dict = {}


def pods(trace_dir: Path):
    """(port pod, reference pod), loaded once per trace."""
    if trace_dir not in _PODS:
        _PODS[trace_dir] = (load_trace(trace_dir), ref_load(trace_dir))
    return _PODS[trace_dir]


def test_constants_equal_reference():
    assert cp_mod._MAX_DEPTH == ref_cp._MAX_DEPTH == 32
    assert cp_mod.TL501_EXPOSED_FRAC == ref_cp.TL501_EXPOSED_FRAC
    assert set(cp_mod.__all__) == set(ref_cp.__all__)


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
@pytest.mark.parametrize("trace_dir", corpus_dirs(), ids=lambda d: d.name)
def test_corpus_doc_equals_reference_and_inequality(trace_dir, arch):
    pod, rpod = pods(trace_dir)
    cfg, rcfg = load_config(arch=arch, tuned=False), \
        ref_config(arch=arch, tuned=False)
    assert pod.modules
    for name in sorted(pod.modules):
        mod = pod.modules[name]
        mp = analyze_module_perf(mod, cfg)
        want = ref_cp.module_perf_doc(
            ref_cp.analyze_module_perf(rpod.modules[name], rcfg))
        assert module_perf_doc(mp) == want
        eng = Engine(cfg).run(mod).cycles
        tol = 1e-6 * max(eng, 1.0)
        assert mp.critical_path_cycles <= eng + tol, name
        assert eng <= mp.serial_cycles + tol, name
        for comp in mp.comps.values():
            assert comp.exposed_collective_cycles <= \
                comp.collective_cycles + tol
            for e in comp.exposures:
                assert -tol <= e.exposed_cycles <= e.priced_cycles + tol


@pytest.mark.parametrize("trace_dir", corpus_dirs(), ids=lambda d: d.name)
def test_streaming_feed_equals_reference(trace_dir):
    pod, rpod = pods(trace_dir)
    cfg, rcfg = load_config(arch="v5p", tuned=False), \
        ref_config(arch="v5p", tuned=False)
    for name in sorted(pod.modules):
        mod, rmod = pod.modules[name], rpod.modules[name]
        builder = CritBuilder(cfg, num_devices=mod.num_devices)
        rbuilder = ref_cp.CritBuilder(rcfg, num_devices=rmod.num_devices)
        for cname in mod.computations:
            builder.feed(mod.computations[cname])
            rbuilder.feed(rmod.computations[cname])
        got = module_perf_doc(builder.finish(mod.entry_name))
        assert got == ref_cp.module_perf_doc(rbuilder.finish(rmod.entry_name))
        json.dumps(got)


@pytest.mark.parametrize("fixture", ["llama_tiny_tp2dp2", "matmul_512"])
def test_cost_helpers_equal_reference(fixture):
    pod, rpod = pods(FIXTURES / fixture)
    for arch in ("v5e", "v5p"):
        cfg, rcfg = load_config(arch=arch, tuned=False), \
            ref_config(arch=arch, tuned=False)
        model, rmodel = cost.CostModel(cfg.arch), ref_cost.CostModel(rcfg.arch)
        for name, mod in pod.modules.items():
            rmod = rpod.modules[name]
            for cname, comp in mod.computations.items():
                rcomp = rmod.computations[cname]
                for op, rop in zip(comp.ops, rcomp.ops, strict=True):
                    assert cost.shape_memory_bytes(comp, op, mod) == \
                        ref_cost.shape_memory_bytes(rcomp, rop, rmod)
                    c = model.op_cost(op, comp, mod)
                    rc = rmodel.op_cost(rop, rcomp, rmod)
                    assert cost.classify_bound(c, cfg.arch) == \
                        ref_cost.classify_bound(rc, rcfg.arch)


# -- DAG semantics (tests/test_critpath.py's cases) ---------------------------

_DIAMOND = """HloModule diamond, is_scheduled=true

ENTRY %main (p0: f32[512,512]) -> f32[512,512] {
  %p0 = f32[512,512]{1,0} parameter(0)
  %d1 = f32[512,512]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %d2 = f32[512,512]{1,0} dot(%d1, %d1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %b = f32[512,512]{1,0} negate(%p0)
  ROOT %join = f32[512,512]{1,0} add(%d2, %b)
}
"""

_ASYNC_TMPL = """HloModule ac, is_scheduled=true, num_partitions=4

%r (a: f32[], b: f32[]) -> f32[] {{
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}}

ENTRY %main (p0: f32[2097152], p1: f32[1024,1024]) -> f32[2097152] {{
  %p0 = f32[2097152]{{0}} parameter(0)
  %p1 = f32[1024,1024]{{1,0}} parameter(1)
  %st = f32[2097152]{{0}} all-reduce-start(%p0), channel_id=1, replica_groups={{{{0,1,2,3}}}}, to_apply=%r
{overlap}  %dn = f32[2097152]{{0}} all-reduce-done(%st)
  ROOT %out = f32[2097152]{{0}} add(%dn, %dn)
}}
"""

_DOT_LINE = (
    "  %dot = f32[1024,1024]{1,0} dot(%p1, %p1), "
    "lhs_contracting_dims={1}, rhs_contracting_dims={0}\n"
)

_WHILE_TMPL = """HloModule wh, is_scheduled=true

%body (p: f32[512,512]) -> f32[512,512] {{
  %p = f32[512,512]{{1,0}} parameter(0)
  ROOT %d = f32[512,512]{{1,0}} dot(%p, %p), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}

%cond (q: f32[512,512]) -> pred[] {{
  %q = f32[512,512]{{1,0}} parameter(0)
  ROOT %t = pred[] constant(true)
}}

ENTRY %main (p0: f32[512,512]) -> f32[512,512] {{
  %p0 = f32[512,512]{{1,0}} parameter(0)
  ROOT %w = f32[512,512]{{1,0}} while(%p0), condition=%cond, body=%body, backend_config={{"known_trip_count":{{"n":"{trips}"}}}}
}}
"""


def _both(text: str, arch: str = "v5e"):
    """The port's ModulePerf of ``text``, after holding its document
    against the reference's."""
    mp = analyze_module_perf(parse_hlo_module(text),
                             load_config(arch=arch, tuned=False))
    want = ref_cp.analyze_module_perf(ref_parse(text),
                                      ref_config(arch=arch, tuned=False))
    assert module_perf_doc(mp) == ref_cp.module_perf_doc(want)
    return mp


def test_diamond_slack():
    mp = _both(_DIAMOND)
    comp = next(iter(mp.comps.values()))
    ops = {o.name: o for o in comp.ops}
    for n in ("d1", "d2", "join"):
        assert ops[n].on_critical_path, n
        assert ops[n].slack == pytest.approx(0.0, abs=1e-6), n
    assert not ops["b"].on_critical_path
    assert ops["b"].slack == pytest.approx(ops["d2"].finish - ops["b"].finish)
    assert comp.critical_path_cycles == pytest.approx(
        max(o.finish for o in comp.ops))
    assert all(o.slack >= -1e-6 for o in comp.ops)
    assert [n for n, _, _ in comp.critical_ops][-1] == "join"


def test_async_halves_span_issue_window():
    bare = _both(_ASYNC_TMPL.format(overlap=""))
    lapped = _both(_ASYNC_TMPL.format(overlap=_DOT_LINE))
    e0 = next(iter(bare.comps.values())).exposures[0]
    e1 = next(iter(lapped.comps.values())).exposures[0]
    assert e0.priced_cycles == pytest.approx(e1.priced_cycles)
    assert e1.exposed_cycles < e0.exposed_cycles
    assert e1.overlapped_cycles > e0.overlapped_cycles
    assert lapped.exposed_collective_cycles < bare.exposed_collective_cycles


@pytest.mark.parametrize("arch", ["v5e", "v5p"])
def test_while_call_composition(arch):
    cfg = load_config(arch=arch, tuned=False)
    totals = {}
    for trips in (1, 8):
        text = _WHILE_TMPL.format(trips=trips)
        mp = _both(text, arch)
        eng = Engine(cfg).run(parse_hlo_module(text)).cycles
        tol = 1e-6 * eng
        assert mp.critical_path_cycles <= eng + tol
        assert eng <= mp.serial_cycles + tol
        totals[trips] = mp.critical_path_cycles
    assert totals[8] > 4 * totals[1]


def test_module_doc_shape():
    doc = module_perf_doc(_both(_DIAMOND))
    for k in ("module", "entry", "critical_path_cycles", "serial_cycles",
              "collective_cycles", "exposed_collective_cycles",
              "computations"):
        assert k in doc, k
    comp = next(iter(doc["computations"].values()))
    for k in ("critical_path_cycles", "serial_cycles", "op_count",
              "dominant_bound", "bound_cycles", "critical_path", "ops",
              "exposures"):
        assert k in comp, k
    assert comp["critical_path"]
    json.dumps(doc)

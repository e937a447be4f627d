"""The whole-trace dataflow engine (``tpusim_torch.analysis.dataflow``)
against the JAX package's, live and in the same process.

* every module of the 12-trace corpus (the two fixtures and the silicon
  captures): ``peaks()``, ``alloc_total(space)``, each computation's
  def-use chains, schedule defects and live intervals equal the JAX
  package's by ``==``; the vmem numbers equal the port's engine walk
  (``_vmem_resident_bytes``, ``Engine._peak_live_of``), as
  ``tests/test_dataflow.py`` holds the reference to its engine;
* the memo on the module;
* the def-use, interval and alias-extension cases of
  ``tests/test_dataflow.py``, in both packages.
"""

from __future__ import annotations

from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.analysis import dataflow as ref_df  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim.trace.hlo_text import parse_hlo_module as ref_parse  # noqa: E402
from tpusim_torch.analysis import dataflow as df  # noqa: E402
from tpusim_torch.timing.engine import (  # noqa: E402
    Engine,
    _vmem_resident_bytes,
)
from tpusim_torch.trace.format import load_trace  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
SILICON = REPO / "reports" / "silicon"


def corpus_dirs() -> list[Path]:
    """The two fixtures and every silicon capture (12 traces)."""
    return [FIXTURES / "llama_tiny_tp2dp2", FIXTURES / "matmul_512"] + \
        sorted(d for d in SILICON.iterdir() if (d / "modules").is_dir())


def test_corpus_has_twelve_traces():
    assert len(corpus_dirs()) == 12


def _comp_view(cdf) -> tuple:
    s = cdf.summary
    return (cdf.name, cdf.is_entry, cdf.defs, cdf.uses, cdf.undefined,
            cdf.misordered,
            [(iv.name, iv.space, iv.nbytes, iv.start, iv.end)
             for iv in cdf.intervals],
            s.alloc, s.local_peak,
            [(c.index, c.live, c.carried, c.callees) for c in s.call_sites])


@pytest.mark.parametrize("trace_dir", corpus_dirs(), ids=lambda d: d.name)
def test_corpus_equals_reference(trace_dir):
    pod, rpod = load_trace(trace_dir), ref_load(trace_dir)
    assert sorted(pod.modules) == sorted(rpod.modules)
    for name in sorted(pod.modules):
        mod, rmod = pod.modules[name], rpod.modules[name]
        got, want = df.analyze_module(mod), ref_df.analyze_module(rmod)
        assert got.entry_name == want.entry_name
        assert got.peaks() == want.peaks()
        for space in df.SPACES:
            assert got.alloc_total(space) == want.alloc_total(space)
            assert got.peak_live(space) == want.peak_live(space)
        # each computation's chains and intervals, fed in dump order
        builder, rbuilder = df.ModuleDataflowBuilder(), \
            ref_df.ModuleDataflowBuilder()
        for cname in mod.computations:
            entry = cname == mod.entry_name
            assert _comp_view(builder.feed(mod.computations[cname], entry)) \
                == _comp_view(rbuilder.feed(rmod.computations[cname], entry))
        assert builder.finish().peaks() == got.peaks()
        # the engine's capacity walk, in the port
        assert got.alloc_total("vmem") == _vmem_resident_bytes(mod)
        assert got.peak_live("vmem") == Engine._peak_live_of(mod)
        assert 0 < got.peak_live("hbm") <= got.alloc_total("hbm")


_TINY = (
    "HloModule m\n\n"
    "ENTRY %main (p0: f32[8]) -> f32[8] {\n"
    "  %p0 = f32[8]{0} parameter(0)\n"
    "  ROOT %r = f32[8]{0} negate(%p0)\n"
    "}\n"
)


def test_analyze_module_memoizes_on_the_module():
    mod = parse_hlo_module(_TINY, name_hint="m")
    first = df.analyze_module(mod)
    assert first is df.analyze_module(mod)
    assert mod._dataflow_cache is first


_DEFECTS = (
    "HloModule m\n\n"
    "ENTRY %main (p0: f32[8]) -> f32[8] {\n"
    "  %p0 = f32[8]{0} parameter(0)\n"
    "  %a = f32[8]{0} add(%p0, %b)\n"
    "  %b = f32[8]{0} negate(%p0)\n"
    "  ROOT %r = f32[8]{0} add(%a, %ghost)\n"
    "}\n"
)

_CHAIN = (
    "HloModule m\n\n"
    "ENTRY %main (p0: f32[1024]) -> f32[1024] {\n"
    "  %p0 = f32[1024]{0} parameter(0)\n"
    "  %a = f32[1024]{0} negate(%p0)\n"
    "  %b = f32[1024]{0} negate(%a)\n"
    "  ROOT %r = f32[1024]{0} add(%b, %b)\n"
    "}\n"
)

_ALIAS = (
    "HloModule m\n\n"
    "ENTRY %main (p0: f32[1024]) -> f32[1024] {\n"
    "  %p0 = f32[1024]{0} parameter(0)\n"
    "  %t = (f32[1024]{0}) tuple(%p0)\n"
    "  %g = f32[1024]{0} get-tuple-element(%t), index=0\n"
    "  %x = f32[1024]{0} negate(%p0)\n"
    "  ROOT %r = f32[1024]{0} add(%g, %x)\n"
    "}\n"
)


def _entry_flow(text: str):
    """The port's and the reference's dataflow of the entry of ``text``."""
    got = df.ModuleDataflowBuilder().feed(
        parse_hlo_module(text, name_hint="m").entry, is_entry=True)
    want = ref_df.ModuleDataflowBuilder().feed(
        ref_parse(text, name_hint="m").entry, is_entry=True)
    assert _comp_view(got) == _comp_view(want)
    return got


def test_def_use_chains_and_schedule_defects():
    cdf = _entry_flow(_DEFECTS)
    assert not cdf.schedule_ok
    assert cdf.undefined == [(3, "ghost")]
    assert cdf.misordered == [(1, "b", 2)]
    assert cdf.defs["a"] == 1
    assert cdf.uses["p0"] == [1, 2]
    assert cdf.uses["a"] == [3]


def test_liveness_intervals_cover_def_to_last_use():
    cdf = _entry_flow(_CHAIN)
    assert cdf.schedule_ok
    spans = {iv.name: (iv.start, iv.end) for iv in cdf.intervals
             if iv.space == "hbm"}
    assert spans == {"p0": (0, 1), "a": (1, 2), "b": (2, 3), "r": (3, 4)}
    assert cdf.summary.local_peak["hbm"] == 2 * 4096
    assert cdf.summary.alloc["hbm"] == 4 * 4096


def test_alias_extension_keeps_source_alive():
    cdf = _entry_flow(_ALIAS)
    spans = {iv.name: (iv.start, iv.end) for iv in cdf.intervals}
    # p0 lives to the root (index 4) through the %t -> %g chain
    assert spans["p0"][1] == 4
    assert "t" not in spans and "g" not in spans


@pytest.mark.parametrize("is_entry", [True, False])
def test_alloc_bytes_by_space_equals_reference(is_entry):
    for text in (_DEFECTS, _CHAIN, _ALIAS):
        ops = parse_hlo_module(text, name_hint="m").entry.ops
        rops = ref_parse(text, name_hint="m").entry.ops
        for op, rop in zip(ops, rops, strict=True):
            assert df.alloc_bytes_by_space(op, is_entry) == \
                ref_df.alloc_bytes_by_space(rop, is_entry)

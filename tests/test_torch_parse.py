"""The port's HLO parser and trace loader against the JAX package's.

Every corpus trace (the ten ``reports/silicon/*`` captures and the two
``tests/fixtures/traces/*`` fixtures) must load into the same
computations, each with the same ops: name, opcode, result shape,
operands, called computations, attributes and collective metadata.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim.trace.hlo_text import parse_hlo_module as ref_parse  # noqa: E402
from tpusim_torch.trace.format import load_trace as port_load  # noqa: E402
from tpusim_torch.trace.hlo_text import parse_hlo_module as port_parse  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORPUS = sorted(
    [p for p in (REPO / "reports" / "silicon").iterdir() if p.is_dir()]
    + [p for p in (REPO / "tests" / "fixtures" / "traces").iterdir()
       if p.is_dir()]
)


def _spec(s):
    """A shape as plain data (the two packages' classes never compare
    equal to each other)."""
    if hasattr(s, "parts"):
        return ("tuple", tuple(_spec(p) for p in s.parts))
    return (s.dtype, s.shape, s.layout, s.tiling, s.memory_space)


def _op(op):
    return (
        op.name, op.opcode, _spec(op.result), op.operands, op.called,
        op.fusion_kind,
        dataclasses.astuple(op.collective) if op.collective else None,
        op.attrs, op.metadata, op.is_root, op.flops, op.transcendentals,
    )


def _module(m):
    return (
        m.name, m.entry_name,
        {k: v for k, v in m.meta.items() if k != "content_hash"},
        {name: (c.is_entry, [_op(o) for o in c.ops])
         for name, c in m.computations.items()},
    )


def _commands(pod):
    return {
        d: [(c.kind.value, c.stream_id, c.device_id, c.nbytes, c.module,
             dataclasses.astuple(c.collective) if c.collective else None,
             c.attrs) for c in dev.commands]
        for d, dev in pod.devices.items()
    }


def test_corpus_has_twelve_traces():
    assert len(CORPUS) == 12


@pytest.mark.parametrize("trace", CORPUS, ids=lambda p: p.name)
def test_load_trace_matches_reference(trace):
    ref, port = ref_load(trace), port_load(trace)
    assert port.meta == ref.meta
    assert sorted(port.modules) == sorted(ref.modules)
    for name in ref.modules:
        assert _module(port.modules[name]) == _module(ref.modules[name])
    assert _commands(port) == _commands(ref)


def test_lenient_parse_matches_reference():
    text = (REPO / "tests" / "fixtures" / "traces" / "matmul_512" /
            "modules" / "matmul_512.hlo").read_text()
    lines = text.splitlines()
    # tear two instruction lines of the entry computation the same way
    torn = [i for i, ln in enumerate(lines) if " = " in ln][-3:-1]
    for i in torn:
        lines[i] = lines[i].split(" = ")[0] + " = f32[12,x]{1,0} copy(%p)"
    damaged = "\n".join(lines)
    with pytest.raises(ValueError):
        port_parse(damaged)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = ref_parse(damaged, strict=False)
        port = port_parse(damaged, strict=False)
    assert port.meta["parse_skipped_lines"] == 2
    assert _module(port) == _module(ref)

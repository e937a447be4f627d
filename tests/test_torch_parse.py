"""The port's HLO parser and trace loader against the JAX package's.

Every corpus trace (the ten ``reports/silicon/*`` captures and the two
``tests/fixtures/traces/*`` fixtures) must load into the same
computations, each with the same ops: name, opcode, result shape,
operands, called computations, attributes and collective metadata.

A trace that mixes plain ``.hlo`` and gzipped ``.hlo.gz`` modules and has
no command list must load its modules in the JAX package's order (plain
sorted, then gzipped sorted), which is also the order of its implicit
one-launch-per-module stream: ``info`` and a ``--resume-kernel 1`` run
must equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.__main__ import main as ref_main  # noqa: E402
from tpusim.sim.driver import simulate_trace as ref_simulate  # noqa: E402
from tpusim.trace.format import load_trace as ref_load  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.sim.driver import simulate_trace as port_simulate  # noqa: E402
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


# -- C1: module order of a mixed .hlo / .hlo.gz trace -------------------------


@pytest.fixture
def mixed_trace(tmp_path):
    """A trace with no command list whose gzipped module sorts first by
    name (``a_big`` = ``matmul_512``) and whose plain one sorts second
    (``b_small`` = silicon ``reduction``)."""
    mods = tmp_path / "mixed" / "modules"
    mods.mkdir(parents=True)
    big = (REPO / "tests" / "fixtures" / "traces" / "matmul_512" /
           "modules" / "matmul_512.hlo").read_text()
    with gzip.open(mods / "a_big.hlo.gz", "wt") as f:
        f.write(big)
    (mods / "b_small.hlo").write_text(
        (REPO / "reports" / "silicon" / "reduction" / "modules" /
         "reduction.hlo").read_text())
    return tmp_path / "mixed"


def test_mixed_trace_module_order_matches_reference(mixed_trace):
    ref, port = ref_load(mixed_trace), port_load(mixed_trace)
    assert list(ref.modules) == ["b_small", "a_big"]
    assert list(port.modules) == list(ref.modules)
    assert _commands(port) == _commands(ref)


def test_mixed_trace_info_matches_reference(mixed_trace, capsys):
    assert ref_main(["info", str(mixed_trace)]) == 0
    want = capsys.readouterr().out
    assert port_main(["info", str(mixed_trace)]) == 0
    assert capsys.readouterr().out == want
    assert list(json.loads(want)["modules"]) == ["b_small", "a_big"]


def test_mixed_trace_resume_kernel_matches_reference(mixed_trace):
    """``--resume-kernel 1`` skips the first launch of the implicit
    stream: which module that is decides every total."""
    overlays = [{"resume_kernel": 1}]
    ref = json.loads(ref_simulate(mixed_trace, arch="v5e", tuned=False,
                                  overlays=overlays).stats.to_json())
    port = json.loads(port_simulate(mixed_trace, arch="v5e", tuned=False,
                                    overlays=overlays).stats.to_json())
    volatile = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
    assert set(port) == set(ref)
    for key in sorted(set(ref) - volatile):
        r, p = ref[key], port[key]
        if isinstance(r, (int, float)):
            assert abs(p - r) <= 1e-9 * max(abs(p), abs(r), 1e-30), key
        else:
            assert p == r, key

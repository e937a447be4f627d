"""While-loop trip-count inference.

Port of ``tpusim/trace/loop_analysis.py``.

XLA records ``known_trip_count`` in the while op's ``backend_config`` on some
backends, but not all (some TPU backends omit it).  ``lax.scan`` /
``fori_loop`` loops still follow a canonical induction pattern in HLO:

* the loop carry is a tuple with an ``s32`` induction variable at index *i*;
* the condition computation's root is ``compare(gte_i(param), constant)``;
* the body's root tuple carries ``add(gte_i(param), constant_step)`` at *i*.

This pass recovers the trip count from that pattern — the structural
analogue of the reference's kernel-header parsing (grid dims from the trace
header, ``trace_parser.cc:299``): without it a traced loop would be timed as
a single iteration.
"""

from __future__ import annotations

import re

from tpusim_torch.ir import Computation, ModuleTrace, TraceOp

__all__ = ["infer_trip_count"]

_PASSTHROUGH = ("copy", "convert", "bitcast", "bitcast-convert", "reshape")

_INT_LITERAL_RE = re.compile(r"-?\d+")


def _chase(comp: Computation, name: str, depth: int = 0) -> TraceOp | None:
    """Follow copy/convert chains to the defining op."""
    if depth > 8 or not comp.has_op(name):
        return None
    op = comp.op(name)
    if op.base in _PASSTHROUGH and op.operands:
        return _chase(comp, op.operands[0], depth + 1)
    return op


def _scalar_const(comp: Computation, name: str) -> int | None:
    op = _chase(comp, name)
    if op is None or op.opcode != "constant":
        return None
    m = _INT_LITERAL_RE.search(op.attrs.get("literal", ""))
    return int(m.group(0)) if m else None


def _gte_index(comp: Computation, name: str) -> int | None:
    op = _chase(comp, name)
    if op is None:
        return None
    if op.opcode == "get-tuple-element":
        try:
            return int(op.attrs.get("index", ""))
        except ValueError:
            return None
    return None


def _tuple_element(comp: Computation, tuple_name: str, idx: int) -> str | None:
    op = _chase(comp, tuple_name)
    if op is None or op.base != "tuple" or idx >= len(op.operands):
        return None
    return op.operands[idx]


def infer_trip_count(
    module: ModuleTrace,
    comp: Computation,
    while_op: TraceOp,
    default: int = 1,
) -> int:
    """Trip count of ``while_op`` (which lives in ``comp``), or ``default``."""
    cond_name = while_op.attrs.get("condition", "").lstrip("%")
    body_name = while_op.attrs.get("body", "").lstrip("%")
    if cond_name not in module.computations or body_name not in module.computations:
        return default
    cond = module.computation(cond_name)
    body = module.computation(body_name)

    root = _chase(cond, cond.root.name)
    if root is None or root.base != "compare" or len(root.operands) != 2:
        return default
    direction = root.attrs.get("direction", "LT")

    # which side is the induction variable?
    idx = _gte_index(cond, root.operands[0])
    bound = _scalar_const(cond, root.operands[1])
    flipped = False
    if idx is None:
        idx = _gte_index(cond, root.operands[1])
        bound = _scalar_const(cond, root.operands[0])
        flipped = True
    if idx is None or bound is None:
        return default

    # start value: while's init tuple element at idx
    if not while_op.operands:
        return default
    init_name = _tuple_element(comp, while_op.operands[0], idx)
    start = _scalar_const(comp, init_name) if init_name else None
    if start is None:
        return default

    # step: body root tuple element at idx = add(gte_idx, const)
    body_elem_name = _tuple_element(body, body.root.name, idx)
    if body_elem_name is None:
        return default
    upd = _chase(body, body_elem_name)
    if upd is None or upd.base not in ("add", "subtract"):
        return default
    step = None
    for operand in upd.operands:
        c = _scalar_const(body, operand)
        if c is not None:
            step = -c if upd.base == "subtract" else c
            break
    if step is None or step == 0:
        return default

    # normalize: iv on the left of the comparison
    if flipped:
        direction = {"LT": "GT", "GT": "LT", "LE": "GE", "GE": "LE"}.get(
            direction, direction
        )

    span = None
    if direction == "LT" and step > 0:
        span = bound - start
    elif direction == "LE" and step > 0:
        span = bound - start + 1
    elif direction == "GT" and step < 0:
        span = start - bound
        step = -step
    elif direction == "GE" and step < 0:
        span = start - bound + 1
        step = -step
    if span is None or span <= 0:
        return default if span is None else 0
    return max((span + step - 1) // step, 0)

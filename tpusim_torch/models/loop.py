"""``scan`` for the port's programs: torch's ``scan`` higher-order op when
traced (capture lowers it to one ``while`` with its trip count), a Python
loop over the trips when run.

Run eagerly, torch's ``scan`` compiles its body through dynamo for each
new program and calls it once more than its trips (torch 2.11).  In a
rank process of a multi-device workload that is a compile of tens of
seconds a rank on the card and one more collective a step.  The loop runs
each trip once, with the same ops in the same order, and stacks the
per-trip outputs as the op does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

__all__ = ["scan"]


def _traced(leaves: list) -> bool:
    """Whether the program is being traced (over fake tensors, or by
    dynamo), not run."""
    from torch._subclasses.fake_tensor import is_fake

    return torch.compiler.is_compiling() or any(
        is_fake(t) for t in leaves if isinstance(t, torch.Tensor))


def scan(combine_fn: Callable, init: Any, xs: Any, *, dim: int = 0,
         reverse: bool = False) -> tuple[Any, Any]:
    """``torch._higher_order_ops.scan.scan(combine_fn, init, xs, dim=dim,
    reverse=reverse)``: ``combine_fn(carry, x) -> (carry, y)`` over the
    slices of ``xs`` along ``dim`` (last to first with ``reverse``); the
    final carry and the ``y``'s stacked along ``dim`` in the order of
    ``xs``."""
    from torch._higher_order_ops.scan import scan as scan_op

    x_leaves, x_spec = pytree.tree_flatten(xs)
    if _traced(pytree.tree_leaves(init) + x_leaves):
        return scan_op(combine_fn, init, xs, dim=dim, reverse=reverse)
    trips = range(x_leaves[0].shape[dim])
    carry, ys = init, []
    for i in (reversed(trips) if reverse else trips):
        x = pytree.tree_unflatten([t.select(dim, i) for t in x_leaves],
                                  x_spec)
        carry, y = combine_fn(carry, x)
        ys.append(y)
    if reverse:
        ys.reverse()
    y_leaves = [pytree.tree_flatten(y)[0] for y in ys]
    spec = pytree.tree_flatten(ys[0])[1]
    stacked = []
    for col in zip(*y_leaves):
        out = torch.stack(col)
        stacked.append(out.movedim(0, dim) if 0 < dim < out.dim() else out)
    return carry, pytree.tree_unflatten(stacked, spec)

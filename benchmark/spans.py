"""The program's own profiler ranges in a traced window, and each step's
kernels filed under them.

The decoder of ``tpusim_torch`` opens a range around each part of a layer
while a profiler runs (``tpusim_torch.llama.<part>``: :data:`PARTS`).  A
kernel belongs to the innermost such range open on the steps' thread when
its launch was made.  :class:`benchmark.trace.Kernel` keeps the launching
op's name, not the launch's host time, so the launches are matched to the
kernels here: on the card's one stream a step's kernels run in the order
of its launch calls (:func:`is_launch`), and each launch is taken by the
next kernel of the step whose op is the innermost op around that launch.
A launch whose work the profiler lost is passed over, and a kernel no
launch matches is filed under no range.

A part's time a step is the union of its kernels' intervals (overlapping
kernels count once), summed over the steps, over the number of steps.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

#: the prefix of the program's range names
PREFIX = "tpusim_torch.llama."
#: the parts of the decoder that a range names, each read by
#: ``metrics/<part>_ms_per_step.py``
PARTS = ("norm", "proj", "rope", "attention", "mlp", "head")

#: the last trace filed and its filing (every reader of one run reads the
#: same trace)
_last: tuple = (None, None)


def is_launch(name: str) -> bool:
    """A host API call that puts work on the card's stream: a kernel
    launch, a copy or a fill."""
    return name.startswith("cu") and any(
        word in name for word in ("LaunchKernel", "Memcpy", "Memset"))


def _launches(host: list[tuple[int, int, str]]) -> list[tuple]:
    """Each launch on the steps' thread as ``(time, op, range)``: the
    innermost op (a name with ``::``) and innermost program range around
    it, or None."""
    out, stack = [], []
    for start, end, name in host:
        while stack and stack[-1][0] <= start:
            stack.pop()
        if is_launch(name):
            op = next((n for _, n in reversed(stack) if "::" in n), None)
            part = next((n for _, n in reversed(stack)
                         if n.startswith(PREFIX)), None)
            out.append((start, op, part))
        stack.append((end, name))
    return out


def file_kernels(trace) -> list[str | None]:
    """The range name of each of ``trace.kernels`` (None for a kernel
    launched outside every range, or matched to no launch)."""
    global _last
    if _last[0] is trace:
        return _last[1]
    starts = [s for s, _ in trace.steps]
    by_step: dict[int, list] = defaultdict(list)
    for t, op, part in _launches(trace.host):
        i = _step_of(starts, trace.steps, t)
        if i is not None:
            by_step[i].append((op, part))
    filed: list[str | None] = [None] * len(trace.kernels)
    kernels: dict[int, list[int]] = defaultdict(list)
    for j, k in enumerate(trace.kernels):
        kernels[k.step].append(j)
    for step, idx in kernels.items():
        idx.sort(key=lambda j: trace.kernels[j].start)
        launches, p = by_step.get(step, []), 0
        for j in idx:
            op = trace.kernels[j].op
            q = next((q for q in range(p, len(launches))
                      if launches[q][0] == op), None)
            if q is not None:
                filed[j], p = launches[q][1], q + 1
    _last = (trace, filed)
    return filed


def _step_of(starts: list[int], steps: list[tuple[int, int]],
             t: int) -> int | None:
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t <= steps[i][1] else None


def ms_per_step(trace, part: str) -> float | None:
    """Milliseconds a step of the kernels filed under ``part``'s range:
    the union of their intervals in each step, summed, over the number of
    steps; None when no kernel is filed under it."""
    if trace is None or not trace.steps:
        return None
    name = PREFIX + part
    per_step: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for k, filed in zip(trace.kernels, file_kernels(trace)):
        if filed == name:
            per_step[k.step].append((k.start, k.end))
    if not per_step:
        return None
    return sum(_union_ns(v) for v in per_step.values()) / len(
        trace.steps) / 1e6


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total

"""The traced window: a ``torch.profiler`` session over the steps, and the
reduction of its events to what the per-layer readers take.

Each step runs inside a ``record_function`` range named :data:`STEP`.  A
device event is filed under the ATen op that launched it (the innermost
op: its linked correlation id), and under the step in whose range that op
started.  The profiler can lose a session's first device records (seen
on an H100), so a session opens with :data:`WARM_RECORDS` fills outside
every step, as ``tpusim_torch.harness.correl_ops`` does.  Busy time is
the union of the step kernels' intervals, not the sum of their
durations.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

STEP = "portbench.step"
WARM_RECORDS = 64
DEVICE_ACTIVITIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: the host event of a launch that waits for room in the card's queue
QUEUE_FULL = "Command Buffer Full"
#: entries of each list of the result's ``breakdown``
BREAKDOWN_ROWS = 10


class Session:
    """A profiler session over the window (CPU and, on a card, CUDA
    activities), opened with the fills that absorb lost records."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        if self.device.type == "cuda":
            for _ in range(WARM_RECORDS):
                torch.zeros(1, device=self.device)
            torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def step(self):
        from torch.profiler import record_function

        return record_function(STEP)


@dataclass
class Kernel:
    name: str
    op: str
    step: int
    start: int
    end: int


@dataclass
class Trace:
    """The window's device work and the host's ranges, in ns."""

    steps: list[tuple[int, int]] = field(default_factory=list)
    kernels: list[Kernel] = field(default_factory=list)
    #: (start, end, name) of the host ops on the thread that ran the steps
    host: list[tuple[int, int, str]] = field(default_factory=list)
    #: (start, end) of the host's waits for room in the launch queue
    blocked: list[tuple[int, int]] = field(default_factory=list)

    def host_busy_ns(self) -> list[int]:
        """Each step's host time less its waits for a full launch
        queue."""
        starts = [s for s, _ in self.steps]
        waits = [0] * len(self.steps)
        for s, e in self.blocked:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < self.steps[i][1]:
                waits[i] += min(e, self.steps[i][1]) - s
        return [e - s - w for (s, e), w in zip(self.steps, waits)]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the kernels' intervals, in order."""
        out: list[list[int]] = []
        for s, e in sorted((k.start, k.end) for k in self.kernels):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def span_ns(self) -> int:
        """First kernel's start to the last kernel's end."""
        if not self.kernels:
            return 0
        return (max(k.end for k in self.kernels)
                - min(k.start for k in self.kernels))

    def gaps(self) -> list[tuple[int, int]]:
        """The device's idle intervals between its busy ones."""
        busy = self.busy_intervals()
        return [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]

    def host_at(self, t: int) -> str:
        """The innermost host op running at ``t`` on the steps' thread."""
        best = None
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for s, e, name in reversed(self.host[max(0, i - 64):i]):
            if s <= t < e and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else "python (between ops)"


def _activity(event) -> str | None:
    fn = getattr(event, "activity_type", None)
    return fn() if callable(fn) else None


def parse(prof) -> Trace:
    """Reduce a finished session to the steps' kernels and host ops."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), -e.end_ns(), e.name(),
                         e.correlation_id(), e.linked_correlation_id(),
                         e.start_thread_id(), e.is_user_annotation()))
        elif (e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()
              and _activity(e) in (None, *DEVICE_ACTIVITIES)):
            device.append((e.name(), e.start_ns(), e.end_ns(),
                           e.linked_correlation_id()))
    host.sort()
    steps = [(s, -ne) for s, ne, name, _, _, _, ann in host
             if ann and name == STEP]
    threads = {tid for _, _, name, _, _, tid, ann in host
               if ann and name == STEP}
    starts = [s for s, _ in steps]
    ops: dict[int, tuple[str, int]] = {}
    main: list[tuple[int, int, str]] = []
    blocked: list[tuple[int, int]] = []
    for s, ne, name, corr, linked, tid, ann in host:
        if linked == 0 and "::" in name:
            ops.setdefault(corr, (name, s))
        if name == QUEUE_FULL:
            blocked.append((s, -ne))
        if tid in threads and not (ann and name == STEP):
            main.append((s, -ne, name))
    out = Trace(steps=steps, host=main, blocked=blocked)
    for name, s, e, linked in device:
        op = ops.get(linked)
        if op is None:
            continue
        i = bisect.bisect_right(starts, op[1]) - 1
        if i < 0 or op[1] > steps[i][1]:
            continue
        out.kernels.append(Kernel(name, op[0], i, s, e))
    return out


def _short(kernel: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[:96] or kernel[:96]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time (by launching op and
    kernel), and the longest idle gaps by what the host was doing when
    each opened, seconds summed over the window."""
    ops: dict[str, float] = defaultdict(float)
    for k in trace.kernels:
        ops[f"{k.op} {_short(k.name)}"] += (k.end - k.start) / 1e9
    gaps: dict[str, float] = defaultdict(float)
    for s, e in trace.gaps():
        gaps[f"host in {trace.host_at(s)}"] += (e - s) / 1e9
    top = lambda d: [[n, v] for n, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])
                     [:BREAKDOWN_ROWS]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}

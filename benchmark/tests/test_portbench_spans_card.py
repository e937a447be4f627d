"""On the card, at the cells' own sizes: a short traced run of each cell
files its kernels under the program's ranges as the profiler's own links
do, the six readers of ``benchmark/spans.py`` each read a number, and
together they cover at least 99% of the steps' busy time (only the
embedding lookup runs outside every range).  Each run prints one JSON
line: the readings, the busy time a step, the kernels a step, the idle
gaps by where the host was, and the card's median SM clock and power over
the window.  These skip without an NVIDIA card; run them on one with
``python -m pytest benchmark/tests/test_portbench_spans_card.py -q -s``."""

import json
import time
from collections import defaultdict

import pytest

from benchmark import clocks, harness, spans, spec
from benchmark import trace as tracing
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _linked_parts(prof) -> dict[tuple[int, int], str | None]:
    """Each device event's range, from the profiler's own link: the
    innermost program range around the op whose correlation id the event
    carries, on that op's thread; keyed by the event's interval."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    host = sorted((e for e in events if e.device_type() == DeviceType.CPU),
                  key=lambda e: (e.start_ns(), -e.end_ns()))
    part_of_op: dict[int, str | None] = {}
    stacks: dict[int, list] = defaultdict(list)
    for e in host:
        stack = stacks[e.start_thread_id()]
        while stack and stack[-1][0] <= e.start_ns():
            stack.pop()
        if "::" in e.name() and e.linked_correlation_id() == 0:
            part_of_op.setdefault(e.correlation_id(), next(
                (n for _, n in reversed(stack) if n.startswith(spans.PREFIX)),
                None))
        stack.append((e.end_ns(), e.name()))
    return {(e.start_ns(), e.end_ns()):
            part_of_op.get(e.linked_correlation_id())
            for e in events if e.device_type() == DeviceType.CUDA}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_ranges_cover_each_cells_traced_steps(card, cell, monkeypatch):
    seen: dict = {}
    parse = tracing.parse

    class Session(tracing.Session):
        # the sampler runs from the profiler's start (which takes seconds
        # the first time in a process, the card idle) to its stop
        def __enter__(self):
            out = super().__enter__()
            seen["sampler"] = clocks.card_sampler(card).__enter__()
            return out

        def __exit__(self, *exc):
            seen["sampler"].__exit__(*exc)
            return super().__exit__(*exc)

    def parse_and_link(prof):
        seen["linked"] = _linked_parts(prof)
        seen["trace"] = parse(prof)
        return seen["trace"]

    monkeypatch.setattr(tracing, "Session", Session)
    monkeypatch.setattr(tracing, "parse", parse_and_link)
    c = spec.find_cell(cell)
    result = harness.run_cell(c, 2 ** 31 + 91, 3.0, True, card,
                              time.perf_counter())
    tr = seen["trace"]
    ctx = harness.Context(trace=tr, host_ns=[], model_flops=0.0, gemms=[],
                          element_size=2, dtype="bfloat16", peaks=None)
    ms = {p: spec.metric_reader(f"{p}_ms_per_step").read(ctx)
          for p in spans.PARTS}
    busy_ms = tr.busy_ns() / 1e6 / len(tr.steps)
    filed = spans.file_kernels(tr)
    differ = sum(1 for k, f in zip(tr.kernels, filed)
                 if seen["linked"].get((k.start, k.end), "?") != f)
    sampler = seen["sampler"]
    print(json.dumps({
        "cell": cell, "steps": len(tr.steps), "ms_per_step": ms,
        "busy_ms_per_step": busy_ms,
        "covered": sum(v or 0.0 for v in ms.values()) / busy_ms,
        "kernels_per_step": result["metrics"]["kernels_per_step"]["value"],
        "filed_unlike_the_profilers_link": differ,
        "kernels": len(tr.kernels),
        "idle_gaps": result["breakdown"]["idle_gaps"],
        "sm_clock_mhz": sampler.median("sm_clock_mhz"),
        "power_w": sampler.median("power_w"),
        "clock_samples": len(sampler.samples["sm_clock_mhz"])}))
    assert result["correct"] is True, result["checks"]
    assert differ == 0
    assert all(v is not None for v in ms.values()), ms
    assert sum(ms.values()) >= 0.99 * busy_ms
    assert sampler.median("sm_clock_mhz") is not None

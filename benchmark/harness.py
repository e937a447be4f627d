"""One run of a cell: set-up, the measured window, the comparison with the
reference, and the result's metrics.

Set-up draws the weights and the inputs on the device from the seed,
builds the program's module and runs the mix's warm-up steps, which use
every shape the window uses.  What a kind of cell computes, takes and is
judged by is its family's (``benchmark/families/<family>.py``); this file
holds the loop, the clocks and the result.  The window is a closed loop: step after
step, each enqueued as soon as the previous call returns, until the host
clock passes ``seconds``; then one synchronisation.  A CUDA event before
each step and after the last gives each step's device duration.  Once the
window has closed and the peak memory is read, the module is dropped and
the reference recomputes the compared steps (an early one drawn from the
seed, and the last) from the same weights and inputs.  In a traced run on
a card, a per-layer metric of the cell that reads nothing ends the run
(:class:`MissingMetric`).
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from benchmark import compare, spec, trace as tracing, traffic


@dataclass
class Context:
    """What a per-layer reader reads (``benchmark/metrics/<name>.py``)."""

    trace: tracing.Trace | None
    host_ns: list[int]
    model_flops: float
    gemms: list
    element_size: int
    dtype: str
    peaks: dict | None
    _classes: dict = field(default_factory=dict)

    def peak_flops(self) -> float | None:
        return (self.peaks or {}).get(f"{self.dtype}_flops")

    def peak_bytes_s(self) -> float | None:
        return (self.peaks or {}).get("hbm_bytes_s")

    def op_class(self, name: str) -> frozenset[str]:
        if name not in self._classes:
            self._classes[name] = spec.op_class(name)
        return self._classes[name]


class StepClock:
    """A mark before each step and after the last: CUDA events on a card
    (read after the window), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter_ns())

    def durations_ms(self) -> list[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) / 1e6 for a, b in pairs]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _p90(values: list[float]) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def peaks_of(kind: str) -> dict | None:
    return spec.load_json(spec.HERE / "peaks.json").get(kind)


class MissingMetric(RuntimeError):
    """A per-layer metric of the cell read nothing in a traced run on a
    card."""


def read_per_layer(cell: spec.Cell, ctx: Context, kind: str,
                   strict: bool) -> dict:
    """The cell's per-layer metrics read from ``ctx``.  A reader that
    finds nothing returns None and its metric is left out; with
    ``strict`` (a card) that raises :class:`MissingMetric` naming each
    such metric and what the run had to read."""
    metrics, missing = {}, []
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if strict and missing:
        tr = ctx.trace
        found = (f"{len(tr.kernels)} kernels of {len(tr.steps)} steps"
                 if tr is not None else "no trace")
        raise MissingMetric(
            f"per-layer metrics read nothing: {', '.join(missing)}; peaks "
            f"of {kind!r} {'found' if ctx.peaks else 'missing from'} "
            f"benchmark/peaks.json; the trace held {found}")
    return metrics


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str | torch.device, t0: float,
             wrap: Callable | None = None) -> dict:
    """Run ``cell`` once and return the result's object (without the
    check for foreign modules, which the entry point makes).  ``wrap``
    replaces the program's module by ``wrap(module)`` (a planted fault
    or the control of :mod:`benchmark.faults`); ``t0``: the process's
    start on ``time.perf_counter``."""
    marks = [("imports", time.perf_counter())]
    fam = spec.family(cell.config["family"])
    mix, config = cell.traffic, cell.config
    fam.check_traffic(config, mix)
    dev = torch.device(device)
    params = fam.make_params(config, seed, dev)
    _sync(dev)
    marks.append(("weights", time.perf_counter()))
    inputs = fam.make_inputs(config, mix, seed, dev)
    module = fam.build(config, dev)
    marks.append(("program", time.perf_counter()))
    if wrap is not None:
        module = wrap(module)
    early = traffic.compared_step(mix, seed)

    def call(i):
        return fam.step(module, params, fam.step_input(inputs, i))

    session = tracing.Session(dev) if trace else None
    clock, host_ns = StepClock(dev), []
    for i in range(mix["warmup"]):
        call(i)
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    with session or contextlib.nullcontext():
        t_start = time.perf_counter()
        setup_s = t_start - t0
        i, kept = 0, None
        while True:
            clock.mark()
            h = time.perf_counter_ns()
            with session.step() if session else contextlib.nullcontext():
                out = call(i)
            host_ns.append(time.perf_counter_ns() - h)
            if i == early:
                kept = out
            i += 1
            if i > early and time.perf_counter() - t_start >= seconds:
                break
        clock.mark()
        _sync(dev)
        window_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), prev in
        zip(marks, [t0] + [t for _, t in marks])), file=sys.stderr)
    steps = i
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    durations = clock.durations_ms()
    del module, clock

    # the comparison, with the program's module gone
    t_ref = time.perf_counter()
    compared = {early: kept, steps - 1: out}
    del kept, out
    per_step = []
    for j in sorted(compared):
        got = compared.pop(j)
        ref = fam.reference(params, fam.step_input(inputs, j), config)
        per_step.append(compare.judge(fam.readings(got, ref), cell.limits))
        del got, ref
    print(f"reference: {len(per_step)} steps in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    checks = {name: {"value": compare.worst(c[name]["value"]
                                            for c in per_step),
                     "limit": per_step[0][name]["limit"]}
              for name in per_step[0]}

    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    device_doc = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": peak}
    result = {"correct": compare.passed(checks), "attempted": steps,
              "failed": sum(1 for c in per_step if not compare.passed(c))}
    if not trace:
        values = {"step_ms": window_s * 1e3 / steps,
                  "step_ms_p90": _p90(durations),
                  "setup_s": setup_s}
        if peak is not None:
            values["peak_mem_gib"] = peak / 2 ** 30
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}
        result["device"] = device_doc
    else:
        t = time.perf_counter()
        tr = tracing.parse(session.prof)
        print(f"trace: {len(tr.kernels)} kernels of {len(tr.steps)} steps "
              f"parsed in {time.perf_counter() - t:.1f} s", file=sys.stderr)
        ctx = Context(trace=tr, host_ns=host_ns,
                      model_flops=fam.model_flops(config, mix),
                      gemms=fam.gemms(config, mix),
                      element_size=fam.element_size(config),
                      dtype=config["torch_dtype"], peaks=peaks_of(kind))
        result["metrics"] = read_per_layer(cell, ctx, kind,
                                           strict=dev.type == "cuda")
        result["device"] = dict(device_doc, busy_s=tr.busy_ns() / 1e9,
                                window_s=window_s)
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    return result

"""The profiler ranges inside the port's decoder
(:mod:`tpusim_torch.obs.ranges`, ``tpusim_torch.llama.<part>``), on the
CPU at the tiny preset:

* with no profiler running :func:`device_range` hands back the shared
  no-op, and the forward's logits are the same bits with a profiler
  running as without;
* under a CPU profiler each range opens as often as the decoder has the
  part (two layers: five norms, four projections, two rotations, two
  attentions, two MLPs, one head), and every outermost ATen op of the
  forward lies inside exactly one of them, but the embedding lookup;
* a capture (``torch.export``, ``make_fx``, and the scanned step whose
  body dynamo traces) made with a profiler running holds the same ops as
  one made without, and no ``profiler._record_function_*`` node;
* ``correl_ops``'s CPU device profile of ``llama_tiny`` (the eager module
  and the captured graph node by node) files the same ops under the same
  executions with the ranges as without them;
* the NVML clock reader shares the power reader's library handling.
"""

from __future__ import annotations

from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import tpusim_torch.harness.correl_ops as co  # noqa: E402
from tpusim_torch.models import get_workload  # noqa: E402
from tpusim_torch.models import llama as port_llama  # noqa: E402
from tpusim_torch.models.llama_aot import build_llama_aot  # noqa: E402
from tpusim_torch.obs import ranges  # noqa: E402
from tpusim_torch.power import telemetry  # noqa: E402
from tpusim_torch.tracer.capture import capture, capture_graph  # noqa: E402

PREFIX = "tpusim_torch.llama."
#: how often each range opens in a forward of two layers
PER_FORWARD = {"norm": 5, "proj": 4, "rope": 2, "attention": 2, "mlp": 2,
               "head": 1}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tiny_forward():
    return get_workload("llama_tiny").build(device="cpu", kv_heads=2,
                                            dtype="float32")


def _ranges_off(monkeypatch):
    monkeypatch.setattr(port_llama, "device_range",
                        lambda name: ranges.OFF)


def test_no_profiler_no_range_and_the_same_logits():
    assert ranges.device_range(PREFIX + "norm") is ranges.OFF
    module, args = _tiny_forward()
    with torch.no_grad():
        off = module(*args)
        with _cpu_profile():
            assert ranges.device_range(PREFIX + "norm") is not ranges.OFF
            on = module(*args)
    assert torch.equal(off, on)


def test_a_traced_call_opens_no_range_under_a_profiler():
    from torch.fx.experimental.proxy_tensor import make_fx

    got = []

    def f(x):
        got.append(ranges.device_range(PREFIX + "norm"))
        return x + 1

    with _cpu_profile():
        make_fx(f, tracing_mode="fake")(torch.ones(2))
    assert got == [ranges.OFF]


def _host_events(prof) -> list:
    return sorted(prof.profiler.kineto_results.events(),
                  key=lambda e: (e.start_ns(), -e.end_ns()))


def test_each_range_opens_once_a_part_and_covers_every_op():
    module, args = _tiny_forward()
    with torch.no_grad(), _cpu_profile() as prof:
        module(*args)
    events = _host_events(prof)
    spans = [(e.start_ns(), e.end_ns(), e.name()[len(PREFIX):])
             for e in events
             if e.is_user_annotation() and e.name().startswith(PREFIX)]
    assert Counter(p for _, _, p in spans) == PER_FORWARD
    # the ranges do not nest
    for (s0, e0, _), (s1, _, _) in zip(spans, spans[1:]):
        assert e0 <= s1
    outside, inside = Counter(), Counter()
    op_end = None
    for e in events:
        if "::" not in e.name():
            continue
        if op_end is not None and e.start_ns() < op_end:
            continue    # an op inside another op
        op_end = e.end_ns()
        around = [p for s, t, p in spans
                  if s <= e.start_ns() and e.end_ns() <= t]
        assert len(around) <= 1
        (inside if around else outside)[e.name()] += 1
    assert outside == {"aten::embedding": 1}
    assert sum(inside.values()) > 50


@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_train",
                                  "scanned"])
def test_captures_made_under_a_profiler_hold_the_same_ops(name):
    if name == "scanned":
        module, args = build_llama_aot(preset="tiny", batch=2, seq=16, dp=1,
                                       tp=1, device="cpu", dtype="float32")
    else:
        module, args = get_workload(name).build(device="cpu")

    def ops(gm) -> list[str]:
        return [str(n.target) for n in gm.graph.nodes
                if n.op == "call_function"]

    off = ops(capture_graph(module, args))
    with _cpu_profile():
        on = ops(capture_graph(module, args))
    assert on == off
    assert not [op for op in on if "record_function" in op]


def _profile_shape(prof: co.DeviceProfile) -> list:
    """Each execution's op count and its nodes' occurrences and op
    counts, without the times."""
    return [(e["events"], {k: v[:2] for k, v in e["nodes"].items()})
            for e in prof.execs]


@pytest.mark.parametrize("per_op", [False, True])
def test_correl_ops_files_the_same_ops_with_the_ranges(per_op, monkeypatch):
    module, args = get_workload("llama_tiny").build(device="cpu", batch=2,
                                                    dtype="float32")
    graph = capture(module, *args, name="llama_tiny").graph if per_op \
        else None
    with_ranges = co._trace_capture(module, args, None, warmup=1, iters=2,
                                    graph=graph)
    _ranges_off(monkeypatch)
    without = co._trace_capture(module, args, None, warmup=1, iters=2,
                                graph=graph)
    assert _profile_shape(with_ranges) == _profile_shape(without)
    assert with_ranges.execs[0]["events"] > 50


class _FakeNvml:
    """``libnvidia-ml.so.1`` as far as the readers call it: one card at
    index 0 whose SM clock reads ``mhz`` and whose meter reads ``mw``."""

    def __init__(self, mhz: int = 1980, mw: int = 612_500, rc: int = 0):
        self.mhz, self.mw, self.rc = mhz, mw, rc
        self.calls: list[str] = []

        def fn(name, body):
            def call(*a):
                self.calls.append(name)
                return body(*a)
            setattr(self, name, call)

        fn("nvmlInit_v2", lambda: 0)
        fn("nvmlShutdown", lambda: 0)
        fn("nvmlDeviceGetHandleByIndex_v2", lambda i, h: 0)
        fn("nvmlDeviceGetHandleByPciBusId_v2", lambda b, h: 0)
        fn("nvmlDeviceGetPowerUsage", self._write(lambda: self.mw))
        fn("nvmlDeviceGetClockInfo",
           lambda h, kind, out: self._write(
               lambda: self.mhz if kind == telemetry.NVML_CLOCK_SM
               else 0)(h, out))

    def _write(self, value):
        def body(handle, out):
            out._obj.value = value()
            return self.rc
        return body


@pytest.mark.parametrize("rc,mhz,watts", [(0, 1980.0, 612.5),
                                          (3, None, None)])
def test_nvml_readers_share_the_handle_and_shut_nvml_down(rc, mhz, watts,
                                                          monkeypatch):
    import ctypes

    lib = _FakeNvml(rc=rc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ctypes, "CDLL", lambda name, *a, **k: lib)
    assert telemetry.read_card_clocks() == mhz
    assert telemetry.read_card_watts() == watts
    assert lib.calls == [
        "nvmlInit_v2", "nvmlDeviceGetHandleByIndex_v2",
        "nvmlDeviceGetClockInfo", "nvmlShutdown",
        "nvmlInit_v2", "nvmlDeviceGetHandleByIndex_v2",
        "nvmlDeviceGetPowerUsage", "nvmlShutdown"]


def test_nvml_clock_reader_answers_none_without_the_library(monkeypatch):
    import ctypes

    def no_library(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    mhz = telemetry.read_card_clocks()
    assert mhz is None or mhz > 0
    monkeypatch.setattr(ctypes, "CDLL", no_library)
    assert telemetry.read_card_clocks() is None
    assert telemetry.read_card_clocks("cuda:0") is None

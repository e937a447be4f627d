"""The readers of the program's ranges on a trace built by hand, and the
clock sampler with fake meters: the CPU half of ``benchmark/spans.py``
and ``benchmark/clocks.py``."""

import statistics
import time

import pytest

from benchmark import clocks, harness, spans, spec
from benchmark.trace import Kernel, Trace

R = spans.PREFIX


def _step(t0: int, mlp_ns: int) -> tuple[list, list]:
    """One step's host events and kernels, from ``t0``: the lookup outside
    every range; a norm; an attention with a norm nested in it, two
    overlapping products and a copy whose device record was lost; an MLP
    whose product takes ``mlp_ns``."""
    host = [
        (t0 + 10, t0 + 20, "aten::embedding"),
        (t0 + 12, t0 + 14, "cudaLaunchKernel"),
        (t0 + 30, t0 + 100, R + "norm"),
        (t0 + 40, t0 + 50, "aten::mul"),
        (t0 + 42, t0 + 44, "cudaLaunchKernel"),
        (t0 + 100, t0 + 300, R + "attention"),
        (t0 + 110, t0 + 150, R + "norm"),
        (t0 + 120, t0 + 130, "aten::mul"),
        (t0 + 122, t0 + 124, "cudaLaunchKernel"),
        (t0 + 160, t0 + 200, "aten::bmm"),
        (t0 + 165, t0 + 167, "cuLaunchKernelEx"),
        (t0 + 170, t0 + 172, "cuLaunchKernelEx"),
        (t0 + 210, t0 + 220, "aten::copy_"),
        (t0 + 212, t0 + 214, "cudaLaunchKernel"),
        (t0 + 230, t0 + 240, "aten::_softmax"),
        (t0 + 232, t0 + 234, "cudaLaunchKernel"),
        (t0 + 300, t0 + 400, R + "mlp"),
        (t0 + 310, t0 + 330, "aten::mm"),
        (t0 + 312, t0 + 314, "cudaLaunchKernel"),
    ]
    step = t0 // 1000
    kernels = [
        Kernel("gather", "aten::embedding", step, t0 + 100, t0 + 110),
        Kernel("mul", "aten::mul", step, t0 + 120, t0 + 150),
        Kernel("mul", "aten::mul", step, t0 + 150, t0 + 170),
        Kernel("gemm", "aten::bmm", step, t0 + 170, t0 + 230),
        Kernel("gemm", "aten::bmm", step, t0 + 200, t0 + 260),
        Kernel("softmax", "aten::_softmax", step, t0 + 260, t0 + 280),
        Kernel("gemm", "aten::mm", step, t0 + 300, t0 + 300 + mlp_ns),
    ]
    return host, kernels


def _trace() -> Trace:
    (h0, k0), (h1, k1) = _step(0, 50), _step(1000, 100)
    # the device records arrive out of order
    return Trace(steps=[(0, 999), (1000, 1999)], kernels=k1 + k0,
                 host=sorted(h0 + h1, key=lambda e: (e[0], -e[1])))


def _read(trace: Trace, part: str):
    ctx = harness.Context(trace=trace, host_ns=[], model_flops=0.0,
                          gemms=[], element_size=2, dtype="bfloat16",
                          peaks=None)
    return spec.metric_reader(f"{part}_ms_per_step").read(ctx)


def test_each_kernel_is_filed_under_the_innermost_range_of_its_launch():
    tr = _trace()
    filed = dict(zip((id(k) for k in tr.kernels), spans.file_kernels(tr)))
    names = [(k.op, filed[id(k)]) for k in sorted(tr.kernels,
                                                  key=lambda k: k.start)]
    assert names[:7] == [
        ("aten::embedding", None), ("aten::mul", R + "norm"),
        ("aten::mul", R + "norm"), ("aten::bmm", R + "attention"),
        ("aten::bmm", R + "attention"), ("aten::_softmax", R + "attention"),
        ("aten::mm", R + "mlp")]
    assert names[7:] == names[:7]


def test_readers_give_the_union_a_step_and_none_without_a_kernel():
    tr = _trace()
    # the norm's kernels abut: 30 + 20 ns a step
    assert _read(tr, "norm") == pytest.approx(50e-6)
    # the products overlap: their union (90 ns), not the sum of their
    # durations (120 ns), with the softmax's 20 ns
    assert _read(tr, "attention") == pytest.approx(110e-6)
    # 50 ns in one step, 100 ns in the other
    assert _read(tr, "mlp") == pytest.approx(75e-6)
    for part in ("proj", "rope", "head"):
        assert _read(tr, part) is None


def test_readers_read_nothing_without_ranges_or_steps():
    tr = _trace()
    tr.host = [e for e in tr.host if not e[2].startswith(R)]
    assert all(_read(tr, part) is None for part in spans.PARTS)
    assert all(_read(Trace(), part) is None for part in spans.PARTS)
    assert _read(None, "norm") is None


def test_a_launch_without_a_match_in_its_step_is_passed_over():
    tr = _trace()
    # the second step loses its attention's first product
    lost = next(k for k in tr.kernels if k.step == 1 and k.op == "aten::bmm")
    tr.kernels.remove(lost)
    filed = spans.file_kernels(tr)
    assert filed.count(R + "mlp") == 2
    assert filed.count(R + "attention") == 5


@pytest.mark.parametrize("name,launch", [
    ("cudaLaunchKernel", True), ("cuLaunchKernelEx", True),
    ("cudaLaunchKernelExC", True), ("cudaMemcpyAsync", True),
    ("cudaMemsetAsync", True), ("Command Buffer Full", False),
    ("cudaStreamIsCapturing", False), ("aten::mm", False),
    (R + "mlp", False)])
def test_launch_names(name, launch):
    assert spans.is_launch(name) is launch


def test_the_sampler_gives_medians_and_stops_with_the_window():
    clock = iter([1980.0, 1755.0, 1980.0, 1410.0] * 1000)
    watts = iter([None, 400.0, 650.0] * 1000)
    with clocks.Sampler(lambda: next(clock), lambda: next(watts),
                        period_s=0.01) as s:
        time.sleep(0.2)
    assert not s._thread.is_alive()
    taken = {k: list(v) for k, v in s.samples.items()}
    time.sleep(0.05)
    assert s.samples == taken
    assert len(taken["sm_clock_mhz"]) >= 3
    assert s.median("sm_clock_mhz") == statistics.median(
        taken["sm_clock_mhz"])
    assert set(taken["power_w"]) <= {400.0, 650.0}
    assert s.median("power_w") == statistics.median(taken["power_w"])


def test_a_sampler_whose_meters_never_answer_has_no_median():
    with clocks.Sampler(lambda: None, lambda: None, period_s=0.01) as s:
        time.sleep(0.03)
    assert s.median("sm_clock_mhz") is None and s.median("power_w") is None

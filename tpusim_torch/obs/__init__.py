"""tpusim_torch.obs — the instrumentation layer of the port.

Port of ``tpusim/obs/`` (its ``__init__`` exports the same names):

* :mod:`tpusim_torch.obs.hub` — named wall-clock **spans** (pipeline
  self-profiling: parse → cost → engine → ICI → power) and **counters**,
  with a no-op default so the hot path is unaffected when disabled;
* :mod:`tpusim_torch.obs.sampler` — the **cycle-window sampler**, fed
  per op by the timing engine and the detailed ICI network, producing
  time series of unit utilization, HBM traffic, ICI occupancy, and (via
  the power coefficients) watts;
* :mod:`tpusim_torch.obs.export` — Perfetto **counter tracks** merged
  into the Chrome trace, a JSONL samples file, and Prometheus-style text;
* :mod:`tpusim_torch.obs.reqtrace` — **request-scoped tracing** for a
  serving plane: per-request span trees over the shared monotonic clock,
  per-route/per-phase latency histograms with fixed log-spaced bounds,
  and a bounded tail-sampling flight recorder.

End-of-run aggregates stay in :mod:`tpusim_torch.sim.stats`; the per-op
Chrome trace stays in :mod:`tpusim_torch.sim.traceviz`.  Every file this
layer writes is the JAX package's, byte for byte, on the same trace and
config (the samples header, the ``"tpusim"`` process name and the
``tpusim_`` metric prefix included).
"""

from tpusim_torch.obs.hub import (
    Instrumentation,
    NullInstrumentation,
    NULL_OBS,
    SpanStat,
)
from tpusim_torch.obs.sampler import CycleWindowSampler, WindowBin
from tpusim_torch.obs.export import (
    COUNTER_TRACKS,
    counter_track_events,
    pod_chrome_trace,
    prometheus_text,
    read_samples_jsonl,
    request_chrome_trace,
    validate_obs_dir,
    validate_sample_rows,
    window_rows,
    write_obs_dir,
    write_samples_jsonl,
)
from tpusim_torch.obs.reqtrace import (
    BUCKET_BOUNDS_MS,
    TRACE_CTX_KEY,
    TRACE_HEADER,
    AccessLog,
    FlightRecorder,
    LatencyHistogram,
    RequestTrace,
    RequestTracer,
    histogram_exposition,
    mint_trace_id,
)

__all__ = [
    "Instrumentation",
    "NullInstrumentation",
    "NULL_OBS",
    "SpanStat",
    "CycleWindowSampler",
    "WindowBin",
    "COUNTER_TRACKS",
    "counter_track_events",
    "pod_chrome_trace",
    "prometheus_text",
    "read_samples_jsonl",
    "request_chrome_trace",
    "validate_obs_dir",
    "validate_sample_rows",
    "window_rows",
    "write_obs_dir",
    "write_samples_jsonl",
    "BUCKET_BOUNDS_MS",
    "TRACE_CTX_KEY",
    "TRACE_HEADER",
    "AccessLog",
    "FlightRecorder",
    "LatencyHistogram",
    "RequestTrace",
    "RequestTracer",
    "histogram_exposition",
    "mint_trace_id",
]

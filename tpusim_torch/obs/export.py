"""Export paths for the observability layer.

Port of ``tpusim/obs/export.py``: the files it writes equal the JAX
package's by bytes.

Three consumers, three formats (SURVEY.md §7's "structured stats plus
stable text lines", extended to time series):

* **Perfetto counter tracks** — ``"ph": "C"`` events merged into the
  Chrome trace (the AerialVision plots, inside the standard viewer
  instead of a bespoke GUI);
* **JSONL samples** — one window per line behind a header line, the
  machine-readable series (the ``gpgpusim_visualizer__*.log.gz``
  analogue; schema checked in at ``ci/obs_schema.json``);
* **Prometheus text** — flat ``tpusim_<stat> <value>`` gauges for the
  harness/monitoring slot the reference serves with YAML-regex scraping.
"""

from __future__ import annotations

import gzip
import json
import re
from pathlib import Path

__all__ = [
    "COUNTER_TRACKS",
    "counter_track_events",
    "escape_prometheus_label_value",
    "pod_chrome_trace",
    "prometheus_metric_name",
    "prometheus_text",
    "read_samples_jsonl",
    "request_chrome_trace",
    "validate_obs_dir",
    "validate_sample_rows",
    "window_rows",
    "write_obs_dir",
    "write_samples_jsonl",
]

#: the counter tracks merged into every exported Chrome trace
COUNTER_TRACKS = (
    "mxu_util", "vpu_util", "dma_util", "ici_occupancy", "hbm_gbps",
    "watts",
)


def _resolve_coeffs(arch, coeffs=None, dvfs_scale: float = 1.0):
    from tpusim_torch.power.model import PowerModel

    if coeffs is None or isinstance(coeffs, str):
        return PowerModel(coeffs or arch.name, dvfs_scale=dvfs_scale).coeffs
    return coeffs


def window_rows(
    sampler, arch, n_devices: int = 1, coeffs=None,
    dvfs_scale: float = 1.0,
) -> list[dict]:
    """Derive the exported metric rows from a sampler's raw windows.

    Utilizations and rates are per-device averages (each device runs the
    same SPMD program; the pod series sums all devices' activity, so the
    per-device view is the sum over ``n_devices``).  Watts follow the
    energy-accounting form of :meth:`PowerModel.report` — per-event
    energies × the window's event counts — plus static+idle, per chip.
    """
    c = _resolve_coeffs(arch, coeffs, dvfs_scale)
    n = max(int(n_devices), 1)
    w = sampler.window_cycles
    span_s = arch.cycles_to_seconds(w)
    rows: list[dict] = []
    for i, b in enumerate(sampler.bins()):
        denom = w * n
        dyn_pj = sum(c.component_picojoules(
            mxu_flops=b.mxu_flops,
            flops=b.flops,
            transcendentals=b.transcendentals,
            hbm_bytes=b.hbm_bytes,
            vmem_bytes=b.vmem_bytes,
            ici_bytes=b.ici_bytes,
        ).values())
        rows.append({
            "t0_cycle": i * w,
            "t1_cycle": (i + 1) * w,
            "mxu_util": b.busy.get("mxu", 0.0) / denom,
            "vpu_util": b.busy.get("vpu", 0.0) / denom,
            "dma_util": b.busy.get("dma", 0.0) / denom,
            "ici_occupancy": b.busy.get("ici", 0.0) / denom,
            "hbm_gbps": b.hbm_bytes / span_s / n / 1e9,
            "ici_gbps": b.ici_bytes / span_s / n / 1e9,
            "tflops": b.flops / span_s / n / 1e12,
            "watts": (
                dyn_pj * 1e-12 / span_s / n
                + c.static_watts + c.idle_clock_watts
            ),
            # avg active-fault count in this window (tpusim_torch.faults feeds
            # the "faults" lane one busy-interval per active fault); 0.0
            # on every healthy run
            "faults_active": b.busy.get("faults", 0.0) / w,
            "op_count": b.op_count,
        })
    return rows


# ---------------------------------------------------------------------------
# JSONL samples
# ---------------------------------------------------------------------------


def write_samples_jsonl(
    rows: list[dict], path: str | Path, meta: dict | None = None
) -> None:
    """Header line then one window per line; ``.gz`` paths are gzip'd."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wt") as f:
        f.write(json.dumps({"tpusim_obs_samples": 1, **(meta or {})}) + "\n")
        for r in rows:
            f.write(json.dumps(r) + "\n")


def read_samples_jsonl(path: str | Path) -> tuple[dict, list[dict]]:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        header = json.loads(f.readline())
        if "tpusim_obs_samples" not in header:
            raise ValueError(f"{path} is not a tpusim obs samples file")
        rows = [json.loads(line) for line in f if line.strip()]
    return header, rows


def validate_sample_rows(
    header: dict, rows: list[dict], schema: dict
) -> None:
    """Check a samples file against the checked-in schema
    (``ci/obs_schema.json``); raises ``ValueError`` with every
    violation collected."""
    errors: list[str] = []
    for key in schema.get("samples_header_required", []):
        if key not in header:
            errors.append(f"header missing {key!r}")
    required: dict[str, str] = schema.get("sample_required", {})
    prev_t1 = None
    for i, r in enumerate(rows):
        for key, typ in required.items():
            if key not in r:
                errors.append(f"row {i}: missing {key!r}")
                continue
            v = r[key]
            if typ == "number" and not isinstance(v, (int, float)):
                errors.append(f"row {i}: {key} not a number ({v!r})")
            elif isinstance(v, (int, float)) and v < 0:
                errors.append(f"row {i}: {key} negative ({v!r})")
        t0, t1 = r.get("t0_cycle"), r.get("t1_cycle")
        if isinstance(t0, (int, float)) and isinstance(t1, (int, float)):
            if t1 <= t0:
                errors.append(f"row {i}: empty window [{t0}, {t1}]")
            if prev_t1 is not None and abs(t0 - prev_t1) > 1e-6 * max(
                abs(t0), 1.0
            ):
                errors.append(
                    f"row {i}: windows not contiguous ({prev_t1} -> {t0})"
                )
            prev_t1 = t1
    if errors:
        raise ValueError(
            "obs samples failed schema check:\n  " + "\n  ".join(errors[:20])
        )


# ---------------------------------------------------------------------------
# Chrome trace (Perfetto counter tracks)
# ---------------------------------------------------------------------------


def counter_track_events(
    rows: list[dict], clock_hz: float, pid: int = 0,
    names: tuple = COUNTER_TRACKS,
) -> list[dict]:
    """Perfetto counter events (``"ph": "C"``) — one per window per
    track, timestamped at the window start in microseconds."""
    us_per_cycle = 1e6 / clock_hz
    events = []
    for r in rows:
        ts = r["t0_cycle"] * us_per_cycle
        for name in names:
            if name in r:
                events.append({
                    "name": name, "ph": "C", "pid": pid, "ts": ts,
                    "args": {"value": round(float(r[name]), 6)},
                })
    return events


def pod_chrome_trace(
    report, arch, rows: list[dict], process_name: str = "tpusim",
    max_kernel_events: int = 100_000,
) -> dict:
    """Pod-level Chrome trace: one lane per device carrying its kernel
    launches, with the sampled counter tracks merged in — the driver's
    counterpart of :func:`tpusim_torch.sim.traceviz.timeline_to_chrome_trace`
    (which stays the per-op module view)."""
    us_per_cycle = 1e6 / arch.clock_hz
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": process_name}},
    ]
    for d in sorted(report.device_cycles):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": d,
            "args": {"name": f"dev{d}"},
        })
    for k in report.kernels[:max_kernel_events]:
        dur = (k.end_cycle - k.start_cycle) * us_per_cycle
        events.append({
            "name": k.module, "ph": "X", "pid": 0, "tid": k.device_id,
            "ts": k.start_cycle * us_per_cycle, "dur": max(dur, 0.001),
            "args": {"stream": k.stream_id},
        })
    names = COUNTER_TRACKS
    if any(r.get("faults_active") for r in rows):
        # degraded-pod runs get the extra track; healthy traces keep the
        # original counter set (COUNTER_TRACKS)
        names = COUNTER_TRACKS + ("faults_active",)
    events.extend(counter_track_events(rows, arch.clock_hz, names=names))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def request_chrome_trace(doc: dict) -> dict:
    """Chrome/Perfetto trace for one serve-request trace document
    (see ``tpusim_torch.obs.reqtrace``) — the request-grain counterpart of
    :func:`pod_chrome_trace`, so a slow serve request and a simulated
    pod render in the same viewer.

    Span ``start_ms``/``dur_ms`` are relative to the trace start;
    Chrome wants microseconds.  All spans share one thread lane — they
    nest on the shared monotonic clock, so the viewer renders the tier
    flame directly."""
    trace_id = doc.get("trace_id", "")
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": f"tpusim serve {trace_id}"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": f"{doc.get('route', '?')} "
                          f"[{doc.get('status', '?')}]"}},
        {"name": f"request:{doc.get('route', '?')}", "ph": "X",
         "pid": 0, "tid": 0, "ts": 0.0,
         "dur": max(float(doc.get("total_ms") or 0.0) * 1000.0, 0.001),
         "args": {"trace_id": trace_id,
                  "status": doc.get("status"),
                  "acceptor": doc.get("acceptor")}},
    ]
    for span in doc.get("spans", ()):
        events.append({
            "name": span["path"], "ph": "X", "pid": 0, "tid": 0,
            "ts": float(span["start_ms"]) * 1000.0,
            "dur": max(float(span["dur_ms"]) * 1000.0, 0.001),
            "args": {"path": span["path"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def prometheus_metric_name(key: str, prefix: str = "tpusim_") -> str:
    """A valid exposition-format metric name for an arbitrary stat key:
    every disallowed character collapses to ``_`` and a leading digit
    gets a guard (``[a-zA-Z_:]`` must start the name).  Stat keys were
    controlled identifiers until the serving layer started exporting
    request-derived values; names must now be safe for ANY key."""
    name = _PROM_BAD.sub("_", prefix + str(key))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_prometheus_label_value(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, the
    double quote, and newline are the three characters with meaning."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_number(v: float) -> str:
    """Shortest-repr gauge value; non-finite floats use the exposition
    spellings (``+Inf``/``-Inf``/``NaN``), not Python's."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return f"{f:.10g}"


def prometheus_text(
    values: dict,
    prefix: str = "tpusim_",
    labels: dict | None = None,
    help_text: dict | None = None,
) -> str:
    """Prometheus exposition format for every numeric stat/counter — the
    pull-scrape slot the reference fills with YAML regexes over stdout,
    now hardened for the serving daemon's ``/metrics``:

    * metric names are sanitized for *any* key (leading digits guarded,
      disallowed characters collapsed); when two keys collide onto one
      sanitized name, only the first (in sorted key order) is emitted —
      duplicate series with one labelset invalidate the whole scrape,
      which would take down the very endpoint this hardening protects;
    * ``labels`` (applied to every sample) have their names sanitized
      and their values escaped per the format (backslash, quote,
      newline) — a hostile trace name cannot break the document;
    * ``help_text`` maps *input keys* to ``# HELP`` lines (newlines and
      backslashes escaped);
    * non-finite floats render as ``+Inf``/``-Inf``/``NaN``, the only
      spellings scrapers accept.

    Bools and non-numeric values are skipped, as before."""
    label_part = ""
    if labels:
        pairs = ",".join(
            f'{_PROM_LABEL_BAD.sub("_", str(k))}='
            f'"{escape_prometheus_label_value(v)}"'
            for k, v in sorted(labels.items())
        )
        label_part = "{" + pairs + "}"
    lines: list[str] = []
    emitted: set[str] = set()
    for k in sorted(values):
        v = values[k]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = prometheus_metric_name(k, prefix)
        if name in emitted:
            continue  # a second sample of one series kills the scrape
        emitted.add(name)
        help_line = (help_text or {}).get(k)
        if help_line:
            escaped = (
                str(help_line).replace("\\", "\\\\").replace("\n", "\\n")
            )
            lines.append(f"# HELP {name} {escaped}")
        # explicit counter-suffix rule: `*_total` is the prometheus
        # naming convention for monotone counters, and every tpusim
        # `_total` key is in fact monotone (request/error/restart
        # accounting) — everything else stays a gauge.  Scrapers that
        # ignored the TYPE line see identical samples.
        mtype = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{label_part} {_prom_number(v)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# one-call directory export + validation
# ---------------------------------------------------------------------------


def write_obs_dir(
    out_dir: str | Path,
    report,
    arch=None,
    obs=None,
    coeffs=None,
    dvfs_scale: float | None = None,
    process_name: str = "tpusim",
) -> dict[str, Path]:
    """Write the full export set for one simulated run:
    ``samples.jsonl`` + ``trace.json`` + ``metrics.prom``.  Returns the
    paths written, keyed by kind.  ``arch``/``dvfs_scale`` default to
    what the report recorded."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if arch is None:
        arch = report.arch_config
    if dvfs_scale is None:
        dvfs_scale = getattr(report, "dvfs_scale", 1.0)
    paths: dict[str, Path] = {}
    sampler = getattr(report, "samples", None)
    if sampler is not None and arch is not None:
        # normalize per REPLAYED device: a trace may declare N devices
        # but record commands for fewer (common in committed fixtures)
        n_dev = len(getattr(report, "device_cycles", {}) or {}) or 1
        rows = window_rows(sampler, arch, n_dev, coeffs, dvfs_scale)
        meta = {
            "arch": arch.name,
            "window_cycles": sampler.window_cycles,
            "num_devices": report.num_devices,
            "replayed_devices": n_dev,
            "clock_hz": arch.clock_hz,
            "config_name": report.config_name,
        }
        paths["samples"] = out_dir / "samples.jsonl"
        write_samples_jsonl(rows, paths["samples"], meta)
        paths["trace"] = out_dir / "trace.json"
        with open(paths["trace"], "w") as f:
            json.dump(
                pod_chrome_trace(report, arch, rows, process_name), f
            )
    values = dict(report.stats.values)
    if obs is not None and getattr(obs, "enabled", False):
        # overwrite the report's snapshot: spans still open when the
        # driver snapshotted (e.g. the enclosing 'simulate') have their
        # real totals only now
        for k, v in obs.stats_dict().items():
            values[f"obs_{k}"] = v
    paths["metrics"] = out_dir / "metrics.prom"
    paths["metrics"].write_text(prometheus_text(values))
    return paths


def validate_obs_dir(out_dir: str | Path, schema: dict) -> dict:
    """CI smoke validation of an export directory against the checked-in
    schema; raises ``ValueError`` on any violation, returns summary
    counts on success."""
    out_dir = Path(out_dir)
    header, rows = read_samples_jsonl(out_dir / "samples.jsonl")
    validate_sample_rows(header, rows, schema)
    min_windows = int(schema.get("min_windows", 2))
    if len(rows) < min_windows:
        raise ValueError(
            f"only {len(rows)} sample windows (schema requires "
            f">= {min_windows})"
        )
    trace = json.loads((out_dir / "trace.json").read_text())
    counters = {
        ev["name"] for ev in trace.get("traceEvents", [])
        if ev.get("ph") == "C"
    }
    missing = set(schema.get("counter_tracks_required", [])) - counters
    if missing:
        raise ValueError(f"trace.json missing counter tracks: {missing}")
    prom = (out_dir / "metrics.prom").read_text()
    n_gauges = 0
    for line in prom.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f"bad prometheus line: {line!r}")
        float(parts[1])
        n_gauges += 1
    if n_gauges == 0:
        raise ValueError("metrics.prom has no gauges")
    return {
        "windows": len(rows),
        "counter_tracks": sorted(counters),
        "gauges": n_gauges,
    }

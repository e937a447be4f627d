"""Request-scoped tracing for the serve fleet.

Port of ``tpusim/obs/reqtrace.py`` (stdlib only); the daemon
(:mod:`tpusim_torch.serve.daemon`, ``serve --trace-requests`` and
``--access-log``) consumes it.

The batch pillar (``tpusim_torch.obs.hub``) answers "where did this *run*
spend its time"; this module answers the same question at request
grain for the serving layer: every HTTP request mints a trace ID
(honoring an inbound ``X-Tpusim-Trace`` header), accumulates a
monotonic-clock span tree across tiers (front fd-dispatch -> http
parse -> hot lookup -> admission -> dispatch -> worker-side
cache probe / lint / price / serialize -> respond), and lands the
completed tree in a bounded in-memory flight recorder with
tail-sampling: the N slowest per route are kept, plus every
non-2xx outcome (504 deadline trips and 422 quarantine verdicts
included).

Aggregates ride the existing ``/metrics`` merge as real prometheus
histograms: per-route and per-phase latency distributions with fixed
log-spaced bounds (x4 per step, 0.25ms .. 65536ms).  The histogram
state is carried in ``metrics_values()`` as plain numeric keys
(per-bucket increments, not cumulative), so the fleet's sum-merge of
peer ``/-/stats`` values composes bucket counts correctly and
quantiles stay meaningful across acceptors; ``histogram_exposition``
re-renders the merged keys as ``_bucket``/``_sum``/``_count`` series
under a single ``# TYPE <family> histogram`` header.

House discipline: tracing off (the default) means zero new stats
keys, no recorder allocation, and byte-identical responses; tracing
on grows only ``/metrics``, the ``/v1/debug/traces`` routes, and a
response *header* — never a response body.

All ``reqtrace_*`` stats-key literals are minted in this module only
(one writer per report line; see ``tpusim_torch.analysis.statskeys``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from bisect import bisect_left
from collections import deque
from pathlib import Path
from typing import Iterable

__all__ = [
    "TRACE_HEADER",
    "TRACE_CTX_KEY",
    "BUCKET_BOUNDS_MS",
    "mint_trace_id",
    "valid_trace_id",
    "RequestTrace",
    "LatencyHistogram",
    "FlightRecorder",
    "RequestTracer",
    "AccessLog",
    "histogram_exposition",
]

#: request/response header carrying the trace ID; an inbound value is
#: honored (so a client or the acceptor->primary proxy hop can pin the
#: ID) and the same header is stamped on every traced response
TRACE_HEADER = "X-Tpusim-Trace"

#: volatile body key marking "collect worker-side spans for this
#: request" across the worker-pool frame boundary; stripped from
#: hot-cache/affinity/quarantine content keys exactly like
#: ``_budget_s`` (see serve.supervisor._VOLATILE_BODY_KEYS)
TRACE_CTX_KEY = "_trace_ctx"

#: fixed log-spaced histogram bounds in milliseconds (x4 per step).
#: Fixed bounds are what make the fleet merge correct: every acceptor
#: buckets identically, so summing per-bucket counts composes.
BUCKET_BOUNDS_MS = (
    0.25, 1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
)

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")

_HIST_FAMILIES = ("reqtrace_route_ms", "reqtrace_phase_ms")
_FAMILY_LABELS = {"reqtrace_route_ms": "route", "reqtrace_phase_ms": "phase"}


def valid_trace_id(token: str) -> bool:
    """True when ``token`` is a well-formed trace ID (8..32 lowercase
    hex) — the gate before embedding one in a fleet-internal URL."""
    return bool(_TRACE_ID_RE.match(token or ""))


def mint_trace_id(inbound: str | None = None) -> str:
    """Return a trace ID: the inbound header value when it is a
    well-formed lowercase-hex token, else a fresh random 16-hex ID."""
    if inbound:
        tok = inbound.strip().lower()
        if _TRACE_ID_RE.match(tok):
            return tok
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# span tree


class _Span:
    """Context-manager span; path derives from the enclosing stack."""

    __slots__ = ("_tr", "_name", "_path", "_t0")

    def __init__(self, tr: "RequestTrace", name: str):
        self._tr = tr
        self._name = name
        self._path = ""
        self._t0 = 0.0

    def __enter__(self):
        tr = self._tr
        tr._stack.append(self._name)
        self._path = "/".join(tr._stack)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tr
        dur = time.monotonic() - self._t0
        tr._stack.pop()
        tr._spans.append((self._path, self._t0, dur))
        return False


class RequestTrace:
    """One request's span tree over the shared monotonic clock.

    Spans are recorded as ``(path, abs_start_s, dur_s)`` against
    ``time.monotonic()``; on Linux CLOCK_MONOTONIC is system-wide, so
    spans timed in a forked worker merge directly with the handler's
    without clock alignment.  ``finish`` is idempotent — the first
    call freezes the document, so a send helper may finalize early
    (e.g. ``/metrics`` observes itself before rendering) without a
    later double-observe.
    """

    __slots__ = (
        "trace_id", "route", "start_s", "status", "meta",
        "_spans", "_stack", "_doc",
    )

    def __init__(self, trace_id: str, route: str,
                 start_s: float | None = None):
        self.trace_id = trace_id
        self.route = route
        self.start_s = time.monotonic() if start_s is None else start_s
        self.status: int | None = None
        self.meta: dict = {}
        self._spans: list[tuple[str, float, float]] = []
        self._stack: list[str] = []
        self._doc: dict | None = None

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add_span(self, path: str, start_s: float, dur_s: float) -> None:
        self._spans.append((path, start_s, max(dur_s, 0.0)))

    def note_fd_dispatch(self, accepted_s: float, received_s: float) -> None:
        """Record the front's accept->fd-handoff leg and pull the trace
        start back to the accept instant so the span nests."""
        if accepted_s < self.start_s:
            self.start_s = accepted_s
        self.add_span("fd_dispatch", accepted_s, received_s - accepted_s)

    def add_worker_spans(self, entries: Iterable, under: str = "dispatch",
                         ) -> None:
        """Merge worker-side ``(name, abs_start_s, dur_s)`` entries as
        children of the handler-side ``under`` span."""
        for entry in entries:
            try:
                name, t0, dur = entry
                self._spans.append(
                    (f"{under}/{name}", float(t0), max(float(dur), 0.0))
                )
            except (TypeError, ValueError):
                continue  # a malformed frame never fails the request

    def finish(self, status: int, acceptor: int | None = None,
               node_id: str | None = None) -> dict:
        """Freeze the trace into its document (idempotent)."""
        if self._doc is not None:
            return self._doc
        self.status = int(status)
        total_ms = (time.monotonic() - self.start_s) * 1000.0
        spans = [
            {
                "path": path,
                "start_ms": round((t0 - self.start_s) * 1000.0, 4),
                "dur_ms": round(dur * 1000.0, 4),
            }
            for path, t0, dur in sorted(self._spans, key=lambda s: s[1])
        ]
        doc = {
            "trace_id": self.trace_id,
            "route": self.route,
            "status": self.status,
            "total_ms": round(total_ms, 4),
            "acceptor": acceptor,
            "spans": spans,
        }
        if node_id is not None:
            # clustered daemons only — the single-node document stays
            # byte-identical, and cross-node forwarded requests
            # correlate in the flight recorder by node
            doc["node_id"] = node_id
        if self.meta:
            doc["meta"] = dict(self.meta)
        self._doc = doc
        return doc


# ---------------------------------------------------------------------------
# histograms


class LatencyHistogram:
    """Fixed-bound latency histogram (per-bucket increments).

    ``counts`` has one overflow slot past the last bound; the exposition
    layer derives the cumulative ``le`` series, so the raw counts stay
    sum-mergeable across acceptors.
    """

    __slots__ = ("counts", "sum_ms", "count")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS_MS) + 1)
        self.sum_ms = 0.0
        self.count = 0

    def observe(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        self.counts[bisect_left(BUCKET_BOUNDS_MS, ms)] += 1
        self.sum_ms += ms
        self.count += 1


# ---------------------------------------------------------------------------
# flight recorder


class FlightRecorder:
    """Bounded in-memory store of completed trace documents.

    Tail-sampling policy: per route, keep the ``keep_slowest`` slowest
    2xx traces (a faster trace never evicts a slower one); every
    non-2xx trace (504 deadline trips, 422 quarantine verdicts, 5xx)
    is kept in a separate bounded ring so error evidence survives even
    on a route dominated by slow successes.
    """

    def __init__(self, keep_slowest: int = 8, keep_errors: int = 64,
                 max_routes: int = 64):
        self.keep_slowest = int(keep_slowest)
        self.max_routes = int(max_routes)
        self._slow: dict[str, list[dict]] = {}
        self._errors: deque = deque(maxlen=int(keep_errors))
        self._lock = threading.Lock()
        self.recorded_total = 0
        self.sampled_out_total = 0

    def record(self, doc: dict) -> bool:
        """Offer a completed trace; returns True when retained."""
        status = int(doc.get("status") or 0)
        with self._lock:
            if not 200 <= status < 300:
                if len(self._errors) == self._errors.maxlen:
                    self.sampled_out_total += 1
                self._errors.append(doc)
                self.recorded_total += 1
                return True
            route = str(doc.get("route") or "other")
            bucket = self._slow.get(route)
            if bucket is None:
                if len(self._slow) >= self.max_routes:
                    self.sampled_out_total += 1
                    return False
                bucket = self._slow[route] = []
            if len(bucket) < self.keep_slowest:
                bucket.append(doc)
                self.recorded_total += 1
                return True
            idx = min(
                range(len(bucket)), key=lambda i: bucket[i]["total_ms"]
            )
            if doc["total_ms"] > bucket[idx]["total_ms"]:
                bucket[idx] = doc
                self.recorded_total += 1
                self.sampled_out_total += 1  # the evicted faster trace
                return True
            self.sampled_out_total += 1
            return False

    def _all(self) -> list[dict]:
        docs: list[dict] = []
        for bucket in self._slow.values():
            docs.extend(bucket)
        docs.extend(self._errors)
        return docs

    def snapshot(self, limit: int = 50) -> list[dict]:
        """Retained traces, slowest first."""
        with self._lock:
            docs = self._all()
        docs.sort(key=lambda d: d["total_ms"], reverse=True)
        return docs[: max(int(limit), 0)]

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            for doc in self._all():
                if doc["trace_id"] == trace_id:
                    return doc
        return None

    @property
    def live(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._slow.values()) + \
                len(self._errors)


# ---------------------------------------------------------------------------
# tracer (per-daemon state)


class RequestTracer:
    """Per-daemon tracing state: mints traces, observes completions
    into the route/phase histograms, and feeds the flight recorder."""

    def __init__(self, acceptor_index: int | None = None,
                 keep_slowest: int = 8, keep_errors: int = 64,
                 node_id: str | None = None):
        self.acceptor_index = acceptor_index
        # stamped late by a daemon that becomes clustered mid-life
        # (the lazy-primary path); None keeps documents and lines
        # byte-identical to the single-node format
        self.node_id = node_id
        self.recorder = FlightRecorder(keep_slowest, keep_errors)
        self._route: dict[str, LatencyHistogram] = {}
        self._phase: dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()

    def begin(self, route: str, inbound: str | None = None,
              start_s: float | None = None) -> RequestTrace:
        return RequestTrace(mint_trace_id(inbound), route, start_s)

    def finish(self, tr: RequestTrace, status: int) -> dict:
        """Finalize a trace: freeze, observe, record.  Idempotent via
        the trace's own frozen document."""
        already = tr._doc is not None
        doc = tr.finish(
            status, acceptor=self.acceptor_index, node_id=self.node_id,
        )
        if already:
            return doc
        with self._lock:
            hist = self._route.get(doc["route"])
            if hist is None:
                hist = self._route[doc["route"]] = LatencyHistogram()
            hist.observe(doc["total_ms"])
            for span in doc["spans"]:
                phase = span["path"].replace("/", ".")
                ph = self._phase.get(phase)
                if ph is None:
                    ph = self._phase[phase] = LatencyHistogram()
                ph.observe(span["dur_ms"])
        self.recorder.record(doc)
        return doc

    # -- surfaces ----------------------------------------------------

    def metrics_values(self) -> dict:
        """Histogram state + recorder counters as plain numeric keys.

        Per-bucket *increments* (``__b<i>``), not cumulative counts, so
        the fleet's sum-merge of peer values composes; zero buckets are
        omitted to keep the payload lean (render treats missing as 0).
        """
        out: dict[str, float] = {}
        with self._lock:
            for family, hists in (
                ("reqtrace_route_ms", self._route),
                ("reqtrace_phase_ms", self._phase),
            ):
                for label in sorted(hists):
                    h = hists[label]
                    base = f"{family}__{label}"
                    for i, c in enumerate(h.counts):
                        if c:
                            out[f"{base}__b{i}"] = float(c)
                    out[f"{base}__sum"] = h.sum_ms
                    out[f"{base}__cnt"] = float(h.count)
        out["reqtrace_recorded_total"] = float(self.recorder.recorded_total)
        out["reqtrace_sampled_out_total"] = float(
            self.recorder.sampled_out_total
        )
        out["reqtrace_traces_live"] = float(self.recorder.live)
        return out

    def traces_doc(self, limit: int = 50) -> list[dict]:
        """Summaries of retained traces, slowest first."""
        out = []
        for d in self.recorder.snapshot(limit):
            summary = {
                "trace_id": d["trace_id"],
                "route": d["route"],
                "status": d["status"],
                "total_ms": d["total_ms"],
                "acceptor": d.get("acceptor"),
                "spans": len(d["spans"]),
            }
            if "node_id" in d:
                summary["node_id"] = d["node_id"]
            out.append(summary)
        return out

    def get(self, trace_id: str) -> dict | None:
        return self.recorder.get(trace_id)


# ---------------------------------------------------------------------------
# prometheus exposition


def histogram_exposition(values: dict, prefix: str = "tpusim_",
                         ) -> tuple[dict, list[str]]:
    """Split ``reqtrace_*_ms`` histogram keys out of a (possibly
    fleet-merged) metrics-values dict and render them as prometheus
    histogram series.

    Returns ``(rest, lines)`` where ``rest`` holds every non-histogram
    key (to flow through ``prometheus_text`` unchanged) and ``lines``
    are the ``# TYPE <family> histogram`` + ``_bucket``/``_sum``/
    ``_count`` exposition lines.  Label parts contain no spaces — the
    repo's scrape validators split sample lines into exactly two
    whitespace-separated fields.
    """
    from tpusim_torch.obs.export import _prom_number

    hist: dict[str, dict[str, dict]] = {}
    rest: dict = {}
    for key, value in values.items():
        parts = key.split("__")
        if len(parts) != 3 or parts[0] not in _HIST_FAMILIES:
            rest[key] = value
            continue
        family, label, tail = parts
        slot = hist.setdefault(family, {}).setdefault(
            label, {"b": {}, "sum": 0.0, "cnt": 0.0}
        )
        try:
            if tail == "sum":
                slot["sum"] = float(value)
            elif tail == "cnt":
                slot["cnt"] = float(value)
            elif tail.startswith("b"):
                slot["b"][int(tail[1:])] = float(value)
            else:
                rest[key] = value
        except (TypeError, ValueError):
            rest[key] = value
    lines: list[str] = []
    for family in sorted(hist):
        name = f"{prefix}{family}"
        label_key = _FAMILY_LABELS[family]
        lines.append(f"# TYPE {name} histogram")
        for label in sorted(hist[family]):
            slot = hist[family][label]
            cum = 0.0
            for i, bound in enumerate(BUCKET_BOUNDS_MS):
                cum += slot["b"].get(i, 0.0)
                lines.append(
                    f'{name}_bucket{{{label_key}="{label}",'
                    f'le="{_prom_number(bound)}"}} {_prom_number(cum)}'
                )
            lines.append(
                f'{name}_bucket{{{label_key}="{label}",le="+Inf"}} '
                f'{_prom_number(slot["cnt"])}'
            )
            lines.append(
                f'{name}_sum{{{label_key}="{label}"}} '
                f'{_prom_number(slot["sum"])}'
            )
            lines.append(
                f'{name}_count{{{label_key}="{label}"}} '
                f'{_prom_number(slot["cnt"])}'
            )
    return rest, lines


# ---------------------------------------------------------------------------
# access log


class AccessLog:
    """Structured JSONL access log with size-based rotation.

    One line per completed (counted) request: monotonic-relative
    timestamp, trace ID (empty when tracing is off), route, status,
    latency, cache tier, acceptor index.  Best-effort by design: lines
    are buffered writes, and rotation keeps exactly one predecessor
    file (``<path>.1``).
    """

    def __init__(self, path: str | os.PathLike,
                 max_bytes: int = 16 * 1024 * 1024):
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.lines_total = 0

    def write(self, *, route: str, status: int, latency_ms: float,
              trace_id: str | None = None, tier: str | None = None,
              acceptor: int | None = None,
              node_id: str | None = None) -> None:
        doc = {
            "ts_s": round(time.monotonic() - self._t0, 6),
            "trace_id": trace_id or "",
            "route": route,
            "status": int(status),
            "latency_ms": round(float(latency_ms), 4),
            "tier": tier or "",
            "acceptor": acceptor,
        }
        if node_id is not None:
            # clustered daemons only: unclustered lines stay
            # byte-identical to the unclustered format
            doc["node_id"] = node_id
        line = json.dumps(doc, sort_keys=True)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self.lines_total += 1
            if self._fh.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        # lint-allow: TL352 best-effort access log — rotation that
        # loses a buffered tail on crash just loses diagnostics, never
        # durable state, so the fsync-before-replace rule is waived
        os.replace(self.path, self.path.with_name(self.path.name + ".1"))
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

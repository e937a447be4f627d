"""The HTTP + lifecycle layer of :mod:`tpusim_torch.serve` (port of
``tpusim/serve/daemon.py``, every route included).

Stdlib only: :class:`http.server.ThreadingHTTPServer` accepts, one
thread per connection; the admission layer (not the thread count)
bounds real concurrency.  The handler does protocol work exclusively —
route, size-cap, parse, map exceptions to status codes — and delegates
every decision to the layers below:

====================  ====  =====================================
route                 verb  backing layer
====================  ====  =====================================
``/v1/simulate``      POST  admission → :meth:`ServeWorker.simulate`
``/v1/lint``          POST  admission → :meth:`ServeWorker.lint`
``/v1/sweep``         POST  :class:`JobTable` (async; returns job id)
``/v1/campaign``      POST  :class:`JobTable` (async; crash-safe when
                            ``--state-dir`` is set — spec persisted,
                            progress journaled, restart resumes)
``/v1/advise``        POST  :class:`JobTable` (async; the sharding
                            advisor's ranked strategy-sweep report)
``/v1/fleet``         POST  :class:`JobTable` (async; the fleet
                            digital twin's capacity report — crash-
                            safe like campaign jobs: spec persisted,
                            pricing journaled, restart resumes)
``/v1/jobs/<id>``     GET   :class:`JobTable`
``/v1/jobs/<id>``     DEL   :class:`JobTable` (cooperative cancel —
                            queued jobs land ``cancelled`` at once,
                            running campaign/advise jobs unwind at
                            their next scenario/cell boundary with
                            completed work journaled)
``/v1/traces``        GET   :class:`TraceRegistry`
``/v1/debug/traces``  GET   request traces (``--trace-requests``)
``/v1/cluster/*``     both  membership, heartbeats, forwarding
                            (:mod:`.cluster`, ``--join``)
``/healthz``          GET   liveness (503 while draining)
``/metrics``          GET   Prometheus via ``obs.export.prometheus_text``
====================  ====  =====================================

Status mapping: :class:`~tpusim_torch.serve.worker.RequestError` carries its
own status (400/404/422), :class:`Overloaded` → 429 + ``Retry-After``,
:class:`DeadlineExceeded` → 504, :class:`Draining` → 503, an oversized
body → 413 before it is read.  Every JSON response carries
``format_version``, ``model_version``, and (simulate) ``cache_hit`` so
clients can reason about staleness.

Lifecycle (the SIGTERM contract): stop admitting, let in-flight
requests and accepted jobs run to completion, flush the disk tier of
the shared result cache, close the listener, exit 0.  ``/healthz``
reports 503 from the first drain instant so load balancers stop
routing before the listener disappears.

The multi-acceptor front tier (the reference's ``serve/front.py``, not
ported yet: ROADMAP A11 item 2) runs one ``ServeDaemon`` per **acceptor
process**, each parsing + admitting on its own GIL.  The daemon keeps its
front-tier identity arguments (``acceptor_index``, ``acceptors_total``,
``reuse_port``, ``public_listener``, ``close_fds``), which keep their
standalone defaults until the front tier lands.  Three
additions engage only in that topology (or, for the hot path, when
``hot_cache`` is mounted standalone):

* the **hot-response path**: a ``POST /v1/simulate`` whose affinity key
  is published in the shared :class:`~tpusim_torch.serve.hotcache.
  HotResponseCache` is answered straight from the mmap — no admission,
  no dispatch, no re-serialization (the stored bytes ARE the final
  envelope, ``cache_hit`` true);
* a **direct listener** on an ephemeral port for fleet-internal traffic
  (peer ``/-/stats`` merges, job proxying to the primary acceptor);
* **fleet views**: ``/metrics`` and ``/healthz`` merge every live
  acceptor's local values into one document (``?scope=local`` keeps a
  single acceptor's view reachable).
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpusim_torch.guard.cancel import CancelToken, OperationCancelled
from tpusim_torch.obs.reqtrace import TRACE_HEADER
from tpusim_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    Degraded,
    Draining,
    JobTable,
    Overloaded,
)
from tpusim_torch.serve.cluster import (
    DEFAULT_BEAT_INTERVAL_S,
    DEFAULT_MISSED_BEATS,
    FORWARD_HEADER,
    StaleEpoch,
    alive_members,
    member_url,
    ring_for,
)
from tpusim_torch.serve.registry import TraceRegistry
from tpusim_torch.serve.supervisor import (
    CooperativeCancel,
    Supervisor,
    WorkerTimeout,
)
from tpusim_torch.serve.worker import MAX_DEADLINE_S, RequestError, ServeWorker

__all__ = ["SERVE_FORMAT_VERSION", "ServeDaemon"]

#: bumped when the response document shape changes
SERVE_FORMAT_VERSION = 1

#: default request-body cap (inline HLO fits; a runaway upload does not)
DEFAULT_MAX_REQUEST_BYTES = 8 * 1024 * 1024


def _prewarm_pricing_stack() -> None:
    """Pull the request path's one-time costs forward to boot.

    A cold first request used to pay them inside its own latency
    budget: the pricing-backend resolution and the lazy imports the
    simulate path performs (driver, faults, analysis passes — tens of
    ms of bytecode work when no .pyc is cached).  Called at daemon
    start and worker boot; everything here is idempotent."""
    from tpusim_torch.fastpath.price import resolve_backend

    resolve_backend(None)
    import tpusim_torch.analysis.config_passes  # noqa: F401
    import tpusim_torch.faults  # noqa: F401
    import tpusim_torch.sim.driver  # noqa: F401
    from tpusim_torch.timing.model_version import model_version

    model_version()  # memoized source-hash pass


def _get_route(path: str) -> str:
    """Histogram/access-log route label for a GET path — a small fixed
    vocabulary, never raw paths (unbounded label cardinality would let
    one curl loop grow /metrics without bound)."""
    if path == "/healthz":
        return "healthz"
    if path == "/metrics":
        return "metrics"
    if path == "/v1/traces":
        return "traces"
    if path.startswith("/v1/debug/traces"):
        return "debug"
    if path.startswith("/v1/jobs/"):
        return "jobs"
    return "other"


def _post_route(path: str) -> str:
    """Route label for a POST path (same fixed-vocabulary rule)."""
    if path in ("/v1/simulate", "/v1/lint", "/v1/sweep", "/v1/campaign",
                "/v1/advise", "/v1/fleet"):
        return path.rsplit("/", 1)[1]
    return "other"


class _Handler(BaseHTTPRequestHandler):
    """Protocol-only; all policy lives in the daemon's layers."""

    #: set per-daemon via the dynamic subclass in ServeDaemon.start
    daemon_obj: "ServeDaemon" = None
    protocol_version = "HTTP/1.1"
    # small JSON responses after sub-ms pricing: waiting out Nagle/
    # delayed-ACK would dominate the latency the cache just earned
    disable_nagle_algorithm = True
    # per-connection socket READ timeout: a client that sends headers
    # and then stalls (or an idle keep-alive) would otherwise pin a
    # handler thread forever — body reads happen BEFORE admission, so
    # no admission bound covers them.  http.server catches the timeout
    # in handle_one_request and closes the connection; in-flight
    # pricing is unaffected (no read is outstanding while we work).
    timeout = 60.0

    # request-trace state, reset per request in parse_request (one
    # handler instance serves every request on a keep-alive connection)
    _trace = None
    _route = None
    _parse_t0 = None
    _finished_tid = None
    _relay_tid = None

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        d = self.daemon_obj
        if d is not None and d.verbose:
            super().log_message(fmt, *args)

    def parse_request(self):
        # stamped AFTER the request line was read (so keep-alive idle
        # time between requests never pollutes the http_parse span) and
        # only when some observability surface is on — tracing off
        # means this hook costs one attribute test per request
        self._trace = None
        self._route = None
        self._parse_t0 = None
        self._finished_tid = None
        self._relay_tid = None
        d = self.daemon_obj
        if d is not None and (
            d.reqtrace is not None or d.access_log is not None
        ):
            self._parse_t0 = time.monotonic()
        return super().parse_request()

    def _track(self, route: str) -> None:
        """Begin per-request observability for a *counted* request —
        called exactly where ``serve_requests_total`` increments, so
        the latency histograms' counts sum to that counter."""
        d = self.daemon_obj
        self._route = route
        rt = d.reqtrace
        if rt is None:
            return
        tr = rt.begin(
            route, self.headers.get(TRACE_HEADER),
            start_s=self._parse_t0,
        )
        acc = d.pop_accept_ts(self.connection)
        if acc is not None:
            # fd-passing front: the parent's accept timestamp rode the
            # send_fds message; the span covers accept -> child recv
            tr.note_fd_dispatch(acc[0], acc[1])
        if self._parse_t0 is not None:
            tr.add_span(
                "http_parse", self._parse_t0,
                time.monotonic() - self._parse_t0,
            )
        self._trace = tr

    def _finalize(self, status: int) -> str | None:
        """Complete per-request observability (idempotent; called by
        every send helper, possibly twice for early-observing routes
        like ``/metrics``).  Returns the trace ID for the response
        header, if any."""
        d = self.daemon_obj
        tr = self._trace
        if tr is not None:
            self._trace = None
            doc = d.reqtrace.finish(tr, status)
            self._finished_tid = tr.trace_id
            if d.access_log is not None:
                self._route = None
                d.access_log.write(
                    route=tr.route, status=status,
                    latency_ms=doc["total_ms"], trace_id=tr.trace_id,
                    tier=(doc.get("meta") or {}).get("tier"),
                    acceptor=d.acceptor_index,
                    node_id=d.cluster_node_id,
                )
            return self._finished_tid
        if self._finished_tid is not None:
            return self._finished_tid
        if self._relay_tid is not None:
            return self._relay_tid
        if d.access_log is not None and self._route is not None:
            route = self._route
            self._route = None  # one access-log line per request
            latency_ms = (
                (time.monotonic() - self._parse_t0) * 1000.0
                if self._parse_t0 is not None else 0.0
            )
            d.access_log.write(
                route=route, status=status, latency_ms=latency_ms,
                acceptor=d.acceptor_index, node_id=d.cluster_node_id,
            )
        return None

    def _send_json(
        self, status: int, doc: dict, headers: dict | None = None,
    ) -> None:
        d = self.daemon_obj
        tr = self._trace
        t_resp = time.monotonic() if tr is not None else 0.0
        body = json.dumps({
            "format_version": SERVE_FORMAT_VERSION,
            "model_version": d.worker.model_version,
            **doc,
        }, sort_keys=True).encode() + b"\n"
        if tr is not None:
            tr.add_span("respond", t_resp, time.monotonic() - t_resp)
        tid = self._finalize(status)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if tid:
            self.send_header(TRACE_HEADER, tid)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; the work is done either way
        d._count_status(status)

    def _send_body(self, status: int, body) -> None:
        """Pre-serialized JSON body: a supervised worker's ok_bytes
        response, or a hot-cache ``memoryview`` — both already carry the
        format/model_version envelope.  A memoryview goes to the socket
        without an intermediate copy (the zero-copy path)."""
        tid = self._finalize(status)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if tid:
            self.send_header(TRACE_HEADER, tid)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        self.daemon_obj._count_status(status)

    def _send_text(self, status: int, text: str, content_type: str) -> None:
        body = text.encode()
        tid = self._finalize(status)
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if tid:
            self.send_header(TRACE_HEADER, tid)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        self.daemon_obj._count_status(status)

    def _read_body(self) -> dict | None:
        """Size-capped JSON body; sends the error response itself and
        returns None on refusal."""
        tr = self._trace
        if tr is None:
            return self._read_body_inner()
        with tr.span("parse"):
            return self._read_body_inner()

    def _read_body_inner(self) -> dict | None:
        d = self.daemon_obj
        try:
            length = int(self.headers.get("Content-Length", "0") or "0")
        except ValueError:
            length = -1
        if length < 0:
            self._send_json(411, {
                "error": "length_required",
                "detail": "Content-Length is required",
            })
            return None
        if length > d.max_request_bytes:
            # refuse BEFORE reading; the unread body makes the
            # connection unusable, so close it
            self.close_connection = True
            self._send_json(413, {
                "error": "request_too_large",
                "detail": (
                    f"body is {length} bytes; this server caps requests "
                    f"at {d.max_request_bytes}"
                ),
            }, headers={"Connection": "close"})
            return None
        raw = self.rfile.read(length) if length else b"{}"
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            self._send_json(400, {
                "error": "bad_json", "detail": f"body is not JSON: {e}",
            })
            return None
        if not isinstance(body, dict):
            self._send_json(400, {
                "error": "bad_json", "detail": "body must be a JSON object",
            })
            return None
        return body

    # -- routes --------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 - stdlib signature
        d = self.daemon_obj
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        local = "scope=local" in query
        if path.startswith("/v1/cluster/"):
            # cluster control traffic is not user traffic (the
            # /-/stats discipline at node grain): uncounted, untraced
            self._cluster_get(path)
            return
        # fleet-internal probes (/-/stats, ?scope=local merges) are not
        # traffic: counting them would inflate the fleet-summed request
        # counters by N-1 on every scrape/health poll
        if path != "/-/stats" and not local:
            d._count("serve_requests_total")
            self._track(_get_route(path))
        if path == "/healthz":
            if d.admission.draining:
                self._send_json(503, {"status": "draining"})
            elif d.cluster_active() and not local:
                self._send_json(200, d.cluster_healthz())
            elif d.in_fleet and not local:
                self._send_json(200, d.fleet_healthz())
            else:
                self._send_json(200, d.local_healthz())
        elif path == "/metrics":
            d._count("serve_requests_metrics_total")
            if self._trace is not None:
                # observe THIS scrape before rendering, so the
                # histogram bucket counts in the document it returns
                # sum exactly to serve_requests_total (finalize is
                # idempotent; _send_text reuses the frozen trace ID)
                self._finalize(200)
            if d.cluster_active() and not local:
                text = d.cluster_metrics_text()
            elif d.in_fleet and not local:
                text = d.fleet_metrics_text()
            else:
                text = d.metrics_text()
            self._send_text(200, text, "text/plain; version=0.0.4")
        elif path == "/v1/debug/traces" or \
                path.startswith("/v1/debug/traces/"):
            self._debug_traces(path, query, local)
        elif path == "/-/stats":
            # fleet-internal: this acceptor's raw metric values as JSON
            # (the peer merging /metrics sums these; JSON beats parsing
            # prometheus text back apart)
            self._send_json(200, {"values": d.metrics_values()})
        elif path == "/v1/traces":
            self._send_json(200, {"traces": d.registry.names()})
        elif path.startswith("/v1/jobs/"):
            if not d.is_primary:
                self._proxy_to_primary("GET", path, None)
                return
            job = d.jobs.get(path.rsplit("/", 1)[1])
            if job is None:
                self._send_json(404, {
                    "error": "unknown_job",
                    "detail": f"no such job {path.rsplit('/', 1)[1]!r}",
                })
            else:
                self._send_json(200, job.to_doc())
        else:
            self._send_json(404, {
                "error": "unknown_route", "detail": f"no route {path!r}",
            })

    def do_POST(self) -> None:  # noqa: N802 - stdlib signature
        d = self.daemon_obj
        path = self.path.split("?", 1)[0].rstrip("/")
        if path.startswith("/v1/cluster/"):
            # joins + 1 Hz heartbeats are cluster-internal control
            # traffic: counting them would make a clustered node's
            # request counters diverge from a single node serving the
            # same user load
            self._cluster_post(path)
            return
        d._count("serve_requests_total")
        self._track(_post_route(path))
        if path == "/v1/simulate":
            d._count("serve_requests_simulate_total")
            body = self._read_body()
            if body is None:
                return
            # hot path: a request whose exact response bytes
            # are already published in the shared mmap tier is answered
            # HERE — no admission slot, no dispatch, no re-pricing, no
            # serialization.  The stored body is the final envelope a
            # warm priced request would produce (cache_hit true), so
            # clients cannot tell the tiers apart except by latency.
            # deadline_ms is stripped from the hot key (volatile), so
            # a MALFORMED one must be rejected before the hot lookup —
            # the cold path 400s it, and the tiers must be
            # indistinguishable except by latency
            deadline_ok = True
            if body.get("deadline_ms") is not None:
                try:
                    float(body["deadline_ms"])
                except (TypeError, ValueError):
                    deadline_ok = False
            tr = self._trace
            t_hot = time.monotonic() if tr is not None else 0.0
            hot_key = (
                d.hot_key_for("simulate", body) if deadline_ok else None
            )
            blob = (
                d.hot.get(hot_key)
                if hot_key is not None and not d.admission.draining
                else None
            )
            if tr is not None:
                # one span covers key derivation + the mmap lookup —
                # the whole of what a hot hit pays
                tr.add_span(
                    "hot_lookup", t_hot, time.monotonic() - t_hot,
                )
            if blob is not None:
                # serve_hot_hits_total rides /metrics from the hot
                # store's own counters — not double-counted here
                if tr is not None:
                    tr.meta["tier"] = "hot"
                self._send_body(200, blob)
                return
            # cluster trace affinity, AFTER the hot miss: a local hot
            # hit is byte-identical wherever it is served, but a miss
            # belongs at the key's owner, where the hot/compiled state
            # for this trace concentrates
            if deadline_ok and self._maybe_forward("simulate", path, body):
                return
            self._run_sync(
                "simulate", d.worker.simulate, body=body, hot_key=hot_key,
            )
        elif path == "/v1/lint":
            d._count("serve_requests_lint_total")
            body = self._read_body()
            if body is None:
                return
            if self._maybe_forward("lint", path, body):
                return
            self._run_sync("lint", d.worker.lint, body=body)
        elif path in ("/v1/sweep", "/v1/campaign", "/v1/advise",
                      "/v1/fleet"):
            kind = path.rsplit("/", 1)[1]
            if d.is_primary:
                # secondaries skip the per-kind counter: the primary
                # counts the forwarded copy, and fleet metrics sum
                d._count(f"serve_requests_{kind}_total")
            if not d.is_primary:
                # exactly one acceptor (the primary) owns the
                # JobTable — async job ids, persistence, and restart
                # recovery stay single-writer.  Secondaries forward the
                # raw request over loopback to its direct listener.
                # The size cap applies BEFORE the body is read, exactly
                # like the local path's _read_body (including its 411
                # on an unparseable length).
                try:
                    length = int(
                        self.headers.get("Content-Length", "0") or 0
                    )
                except ValueError:
                    self._send_json(411, {
                        "error": "length_required",
                        "detail": "Content-Length is required",
                    })
                    return
                if length > d.max_request_bytes:
                    self.close_connection = True
                    self._send_json(413, {
                        "error": "request_too_large",
                        "detail": (
                            f"body is {length} bytes; this server caps "
                            f"requests at {d.max_request_bytes}"
                        ),
                    }, headers={"Connection": "close"})
                    return
                raw = self.rfile.read(length) if length > 0 else b""
                self._proxy_to_primary("POST", path, raw)
                return
            body = self._read_body()
            if body is None:
                return
            try:
                job = d.jobs.submit(kind, body)
            except Overloaded as e:
                d._count("serve_rejected_429_total")
                self._send_json(429, {
                    "error": "overloaded",
                    "detail": "job queue full; retry later",
                }, headers={"Retry-After": int(e.retry_after_s)})
                return
            except Draining:
                d._count("serve_draining_503_total")
                self._send_json(503, {
                    "error": "draining",
                    "detail": "server is draining; not accepting jobs",
                })
                return
            self._send_json(202, {
                "job_id": job.job_id, "status": job.status,
                "poll": f"/v1/jobs/{job.job_id}",
            })
        else:
            self._send_json(404, {
                "error": "unknown_route", "detail": f"no route {path!r}",
            })

    def do_DELETE(self) -> None:  # noqa: N802 - stdlib signature
        """``DELETE /v1/jobs/<id>`` — cooperative job cancellation
        (tpusim_torch.guard): a queued job lands terminal ``cancelled``
        immediately; a running campaign/advise job has its token
        tripped and unwinds at its next scenario/cell boundary with
        everything completed already journaled (a later ``--resume``
        re-prices nothing)."""
        d = self.daemon_obj
        d._count("serve_requests_total")
        path = self.path.split("?", 1)[0].rstrip("/")
        self._track("jobs" if path.startswith("/v1/jobs/") else "other")
        if not path.startswith("/v1/jobs/"):
            self._send_json(404, {
                "error": "unknown_route", "detail": f"no route {path!r}",
            })
            return
        if not d.is_primary:
            self._proxy_to_primary("DELETE", path, None)
            return
        job_id = path.rsplit("/", 1)[1]
        status = d.jobs.cancel(job_id)
        if status is None:
            self._send_json(404, {
                "error": "unknown_job",
                "detail": f"no such job {job_id!r}",
            })
            return
        if status in ("cancelled", "cancelling"):
            d._count("serve_jobs_cancel_requests_total")
        self._send_json(200, {"job_id": job_id, "status": status})

    def _debug_traces(self, path: str, query: str, local: bool) -> None:
        """``GET /v1/debug/traces`` (summaries, slowest first, fleet-
        merged) and ``/v1/debug/traces/<id>`` (one span tree; add
        ``?format=chrome`` for the Perfetto/Chrome export).  404 when
        tracing is off — the debug surface only exists when the flight
        recorder does."""
        d = self.daemon_obj
        rt = d.reqtrace
        if rt is None:
            self._send_json(404, {
                "error": "tracing_disabled",
                "detail": (
                    "start the daemon with --trace-requests to record "
                    "request traces"
                ),
            })
            return
        if path == "/v1/debug/traces":
            docs = rt.traces_doc()
            if d.in_fleet and not local:
                docs = d.fleet_traces_doc(docs)
            self._send_json(200, {"traces": docs})
            return
        trace_id = path.rsplit("/", 1)[1]
        doc = rt.get(trace_id)
        if doc is None and d.in_fleet and not local:
            doc = d.fleet_trace_get(trace_id)
        if doc is None:
            self._send_json(404, {
                "error": "unknown_trace",
                "detail": f"no recorded trace {trace_id!r}",
            })
            return
        if "format=chrome" in query:
            from tpusim_torch.obs.export import request_chrome_trace

            # the raw viewer document, no response envelope: this body
            # is meant to be saved and loaded into Perfetto/chrome as-is
            self._send_text(
                200, json.dumps(request_chrome_trace(doc), sort_keys=True),
                "application/json",
            )
            return
        self._send_json(200, {"trace": doc})

    # -- cluster routes (tpusim_torch.serve.cluster) -------------------------------

    def _cluster_get(self, path: str) -> None:
        d = self.daemon_obj
        if path == "/v1/cluster/stats":
            # cluster-internal: this NODE's raw values (acceptor-
            # merged in front mode) — what peer nodes fold into their
            # node-grain /metrics merge
            self._send_json(200, {"values": d.node_stats_values()})
            return
        if path != "/v1/cluster/view":
            self._send_json(404, {
                "error": "unknown_route", "detail": f"no route {path!r}",
            })
            return
        if d.in_fleet and not d.is_primary:
            # the registry (and the member-side gossip cache) live on
            # acceptor 0; secondaries forward like job routes do
            self._proxy_to_primary("GET", path, None, counted=False)
            return
        view = d.cluster_view_doc()
        if view is None:
            self._send_json(404, {
                "error": "no_cluster",
                "detail": (
                    "this node is not part of a cluster (start peers "
                    "with --join pointing here, or --join one)"
                ),
            })
            return
        self._send_json(200, view)

    def _cluster_post(self, path: str) -> None:
        d = self.daemon_obj
        if path not in ("/v1/cluster/join", "/v1/cluster/beat"):
            self._send_json(404, {
                "error": "unknown_route", "detail": f"no route {path!r}",
            })
            return
        if d.in_fleet and not d.is_primary:
            # single-writer epoch: only acceptor 0 mutates membership
            try:
                length = int(
                    self.headers.get("Content-Length", "0") or 0
                )
            except ValueError:
                length = 0
            if length > d.max_request_bytes:
                self.close_connection = True
                self._send_json(413, {
                    "error": "request_too_large",
                    "detail": "cluster control bodies are small",
                }, headers={"Connection": "close"})
                return
            raw = self.rfile.read(length) if length > 0 else b""
            self._proxy_to_primary("POST", path, raw, counted=False)
            return
        body = self._read_body()
        if body is None:
            return
        node_id = str(body.get("node_id") or "")
        if not node_id:
            self._send_json(400, {
                "error": "bad_request", "detail": "node_id is required",
            })
            return
        try:
            epoch = int(body.get("epoch") or 0)
        except (TypeError, ValueError):
            self._send_json(400, {
                "error": "bad_request", "detail": "epoch must be an int",
            })
            return
        if path == "/v1/cluster/join":
            reg = d.ensure_cluster_registry()
            if reg is None:
                # we are a member ourselves — point the joiner at OUR
                # primary instead of forking a second epoch writer
                self._send_json(409, {
                    "error": "not_primary",
                    "detail": (
                        f"this node joined {d.cluster_join}; join the "
                        f"primary there"
                    ),
                })
                return
            try:
                view = reg.join(
                    node_id, str(body.get("url") or ""), epoch,
                )
            except StaleEpoch as e:
                self._send_json(409, {
                    "error": "stale_epoch", "detail": str(e),
                })
                return
        else:
            reg = d.cluster
            if reg is None:
                # beats only make sense against a live registry; a
                # restarted primary lost its table — members must
                # rejoin fresh (409 is exactly that signal)
                self._send_json(409, {
                    "error": "no_cluster",
                    "detail": "no registry here; rejoin with epoch 0",
                })
                return
            try:
                view = reg.beat(
                    node_id, epoch,
                    shedding=bool(body.get("shedding")),
                )
            except StaleEpoch as e:
                self._send_json(409, {
                    "error": "stale_epoch", "detail": str(e),
                })
                return
        self._send_json(200, view)

    def _maybe_forward(self, endpoint: str, path: str, body: dict) -> bool:
        """Cluster trace affinity: when the affinity key's owner is
        another alive node, forward the request there one-hop and relay
        its bytes.  True when the response was sent here."""
        d = self.daemon_obj
        if self.headers.get(FORWARD_HEADER):
            # already forwarded once: serve locally no matter what our
            # ring says — the one-hop guarantee that kills routing
            # loops during view skew
            return False
        target = d.cluster_owner_url(endpoint, body)
        if target is None:
            return False
        return self._forward_to_node(target, path, body, endpoint)

    def _forward_to_node(
        self, url: str, path: str, body: dict, endpoint: str,
    ) -> bool:
        import http.client
        from urllib.parse import urlsplit

        d = self.daemon_obj
        raw = json.dumps(body).encode()
        tr = self._trace
        try:
            u = urlsplit(url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=30.0,
            )
            headers = {
                "Content-Type": "application/json",
                FORWARD_HEADER: d.node_id,
            }
            if tr is not None:
                headers[TRACE_HEADER] = tr.trace_id
            conn.request("POST", path, body=raw, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            conn.close()
        except (OSError, http.client.HTTPException):
            # the owner is unreachable (dying, not yet reaped): serve
            # locally — pricing is node-invariant, only cache locality
            # suffers, and a request must never fail because the ring
            # is mid-heal
            d._count("cluster_forward_fallback_total")
            return False
        d._count("cluster_forwarded_total")
        # the owner counted the forwarded copy as ITS request;
        # compensate ours so node-summed totals count each user
        # request exactly once (the _proxy_to_primary discipline)
        d._count("serve_requests_total", -1.0)
        d._count(f"serve_requests_{endpoint}_total", -1.0)
        self._trace = None
        self._route = None
        if tr is not None:
            self._relay_tid = resp.getheader(TRACE_HEADER) or tr.trace_id
        self._send_body(resp.status, payload)
        return True

    def _proxy_to_primary(
        self, method: str, path: str, raw, counted: bool = True,
    ) -> None:
        """Forward one job-family request to the primary acceptor's
        direct listener (the JobTable is single-owner).  The
        primary's response travels back verbatim.  ``counted=False``
        for cluster control routes, which never touched the request
        counters."""
        import http.client

        d = self.daemon_obj
        # the request was already counted at route entry, and the
        # primary will count the forwarded copy when it handles it —
        # without this compensation every proxied job request would
        # show as TWO requests in the fleet-summed /metrics
        if counted:
            d._count("serve_requests_total", -1.0)
        # the same rule governs tracing: drop this acceptor's trace
        # (never observed/recorded — the fleet histogram counts must
        # keep summing to serve_requests_total) and propagate its ID
        # over the hop so the PRIMARY records the span tree under it
        tr = self._trace
        self._trace = None
        self._route = None
        target = d.primary_direct
        if target is None:
            d._count("serve_proxy_unavailable_total")
            self._send_json(503, {
                "error": "primary_unavailable",
                "detail": (
                    "the primary acceptor (job owner) is restarting; "
                    "retry shortly"
                ),
            }, headers={"Retry-After": 1})
            return
        try:
            conn = http.client.HTTPConnection(d.host, target, timeout=30.0)
            headers = {"Accept": "application/json"}
            if raw:
                headers["Content-Type"] = "application/json"
            if tr is not None:
                headers[TRACE_HEADER] = tr.trace_id
            conn.request(method, path, body=raw or None, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if tr is not None:
                # relay the primary's (== our pinned) trace ID on the
                # response we forward back to the client
                self._relay_tid = (
                    resp.getheader(TRACE_HEADER) or tr.trace_id
                )
            conn.close()
        except (OSError, http.client.HTTPException):
            d._count("serve_proxy_unavailable_total")
            self._send_json(503, {
                "error": "primary_unavailable",
                "detail": (
                    "the primary acceptor (job owner) did not answer; "
                    "retry shortly"
                ),
            }, headers={"Retry-After": 1})
            return
        d._count("serve_proxied_total")
        self._send_body(resp.status, payload)

    def _run_sync(
        self, endpoint: str, fn, body: dict | None = None,
        hot_key: str | None = None,
    ) -> None:
        """Admission-gated execution of one synchronous endpoint."""
        d = self.daemon_obj
        if body is None:
            body = self._read_body()
        if body is None:
            return
        budget_s = d.deadline_s
        if body.get("deadline_ms") is not None:
            try:
                budget_s = float(body["deadline_ms"]) / 1000.0
            except (TypeError, ValueError):
                self._send_json(400, {
                    "error": "bad_request",
                    "detail": "deadline_ms must be a number",
                })
                return
        budget_s = min(max(budget_s, 0.0), MAX_DEADLINE_S)
        deadline = time.monotonic() + budget_s
        if d.watchdog is not None and d.watchdog.shedding:
            # the memory ladder's terminal step: past the hard RSS
            # threshold with every droppable store already dropped,
            # admitting more work would invite the OOM-killer — shed
            # with a hint sized to the sampler's recovery cadence
            d._count("guard_shed_503_total")
            self._send_json(503, {
                "error": "memory_pressure",
                "detail": (
                    "daemon is over its --max-rss hard threshold and "
                    "shedding load; retry shortly"
                ),
            }, headers={"Retry-After": 2})
            return
        if d.cluster_shed():
            # the watchdog ladder at node grain: too few alive nodes
            # to absorb this load — shed instead of queueing work the
            # survivors will only time out on
            d._count("cluster_shed_total")
            self._send_json(503, {
                "error": "cluster_degraded",
                "detail": (
                    "alive cluster nodes are below the configured "
                    "floor; retry after the fleet heals"
                ),
            }, headers={"Retry-After": 2})
            return
        tr = self._trace
        try:
            t_adm = time.monotonic()
            with d.admission.admit(deadline):
                if tr is not None:
                    # the admission span is the queue wait: admit()
                    # blocks in __enter__ until a slot frees
                    tr.add_span(
                        "admission", t_adm, time.monotonic() - t_adm,
                    )
                if d.work_hook is not None:
                    d.work_hook(endpoint, body)
                if time.monotonic() >= deadline:
                    raise DeadlineExceeded("deadline expired at admission")
                if tr is None:
                    result = d.execute_sync(endpoint, fn, body, deadline)
                else:
                    t_disp = time.monotonic()
                    try:
                        result = d.execute_sync(
                            endpoint, fn, body, deadline, reqtrace=tr,
                        )
                    finally:
                        # recorded on the way out even for the 504/422
                        # ladder below — those are the traces the
                        # recorder's error ring exists for
                        tr.add_span(
                            "dispatch", t_disp,
                            time.monotonic() - t_disp,
                        )
        except RequestError as e:
            if e.status == 400:
                d._count("serve_validation_400_total")
            self._send_json(e.status, {
                "error": e.code, "detail": e.detail, **e.extra,
            })
            return
        except Overloaded as e:
            d._count("serve_rejected_429_total")
            self._send_json(429, {
                "error": "overloaded",
                "detail": (
                    f"{d.admission.max_inflight} in flight and the wait "
                    f"queue is full; retry later"
                ),
            }, headers={"Retry-After": int(e.retry_after_s)})
            return
        except Degraded as e:
            # load shedding: the worker pool is below its live
            # floor, so queueing would only convert this request into a
            # slow 504 — tell the client when the restart backoff opens.
            # serve_shed_503_total is minted by the supervisor alone
            # (its stats_dict merges last into /metrics); counting here
            # too would shadow-write a value the merge then overwrites.
            self._send_json(503, {
                "error": "degraded",
                "detail": (
                    "worker pool is below its live floor; retry after "
                    "the restart backoff"
                ),
            }, headers={"Retry-After": int(e.retry_after_s)})
            return
        except (CooperativeCancel, OperationCancelled):
            # tpusim_torch.guard: the deadline tripped INSIDE the pricing
            # stack and the run cancelled in-process — still a 504, but
            # the worker (process or thread) survives with its caches
            # warm and zero restarts.  Ordered before WorkerTimeout/
            # DeadlineExceeded: CooperativeCancel subclasses them.
            d._count("serve_deadline_504_total")
            d._count("guard_coop_504_total")
            self._send_json(504, {
                "error": "deadline_exceeded",
                "detail": (
                    f"pricing exceeded the {budget_s:.3f}s deadline and "
                    f"was cancelled in-process (cooperative cancel); "
                    f"the worker survives with warm caches"
                ),
            })
            return
        except WorkerTimeout:
            # ordered before DeadlineExceeded (its parent): the request
            # STARTED and its worker was killed for outliving the budget
            d._count("serve_deadline_504_total")
            self._send_json(504, {
                "error": "deadline_exceeded",
                "detail": (
                    f"pricing exceeded the {budget_s:.3f}s deadline; "
                    f"the worker was killed and is being restarted"
                ),
            })
            return
        except DeadlineExceeded:
            d._count("serve_deadline_504_total")
            self._send_json(504, {
                "error": "deadline_exceeded",
                "detail": (
                    f"request did not start within its "
                    f"{budget_s:.3f}s deadline"
                ),
            })
            return
        except Draining:
            d._count("serve_draining_503_total")
            self._send_json(503, {
                "error": "draining",
                "detail": "server is draining; retry against a peer",
            })
            return
        except Exception as e:  # noqa: BLE001 - the 500 boundary
            d._count("serve_errors_total")
            self._send_json(500, {
                "error": "internal",
                "detail": f"{type(e).__name__}: {e}",
            })
            return
        if isinstance(result, (bytes, bytearray)):
            self._send_body(200, bytes(result))
        else:
            self._send_json(200, result)
        if hot_key is not None:
            # publish AFTER answering: the requester never waits on the
            # (one-time) warm-form serialization + fsync'd append
            d.hot_publish(hot_key, result)


class ServeDaemon:
    """Composes the four layers and owns the listener + job threads."""

    def __init__(
        self,
        trace_root=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_inflight: int = 4,
        queue_depth: int = 16,
        deadline_s: float = 30.0,
        max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
        result_cache=None,
        cache_entries: int = 4096,
        workers: int = 1,
        serve_workers: int = 0,
        min_workers: int = 1,
        restart_backoff_s: float = 0.05,
        chaos_hooks: bool = False,
        job_workers: int = 1,
        job_queue_depth: int = 16,
        drain_grace_s: float = 60.0,
        state_dir=None,
        verbose: bool = False,
        work_hook=None,
        cache_quota=None,
        max_rss=None,
        max_worker_rss=None,
        compile_cache=None,
        hot_cache=None,
        hot_quota_bytes=None,
        strict_lint: bool = False,
        acceptor_index: int | None = None,
        acceptors_total: int = 0,
        reuse_port: bool = False,
        public_listener: bool = True,
        quarantine_dir=None,
        close_fds=(),
        worker_close_fds=(),
        trace_requests: bool = False,
        access_log=None,
        cluster_join: str | None = None,
        cluster_beat_s: float | None = None,
        cluster_missed_beats: int | None = None,
        cluster_min_nodes: int = 1,
    ):
        from pathlib import Path

        from tpusim_torch.guard.store import parse_size
        from tpusim_torch.perf.cache import ResultCache, as_result_cache

        self.host = host
        self._requested_port = int(port)
        self.deadline_s = float(deadline_s)
        self.max_request_bytes = int(max_request_bytes)
        self.drain_grace_s = float(drain_grace_s)
        self.verbose = bool(verbose)
        self.work_hook = work_hook
        # front-tier identity: None = standalone daemon (every topology
        # the port serves today); an int = this process is
        # acceptor <index> of a FrontSupervisor fleet.  Acceptor 0 is
        # the primary (sole owner of the async JobTable); the rest
        # proxy job-family routes to its direct listener.
        self.acceptor_index = acceptor_index
        self.acceptors_total = max(int(acceptors_total), 0)
        self.in_fleet = acceptor_index is not None
        self.is_primary = acceptor_index in (None, 0)
        self.reuse_port = bool(reuse_port)
        self.public_listener = bool(public_listener)
        self._close_fds = tuple(close_fds or ())
        # fds this daemon needs but its forked WORKERS must close (an
        # acceptor's control pipe and fd-passing socket: a worker
        # holding them open would keep a dead acceptor's channels
        # half-alive — the front parent would ship connections into a
        # socketpair nobody drains)
        self._worker_close_fds = tuple(worker_close_fds or ())
        # peer map (acceptor index -> direct port), pushed by the front
        # supervisor after boot and on membership changes
        self._peers: dict[int, int] = {}
        self.primary_direct: int | None = None
        self._peer_lock = threading.Lock()
        # multi-node cluster (tpusim_torch.serve.cluster): --join makes this
        # daemon a member heartbeating a remote primary; a daemon
        # started WITHOUT --join becomes a cluster primary lazily, on
        # the first /v1/cluster/join it receives.  Until either
        # happens the daemon carries zero cluster state and mints zero
        # cluster stats keys — the single-node path stays key- and
        # byte-identical by construction.
        self.cluster_join = cluster_join or None
        self.cluster_beat_s = float(
            cluster_beat_s if cluster_beat_s is not None
            else DEFAULT_BEAT_INTERVAL_S
        )
        self.cluster_missed_beats = int(
            cluster_missed_beats if cluster_missed_beats is not None
            else DEFAULT_MISSED_BEATS
        )
        self.cluster_min_nodes = max(int(cluster_min_nodes), 1)
        self.cluster = None            # ClusterRegistry (primary side)
        self.cluster_node_id = None    # stamped once clustered
        self._cluster_view = None      # gossiped view (member side)
        self._cluster_lock = threading.Lock()
        self._heartbeat = None
        self._reaper: threading.Thread | None = None
        self._stop_cluster = threading.Event()

        # the process-wide shared result cache: always at least the
        # in-memory tier (sharing across requests IS the service's
        # reason to exist); --result-cache adds the disk tier
        self.result_cache = as_result_cache(result_cache) or ResultCache(
            max_entries=cache_entries
        )
        self.result_cache.max_entries = max(
            self.result_cache.max_entries, int(cache_entries)
        )
        # tpusim_torch.guard: --cache-quota bounds the shared disk tier.  The
        # daemon's own publishes GC it; worker fleets get the same quota
        # via settings so every writer of the dir enforces it.
        self.cache_quota_bytes = parse_size(cache_quota)
        if self.cache_quota_bytes is not None:
            self.result_cache.quota_bytes = self.cache_quota_bytes
        # tpusim_torch.fastpath.store: --compile-cache mounts the durable
        # compiled-module tier process-wide BEFORE the registry exists,
        # so every trace the registry loads defers its parse — a cold
        # first request against a warm store prices from mmapped
        # columns with zero Python IR construction.  Durable writes
        # (fsync-before-replace): this tier serves a fleet, and a
        # daemon killed mid-publish must never leave a short-read
        # record for its successors to warn about.
        self.compile_store = None
        if compile_cache is not None and compile_cache is not False:
            from tpusim_torch.fastpath.store import as_compile_store

            self.compile_store = as_compile_store(
                compile_cache, durable=True,
                quota_bytes=self.cache_quota_bytes,
            )
        self.registry = TraceRegistry(trace_root)
        # --strict-lint: every simulate request passes the trace-level
        # lint gate first — errors OR warnings refuse with 422 + the
        # diagnostics doc, verdict cached by content hash so the fleet
        # lints each distinct trace once
        self.strict_lint = bool(strict_lint)
        self.worker = ServeWorker(
            self.registry, result_cache=self.result_cache, workers=workers,
            strict_lint=self.strict_lint,
        )
        # the shared mmap hot-response cache.  Keyed by the
        # supervisor's content-hash affinity identity + a per-trace
        # stat fingerprint; generation-stamped with model_version /
        # format version / tuned-overlay state so staleness is
        # structurally impossible (a bump orphans the files).
        self.hot = None
        if hot_cache:
            from tpusim_torch.serve.hotcache import (
                HotResponseCache, hot_generation,
            )

            hot_dir = (
                hot_cache if isinstance(hot_cache, (str, Path))
                else ".tpusim_hot"  # the --result-cache default idiom
            )
            self.hot = HotResponseCache(
                hot_dir,
                generation=hot_generation(
                    self.worker.model_version, SERVE_FORMAT_VERSION,
                ),
                **(
                    {"quota_bytes": int(hot_quota_bytes)}
                    if hot_quota_bytes else {}
                ),
            )
        self._trace_fp_cache: dict[str, str] = {}
        self._trace_fp_lock = threading.Lock()
        # serve_workers >= 1 mounts the supervised pre-forked
        # worker pool — sync pricing (simulate/lint) moves into N
        # crash-isolated processes behind the admission layer, each with
        # its own registry + L1 cache and the daemon's disk cache dir
        # (when mounted) as the shared durable L2.  0 keeps the
        # single-process path, byte-identical by contract.
        self.serve_workers = max(int(serve_workers), 0)
        self.supervisor: Supervisor | None = None
        if self.serve_workers > 0:
            self.supervisor = Supervisor(
                settings={
                    "trace_root": str(trace_root) if trace_root else None,
                    "disk_cache_dir": (
                        str(self.result_cache.disk_dir)
                        if self.result_cache.disk_dir else None
                    ),
                    "cache_entries": int(cache_entries),
                    "cache_quota_bytes": self.cache_quota_bytes,
                    "compile_cache_dir": (
                        str(self.compile_store.disk_dir)
                        if self.compile_store is not None else None
                    ),
                    "chaos_hooks": bool(chaos_hooks),
                    "strict_lint": self.strict_lint,
                    # lets workers serialize the FINAL response body
                    # (byte-identical to _send_json's by construction)
                    "format_version": SERVE_FORMAT_VERSION,
                },
                num_workers=self.serve_workers,
                min_live=min_workers,
                restart_backoff_s=restart_backoff_s,
                max_worker_rss_bytes=parse_size(max_worker_rss),
                # a shared quarantine dir makes poison
                # refusal fleet-wide across acceptors
                quarantine_dir=quarantine_dir,
            )
            if self.result_cache.disk_dir is not None:
                # the parent still publishes to the shared dir (async
                # sweep/campaign/advise jobs price in parent threads);
                # its writes must carry the same fsync-before-replace
                # guarantee the workers' durable L2 does, or a host
                # crash mid-parent-publish leaves the short-read record
                # the durable tier exists to rule out
                self.result_cache.durable = True
        self.admission = AdmissionController(
            max_inflight=max_inflight, queue_depth=queue_depth,
        )
        # --state-dir makes accepted jobs crash-safe: specs persist
        # under <state_dir>/jobs (re-enqueued on restart) and campaign
        # jobs journal per-scenario progress under <state_dir>/campaigns
        # so a restarted daemon RESUMES them instead of re-pricing
        self.state_dir = Path(state_dir) if state_dir else None
        self.jobs = JobTable(
            queue_depth=job_queue_depth,
            persist_dir=(
                self.state_dir / "jobs" if self.state_dir else None
            ),
            # reclaim per-job campaign journals when the job ages out
            # of retention — journals are scenario-grained and fsync'd,
            # so a long-running daemon would otherwise grow disk
            # monotonically with every campaign ever run
            evict_hook=self._evict_job_state,
        )

        # tpusim_torch.guard: --max-rss mounts the memory watchdog with the
        # documented degradation ladder (shrink LRUs → drop compiled
        # tier → force lean streaming); its terminal shed state makes
        # _run_sync answer 503 + Retry-After instead of letting the
        # OOM-killer choose a victim
        self.watchdog = None
        max_rss_bytes = parse_size(max_rss)
        if max_rss_bytes is not None:
            from tpusim_torch.guard.watchdog import MemoryWatchdog, default_ladder

            self.watchdog = default_ladder(
                MemoryWatchdog(
                    soft_bytes=None, hard_bytes=max_rss_bytes,
                ),
                result_cache=self.result_cache,
            )
        #: startup integrity-sweep counters (guard_* /metrics gauges)
        self._guard_startup: dict[str, float] = {}

        self._httpd: ThreadingHTTPServer | None = None
        self._direct_httpd: ThreadingHTTPServer | None = None
        self._direct_thread: threading.Thread | None = None
        self._serve_thread: threading.Thread | None = None
        self._job_threads: list[threading.Thread] = []
        # 0 is a legitimate (test-facing) value: accept + persist jobs
        # without draining them — the restart-recovery path in a box
        self._job_workers = max(int(job_workers), 0)
        self._stop_jobs = threading.Event()
        self._stopped = threading.Event()
        self._counters: dict[str, float] = {}
        self._counter_lock = threading.Lock()
        self._clock0 = time.monotonic()

        # request-scoped tracing (L24, tpusim_torch.obs.reqtrace): OFF by
        # default — None means the handler pays one attribute test per
        # request, zero new stats keys, byte-identical responses
        self.reqtrace = None
        if trace_requests:
            from tpusim_torch.obs.reqtrace import RequestTracer

            self.reqtrace = RequestTracer(acceptor_index=acceptor_index)
        # structured JSONL access log (independent of tracing; lines
        # carry trace IDs only when tracing is also on)
        self.access_log = None
        if access_log:
            from tpusim_torch.obs.reqtrace import AccessLog

            log_path = (
                Path(access_log) if isinstance(access_log, (str, Path))
                else (
                    self.state_dir / "access.jsonl"
                    if self.state_dir else Path("tpusim-access.jsonl")
                )
            )
            if self.in_fleet:
                # one file per acceptor: concurrent writers rotating one
                # shared file would race each other's os.replace
                log_path = log_path.with_name(
                    f"{log_path.stem}.{acceptor_index}{log_path.suffix}"
                )
            self.access_log = AccessLog(log_path)
        # fd-passing front mode: accept timestamps for in-flight handed
        # connections, keyed by socket identity until the first request
        # on each connection claims its fd_dispatch span
        self._accept_ts: dict[int, tuple[float, float]] = {}
        self._accept_lock = threading.Lock()

    # -- counters ------------------------------------------------------------

    def _count(self, key: str, delta: float = 1.0) -> None:
        with self._counter_lock:
            self._counters[key] = self._counters.get(key, 0.0) + delta

    def _count_status(self, status: int) -> None:
        bucket = (
            "serve_responses_ok_total" if status < 400 else
            "serve_responses_client_error_total" if status < 500 else
            "serve_responses_server_error_total"
        )
        self._count(bucket)

    def metrics_values(self) -> dict[str, float]:
        """This process's raw metric values — the assembly half of
        ``/metrics``, also served as JSON on the fleet-internal
        ``/-/stats`` route so peer acceptors can merge without parsing
        Prometheus text back apart."""
        with self._counter_lock:
            values = dict(self._counters)
        values["serve_uptime_s"] = time.monotonic() - self._clock0
        if self.hot is not None:
            for k, v in self.hot.stats_dict().items():
                values[f"serve_{k}"] = v
        for k, v in self.admission.stats_dict().items():
            values[f"serve_admission_{k}"] = v
        for k, v in self.jobs.stats_dict().items():
            values[f"serve_{k}"] = v
        for k, v in self.registry.stats_dict().items():
            values[f"serve_registry_{k}"] = v
        for k, v in self.worker.stats_dict().items():
            values[f"serve_{k}"] = v
        if self.supervisor is not None:
            for k, v in self.supervisor.stats_dict().items():
                values[f"serve_{k}"] = v
        # compile-cache effectiveness — only when the durable compiled
        # tier is mounted (the faults_* discipline on /metrics too)
        from tpusim_torch.fastpath.store import get_compile_store

        if get_compile_store() is not None:
            from tpusim_torch.perf.cache import compiled_cache_stats

            for k, v in compiled_cache_stats().items():
                values[f"fastpath_{k}"] = v
        # tpusim_torch.guard gauges — only when guard features are active
        # (quota / watchdog / startup sweep), mirroring the report-key
        # discipline: an un-governed daemon's scrape is unchanged
        if (
            self.result_cache.quota_bytes is not None
            or self.result_cache.quota_entries is not None
        ):
            for k, v in self.result_cache.guard_stats_dict().items():
                values[f"guard_{k}"] = v
        if self.watchdog is not None:
            for k, v in self.watchdog.stats_dict().items():
                values[f"guard_{k}"] = v
        for k, v in self._guard_startup.items():
            values[f"guard_{k}"] = v
        # request-trace histograms + recorder counters — ONLY when
        # tracing is active (the guard_* discipline on /metrics: a
        # tracing-off daemon's scrape and /-/stats are key-identical)
        if self.reqtrace is not None:
            values.update(self.reqtrace.metrics_values())
        # cluster membership counters — registry-only (the single
        # epoch writer is also their single stats writer); a
        # never-clustered daemon's scrape stays key-identical
        if self.cluster is not None:
            values.update(self.cluster.stats_dict())
        return values

    @staticmethod
    def _render_metrics(values: dict[str, float]) -> str:
        from tpusim_torch.obs.export import prometheus_text
        from tpusim_torch.obs.reqtrace import histogram_exposition

        # split the (possibly fleet-merged) latency-histogram state out
        # first: its keys render as real histogram-typed series, and
        # everything else stays on the hardened gauge/counter path
        rest, hist_lines = histogram_exposition(values)
        text = prometheus_text(
            rest,
            help_text={
                "serve_requests_total": "HTTP requests received",
                "serve_uptime_s": "seconds since daemon start",
            },
        )
        if hist_lines:
            text += "\n".join(hist_lines) + "\n"
        return text

    def metrics_text(self) -> str:
        """The ``/metrics`` document — every serve counter plus the
        admission/job/registry/cache gauges, in Prometheus exposition
        format via the hardened :func:`~tpusim_torch.obs.export.
        prometheus_text`."""
        return self._render_metrics(self.metrics_values())

    # -- fleet views ----------------------------------------------------------

    def set_peers(
        self, peers: dict[int, int], primary_direct: int | None,
    ) -> None:
        """Membership push from the front supervisor: acceptor index →
        direct port, plus the primary's direct port (job proxy target)."""
        with self._peer_lock:
            self._peers = {int(k): int(v) for k, v in peers.items()}
            self.primary_direct = primary_direct

    def _peer_ports(self) -> list[tuple[int, int]]:
        with self._peer_lock:
            return sorted(
                (i, p) for i, p in self._peers.items()
                if i != self.acceptor_index
            )

    def _fetch_peer_json(self, port: int, path: str) -> dict | None:
        import http.client
        import json as _json

        try:
            # sub-second timeout: a health probe must not stack peer
            # waits past a balancer's own check timeout
            conn = http.client.HTTPConnection(self.host, port, timeout=0.8)
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
            conn.close()
            if resp.status != 200:
                return None
            return _json.loads(payload)
        except (OSError, ValueError, http.client.HTTPException):
            return None

    def _fetch_peers_json(self, path: str) -> dict[int, dict | None]:
        """All peers' ``path`` docs, fetched CONCURRENTLY — N-1
        sequential timeouts against down peers would turn a partial
        outage into a failed health check on the healthy acceptors."""
        peers = self._peer_ports()
        results: dict[int, dict | None] = {}
        if not peers:
            return results

        def fetch(idx, port):
            results[idx] = self._fetch_peer_json(port, path)

        threads = [
            threading.Thread(target=fetch, args=(i, p), daemon=True)
            for i, p in peers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2.0)
        return {i: results.get(i) for i, _p in peers}

    #: fleet-merge keys that describe ONE shared resource (the hot
    #: store every acceptor mounts): summing N identical views would
    #: report N× the real state, so these take the max instead
    _FLEET_MAX_KEYS = frozenset({
        "serve_uptime_s", "serve_hot_entries", "serve_hot_segment_bytes",
    })

    @classmethod
    def _merge_values(cls, merged: dict, vals: dict) -> None:
        """Fold one peer's raw values into ``merged`` — counters sum,
        the shared-resource gauges take the max."""
        for k, v in vals.items():
            if not isinstance(v, (int, float)):
                continue
            if k in cls._FLEET_MAX_KEYS:
                merged[k] = max(merged.get(k, 0.0), v)
            else:
                merged[k] = merged.get(k, 0.0) + v

    def _merged_acceptor_values(self) -> tuple[dict, int]:
        """This NODE's values: local plus every live peer acceptor's,
        merged.  Returns ``(values, acceptors_alive)``."""
        merged = self.metrics_values()
        alive = 1
        for _idx, doc in self._fetch_peers_json("/-/stats").items():
            vals = (doc or {}).get("values")
            if not isinstance(vals, dict):
                continue
            alive += 1
            self._merge_values(merged, vals)
        return merged, alive

    def fleet_metrics_text(self) -> str:
        """One fleet view: every live acceptor's values merged —
        counters/gauges sum (an N-acceptor fleet's inflight capacity IS
        the sum of its admission bounds), while uptime and the shared
        hot-store gauges take the max, and ``serve_acceptors_alive`` /
        ``_configured`` describe the fleet."""
        merged, alive = self._merged_acceptor_values()
        merged["serve_acceptors_alive"] = alive
        merged["serve_acceptors_configured"] = self.acceptors_total
        return self._render_metrics(merged)

    def local_healthz(self) -> dict:
        doc = {
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._clock0, 3),
            **{f"admission_{k}": v
               for k, v in self.admission.stats_dict().items()},
        }
        if self.in_fleet:
            import os as _os

            doc["acceptor_index"] = self.acceptor_index
            doc["pid"] = _os.getpid()
            doc["direct_port"] = self.direct_port
            doc["primary"] = self.is_primary
        sup = self.supervisor
        if sup is not None:
            alive = sup.alive_count()
            # degraded is a STATE, not an outage: the daemon still
            # answers (shedding), so /healthz stays 200 and balancers
            # read the field, not the status code
            if alive < sup.min_live:
                doc["status"] = "degraded"
            doc["workers_alive"] = alive
            doc["workers_configured"] = sup.num_workers
            doc["workers"] = sup.worker_docs()
        return doc

    def fleet_healthz(self) -> dict:
        """The merged ``/healthz``: this acceptor's local doc plus every
        peer's (over their direct listeners), with one fleet verdict —
        ``ok`` only when every configured acceptor answered ok."""
        local = self.local_healthz()
        acceptors = [local]
        alive = 1
        status = local["status"]
        ports = dict(self._peer_ports())
        for idx, peer in self._fetch_peers_json(
            "/healthz?scope=local"
        ).items():
            if peer is None:
                acceptors.append({
                    "acceptor_index": idx, "status": "unreachable",
                    "direct_port": ports.get(idx),
                })
                status = "degraded"
                continue
            alive += 1
            acceptors.append(peer)
            if peer.get("status") != "ok":
                status = "degraded"
        if self.acceptors_total and alive < self.acceptors_total:
            status = "degraded"
        return {
            "status": status,
            "acceptors_alive": alive,
            "acceptors_configured": self.acceptors_total,
            "acceptors": sorted(
                acceptors, key=lambda a: a.get("acceptor_index", -1)
            ),
        }

    # -- multi-node cluster (tpusim_torch.serve.cluster) ---------------------------

    @property
    def node_id(self) -> str:
        """Cluster identity of this node: its public address.  Stable
        across acceptor restarts (the fleet shares one public port) and
        unique per box+port, which is all membership needs."""
        return f"{self.host}:{self.port}"

    def cluster_active(self) -> bool:
        """True once this daemon is part of a cluster — as the lazy
        primary (registry materialized) or as a joined member (a
        gossiped view arrived)."""
        return self.cluster is not None or self._cluster_view is not None

    def cluster_view_doc(self) -> dict | None:
        """The current membership view: authoritative on the primary,
        the latest gossiped copy on a member, None unclustered."""
        if self.cluster is not None:
            return self.cluster.view()
        return self._cluster_view

    def _on_cluster_view(self, view: dict) -> None:
        self._cluster_view = view

    def ensure_cluster_registry(self):
        """Materialize the primary-side registry on first join (None on
        a member — it can never own the epoch).  Lazy on purpose: a
        daemon nobody joins runs the exact single-node code paths and
        mints zero cluster stats keys."""
        if self.cluster_join is not None:
            return None
        with self._cluster_lock:
            if self.cluster is None:
                from tpusim_torch.serve.cluster import ClusterRegistry

                self.cluster = ClusterRegistry(
                    self.node_id, self.url,
                    beat_interval_s=self.cluster_beat_s,
                    missed_beats=self.cluster_missed_beats,
                )
                self.cluster_node_id = self.node_id
                if self.reqtrace is not None:
                    self.reqtrace.node_id = self.node_id
                self._reaper = threading.Thread(
                    target=self._reap_loop,
                    name="tpusim-cluster-reap", daemon=True,
                )
                self._reaper.start()
            return self.cluster

    def _reap_loop(self) -> None:
        while not self._stop_cluster.wait(self.cluster_beat_s):
            reg = self.cluster
            if reg is None:
                return
            died = reg.reap()
            if died and self.verbose:
                print(
                    f"tpusim_torch serve: cluster marked dead: "
                    f"{', '.join(died)} (epoch {reg.epoch})"
                )

    def _watchdog_shedding(self) -> bool:
        return self.watchdog is not None and self.watchdog.shedding

    def cluster_shed(self) -> bool:
        """Node-grain load shed: with the alive-node count below the
        configured floor, queueing more work onto the survivors only
        converts overload into timeouts — answer 503 + Retry-After and
        let the balancer back off until the fleet heals."""
        if self.cluster_min_nodes <= 1:
            return False
        view = self.cluster_view_doc()
        if view is None:
            return False
        return len(alive_members(view)) < self.cluster_min_nodes

    def cluster_owner_url(self, endpoint: str, body: dict) -> str | None:
        """Where a simulate/lint request's affinity key lives: the
        owning node's public URL, or None when this node should serve
        it (owner == self, ring too small, or no cluster).  The key is
        the supervisor's volatile-stripped affinity hash, so cache
        identity is node-invariant by construction."""
        view = self.cluster_view_doc()
        if view is None:
            return None
        ring = ring_for(view)
        if len(ring) < 2:
            return None
        owner = ring.owner(Supervisor.affinity_key(endpoint, body))
        if owner is None or owner == self.node_id:
            return None
        return member_url(view, owner)

    def _fetch_node_json(self, url: str, path: str) -> dict | None:
        """GET a peer NODE's ``path`` (public URL; the acceptor-grain
        twin is :meth:`_fetch_peer_json` over direct ports)."""
        import http.client
        from urllib.parse import urlsplit

        try:
            u = urlsplit(url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=0.8,
            )
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
            conn.close()
            if resp.status != 200:
                return None
            return json.loads(payload)
        except (OSError, ValueError, http.client.HTTPException):
            return None

    def node_stats_values(self) -> dict[str, float]:
        """This NODE's raw metric values — acceptor-fleet-merged in
        front mode, plain local otherwise.  Served on the
        cluster-internal ``/v1/cluster/stats`` route so peers merge
        node-grain numbers, never double-counting acceptors."""
        if self.in_fleet:
            merged, _alive = self._merged_acceptor_values()
            return merged
        return self.metrics_values()

    def cluster_metrics_text(self) -> str:
        """Node-grain ``/metrics``: every alive member's node-local
        values merged (counters sum, shared-resource gauges max), plus
        ``serve_nodes_alive`` / ``serve_nodes_configured``.  The
        registry's own counters ride in via the primary's values —
        exactly one writer per key across the whole cluster."""
        view = self.cluster_view_doc() or {}
        members = [
            m for m in view.get("members", ()) if isinstance(m, dict)
        ]
        merged = self.node_stats_values()
        alive = 1
        for m in members:
            if not m.get("alive") or m.get("node_id") == self.node_id:
                continue
            doc = self._fetch_node_json(
                str(m.get("url")), "/v1/cluster/stats",
            )
            vals = (doc or {}).get("values")
            if not isinstance(vals, dict):
                continue
            alive += 1
            self._merge_values(merged, vals)
        merged["serve_nodes_alive"] = alive
        merged["serve_nodes_configured"] = max(len(members), 1)
        return self._render_metrics(merged)

    def cluster_healthz(self) -> dict:
        """The node-grain ``/healthz``: the local (or acceptor-merged)
        doc plus a cluster section; ``degraded`` while any configured
        member is dead."""
        doc = (
            self.fleet_healthz() if self.in_fleet
            else self.local_healthz()
        )
        view = self.cluster_view_doc() or {}
        members = [
            m for m in view.get("members", ()) if isinstance(m, dict)
        ]
        alive = sum(1 for m in members if m.get("alive"))
        doc["cluster"] = {
            "epoch": view.get("epoch"),
            "node_id": self.node_id,
            "primary": self.cluster is not None,
            "nodes_alive": alive,
            "nodes_configured": len(members),
        }
        if alive < len(members):
            doc["status"] = "degraded"
        return doc

    # -- hot-response tier ----------------------------------------------------

    def fleet_traces_doc(self, local_docs: list, limit: int = 50) -> list:
        """Fleet-merged slow-trace summaries: this acceptor's plus every
        peer's local list, re-sorted slowest first.  Any acceptor can
        answer ``GET /v1/debug/traces`` for the whole fleet."""
        docs = list(local_docs)
        for _idx, doc in self._fetch_peers_json(
            "/v1/debug/traces?scope=local"
        ).items():
            peer_traces = (doc or {}).get("traces")
            if isinstance(peer_traces, list):
                docs.extend(
                    t for t in peer_traces if isinstance(t, dict)
                )
        docs.sort(key=lambda t: t.get("total_ms", 0.0), reverse=True)
        return docs[: max(int(limit), 0)]

    def fleet_trace_get(self, trace_id: str) -> dict | None:
        """By-ID fleet fallback: ask every peer's local recorder for a
        trace this acceptor never saw (requests balance across
        acceptors, so the slowest trace rarely lives where the debug
        query lands)."""
        from tpusim_torch.obs.reqtrace import valid_trace_id

        if not valid_trace_id(trace_id):
            return None
        for _idx, doc in self._fetch_peers_json(
            f"/v1/debug/traces/{trace_id}?scope=local"
        ).items():
            trace = (doc or {}).get("trace")
            if isinstance(trace, dict):
                return trace
        return None

    def _trace_fingerprint(self, name: str) -> str | None:
        """A cheap stat fingerprint of one named trace directory
        (file names + sizes + mtimes), cached per name.  Joins the hot
        key so a hot dir surviving a daemon restart can never serve
        bytes priced from different on-disk trace content."""
        with self._trace_fp_lock:
            fp = self._trace_fp_cache.get(name)
        if fp is not None:
            return fp
        root = self.registry.trace_root
        if root is None:
            return None
        path = root / name
        if not path.is_dir():
            return None
        import hashlib

        parts = []
        try:
            for p in sorted(path.rglob("*")):
                if p.is_file():
                    st = p.stat()
                    parts.append(
                        f"{p.relative_to(path)}:{st.st_size}:"
                        f"{st.st_mtime_ns}"
                    )
        except OSError:
            return None
        fp = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
        with self._trace_fp_lock:
            self._trace_fp_cache[name] = fp
        return fp

    def hot_key_for(self, endpoint: str, body: dict) -> str | None:
        """The hot-cache identity of one request, or None when the
        request is not hot-servable (no hot tier, or a named trace we
        cannot fingerprint).  Built on the supervisor's affinity hash —
        the same volatile-key stripping, so deadlines never fragment
        the hot tier."""
        if self.hot is None or not isinstance(body, dict):
            return None
        from tpusim_torch.serve.supervisor import Supervisor

        key = Supervisor.affinity_key(endpoint, body)
        trace = body.get("trace")
        if trace is not None:
            fp = self._trace_fingerprint(str(trace))
            if fp is None:
                return None  # unknown trace: let the 404 path answer
            key = f"{key}-{fp}"
        return key

    def hot_publish(self, hot_key: str, result) -> None:
        """Publish one successful simulate response in WARM form: the
        exact bytes a repeat (result-cache-hit) request would produce —
        ``cache_hit`` true, the per-request cache accounting folded to
        its steady state (every get that missed cold hits on replay).
        First writer wins across acceptors; all produced byte-identical
        pricing by the serving contract."""
        import json as _json

        try:
            if isinstance(result, (bytes, bytearray, memoryview)):
                doc = _json.loads(bytes(result))
            else:
                doc = {
                    "format_version": SERVE_FORMAT_VERSION,
                    "model_version": self.worker.model_version,
                    **result,
                }
            if not doc.get("cache_hit", False):
                doc = dict(doc)
                doc["cache_hit"] = True
                stats = doc.get("stats")
                if isinstance(stats, dict) and "cache_misses" in stats:
                    # fold the per-request accounting to its warm form,
                    # PRESERVING numeric types — an int 0 and a float
                    # 0.0 serialize differently, and these bytes must
                    # equal a real warm response's exactly
                    stats = dict(stats)
                    misses = stats["cache_misses"]
                    stats["cache_hits"] = (
                        stats.get("cache_hits", 0) + misses
                    )
                    stats["cache_misses"] = type(misses)(0)
                    doc["stats"] = stats
            body = _json.dumps(doc, sort_keys=True).encode() + b"\n"
            # publishes ride /metrics from the hot store's own counter
            self.hot.publish(hot_key, body)
        except (OSError, ValueError, TypeError):
            self._count("serve_hot_publish_errors_total")

    # -- sync dispatch -------------------------------------------------------

    def execute_sync(self, endpoint: str, fn, body: dict, deadline: float,
                     reqtrace=None):
        """One admitted synchronous request: through the supervised
        worker pool when mounted (crash isolation, cooperative deadline
        cancel with kill escalation, quarantine — the supervised path),
        else the in-process worker (``fn``) pricing under a
        :class:`~tpusim_torch.guard.CancelToken` armed with the same deadline.
        Responses are byte-identical either way.  ``reqtrace`` collects
        the worker-side tier spans (both paths time over the shared
        monotonic clock, so they merge without alignment)."""
        if self.supervisor is not None:
            return self.supervisor.execute(
                endpoint, body, deadline=deadline, reqtrace=reqtrace,
            )
        cancel = CancelToken(deadline=deadline)
        if reqtrace is None:
            return fn(body, cancel=cancel)
        spans: list = []
        try:
            result = fn(body, cancel=cancel, spans=spans)
        finally:
            reqtrace.add_worker_spans(spans)
        if isinstance(result, dict) and "cache_hit" in result:
            reqtrace.meta["tier"] = (
                "warm" if result.get("cache_hit") else "priced"
            )
        return result

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._requested_port
        return self._httpd.server_address[1]

    @property
    def direct_port(self) -> int | None:
        """The fleet-internal listener's port (None when this
        daemon is not an acceptor)."""
        if self._direct_httpd is None:
            return None
        return self._direct_httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def inject_connection(self, sock, addr, accepted_s=None) -> None:
        """Dispatch one already-accepted connection into this daemon's
        HTTP stack — the fd-passing fallback path on kernels without
        ``SO_REUSEPORT`` (the front parent accepts and ships the fd via
        ``socket.send_fds``; this acceptor parses and serves it).
        ``accepted_s`` is the front parent's monotonic accept timestamp
        (shared clock): when tracing is on, the first request on this
        connection gets an ``fd_dispatch`` span covering the handoff."""
        if self.reqtrace is not None and accepted_s is not None:
            self._note_accepted(sock, float(accepted_s))
        server = self._direct_httpd or self._httpd
        server.process_request(sock, addr)

    def _note_accepted(self, sock, accepted_s: float) -> None:
        with self._accept_lock:
            if len(self._accept_ts) > 1024:
                # connections that never issued a request would leak
                # their stamps; a full map means exactly that — reset
                self._accept_ts.clear()
            self._accept_ts[id(sock)] = (accepted_s, time.monotonic())

    def pop_accept_ts(self, sock) -> tuple[float, float] | None:
        """Claim (once) the fd-passing accept/handoff timestamps for a
        handler's connection; None on the reuseport/direct path."""
        if not self._accept_ts:
            return None
        with self._accept_lock:
            return self._accept_ts.pop(id(sock), None)

    def start(self) -> "ServeDaemon":
        """Bind the listener and start serving on background threads.
        Returns self (so tests can ``ServeDaemon(...).start()``)."""
        _prewarm_pricing_stack()
        sweep_dirs = []
        if self.result_cache.disk_dir is not None \
                and self.result_cache.disk_dir.is_dir():
            sweep_dirs.append(self.result_cache.disk_dir)
        if self.compile_store is not None \
                and self.compile_store.disk_dir.is_dir() \
                and self.compile_store.disk_dir not in sweep_dirs:
            # a compiled tier mounted at its own dir gets the same boot
            # sweep (verify_store is tier-aware; a shared dir is swept
            # once and covers both record kinds)
            sweep_dirs.append(self.compile_store.disk_dir)
        for sweep_dir in sweep_dirs:
            # startup integrity sweep (tpusim_torch.guard): quarantine corrupt
            # or stale-format records BEFORE the first request can trip
            # over them — a crashed peer's damage heals at boot, not one
            # warning at a time under traffic
            from tpusim_torch.guard.store import verify_store

            res = verify_store(sweep_dir)
            # accumulate: a daemon may sweep the result dir AND a
            # separately-mounted compiled dir
            for key, add in (
                ("startup_records_checked", res.checked),
                ("startup_records_ok", res.ok),
                ("startup_quarantined",
                 res.quarantined_corrupt + res.quarantined_stale_format),
                ("startup_stale_model", res.stale_model),
            ):
                self._guard_startup[key] = (
                    self._guard_startup.get(key, 0) + add
                )
            if self.verbose and (
                res.quarantined_corrupt or res.quarantined_stale_format
            ):
                print(
                    f"tpusim_torch serve: startup sweep quarantined "
                    f"{res.quarantined_corrupt} corrupt + "
                    f"{res.quarantined_stale_format} stale-format "
                    f"cache record(s)"
                )
        if self.watchdog is not None:
            self.watchdog.start()
        import os as _os

        for fd in self._close_fds:
            # fds inherited from a front supervisor (its port-reserve
            # socket, siblings' pipe ends): close them so a dead parent
            # releases its resources regardless of acceptor lifetimes
            try:
                _os.close(int(fd))
            except (OSError, ValueError, TypeError):
                pass
        handler = type(
            "BoundHandler", (_Handler,), {"daemon_obj": self},
        )

        class _Server(ThreadingHTTPServer):
            # most clients (urllib included) open a fresh connection
            # per request; the stdlib backlog of 5 overflows under any
            # real concurrency and SYN retransmits (~1s) then dwarf the
            # service time
            request_queue_size = 128

        class _ReusePortServer(_Server):
            # N acceptor processes each bind their own
            # listening socket on the SAME port; the kernel distributes
            # incoming connections across the reuseport group — no
            # single process ever parses every request
            def server_bind(self):
                import socket as _socket

                self.socket.setsockopt(
                    _socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1,
                )
                super().server_bind()

        self._httpd = None
        if self.public_listener:
            server_cls = _ReusePortServer if self.reuse_port else _Server
            self._httpd = server_cls(
                (self.host, self._requested_port), handler,
            )
            self._httpd.daemon_threads = True
        self._direct_httpd = None
        if self.in_fleet:
            # the fleet-internal listener: peer /-/stats merges, job
            # proxying to the primary, and (fd-passing fallback mode)
            # the server object injected connections dispatch through
            self._direct_httpd = _Server((self.host, 0), handler)
            self._direct_httpd.daemon_threads = True
        if self.supervisor is not None:
            # forked workers inherit the freshly-bound listeners; they
            # close them first thing (the fds travel via settings) so a
            # dead daemon's port is never held open by its workers
            self.supervisor.settings["inherited_fds"] = [
                s.fileno() for s in (self._httpd, self._direct_httpd)
                if s is not None
            ] + [int(f) for f in self._worker_close_fds]
            self.supervisor.start()
        if self._httpd is not None:
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="tpusim-serve-accept", daemon=True,
            )
            self._serve_thread.start()
        if self._direct_httpd is not None:
            self._direct_thread = threading.Thread(
                target=self._direct_httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="tpusim-serve-direct", daemon=True,
            )
            self._direct_thread.start()
        if self.cluster_join is not None:
            from tpusim_torch.serve.cluster import HeartbeatLoop

            # a --join member is clustered from boot; started here
            # because node_id needs the BOUND public port
            self.cluster_node_id = self.node_id
            if self.reqtrace is not None:
                self.reqtrace.node_id = self.node_id
            self._heartbeat = HeartbeatLoop(
                node_id=self.node_id, url=self.url,
                join_addr=self.cluster_join,
                interval_s=self.cluster_beat_s,
                on_view=self._on_cluster_view,
                shedding=self._watchdog_shedding,
            ).start()
        for i in range(self._job_workers):
            t = threading.Thread(
                target=self._job_loop, name=f"tpusim-serve-job-{i}",
                daemon=True,
            )
            t.start()
            self._job_threads.append(t)
        return self

    def campaign_dir(self, job_id: str):
        """Where one campaign job journals (None without --state-dir:
        the job still runs, it just cannot survive a crash)."""
        if self.state_dir is None:
            return None
        return self.state_dir / "campaigns" / job_id

    def fleet_dir(self, job_id: str):
        """Where one fleet job journals — the campaign discipline
        under its own subtree."""
        if self.state_dir is None:
            return None
        return self.state_dir / "fleet" / job_id

    def _evict_job_state(self, job_id: str) -> None:
        import shutil

        for d in (self.campaign_dir(job_id), self.fleet_dir(job_id)):
            if d is not None and d.is_dir():
                shutil.rmtree(d, ignore_errors=True)

    def _run_job(self, job) -> dict:
        if job.kind == "campaign":
            return self.worker.campaign(
                job.request, out_dir=self.campaign_dir(job.job_id),
                cancel=job.cancel_token,
            )
        if job.kind == "fleet":
            return self.worker.fleet(
                job.request, out_dir=self.fleet_dir(job.job_id),
                cancel=job.cancel_token,
            )
        if job.kind == "advise":
            # no journal: an advise sweep is cache-warm cheap, so a
            # recovered job simply re-prices (byte-identical by the
            # determinism contract)
            return self.worker.advise(job.request, cancel=job.cancel_token)
        return self.worker.sweep(job.request, cancel=job.cancel_token)

    def _job_loop(self) -> None:
        while True:
            job = self.jobs.next_job(timeout_s=0.2)
            if job is None:
                if self._stop_jobs.is_set():
                    return
                continue
            try:
                result = self._run_job(job)
            except OperationCancelled as e:
                # DELETE /v1/jobs/<id> landed mid-run: the runner
                # unwound at a scenario/cell boundary with completed
                # work journaled — terminal 'cancelled', not 'failed'
                self.jobs.finish(
                    job, None, f"cancelled: {e}", status="cancelled",
                )
                self._count("serve_jobs_cancelled_total")
            except RequestError as e:
                self.jobs.finish(job, None, f"{e.code}: {e.detail}")
                self._count("serve_jobs_failed_total")
            except Exception as e:  # noqa: BLE001 - job boundary
                self.jobs.finish(job, None, f"{type(e).__name__}: {e}")
                self._count("serve_jobs_failed_total")
            else:
                self.jobs.finish(job, result, None)
                self._count("serve_jobs_done_total")

    def drain_and_stop(self) -> bool:
        """The SIGTERM sequence: stop admitting, finish in-flight work
        and accepted jobs, flush the disk cache, close the listener.
        Returns True when everything drained inside the grace period."""
        self._stop_cluster.set()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        self.admission.start_drain()
        self.jobs.start_drain()
        clean = self.admission.wait_idle(self.drain_grace_s)
        clean = self.jobs.wait_idle(self.drain_grace_s) and clean
        self._stop_jobs.set()
        for t in self._job_threads:
            t.join(timeout=2.0)
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        flushed = self.result_cache.flush()
        if self.verbose and flushed:
            print(f"tpusim_torch serve: drain flushed {flushed} cache records")
        for srv in (self._httpd, self._direct_httpd):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        if self.access_log is not None:
            self.access_log.close()
        self._stopped.set()
        return clean

    def abort(self) -> None:
        """Stop WITHOUT draining — the crash-simulation path (tests,
        emergency teardown): listener closed, job threads told to stop,
        queued/running jobs left exactly as persisted so a fresh daemon
        on the same ``state_dir`` recovers them."""
        self._stop_cluster.set()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        self._stop_jobs.set()
        for t in self._job_threads:
            t.join(timeout=2.0)
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.supervisor is not None:
            # crash simulation still reaps the fleet: orphan workers
            # would hold the (inherited) state the next daemon needs
            self.supervisor.stop(grace_s=0.2)
        for srv in (self._httpd, self._direct_httpd):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        if self.access_log is not None:
            self.access_log.close()
        self._stopped.set()

    def wait_stopped(self, timeout_s: float | None = None) -> bool:
        return self._stopped.wait(timeout_s)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → drain on a helper thread (the handler runs
        on the main thread, which may be blocked in ``wait_stopped``;
        ``shutdown()`` must never be called from the accept loop)."""

        def _on_signal(signum, frame):
            threading.Thread(
                target=self.drain_and_stop,
                name="tpusim-serve-drain", daemon=True,
            ).start()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    # -- context manager (tests) ---------------------------------------------

    def __enter__(self) -> "ServeDaemon":
        return self.start()

    def __exit__(self, *exc) -> bool:
        if not self._stopped.is_set():
            self.drain_and_stop()
        return False

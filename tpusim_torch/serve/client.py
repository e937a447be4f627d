"""Typed client for the :mod:`tpusim_torch.serve` API — stdlib only
(port of ``tpusim/serve/client.py``).

The programmatic counterpart of the curl examples in the README: one
method per route, JSON in/out, server errors surfaced as
:class:`ServeError` carrying the status, the stable error code, and the
diagnostics document when the server attached one (the 400 validation
path).  Used by ``chip_smoke.py``'s serving phase and
``tests/test_torch_serve.py`` — the client IS the contract test surface.

Transport: one persistent keep-alive connection per (client, thread)
over :mod:`http.client`, reconnecting transparently when the server
closed it.  A warm request prices in ~1ms server-side; paying a fresh
TCP handshake + connection teardown per call (urllib's behavior) would
cost more than the service itself.

Robustness: every call carries a socket timeout (the
constructor default, overridable per call via ``timeout_s=``) so a
stalled daemon can never block the client forever, and **safe**
failures — an idempotent GET, or a POST whose bytes never finished
sending — retry with exponential backoff plus deterministic jitter.  A
non-idempotent POST that finished sending is never replayed: the server
may have executed it, and a re-sent ``/v1/sweep`` would enqueue a
duplicate job.

The safe set extends to **idempotent POSTs**: ``/v1/simulate``
and ``/v1/lint`` are pure functions of their body (pricing mutates
nothing), so a connection reset by a recycled acceptor — the multi-
acceptor front SIGKILLs and respawns acceptors under chaos — retries
them transparently on a fresh connection, which the kernel routes to a
surviving acceptor.  ``DELETE /v1/jobs/<id>`` (cancel) is idempotent by
contract (cancelling twice changes nothing) and retries too.  Job
SUBMISSIONS stay never-replayed.
"""

from __future__ import annotations

import hashlib
import http.client
import itertools
import json
import os
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

from tpusim_torch.obs.reqtrace import TRACE_HEADER

__all__ = ["JobStatus", "LintReport", "ServeClient", "ServeError", "SimResult"]


class ServeError(RuntimeError):
    """A non-2xx response from the daemon."""

    def __init__(
        self, status: int, code: str, detail: str,
        doc: dict | None = None, retry_after_s: float | None = None,
    ):
        self.status = int(status)
        self.code = code
        self.detail = detail
        self.doc = doc or {}
        self.retry_after_s = retry_after_s
        super().__init__(f"HTTP {status} {code}: {detail}")

    @property
    def diagnostics(self) -> list[dict]:
        """The TLxxx items of a validation refusal ([] otherwise)."""
        return list(
            (self.doc.get("diagnostics") or {}).get("diagnostics", [])
        )


@dataclass
class SimResult:
    """``POST /v1/simulate`` response."""

    stats: dict
    cache_hit: bool
    trace: str
    arch: str
    num_devices: int
    sim_cycles: float
    model_version: str
    format_version: int


@dataclass
class LintReport:
    """``POST /v1/lint`` response."""

    summary: str
    errors: int
    warnings: int
    diagnostics: dict
    model_version: str

    @property
    def codes(self) -> list[str]:
        return sorted({
            d["code"] for d in self.diagnostics.get("diagnostics", [])
        })


@dataclass
class JobStatus:
    """``GET /v1/jobs/<id>`` response."""

    job_id: str
    status: str        # queued | running | done | failed | cancelled
    result: dict | None = None
    error: str | None = None
    raw: dict = field(default_factory=dict)

    @property
    def terminal(self) -> bool:
        return self.status in ("done", "failed", "cancelled")


#: per-process client counter — the instance half of the jitter salt
_CLIENT_SEQ = itertools.count()


class ServeClient:
    """One daemon endpoint; every method is a single HTTP round trip."""

    def __init__(
        self,
        base_url: str,
        timeout_s: float = 120.0,
        retries: int = 1,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        honor_retry_after: bool = False,
        retry_after_max_s: float = 30.0,
        members: list[str] | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        #: extra attempts for SAFE failures (idempotent GETs and POSTs
        #: whose bytes never finished sending); 0 disables retrying
        self.retries = max(int(retries), 0)
        self.backoff_base_s = max(float(backoff_base_s), 0.0)
        self.backoff_max_s = max(float(backoff_max_s), self.backoff_base_s)
        #: opt-in: honor ``Retry-After`` on 429/503 RESPONSES by
        #: sleeping and re-issuing, up to the same ``retries`` budget.
        #: Safe even for job submissions — a clean 429/503 means the
        #: server REFUSED the request, so re-sending is not a replay
        #: (unlike a transport failure after the bytes left, which
        #: stays never-replayed); timeouts are likewise never retried.
        self.honor_retry_after = bool(honor_retry_after)
        #: ceiling on one honored wait — a server advertising a
        #: pathological hint must not park the client for minutes
        self.retry_after_max_s = max(float(retry_after_max_s), 0.0)
        parsed = urllib.parse.urlsplit(self.base_url)
        if parsed.scheme != "http" or parsed.hostname is None:
            raise ValueError(
                f"base_url must be http://host:port, got {base_url!r}"
            )
        self._host = parsed.hostname
        self._port = parsed.port or 80
        #: cluster failover: additional known members, tried
        #: in rotation when the active endpoint refuses or resets a
        #: SAFE request (idempotent, or bytes never finished sending).
        #: The never-replay rules are untouched: a submission that
        #: finished sending, or ANY timeout, never moves to another
        #: node — failover only re-issues what plain retry already
        #: could, just somewhere the connection still opens.
        addrs = [(self._host, self._port)]
        for url in members or []:
            p = urllib.parse.urlsplit(url.rstrip("/"))
            if p.scheme != "http" or p.hostname is None:
                raise ValueError(
                    f"members must be http://host:port, got {url!r}"
                )
            pair = (p.hostname, p.port or 80)
            if pair not in addrs:
                addrs.append(pair)
        self._addrs = addrs
        self._active = 0
        self._local = threading.local()
        # (pid, construction order) — distinct per client instance and
        # per process, yet stable for a given run's construction order,
        # so retry timing stays reproducible within one test run
        self._jitter_salt = f"{os.getpid()}:{next(_CLIENT_SEQ)}"

    # -- transport -----------------------------------------------------------

    def _conn(
        self, fresh: bool = False, timeout_s: float | None = None,
    ) -> http.client.HTTPConnection:
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        host, port = self._addrs[self._active]
        conn = getattr(self._local, "conn", None)
        if conn is not None and (conn.host, conn.port) != (host, port):
            # another thread's failover moved the active member since
            # this thread cached its connection — follow it
            conn.close()
            conn = None
        if conn is None or fresh:
            if conn is not None:
                conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=t)
            self._local.conn = conn
        elif conn.timeout != t:
            # per-call override on a warm keep-alive connection: the
            # timeout lives on the live socket, not just the factory
            conn.timeout = t
            if conn.sock is not None:
                conn.sock.settimeout(t)
        return conn

    def _backoff_s(self, attempt: int, path: str) -> float:
        """Exponential backoff with deterministic jitter (±25%, derived
        from the client instance + call identity: N identical clients
        retrying the same failed path each land on a DIFFERENT sleep —
        the herd de-synchronizes — while any one client's schedule is
        stable within a run)."""
        base = min(
            self.backoff_base_s * (2.0 ** attempt), self.backoff_max_s,
        )
        h = hashlib.sha256(
            f"{self._jitter_salt}:{path}:{attempt}".encode()
        ).digest()
        return base * (0.75 + 0.5 * int.from_bytes(h[:4], "big") / 0xFFFFFFFF)

    def _raw(
        self, method: str, path: str, body: dict | None = None,
        timeout_s: float | None = None, idempotent: bool = False,
    ):
        data = None
        headers = {"Accept": "application/json"}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        attempt = 0
        fresh = False
        # a REUSED keep-alive socket the server closed between calls is
        # a transport artifact, not a failing server: safe requests get
        # ONE immediate reconnect that neither counts against the retry
        # policy (retries=0 must still survive idle-closed connections,
        # as a plain keep-alive client does) nor sleeps (a backoff here would
        # tax every request after any idle gap)
        stale_budget = 1
        # one free immediate hop per OTHER known member: a dead node's
        # refused connection must not burn the caller's retry budget
        # just to reach a survivor (retries=0 still fails over)
        failover_budget = len(self._addrs) - 1
        while True:
            was_cached = getattr(self._local, "conn", None) is not None
            conn = self._conn(fresh=fresh, timeout_s=timeout_s)
            sent = False
            try:
                conn.request(method, path, body=data, headers=headers)
                sent = True
                resp = conn.getresponse()
                payload = resp.read()
                # request tracing (off by default server-side): remember
                # the last trace id this thread's requests were assigned
                # so callers can fetch the span tree afterwards
                tid = resp.getheader(TRACE_HEADER)
                if tid:
                    self._local.last_trace_id = tid
                return resp, payload
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, TimeoutError) as e:
                # the server may close an idle keep-alive connection
                # between calls, a daemon may be mid-restart, a stalled
                # one times out.  A non-idempotent request that FINISHED
                # SENDING is never replayed — the server may have
                # executed it (a re-sent /v1/sweep would enqueue a
                # second job) — so only send-stage failures and safe
                # methods retry, with jittered backoff between attempts.
                conn.close()
                self._local.conn = None
                fresh = True
                # idempotent covers simulate/lint POSTs and cancel
                # DELETEs: re-executing them changes nothing server-
                # side, so a connection reset from a recycled acceptor
                # (a front tier restarts acceptors under it) is retried
                # like any GET — unlike a job submission, which is
                # never replayed once its bytes finished sending.  A
                # TIMEOUT is different even for idempotent bodies: the
                # server may still be executing the slow request, and
                # stacking a replay behind it only compounds the load.
                retryable = (
                    method == "GET"
                    or not sent
                    or (idempotent and not isinstance(e, TimeoutError))
                )
                if (
                    retryable and was_cached and stale_budget > 0
                    and not isinstance(e, TimeoutError)
                ):
                    # a timeout is a real wait, never the stale case
                    stale_budget -= 1
                    continue
                if (
                    retryable and failover_budget > 0
                    and isinstance(e, ConnectionError)
                    and not isinstance(e, TimeoutError)
                ):
                    # connection refused/reset on a SAFE request and
                    # other cluster members are known: rotate to the
                    # next one and re-issue there.  Timeouts never fail
                    # over (the slow node may still be executing) and
                    # non-idempotent requests that finished sending
                    # were already excluded by `retryable`.
                    failover_budget -= 1
                    self._active = (self._active + 1) % len(self._addrs)
                    continue
                if attempt >= self.retries or not retryable:
                    code = (
                        "timeout" if isinstance(e, TimeoutError)
                        else "connection_failed"
                    )
                    raise ServeError(
                        0, code, f"{type(e).__name__}: {e}",
                    ) from None
                time.sleep(self._backoff_s(attempt, path))
                attempt += 1

    def _retry_after_wait_s(self, retry_after_s: float, attempt: int,
                            path: str) -> float:
        """One honored backpressure wait: the server's hint floored by
        the client's own exponential schedule (so repeated refusals
        still back off even under a constant hint), jittered
        deterministically (±25%, the ``_backoff_s`` salt — N clients
        refused together fan back out de-synchronized), capped at
        ``retry_after_max_s``."""
        base = max(float(retry_after_s), self._backoff_s(attempt, path))
        h = hashlib.sha256(
            f"{self._jitter_salt}:ra:{path}:{attempt}".encode()
        ).digest()
        jitter = 0.25 * int.from_bytes(h[:4], "big") / 0xFFFFFFFF
        return min(base * (1.0 + jitter), self.retry_after_max_s)

    def _request(
        self, method: str, path: str, body: dict | None = None,
        timeout_s: float | None = None, idempotent: bool = False,
    ) -> dict:
        attempt = 0
        while True:
            resp, payload = self._raw(
                method, path, body, timeout_s=timeout_s,
                idempotent=idempotent,
            )
            try:
                doc = json.loads(payload or b"{}")
            except (json.JSONDecodeError, ValueError):
                doc = {}
            if resp.status < 400:
                return doc
            retry_after = resp.getheader("Retry-After")
            if (
                self.honor_retry_after
                and resp.status in (429, 503)
                and retry_after is not None
                and attempt < self.retries
            ):
                # a clean backpressure refusal: the server did NOT
                # execute the request, so re-issuing is safe for every
                # route — job submissions included (the never-replay
                # rule guards ambiguous TRANSPORT failures, which
                # _raw still never replays once the bytes left)
                try:
                    hint = float(retry_after)
                except (TypeError, ValueError):
                    hint = 1.0
                time.sleep(self._retry_after_wait_s(hint, attempt, path))
                attempt += 1
                continue
            try:
                # Retry-After may legally be an HTTP-date; surface
                # an unparseable hint as None, never a raw ValueError
                retry_after_s = float(retry_after) \
                    if retry_after is not None else None
            except (TypeError, ValueError):
                retry_after_s = None
            raise ServeError(
                resp.status,
                str(doc.get("error", "http_error")),
                str(doc.get("detail", resp.reason)),
                doc=doc,
                retry_after_s=retry_after_s,
            )

    # -- routes --------------------------------------------------------------

    def healthz(self, timeout_s: float | None = None) -> dict:
        return self._request("GET", "/healthz", timeout_s=timeout_s)

    def metrics_text(self, timeout_s: float | None = None) -> str:
        resp, payload = self._raw("GET", "/metrics", timeout_s=timeout_s)
        if resp.status != 200:
            raise ServeError(resp.status, "http_error", resp.reason)
        return payload.decode()

    def traces(self, timeout_s: float | None = None) -> list[str]:
        return list(
            self._request("GET", "/v1/traces", timeout_s=timeout_s)
            .get("traces", [])
        )

    @property
    def last_trace_id(self) -> str | None:
        """The request-trace id of this THREAD's most recent response,
        or None when the server runs with tracing off (the default)."""
        return getattr(self._local, "last_trace_id", None)

    def recent_traces(
        self, timeout_s: float | None = None,
    ) -> list[dict]:
        """Flight-recorder summaries (slowest-first; the whole fleet's
        when the daemon is a multi-acceptor front).  Requires the
        server to run with ``--trace-requests``."""
        return list(
            self._request(
                "GET", "/v1/debug/traces", timeout_s=timeout_s,
            ).get("traces", [])
        )

    def trace_detail(
        self, trace_id: str, chrome: bool = False,
        timeout_s: float | None = None,
    ) -> dict:
        """One recorded span tree by id (``chrome=True`` returns the
        Perfetto/Chrome ``traceEvents`` document instead)."""
        path = f"/v1/debug/traces/{trace_id}"
        if chrome:
            resp, payload = self._raw(
                "GET", path + "?format=chrome", timeout_s=timeout_s,
            )
            if resp.status != 200:
                raise ServeError(resp.status, "http_error", resp.reason)
            return dict(json.loads(payload))
        return dict(
            self._request("GET", path, timeout_s=timeout_s)
            .get("trace", {})
        )

    def simulate(
        self,
        trace: str | None = None,
        hlo_text: str | None = None,
        arch: str | None = None,
        overlays: list[dict] | None = None,
        faults: dict | None = None,
        tuned: bool = True,
        num_devices: int = 1,
        validate: bool = True,
        deadline_ms: int | None = None,
        timeout_s: float | None = None,
    ) -> SimResult:
        body: dict = {"tuned": tuned, "validate": validate}
        if trace is not None:
            body["trace"] = trace
        if hlo_text is not None:
            body["hlo_text"] = hlo_text
            body["num_devices"] = num_devices
        if arch is not None:
            body["arch"] = arch
        if overlays:
            body["overlays"] = overlays
        if faults is not None:
            body["faults"] = faults
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        doc = self._request(
            "POST", "/v1/simulate", body, timeout_s=timeout_s,
            idempotent=True,
        )
        return SimResult(
            stats=doc["stats"],
            cache_hit=bool(doc["cache_hit"]),
            trace=str(doc["trace"]),
            arch=str(doc["arch"]),
            num_devices=int(doc["num_devices"]),
            sim_cycles=float(doc["sim_cycles"]),
            model_version=str(doc["model_version"]),
            format_version=int(doc["format_version"]),
        )

    def lint(
        self,
        trace: str | None = None,
        hlo_text: str | None = None,
        arch: str | None = None,
        overlays: list[dict] | None = None,
        faults: dict | None = None,
        num_devices: int = 1,
        timeout_s: float | None = None,
    ) -> LintReport:
        body: dict = {}
        if trace is not None:
            body["trace"] = trace
        if hlo_text is not None:
            body["hlo_text"] = hlo_text
            body["num_devices"] = num_devices
        if arch is not None:
            body["arch"] = arch
        if overlays:
            body["overlays"] = overlays
        if faults is not None:
            body["faults"] = faults
        doc = self._request(
            "POST", "/v1/lint", body, timeout_s=timeout_s, idempotent=True,
        )
        return LintReport(
            summary=str(doc["summary"]),
            errors=int(doc["errors"]),
            warnings=int(doc["warnings"]),
            diagnostics=dict(doc["diagnostics"]),
            model_version=str(doc["model_version"]),
        )

    def sweep(self, timeout_s: float | None = None, **request) -> str:
        """Submit an async sweep; returns the job id."""
        doc = self._request(
            "POST", "/v1/sweep", request, timeout_s=timeout_s,
        )
        return str(doc["job_id"])

    def campaign(self, timeout_s: float | None = None, **request) -> str:
        """Submit an async Monte-Carlo campaign (``spec=`` + the usual
        ``trace=``/``hlo_text=``); returns the job id.  Poll with
        :meth:`wait_job` — the result is the campaign report
        document."""
        doc = self._request(
            "POST", "/v1/campaign", request, timeout_s=timeout_s,
        )
        return str(doc["job_id"])

    def fleet(self, timeout_s: float | None = None, **request) -> str:
        """Submit an async fleet digital-twin run (``spec=`` + the
        usual ``trace=``/``hlo_text=``); returns the job id.  Poll
        with :meth:`wait_job` — the result is the fleet capacity
        report document."""
        doc = self._request(
            "POST", "/v1/fleet", request, timeout_s=timeout_s,
        )
        return str(doc["job_id"])

    def advise(self, timeout_s: float | None = None, **request) -> str:
        """Submit an async sharding-advisor sweep (``spec=`` + the
        usual ``trace=``/``hlo_text=``); returns the job id.  Poll
        with :meth:`wait_job` — the result is the ranked advise
        report document."""
        doc = self._request(
            "POST", "/v1/advise", request, timeout_s=timeout_s,
        )
        return str(doc["job_id"])

    def job(self, job_id: str, timeout_s: float | None = None) -> JobStatus:
        doc = self._request(
            "GET", f"/v1/jobs/{job_id}", timeout_s=timeout_s,
        )
        return JobStatus(
            job_id=str(doc["job_id"]),
            status=str(doc["status"]),
            result=doc.get("result"),
            error=doc.get("error"),
            raw=doc,
        )

    def cancel_job(
        self, job_id: str, timeout_s: float | None = None,
    ) -> str:
        """``DELETE /v1/jobs/<id>`` — cooperative cancellation.  A
        queued job is terminal ``cancelled`` on return; a running
        campaign/advise job returns ``cancelling`` and lands terminal
        once the runner unwinds at its next scenario/cell boundary
        (poll with :meth:`wait_job`; completed scenarios stay journaled
        for ``--resume``).  Returns the job's reported status."""
        doc = self._request(
            "DELETE", f"/v1/jobs/{job_id}", timeout_s=timeout_s,
            idempotent=True,
        )
        return str(doc["status"])

    def wait_job(
        self, job_id: str, timeout_s: float = 120.0,
        poll_s: float = 0.1, poll_timeout_s: float | None = None,
    ) -> JobStatus:
        """Poll until the job is terminal; raises TimeoutError.
        ``timeout_s`` bounds the whole wait; ``poll_timeout_s`` is the
        per-poll socket timeout (the constructor default otherwise)."""
        deadline = time.monotonic() + timeout_s
        while True:
            status = self.job(job_id, timeout_s=poll_timeout_s)
            if status.terminal:
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {status.status!r} after "
                    f"{timeout_s:.0f}s"
                )
            time.sleep(poll_s)

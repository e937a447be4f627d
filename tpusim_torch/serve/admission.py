"""Admission control + async job table — the daemon's queueing layer
(port of ``tpusim/serve/admission.py``).

The offline harness batches jobs (procman's bounded ``parallel``); an
online service needs the same bound plus *backpressure
semantics*: a request that cannot run soon must be told so cheaply (429
+ ``Retry-After``), a request that waited past its deadline must fail
predictably (504), and an oversized body must be refused before it is
read (413).  This module owns those decisions; the HTTP layer only maps
the exceptions to status codes.

Model: at most ``max_inflight`` requests execute concurrently; up to
``queue_depth`` more may wait.  A waiter that is still queued at its
deadline raises :class:`DeadlineExceeded`; a request arriving with the
wait queue full raises :class:`Overloaded` (the 429, with a retry hint
derived from the observed service rate); once the daemon starts
draining, everything new raises :class:`Draining` (503) while in-flight
work runs to completion — the SIGTERM contract.

:class:`JobTable` is the async half (``POST /v1/sweep`` → job id →
``GET /v1/jobs/<id>``): a bounded FIFO drained by daemon-owned worker
threads, with terminal results retained for polling, persisted under a
``--state-dir`` and recovered on restart (a torn or wrongly shaped job
file is quarantined, never fatal).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "AdmissionController",
    "DeadlineExceeded",
    "Degraded",
    "Draining",
    "Job",
    "JobTable",
    "Overloaded",
]


class Overloaded(RuntimeError):
    """Queue full — the 429 with a Retry-After hint."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = max(float(retry_after_s), 1.0)
        super().__init__(
            f"queue full; retry after {self.retry_after_s:.0f}s"
        )


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was queued — the 504."""


class Draining(RuntimeError):
    """The daemon is shutting down and admits nothing new — the 503."""


class Degraded(RuntimeError):
    """The supervised worker pool has fewer live workers than its floor
    — the load-shedding 503 + ``Retry-After``.  Queueing into a
    dead pool would convert every request into a slow 504; telling the
    client to come back when the restart backoff opens is cheaper for
    both sides."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = max(float(retry_after_s), 1.0)
        super().__init__(
            f"worker pool degraded; retry after {self.retry_after_s:.0f}s"
        )


class AdmissionController:
    """Bounded inflight + bounded FIFO wait queue with deadlines."""

    def __init__(self, max_inflight: int = 4, queue_depth: int = 16):
        self.max_inflight = max(int(max_inflight), 1)
        self.queue_depth = max(int(queue_depth), 0)
        self._cond = threading.Condition()
        self._inflight = 0
        # FIFO of waiter tokens: a fresh arrival may bypass it only
        # when it is empty, so a queued request can never be starved
        # to its deadline by a steady stream of newcomers
        self._queue: list[object] = []
        self._draining = False
        # observed service rate feeds the Retry-After hint
        self._done = 0
        self._busy_seconds = 0.0

    # -- state ---------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def start_drain(self) -> None:
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def wait_idle(self, timeout_s: float | None = None) -> bool:
        """Block until nothing is in flight or queued (the drain join).
        Returns False on timeout."""
        deadline = time.monotonic() + timeout_s if timeout_s else None
        with self._cond:
            while self._inflight > 0 or self._queue:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining if remaining is not None else 0.5)
        return True

    def _retry_after(self) -> float:
        """Hint: how long until a queue slot plausibly frees — the mean
        observed service time times the backlog ahead of a new arrival,
        spread over the inflight lanes."""
        mean_s = (
            self._busy_seconds / self._done if self._done else 1.0
        )
        backlog = self._inflight + len(self._queue)
        return max(mean_s * backlog / self.max_inflight, 1.0)

    # -- the slot ------------------------------------------------------------

    def admit(self, deadline: float | None = None) -> "_Slot":
        """Claim an execution slot, waiting (bounded by ``deadline``, a
        ``time.monotonic()`` instant) for one to free.  Use as a context
        manager::

            with admission.admit(deadline):
                ... do the work ...

        Raises :class:`Overloaded` / :class:`DeadlineExceeded` /
        :class:`Draining` instead of admitting."""
        with self._cond:
            if self._draining:
                raise Draining("server is draining")
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded("deadline expired before admission")
            if self._inflight >= self.max_inflight or self._queue:
                if len(self._queue) >= self.queue_depth:
                    raise Overloaded(self._retry_after())
                token = object()
                self._queue.append(token)
                try:
                    # FIFO: proceed only at the head of the queue AND
                    # with a free lane — a newcomer behind us cannot
                    # overtake, because it queues whenever _queue is
                    # non-empty
                    while (
                        self._queue[0] is not token
                        or self._inflight >= self.max_inflight
                    ):
                        if self._draining:
                            raise Draining("server is draining")
                        remaining = None
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise DeadlineExceeded(
                                    "deadline expired while queued"
                                )
                        self._cond.wait(
                            remaining if remaining is not None else 0.5
                        )
                finally:
                    # success or abandonment (deadline/drain), the token
                    # leaves the line so later waiters can advance
                    self._queue.remove(token)
                    self._cond.notify_all()
            self._inflight += 1
        return _Slot(self)

    def _release(self, busy_s: float) -> None:
        with self._cond:
            self._inflight -= 1
            self._done += 1
            self._busy_seconds += busy_s
            self._cond.notify_all()

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        with self._cond:
            return {
                "inflight": self._inflight,
                "queued": len(self._queue),
                "max_inflight": self.max_inflight,
                "queue_depth": self.queue_depth,
                "completed": self._done,
                "draining": int(self._draining),
            }


class _Slot:
    """One admitted execution; releases on exit and feeds the service-
    rate estimate."""

    __slots__ = ("_adm", "_t0")

    def __init__(self, adm: AdmissionController):
        self._adm = adm
        self._t0 = time.monotonic()

    def __enter__(self) -> "_Slot":
        return self

    def __exit__(self, *exc) -> bool:
        self._adm._release(time.monotonic() - self._t0)
        return False


# ---------------------------------------------------------------------------
# Async jobs
# ---------------------------------------------------------------------------


@dataclass
class Job:
    """One async request (``POST /v1/sweep``)."""

    job_id: str
    kind: str
    request: dict
    status: str = "queued"   # queued | running | done | failed | cancelled
    result: dict | None = None
    error: str | None = None
    submitted_s: float = field(default_factory=time.monotonic)
    finished_s: float | None = None
    #: cooperative-cancellation token (tpusim_torch.guard.CancelToken), minted
    #: at submit so ``DELETE /v1/jobs/<id>`` can trip it whether the job
    #: is still queued or already running — resumable kinds (campaign)
    #: check it at scenario grain and journal everything completed
    cancel_token: object | None = field(default=None, repr=False)

    def to_doc(self) -> dict:
        doc = {
            "job_id": self.job_id,
            "kind": self.kind,
            "status": self.status,
        }
        if self.result is not None:
            doc["result"] = self.result
        if self.error is not None:
            doc["error"] = self.error
        return doc


class JobTable:
    """Bounded FIFO of async jobs + terminal-result retention.

    The daemon owns the worker threads; the table only sequences.  A
    full queue raises :class:`Overloaded` — the same backpressure story
    as the sync path.

    ``persist_dir`` adds crash-safety for the job SPECS: every accepted
    job writes ``<dir>/<job_id>.json`` (atomic temp + ``os.replace``)
    and updates it on state transitions, so a restarted daemon
    re-enqueues whatever was queued or running when the process died —
    an accepted job id must eventually resolve even across a crash.
    (Campaign jobs additionally journal their per-scenario progress via
    :mod:`tpusim_torch.campaign.journal`; requeueing here is what re-enters
    that resume path.)"""

    def __init__(
        self, queue_depth: int = 16, keep: int = 256,
        persist_dir=None, evict_hook=None,
    ):
        self.queue_depth = max(int(queue_depth), 1)
        self.keep = max(int(keep), 1)
        #: called with a job_id when a terminal job ages out of `keep`
        #: — the daemon uses it to reclaim per-job state (campaign
        #: journal dirs) that would otherwise grow without bound
        self.evict_hook = evict_hook
        self._cond = threading.Condition()
        self._queue: list[Job] = []
        self._jobs: dict[str, Job] = {}
        self._next_id = 0
        self._draining = False
        self.persist_dir = Path(persist_dir) if persist_dir else None
        self.recovered = 0
        if self.persist_dir is not None:
            os.makedirs(self.persist_dir, exist_ok=True)
            self._recover()

    # -- persistence ---------------------------------------------------------

    def _job_path(self, job_id: str):
        return self.persist_dir / f"{job_id}.json"

    def _persist(self, job: Job) -> None:
        """Write the job's current state (caller holds the lock)."""
        if self.persist_dir is None:
            return
        doc = {
            "job_id": job.job_id,
            "kind": job.kind,
            "request": job.request,
            "status": job.status,
        }
        if job.result is not None:
            doc["result"] = job.result
        if job.error is not None:
            doc["error"] = job.error
        path = self._job_path(job.job_id)
        tmp = path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}"
        )
        tmp.write_text(json.dumps(doc, sort_keys=True) + "\n")
        # lint-allow: TL352 best-effort job persist — boot quarantines
        # a torn file with one warning and recovery continues
        os.replace(tmp, path)

    def _unpersist(self, job_id: str) -> None:
        if self.persist_dir is None:
            return
        try:
            self._job_path(job_id).unlink()
        except OSError:
            pass

    def _quarantine(self, path, reason: str) -> None:
        """Move one torn/corrupt persist file aside (a single warning;
        the file keeps its name under ``quarantine/`` for forensics)
        so every later boot recovers cleanly instead of re-warning —
        or worse, aborting — on the same damage."""
        import warnings

        target = self.persist_dir / "quarantine" / path.name
        try:
            os.makedirs(target.parent, exist_ok=True)
            # lint-allow: TL352 quarantine MOVE of damage already on
            # disk, not a staged publish
            os.replace(path, target)
            moved = f"quarantined to {target.parent.name}/{target.name}"
        except OSError:
            moved = "left in place (quarantine move failed)"
        warnings.warn(
            f"job table: persisted job {path.name} is unreadable "
            f"({reason}); {moved}, recovery continues with the "
            f"healthy jobs",
            RuntimeWarning, stacklevel=3,
        )

    def _recover(self) -> None:
        """Reload persisted jobs: terminal ones return to the polling
        table, queued/RUNNING ones re-enqueue (a job that was mid-run
        when the daemon died must run again — resumable kinds pick up
        from their own journal).  A torn or corrupt per-job file —
        a daemon killed mid-``_persist`` before the atomic replace, or
        disk damage — quarantines with ONE warning and recovery
        continues: one bad file must never take down the healthy
        jobs' crash-safety."""
        from tpusim_torch.guard.cancel import CancelToken

        for path in sorted(self.persist_dir.glob("job-*.json")):
            try:
                doc = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError, ValueError) as e:
                self._quarantine(path, f"{type(e).__name__}: {e}")
                continue
            try:
                job = Job(
                    job_id=str(doc["job_id"]),
                    kind=str(doc["kind"]),
                    request=dict(doc["request"]),
                    status=str(doc.get("status", "queued")),
                    result=doc.get("result"),
                    error=doc.get("error"),
                    cancel_token=CancelToken(),
                )
                num = int(job.job_id.rsplit("-", 1)[1])
            except (KeyError, TypeError, ValueError, IndexError,
                    AttributeError) as e:
                self._quarantine(path, f"{type(e).__name__}: {e}")
                continue
            self._next_id = max(self._next_id, num)
            self._jobs[job.job_id] = job
            if job.status in ("queued", "running"):
                job.status = "queued"
                self._queue.append(job)
                self.recovered += 1
                self._persist(job)

    # -- sequencing ----------------------------------------------------------

    def submit(self, kind: str, request: dict) -> Job:
        with self._cond:
            if self._draining:
                raise Draining("server is draining")
            if len(self._queue) >= self.queue_depth:
                raise Overloaded(float(len(self._queue)))
            self._next_id += 1
            from tpusim_torch.guard.cancel import CancelToken

            job = Job(
                job_id=f"job-{self._next_id:06d}", kind=kind,
                request=request, cancel_token=CancelToken(),
            )
            self._queue.append(job)
            self._jobs[job.job_id] = job
            self._persist(job)
            evicted = self._trim()
            self._cond.notify()
        # eviction reclaims arbitrary per-job state (a campaign journal
        # dir can hold thousands of records) — never under the lock,
        # where it would stall every submit/poll/drain on one rmtree
        for jid in evicted:
            if self.evict_hook is not None:
                try:
                    self.evict_hook(jid)
                except Exception:  # noqa: BLE001 - eviction best-effort
                    pass
        return job

    def get(self, job_id: str) -> Job | None:
        with self._cond:
            return self._jobs.get(job_id)

    def next_job(self, timeout_s: float = 0.5) -> Job | None:
        """Pop the next queued job (worker loop); None on timeout."""
        with self._cond:
            if not self._queue:
                self._cond.wait(timeout_s)
            if not self._queue:
                return None
            job = self._queue.pop(0)
            job.status = "running"
            self._persist(job)
            return job

    def finish(
        self, job: Job, result: dict | None, error: str | None,
        status: str | None = None,
    ) -> None:
        """Land a terminal state.  ``status`` overrides the derived
        done/failed verdict — the job loop passes ``"cancelled"`` when a
        run raised :class:`tpusim_torch.guard.OperationCancelled` (a client
        asked for it; not a failure, not a success)."""
        with self._cond:
            job.status = status or (
                "failed" if error is not None else "done"
            )
            job.result = result
            job.error = error
            job.finished_s = time.monotonic()
            self._persist(job)
            self._cond.notify_all()

    def cancel(self, job_id: str) -> str | None:
        """``DELETE /v1/jobs/<id>``: a queued job lands terminal
        ``cancelled`` immediately; a running job has its token tripped
        and the job loop records ``cancelled`` when the runner unwinds
        (campaign journals guarantee a later resume re-prices nothing
        completed).  Returns the job's (possibly new) status, or None
        for an unknown id.  Terminal jobs are a no-op — cancelling what
        already finished changes nothing."""
        with self._cond:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job.status == "queued":
                try:
                    self._queue.remove(job)
                except ValueError:
                    pass  # a worker popped it between our checks
                else:
                    job.status = "cancelled"
                    job.error = "cancelled by client"
                    job.finished_s = time.monotonic()
                    self._persist(job)
                    self._cond.notify_all()
                    return job.status
            if job.status == "running":
                tok = job.cancel_token
                if tok is not None:
                    tok.cancel("cancelled by client (DELETE /v1/jobs)")
                return "cancelling"
            return job.status

    def start_drain(self) -> None:
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def wait_idle(self, timeout_s: float | None = None) -> bool:
        """Block until no job is queued or running (the drain join:
        queued jobs still execute — an accepted job id must resolve)."""
        deadline = time.monotonic() + timeout_s if timeout_s else None
        with self._cond:
            while any(
                j.status in ("queued", "running")
                for j in self._jobs.values()
            ):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining if remaining is not None else 0.5)
        return True

    def _trim(self) -> list[str]:
        # retain only the newest `keep` terminal jobs; queued/running
        # entries are never dropped.  Returns the evicted ids — the
        # caller runs evict_hook on them OUTSIDE the lock.
        terminal = [
            jid for jid, j in self._jobs.items()
            if j.status in ("done", "failed", "cancelled")
        ]
        evicted: list[str] = []
        while len(terminal) > self.keep:
            dropped = terminal.pop(0)
            self._jobs.pop(dropped, None)
            self._unpersist(dropped)
            evicted.append(dropped)
        return evicted

    def stats_dict(self) -> dict[str, float]:
        with self._cond:
            counts = {"queued": 0, "running": 0, "done": 0, "failed": 0,
                      "cancelled": 0}
            for j in self._jobs.values():
                counts[j.status] = counts.get(j.status, 0) + 1
            return {f"jobs_{k}": v for k, v in counts.items()}

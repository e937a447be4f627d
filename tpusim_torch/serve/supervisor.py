"""Supervised pre-forked worker pool — the serving tier's robustness
core (port of ``tpusim/serve/supervisor.py``).

A daemon that prices every request under one Python process is capped
at one core by the GIL, and one bad request (an OOM on a pathological
inline module, a hung call) takes the whole daemon and every in-flight
job with it.  This module gives the serve tier the property that **one
bad request costs exactly one worker, never the service**.

Shape: N long-lived worker processes (forked up front, spawn fallback —
the :mod:`tpusim_torch.perf.pool` start-method story), each running
:func:`tpusim_torch.serve.worker.worker_child_main`: its own
:class:`~tpusim_torch.serve.registry.TraceRegistry` (per-worker hot pods), its
own in-memory L1 :class:`~tpusim_torch.perf.ResultCache`, and — when the
daemon mounts ``--result-cache`` — the shared **disk** tier as L2
(``durable=True``: fsync-before-replace, so a worker killed mid-publish
can never leave a short-read record).  Requests travel over a duplex
pipe per worker; responses are the exact dicts the in-process
:class:`~tpusim_torch.serve.worker.ServeWorker` returns, so served stats docs
stay **byte-identical** across 1..N workers and the single-process path.

The supervisor is the policy layer:

* **content-hash affinity** — a request's canonical body hash picks its
  home worker, so identical requests from many users land on a warm L1;
  dispatch stays work-conserving (a busy home spills to any free live
  worker rather than queueing behind itself);
* **per-request deadlines** — a worker that has not answered by the
  request's deadline is killed (SIGTERM, then SIGKILL escalation after a
  short grace) and restarted; a hung native call can no longer pin the
  daemon.  The request gets the 504 it already had a contract for;
* **crash detection + supervised restart** — a worker death (EOF on the
  pipe, a reaped pid) schedules a restart with exponential backoff and
  deterministic jitter (procman-style), so a crash-looping worker cannot
  busy-spin the host;
* **poison-request quarantine** — a request whose worker dies under it
  is retried once on a fresh worker; a second death quarantines the
  request's content hash and answers 422 with a diagnostic.  Later
  identical requests are refused immediately — the pool never
  crash-loops on one input;
* **graceful degradation** — when live workers fall below ``min_live``
  the pool sheds load (:class:`~tpusim_torch.serve.admission.Degraded` → 503 +
  ``Retry-After``) instead of queueing into a dead pool, and
  ``/healthz`` + ``/metrics`` expose per-worker state
  (alive/restarts/kills/quarantine size) so balancers and operators see
  the same truth.

Workers fork from the daemon's process, which may hold torch and a CUDA
context (``chip_smoke.py`` serves from one).  :meth:`Supervisor._preload`
imports the port's pricing stack, torch included, before any fork; each
child then runs one intra-op thread and never touches ``torch.cuda``
(:func:`~tpusim_torch.serve.worker.worker_child_main`).
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import signal
import threading
import time

from tpusim_torch.serve.admission import Degraded, DeadlineExceeded
from tpusim_torch.serve.worker import RequestError, worker_child_main

__all__ = ["CooperativeCancel", "Supervisor", "WorkerSlot", "WorkerTimeout"]

#: fields stripped from the affinity/quarantine hash: they change how
#: long a request may run, never what it prices (a poison request with a
#: different deadline is the same poison; ``_budget_s`` is the shipped
#: remaining-deadline budget of the cooperative-cancellation frame)
_VOLATILE_BODY_KEYS = ("deadline_ms", "_budget_s", "_trace_ctx")

#: restart backoff ceiling — a flapping worker must not sleep forever
MAX_RESTART_BACKOFF_S = 30.0

#: grace between SIGTERM and the SIGKILL escalation on a deadline kill
KILL_GRACE_S = 0.5

#: grace PAST the request deadline for the worker's cooperative
#: cancellation frame (tpusim_torch.guard): the child's own CancelToken trips
#: at the same instant, and letting it unwind in-process keeps the
#: worker — and its warm registry/L1 — alive.  Only a worker that never
#: reaches a cancel check inside this window (a hung native call, a
#: chaos sleep) meets the SIGTERM/SIGKILL escalation.
COOP_CANCEL_GRACE_S = 0.75


class WorkerTimeout(DeadlineExceeded):
    """The request's deadline expired while a worker was pricing it; the
    worker was killed and is being restarted.  Subclasses
    :class:`DeadlineExceeded` so the HTTP layer's 504 mapping applies."""


class CooperativeCancel(DeadlineExceeded):
    """The request's deadline expired and the worker cancelled it
    IN-PROCESS (tpusim_torch.guard): still a 504, but the worker survives
    with its caches warm and the restart counters untouched."""


class _WorkerGone(ConnectionError):
    """The worker died before it ever STARTED the request — the send
    failed, or the pipe closed before the worker's ack frame came back
    (the request sat unread in the buffer of a worker something else
    killed).  Distinct from a mid-pricing death: this request cannot be
    the killer, so it must not charge the poison-retry budget."""


def _det_jitter(index: int, spawns: int, base: float) -> float:
    """Deterministic restart jitter (procman-style): up to 25% of the
    backoff, derived from the slot identity — reproducible, but two
    slots crashing together do not restart in lockstep."""
    h = hashlib.sha256(f"{index}:{spawns}".encode()).digest()
    return 0.25 * base * (int.from_bytes(h[:4], "big") / 0xFFFFFFFF)


class WorkerSlot:
    """One supervised worker position: the live process (when alive),
    its pipe, and the slot's supervision history.  ``lock`` serializes
    dispatch — a worker prices one request at a time."""

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        self.proc = None
        self.conn = None
        self.alive = False
        self.busy = False
        self.pid: int | None = None
        self.spawns = 0           # spawn ATTEMPTS (the jitter stream)
        self.boots = 0            # successful ready registrations
        self.kills = 0            # deadline kills (supervisor-initiated)
        self.crashes = 0          # uncommanded deaths (request or idle)
        self.consecutive_failures = 0
        self.next_restart_at = 0.0   # time.monotonic() gate
        self.started_at = 0.0
        self.requests_done = 0

    @property
    def restarts(self) -> int:
        # counted from BOOTS, not attempts: a respawn that never came
        # up is not a heal, and the chaos smoke's ">= 1 restart" gate
        # must mean a worker actually returned to service
        return max(self.boots - 1, 0)

    def to_doc(self) -> dict:
        return {
            "index": self.index,
            "alive": self.alive,
            "busy": self.busy,
            "pid": self.pid,
            "restarts": self.restarts,
            "kills": self.kills,
            "crashes": self.crashes,
            "requests_done": self.requests_done,
        }


class Supervisor:
    """Owns the worker fleet; see the module docstring for the policy.

    ``settings`` is the picklable child bootstrap document
    (:func:`~tpusim_torch.serve.worker.worker_child_main`'s contract):
    ``trace_root``, ``disk_cache_dir``, ``cache_entries``,
    ``chaos_hooks``, ``inherited_fds``."""

    def __init__(
        self,
        settings: dict,
        num_workers: int = 2,
        min_live: int = 1,
        retry_budget: int = 1,
        quarantine_max: int = 256,
        restart_backoff_s: float = 0.05,
        spawn_timeout_s: float = 60.0,
        max_worker_rss_bytes: int | None = None,
        quarantine_dir=None,
    ):
        self.settings = dict(settings)
        # a shared quarantine directory makes poison refusal
        # FLEET-wide — every acceptor's supervisor publishes its poison
        # verdicts as one atomic file per content hash, so a request
        # that killed workers behind acceptor A is refused immediately
        # by acceptor B instead of being allowed to kill B's workers too
        from pathlib import Path

        self.quarantine_dir = Path(quarantine_dir) if quarantine_dir else None
        if self.quarantine_dir is not None:
            self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        # negative-lookup cache for the shared dir: clean keys are the
        # overwhelming majority, and an open()+ENOENT per dispatch
        # forever would tax the hot path.  The dir's mtime moves when a
        # peer publishes a verdict (rename into the dir), which is the
        # invalidation signal.
        self._quarantine_neg: set[str] = set()
        self._quarantine_dir_mtime: int = -1
        # tpusim_torch.guard: per-worker RSS cap.  The monitor samples each
        # idle worker's /proc RSS about once a second and restarts an
        # over-budget one DELIBERATELY between requests (commanded kill,
        # base restart delay) — the OOM-killer stops choosing victims.
        self.max_worker_rss_bytes = (
            int(max_worker_rss_bytes) if max_worker_rss_bytes else None
        )
        self.num_workers = max(int(num_workers), 1)
        self.min_live = min(max(int(min_live), 1), self.num_workers)
        self.retry_budget = max(int(retry_budget), 0)
        self.quarantine_max = max(int(quarantine_max), 1)
        self.restart_backoff_s = max(float(restart_backoff_s), 0.0)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.slots = [WorkerSlot(i) for i in range(self.num_workers)]
        self._lock = threading.Lock()
        # dispatchers wait HERE for capacity, not on any one worker's
        # lock: any release/restart notifies, every waiter re-scans the
        # whole fleet — a freed neighbor is claimed in microseconds
        # instead of after a per-slot wait timeout
        self._free_cond = threading.Condition()
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._req_seq = 0
        # quarantine: affinity hash -> diagnostic doc (insertion-ordered
        # dict doubles as the LRU)
        self._quarantine: dict[str, dict] = {}
        # cumulative policy counters (mirrored on /metrics as serve_*)
        self.dispatched = 0
        self.retried = 0
        self.shed = 0
        self.poisoned = 0
        self.coop_cancels = 0
        self.rss_kills = 0
        self._rss_tick = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Supervisor":
        """Fork the initial fleet and start the monitor.  Heavy modules
        are imported *first* so every fork inherits them — the child
        never runs the import machinery (forking a threaded parent
        mid-import is the classic deadlock), and a restarted worker is
        ready in milliseconds."""
        self._preload()
        from tpusim_torch.perf.pool import DeferSignals

        # the pool.py discipline: a SIGTERM landing mid-fork is deferred
        # until every child is up and registered, so the drain path can
        # reap them instead of leaving orphans
        with DeferSignals():
            for slot in self.slots:
                self._spawn(slot)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="tpusim-serve-supervisor",
            daemon=True,
        )
        self._monitor.start()
        return self

    @staticmethod
    def _preload() -> None:
        import torch  # noqa: F401

        import tpusim_torch.analysis.config_passes  # noqa: F401
        import tpusim_torch.fastpath.price  # noqa: F401
        import tpusim_torch.faults  # noqa: F401
        import tpusim_torch.sim.driver  # noqa: F401
        import tpusim_torch.timing.config  # noqa: F401
        import tpusim_torch.trace.format  # noqa: F401
        import tpusim_torch.trace.native  # noqa: F401

    def stop(self, grace_s: float = 2.0) -> None:
        """Shut the fleet down: a shutdown sentinel to every live
        worker, a bounded join, SIGKILL for stragglers."""
        with self._lock:
            # same lock _spawn registers under: a restart in flight
            # either registered already (this sweep reaps it) or will
            # see _stop at registration and tear its worker down —
            # no process can slip in AFTER the sweep
            self._stop.set()
        for slot in self.slots:
            conn, proc = slot.conn, slot.proc
            slot.alive = False
            if conn is not None:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + max(grace_s, 0.1)
        for slot in self.slots:
            proc = slot.proc
            if proc is None:
                continue
            proc.join(max(deadline - time.monotonic(), 0.05))
            if proc.is_alive():
                proc.kill()
                proc.join(1.0)
            self._close_slot(slot)
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)

    def _close_slot(self, slot: WorkerSlot) -> None:
        if slot.conn is not None:
            try:
                slot.conn.close()
            except OSError:
                pass
        slot.conn = None
        slot.proc = None
        slot.alive = False
        slot.busy = False
        slot.pid = None

    # -- spawning / supervision ----------------------------------------------

    def _spawn(self, slot: WorkerSlot) -> bool:
        """Start one worker and wait for its ready handshake.  Returns
        False (and schedules a backed-off retry) when the child never
        reported ready."""
        methods = multiprocessing.get_all_start_methods()
        method = "fork" if "fork" in methods else "spawn"
        ctx = multiprocessing.get_context(method)
        settings = self.settings
        if method != "fork":
            # a spawned child inherits none of the parent's fds;
            # inherited_fds carries PARENT fd numbers (the listener),
            # and closing those numbers in a fresh interpreter would
            # hit the child's own pipe/interpreter fds
            settings = {
                k: v for k, v in settings.items() if k != "inherited_fds"
            }
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        proc = ctx.Process(
            target=worker_child_main,
            args=(slot.index, child_conn, settings),
            name=f"tpusim-serve-worker-{slot.index}",
            daemon=True,
        )
        slot.spawns += 1
        try:
            proc.start()
        except OSError:
            parent_conn.close()
            child_conn.close()
            self._mark_failed_spawn(slot)
            return False
        child_conn.close()
        ready = False
        try:
            if parent_conn.poll(self.spawn_timeout_s):
                msg = parent_conn.recv()
                ready = (
                    isinstance(msg, tuple) and len(msg) == 2
                    and msg[0] == "ready"
                )
        except (EOFError, OSError):
            ready = False
        if not ready:
            try:
                proc.kill()
                proc.join(1.0)
            except (OSError, ValueError):
                pass
            parent_conn.close()
            self._mark_failed_spawn(slot)
            return False
        with self._lock:
            if self._stop.is_set():
                registered = False
            else:
                slot.proc = proc
                slot.conn = parent_conn
                slot.pid = proc.pid
                slot.alive = True
                slot.boots += 1
                slot.started_at = time.monotonic()
                registered = True
        if not registered:
            # stop() won the lock first: its sweep is over, so this
            # fresh worker would never receive the shutdown sentinel —
            # tear it down here instead of leaking the process
            try:
                parent_conn.send(None)
            except (BrokenPipeError, OSError):
                pass
            proc.join(1.0)
            if proc.is_alive():
                proc.kill()
                proc.join(1.0)
            parent_conn.close()
            return False
        with self._free_cond:
            self._free_cond.notify_all()  # fresh capacity: wake waiters
        return True

    def _mark_failed_spawn(self, slot: WorkerSlot) -> None:
        with self._lock:
            slot.alive = False
            slot.consecutive_failures += 1
            slot.next_restart_at = (
                time.monotonic() + self._backoff_for(slot)
            )

    def _backoff_for(self, slot: WorkerSlot) -> float:
        base = self.restart_backoff_s * (
            2.0 ** max(slot.consecutive_failures - 1, 0)
        )
        base = min(base, MAX_RESTART_BACKOFF_S)
        return base + _det_jitter(slot.index, slot.spawns, base)

    def _mark_dead(
        self, slot: WorkerSlot, *, commanded: bool, count_kill: bool = True,
    ) -> None:
        """Record a worker death and schedule its restart.  Commanded
        kills (deadline enforcement) restart on the base delay — the
        request was at fault; uncommanded crashes compound the backoff.
        ``count_kill=False`` is the deliberate RSS recycle: commanded
        semantics (base delay, no crash streak) without inflating the
        deadline-kill counter."""
        with self._lock:
            was_alive = slot.alive
            slot.alive = False
            slot.pid = None
            if not was_alive:
                return
            if commanded:
                if count_kill:
                    slot.kills += 1
                slot.next_restart_at = (
                    time.monotonic() + self.restart_backoff_s
                )
            else:
                slot.crashes += 1
                slot.consecutive_failures += 1
                slot.next_restart_at = (
                    time.monotonic() + self._backoff_for(slot)
                )
        proc, conn = slot.proc, slot.conn
        if proc is not None:
            try:
                proc.join(0.1)
            except (OSError, ValueError):
                pass
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        slot.conn = None
        slot.proc = None
        with self._free_cond:
            # waiters must re-check the floor (Degraded beats waiting
            # forever for capacity that just died)
            self._free_cond.notify_all()

    def _kill_slot(self, slot: WorkerSlot, count_kill: bool = True) -> None:
        """Deadline enforcement: SIGTERM, a short grace, then SIGKILL.
        A worker stuck in a native call ignores the TERM; the KILL does
        not ask."""
        proc = slot.proc
        if proc is None or proc.pid is None:
            self._mark_dead(slot, commanded=True, count_kill=count_kill)
            return
        try:
            proc.terminate()
            proc.join(KILL_GRACE_S)
            if proc.is_alive():
                proc.kill()
                proc.join(2.0)
        except (OSError, ValueError):
            pass
        self._mark_dead(slot, commanded=True, count_kill=count_kill)

    def _monitor_loop(self) -> None:
        """Detect idle deaths (a worker OOM-killed between requests),
        restart dead slots once their backoff gate opens, and enforce
        the per-worker RSS cap (tpusim_torch.guard)."""
        while not self._stop.wait(0.05):
            self._rss_tick += 1
            if (
                self.max_worker_rss_bytes is not None
                and self._rss_tick % 20 == 0  # ~1s cadence
            ):
                self._enforce_rss_caps()
            for slot in self.slots:
                if self._stop.is_set():
                    return
                proc = slot.proc
                if slot.alive and proc is not None and not proc.is_alive():
                    # died while idle (or the dispatcher has not noticed
                    # yet); only claim it if no request holds the slot —
                    # the dispatcher's EOF path owns the busy case
                    if slot.lock.acquire(blocking=False):
                        try:
                            if (
                                slot.alive and slot.proc is proc
                                and not proc.is_alive()
                            ):
                                self._mark_dead(slot, commanded=False)
                        finally:
                            slot.lock.release()
                elif (
                    not slot.alive
                    and time.monotonic() >= slot.next_restart_at
                    and slot.lock.acquire(blocking=False)
                ):
                    # respawn in a per-slot thread, slot lock handed
                    # over: _spawn blocks up to spawn_timeout_s on the
                    # ready handshake, and one hung boot must not stall
                    # every OTHER dead slot's restart (or idle-death
                    # detection) behind it.  The held lock is what
                    # keeps respawns single-flight per slot.
                    threading.Thread(
                        target=self._respawn_locked, args=(slot,),
                        name=f"tpusim-serve-respawn-{slot.index}",
                        daemon=True,
                    ).start()

    def _enforce_rss_caps(self) -> None:
        """Restart any IDLE worker whose RSS exceeds the cap — a
        deliberate, supervised recycle (base restart delay, fresh
        caches) instead of the OOM-killer picking a victim mid-request.
        Busy slots are skipped: the cap never truncates in-flight work;
        a worker that stays busy is bounded by the request deadline."""
        from tpusim_torch.guard.watchdog import rss_bytes

        for slot in self.slots:
            if not slot.alive or slot.pid is None:
                continue
            rss = rss_bytes(slot.pid)
            if rss <= 0 or rss < self.max_worker_rss_bytes:
                continue
            if not slot.lock.acquire(blocking=False):
                continue  # busy: re-checked next sweep
            try:
                if slot.alive and slot.pid is not None:
                    with self._lock:
                        self.rss_kills += 1
                    self._kill_slot(slot, count_kill=False)
            finally:
                slot.lock.release()

    def _respawn_locked(self, slot: WorkerSlot) -> None:
        """Monitor handed us ``slot.lock`` already held; boot the
        worker and release."""
        try:
            if not slot.alive and not self._stop.is_set():
                self._spawn(slot)
        finally:
            slot.lock.release()

    # -- dispatch ------------------------------------------------------------

    @staticmethod
    def affinity_key(endpoint: str, body: dict) -> str:
        """Canonical content hash of one request — the affinity AND
        quarantine identity.  Inline HLO text rides in the body, so two
        users submitting the same module land on the same warm L1."""
        doc = {
            k: v for k, v in (body or {}).items()
            if k not in _VOLATILE_BODY_KEYS
        }
        payload = json.dumps(
            {"endpoint": endpoint, "body": doc},
            sort_keys=True, default=str,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:24]

    def alive_count(self) -> int:
        return sum(1 for s in self.slots if s.alive)

    def _shed_retry_after(self) -> float:
        """Hint for the 503: when the soonest dead slot may come back."""
        now = time.monotonic()
        etas = [
            max(s.next_restart_at - now, 0.0)
            for s in self.slots if not s.alive
        ]
        return max(min(etas, default=1.0), 1.0)

    def _release_slot(self, slot: WorkerSlot) -> None:
        slot.busy = False
        slot.lock.release()
        with self._free_cond:
            self._free_cond.notify_all()

    def _acquire_slot(self, key: str, deadline: float | None) -> WorkerSlot:
        """Claim a live worker: the affinity home when free, any free
        live worker otherwise (work-conserving), else wait for ANY
        release and re-scan.  Raises :class:`Degraded` below the live
        floor and :class:`DeadlineExceeded` when the wait outlives the
        request."""
        start = int(key[:8], 16) % len(self.slots)
        order = [
            self.slots[(start + i) % len(self.slots)]
            for i in range(len(self.slots))
        ]
        with self._free_cond:
            while True:
                if self.alive_count() < self.min_live:
                    self.shed += 1
                    raise Degraded(self._shed_retry_after())
                for slot in order:
                    if slot.alive and slot.lock.acquire(blocking=False):
                        if slot.alive:
                            slot.busy = True
                            return slot
                        slot.lock.release()
                timeout = 0.1
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DeadlineExceeded(
                            "deadline expired waiting for a worker"
                        )
                    timeout = min(timeout, remaining)
                self._free_cond.wait(timeout)

    def _round_trip(
        self, slot: WorkerSlot, endpoint: str, body: dict,
        deadline: float | None, trace_ctx: bool = False,
    ) -> tuple[str, object, dict | None]:
        """One request over one worker's pipe.  Returns the worker's
        ``(kind, payload, trace_extras)`` — ``trace_extras`` is the
        optional ``"spans"`` frame a tracing-aware child sends just
        before its final frame (worker-side span timings + cache tier),
        ``None`` otherwise; raises :class:`WorkerTimeout` after killing
        a worker that outlived the deadline, :class:`_WorkerGone` when
        the worker died without ever acking the request (not charged to
        the poison budget), ``ConnectionError`` on a mid-request death
        (the caller's retry/quarantine path)."""
        with self._lock:
            self._req_seq += 1
            req_id = self._req_seq
        conn = slot.conn
        acked = False
        trace_extras: dict | None = None
        if deadline is not None or trace_ctx:
            body = dict(body or {})
        if deadline is not None:
            # ship the remaining budget so the child arms its own
            # CancelToken (tokens never cross pipes); the signal kill
            # below becomes the ESCALATION past the cooperative grace,
            # not the first resort
            body["_budget_s"] = max(deadline - time.monotonic(), 0.0)
        if trace_ctx:
            # volatile marker (stripped from the affinity/quarantine
            # content hash like _budget_s): the child times its tiers
            # and ships them back in an extra "spans" frame
            body["_trace_ctx"] = True
        try:
            conn.send((req_id, endpoint, body))
        except (BrokenPipeError, OSError):
            self._mark_dead(slot, commanded=False)
            raise _WorkerGone("worker died before the request was sent")
        kill_at = (
            deadline + COOP_CANCEL_GRACE_S if deadline is not None
            else None
        )
        while True:
            timeout = 0.5
            if deadline is not None:
                now = time.monotonic()
                if now >= kill_at:
                    self._kill_slot(slot)
                    raise WorkerTimeout(
                        "worker exceeded the request deadline and was "
                        "killed"
                    )
                # past the deadline but inside the grace: keep polling
                # for the worker's in-process 'cancelled' frame
                timeout = min(timeout, max(kill_at - now, 0.01))
            try:
                if conn.poll(timeout):
                    msg = conn.recv()
                    if (
                        isinstance(msg, tuple) and len(msg) == 3
                        and msg[0] == req_id
                    ):
                        if msg[1] == "ack":
                            acked = True  # the worker READ the request
                            continue
                        if msg[1] == "spans":
                            # worker-side span timings ride ahead of
                            # the final frame; stash, keep polling
                            if isinstance(msg[2], dict):
                                trace_extras = msg[2]
                            continue
                        return msg[1], msg[2], trace_extras
                    continue  # stale frame from a pre-kill epoch
            except (EOFError, OSError):
                self._mark_dead(slot, commanded=False)
                if not acked:
                    # no ack frame: the request sat unread in the pipe
                    # buffer when something ELSE killed the worker —
                    # retry elsewhere without charging the poison budget
                    raise _WorkerGone(
                        "worker died before reading the request"
                    )
                raise ConnectionError(
                    "worker died while pricing the request"
                )
            proc = slot.proc
            if proc is not None and not proc.is_alive():
                # belt for exotic hosts where EOF never surfaces; drain
                # any frames already buffered (the ack, even the full
                # response) before deciding what this death means
                if conn.poll(0):
                    continue
                self._mark_dead(slot, commanded=False)
                if not acked:
                    raise _WorkerGone(
                        "worker died before reading the request"
                    )
                raise ConnectionError(
                    "worker died while pricing the request"
                )

    def execute(
        self, endpoint: str, body: dict, deadline: float | None = None,
        reqtrace=None,
    ) -> dict:
        """Price one request through the fleet, applying every policy in
        the module docstring.  Returns the worker's response dict;
        raises :class:`~tpusim_torch.serve.worker.RequestError` (passthrough
        and quarantine), :class:`Degraded`, :class:`WorkerTimeout`, or
        ``RuntimeError`` (the worker survived but the request blew up —
        the HTTP layer's 500 boundary).  ``reqtrace`` (a
        :class:`tpusim_torch.obs.reqtrace.RequestTrace`) opts the child into
        span collection; its timings merge back as ``dispatch/*``
        children over the shared monotonic clock."""
        key = self.affinity_key(endpoint, body)
        with self._lock:
            poison = self._quarantine.get(key)
        if poison is None and self.quarantine_dir is not None:
            poison = self._quarantine_file_get(key)
        with self._lock:
            if poison is None:
                self.dispatched += 1
            else:
                # every quarantine-refused response counts: the gauge's
                # name is poison_422_TOTAL, and an operator watching it
                # must see ongoing poison traffic, not just first blood
                self.poisoned += 1
        if poison is not None:
            raise RequestError(
                422, "poison_request",
                "this request previously killed its worker and is "
                "quarantined",
                extra={"poison": dict(poison)},
            )
        attempts = 0
        while True:
            slot = self._acquire_slot(key, deadline)
            try:
                kind, payload, trace_extras = self._round_trip(
                    slot, endpoint, body, deadline,
                    trace_ctx=reqtrace is not None,
                )
            except _WorkerGone:
                # the worker died without ever STARTING the request (no
                # ack frame came back — an idle death, or an unrelated
                # kill with the request unread in the buffer).  Not
                # this request's fault: take another slot without
                # charging the poison budget.  Bounded, not a spin:
                # every such failure marks its slot dead, so repeats
                # end in Degraded at the live floor.
                with self._lock:
                    self.retried += 1
                continue
            except ConnectionError as e:
                attempts += 1
                if attempts > self.retry_budget:
                    doc = self._quarantine_add(key, endpoint, body, str(e))
                    with self._lock:
                        self.poisoned += 1
                    raise RequestError(
                        422, "poison_request",
                        f"request killed {attempts} worker(s) and is now "
                        f"quarantined",
                        extra={"poison": doc},
                    )
                with self._lock:
                    self.retried += 1
                continue
            else:
                # bookkeeping BEFORE the release (else runs first):
                # once released the slot may belong to another request,
                # and a crash streak it just started must not be wiped
                # by this request's success
                slot.requests_done += 1
                with self._lock:
                    slot.consecutive_failures = 0
            finally:
                self._release_slot(slot)
            if reqtrace is not None and trace_extras is not None:
                reqtrace.add_worker_spans(trace_extras.get("spans") or ())
                tier = trace_extras.get("tier")
                if tier:
                    reqtrace.meta["tier"] = tier
            if kind in ("ok", "ok_bytes"):
                # ok_bytes is the final serialized response body (the
                # worker's serialization IS the parent's, byte for byte)
                return payload
            if kind == "cancelled":
                # the worker cancelled in-process at its deadline and
                # SURVIVED (slot released live above, caches warm, no
                # restart) — SIGKILL never entered the picture
                with self._lock:
                    self.coop_cancels += 1
                raise CooperativeCancel(str(payload))
            if kind == "request_error":
                status, code, detail, extra = payload
                raise RequestError(status, code, detail, extra)
            raise RuntimeError(str(payload))

    def _quarantine_add(
        self, key: str, endpoint: str, body: dict, detail: str,
    ) -> dict:
        doc = {
            "content_hash": key,
            "endpoint": endpoint,
            "trace": body.get("trace") if isinstance(body, dict) else None,
            "detail": detail,
            "worker_deaths": self.retry_budget + 1,
        }
        with self._lock:
            self._quarantine[key] = doc
            while len(self._quarantine) > self.quarantine_max:
                self._quarantine.pop(next(iter(self._quarantine)))
        if self.quarantine_dir is not None:
            # publish fleet-wide: one atomic file per content hash, so
            # every OTHER acceptor's supervisor refuses this request
            # without paying its own worker deaths first
            try:
                path = self.quarantine_dir / f"{key}.json"
                tmp = path.with_suffix(f".tmp.{os.getpid()}")
                tmp.write_text(json.dumps(doc, sort_keys=True))
                # lint-allow: TL352 best-effort poison marker — a lost
                # verdict just re-learns on the next worker death
                os.replace(tmp, path)
            except OSError:
                pass  # local quarantine still holds
        return doc

    def _quarantine_file_get(self, key: str) -> dict | None:
        """A peer acceptor's quarantine verdict for ``key`` (shared
        dir), cached into the local LRU on first sight.  Negative
        results are cached against the dir's mtime (a publish renames a
        file into the dir, moving it) so clean traffic pays one stat,
        not one failed open per dispatch."""
        try:
            dir_mtime = self.quarantine_dir.stat().st_mtime_ns
        except OSError:
            return None
        with self._lock:
            if dir_mtime != self._quarantine_dir_mtime:
                self._quarantine_neg.clear()
                self._quarantine_dir_mtime = dir_mtime
            elif key in self._quarantine_neg:
                return None
        try:
            doc = json.loads(
                (self.quarantine_dir / f"{key}.json").read_text()
            )
        except (OSError, json.JSONDecodeError):
            with self._lock:
                if dir_mtime == self._quarantine_dir_mtime:
                    self._quarantine_neg.add(key)
            return None
        if not isinstance(doc, dict):
            return None
        with self._lock:
            self._quarantine.setdefault(key, doc)
            while len(self._quarantine) > self.quarantine_max:
                self._quarantine.pop(next(iter(self._quarantine)))
        return doc

    # -- test / chaos helpers ------------------------------------------------

    def worker_pids(self) -> list[int | None]:
        return [s.pid for s in self.slots]

    def kill_worker(self, index: int) -> None:
        """SIGKILL one worker outright (chaos testing — the supervisor
        discovers the death exactly as it would a real crash)."""
        pid = self.slots[index].pid
        if pid is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass

    # -- reporting -----------------------------------------------------------

    def worker_docs(self) -> list[dict]:
        return [s.to_doc() for s in self.slots]

    def stats_dict(self) -> dict[str, float]:
        return {
            "workers_configured": self.num_workers,
            "workers_alive": self.alive_count(),
            "workers_min_live": self.min_live,
            "worker_restarts_total": sum(s.restarts for s in self.slots),
            "worker_kills_total": sum(s.kills for s in self.slots),
            "worker_crashes_total": sum(s.crashes for s in self.slots),
            "worker_requests_total": sum(
                s.requests_done for s in self.slots
            ),
            "worker_dispatched_total": self.dispatched,
            "worker_retries_total": self.retried,
            "quarantine_size": len(self._quarantine),
            "poison_422_total": self.poisoned,
            "shed_503_total": self.shed,
            # tpusim_torch.guard: in-process deadline cancels (worker
            # survived) and deliberate per-worker RSS recycles
            "worker_coop_cancels_total": self.coop_cancels,
            "worker_rss_kills_total": self.rss_kills,
        }

"""Local process manager — the rebuild of ``util/job_launching/procman.py``
(the reference's dependency-free slurm substitute, ``procman.py:11-35``):
run a queue of jobs with bounded parallelism, track status, persist state.

Port of ``tpusim/harness/procman.py``.

This is the "fake cluster" for laptops/CI; torque/slurm submission can slot
in behind the same interface later (``run_simulations.py:376-397`` selects
launchers the same way).

Hardened for flaky capture boxes (live TPU-VM jobs die from transient
signals — preempted tunnels, OOM kills, device resets): a job submitted
with ``retries=N`` is reaped-and-resubmitted up to N extra attempts with
exponential backoff plus deterministic jitter, and the attempt count is
carried through ``status_summary()`` / ``dump_state()`` so run metadata
records how hard each result was to get.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Job", "ProcMan"]

#: backoff ceiling — a tenth attempt must not sleep for an hour
MAX_BACKOFF_S = 60.0


@dataclass
class Job:
    job_id: int
    cmd: list[str]
    cwd: str | None = None
    log_path: str | None = None
    env: dict[str, str] | None = None
    status: str = "pending"   # pending | running | done | failed | cancelled
    returncode: int | None = None
    started_at: float | None = None
    finished_at: float | None = None
    # -- retry policy (0 = the pre-hardening terminal-on-failure behavior)
    retries: int = 0              # extra attempts after the first failure
    backoff_s: float = 0.5        # base delay; doubles per failed attempt
    attempts: int = 0             # attempts actually started
    not_before: float = 0.0       # earliest wall time of the next attempt

    _proc: subprocess.Popen | None = field(default=None, repr=False)
    _log_f: object | None = field(default=None, repr=False)

    @property
    def retried(self) -> int:
        """Resubmissions performed (attempts beyond the first)."""
        return max(self.attempts - 1, 0)

    def next_backoff_s(self) -> float:
        """Exponential backoff with deterministic jitter for the NEXT
        resubmission: ``backoff * 2^(failures-1)`` plus up to 25% jitter
        derived from (job_id, attempt) — spreads a herd of identically
        failing jobs without nondeterministic sleeps."""
        base = self.backoff_s * (2.0 ** max(self.attempts - 1, 0))
        jitter = 0.25 * base * (
            ((self.job_id * 2654435761 + self.attempts * 40503) % 1000)
            / 1000.0
        )
        return min(base + jitter, MAX_BACKOFF_S)


class ProcMan:
    """Run jobs locally with at most ``parallel`` concurrent processes."""

    def __init__(self, parallel: int | None = None):
        self.parallel = parallel or max((os.cpu_count() or 2) // 2, 1)
        self.jobs: list[Job] = []
        # graceful-shutdown latch: once set, no pending job starts;
        # running jobs are reaped normally (the SIGTERM drain contract —
        # a killed suite run must not orphan its simulate children)
        self._draining = False

    # -- graceful shutdown -------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def request_drain(self) -> None:
        """Stop starting pending jobs; let running ones finish.  The
        ``run`` loop then returns once the last running job is reaped,
        with the never-started jobs marked ``cancelled``."""
        self._draining = True

    def submit(
        self,
        cmd: list[str],
        *,
        cwd: str | Path | None = None,
        log_path: str | Path | None = None,
        env: dict[str, str] | None = None,
        retries: int = 0,
        backoff_s: float = 0.5,
    ) -> Job:
        job = Job(
            job_id=len(self.jobs),
            cmd=[str(c) for c in cmd],
            cwd=str(cwd) if cwd else None,
            log_path=str(log_path) if log_path else None,
            env=env,
            retries=max(int(retries), 0),
            backoff_s=max(float(backoff_s), 0.0),
        )
        self.jobs.append(job)
        return job

    # -- scheduling --------------------------------------------------------

    def _start(self, job: Job) -> None:
        log_f = None
        if job.log_path:
            Path(job.log_path).parent.mkdir(parents=True, exist_ok=True)
            # retries append, with a banner, so the failed attempt's
            # output stays diagnosable; the sentinel scrape reads the
            # whole file either way
            mode = "a" if job.attempts > 0 else "w"
            log_f = open(job.log_path, mode)
            if job.attempts > 0:
                log_f.write(
                    f"\n=== tpusim procman: retry attempt "
                    f"{job.attempts + 1}/{job.retries + 1} "
                    f"(previous rc={job.returncode}) ===\n"
                )
                log_f.flush()
        env = dict(os.environ)
        if job.env:
            env.update(job.env)
        job._proc = subprocess.Popen(
            job.cmd, cwd=job.cwd, env=env,
            stdout=log_f or subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
        )
        job._log_f = log_f
        job.status = "running"
        job.attempts += 1
        job.started_at = time.time()

    def _reap(self, job: Job) -> None:
        assert job._proc is not None
        rc = job._proc.poll()
        if rc is None:
            return
        job.returncode = rc
        job.finished_at = time.time()
        if job._log_f is not None:
            job._log_f.close()  # type: ignore[attr-defined]
            job._log_f = None
        job._proc = None
        if rc == 0:
            job.status = "done"
        elif job.attempts <= job.retries:
            # transient death (negative rc = killed by signal, positive =
            # nonzero exit): resubmit after backoff instead of going
            # terminal — the capture-box flake path
            job.status = "pending"
            job.not_before = time.time() + job.next_backoff_s()
        else:
            job.status = "failed"

    def step(self) -> bool:
        """Advance the scheduler one tick; returns True while work remains."""
        running = [j for j in self.jobs if j.status == "running"]
        for j in running:
            self._reap(j)
        running = [j for j in self.jobs if j.status == "running"]
        if self._draining:
            # drain mode: nothing new starts; work remains only while
            # something is still running (pending jobs no longer count)
            return bool(running)
        now = time.time()
        pending = [
            j for j in self.jobs
            if j.status == "pending" and now >= j.not_before
        ]
        for j in pending[: max(self.parallel - len(running), 0)]:
            self._start(j)
        return any(j.status in ("pending", "running") for j in self.jobs)

    def run(
        self,
        poll_s: float = 0.2,
        timeout_s: float | None = None,
        on_tick=None,
        drain_signals: bool = False,
    ) -> bool:
        """Run until all jobs finish.  Returns True if all succeeded.
        ``on_tick(self)`` is called once per poll — the job_status.py
        monitoring hook.

        ``drain_signals=True`` turns SIGTERM/SIGINT into a graceful
        drain for the duration of this call: running children are
        reaped normally (never orphaned), never-started jobs are marked
        ``cancelled``, and ``run`` returns instead of the process dying
        mid-reap.  Handlers are installed only from the main thread and
        always restored."""
        prev_handlers: dict[int, object] = {}
        if drain_signals and (
            threading.current_thread() is threading.main_thread()
        ):
            try:
                for s in (signal.SIGTERM, signal.SIGINT):
                    prev_handlers[s] = signal.signal(
                        s, lambda signum, frame: self.request_drain()
                    )
            except (ValueError, OSError):  # pragma: no cover
                prev_handlers = {}
        try:
            deadline = time.time() + timeout_s if timeout_s else None
            while self.step():
                if on_tick is not None:
                    on_tick(self)
                if deadline and time.time() > deadline:
                    self.kill_all()
                    return False
                time.sleep(poll_s)
            if on_tick is not None:
                on_tick(self)
            if self._draining:
                for j in self.jobs:
                    if j.status == "pending":
                        j.status = "cancelled"
            return all(j.status == "done" for j in self.jobs)
        finally:
            for s, prev in prev_handlers.items():
                signal.signal(s, prev)

    def kill_all(self) -> None:
        for j in self.jobs:
            if j._proc is not None:
                j._proc.kill()
            if j.status in ("pending", "running"):
                j.status = "failed"

    # -- reporting ---------------------------------------------------------

    def status_summary(self) -> dict[str, int]:
        out: dict[str, int] = {}
        retries = 0
        for j in self.jobs:
            out[j.status] = out.get(j.status, 0) + 1
            retries += j.retried
        if retries:
            # only present when a resubmission actually happened, so the
            # healthy-path summary shape is unchanged
            out["retries"] = retries
        return out

    def dump_state(self, path: str | Path) -> None:
        state = [
            {
                "job_id": j.job_id, "cmd": j.cmd, "status": j.status,
                "returncode": j.returncode, "log": j.log_path,
                "started_at": j.started_at, "finished_at": j.finished_at,
                "attempts": j.attempts, "retries_allowed": j.retries,
            }
            for j in self.jobs
        ]
        with open(path, "w") as f:
            json.dump(state, f, indent=2)

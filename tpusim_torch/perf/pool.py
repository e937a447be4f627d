"""Deterministic worker pool — the fan-out half of :mod:`tpusim_torch.perf`.

Port of ``tpusim/perf/pool.py``.  The fan-out layers (the link sweeps and
the driver's per-segment module pricing) are embarrassingly parallel *and*
pure — each task is a closed-form float computation — so a process pool
with an **ordered** result merge reproduces the serial path bit-for-bit:
same tasks, same math, same merge order.

Contract (the reference's):

* ``workers<=1`` (the default when ``$TPUSIM_WORKERS`` is unset)
  short-circuits to a plain in-process loop — no pool, no pickling, no
  behavior change;
* the start method is ``fork`` where available (context transfers by
  inheritance — no pickling of pods/configs) with a ``spawn`` fallback
  (context travels through the initializer, so it must pickle);
* results always merge in task-submission order (``Pool.map``
  semantics), so downstream reports cannot depend on scheduling;
* any pool-infrastructure failure falls back to the serial loop rather
  than failing the run — parallelism is an optimization of host work,
  never a requirement.

Worker functions must be module-level (pickled by qualified name) and
reach their shared inputs through :func:`pool_context`, set per call via
``map_ordered(..., context=...)``.

A forked child inherits torch's intra-op OpenMP pool in the state the
parent left it, and a parallel region entered in the child can then wait
forever on threads that were not forked.  Pool workers therefore run with
one intra-op thread; pricing's CPU float64 scans are serial anyway, so no
result changes.  Nothing a worker runs may touch ``torch.cuda``: a forked
child cannot initialise CUDA again.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import signal
import threading
from typing import Any, Callable, Iterable

__all__ = [
    "DeferSignals",
    "env_workers",
    "map_ordered",
    "pool_context",
    "resolve_workers",
]


class DeferSignals:
    """Defer SIGTERM/SIGINT while a pooled map is in flight.

    The default SIGTERM disposition kills the parent instantly — skipping
    atexit, so the pool's daemonic children are ORPHANED mid-task (they
    finish their item, then block forever on the dead task queue).  While
    this guard is active the signal is only recorded; on exit — after the
    pool context has reaped its workers — the original disposition is
    restored and the signal re-delivered, so the process still honors the
    kill, just *after* the in-flight work has drained (and, for cached
    sweeps, landed in the disk tier).

    Signal handlers can only be installed from the main thread; from other
    threads this is a no-op and the process-level handlers keep their
    behavior."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __enter__(self) -> "DeferSignals":
        self._received: list[int] = []
        self._prev: dict[int, object] = {}
        self._active = (
            threading.current_thread() is threading.main_thread()
        )
        if self._active:
            try:
                for s in self._SIGNALS:
                    self._prev[s] = signal.signal(
                        s, lambda signum, frame: self._received.append(signum)
                    )
            except (ValueError, OSError):  # pragma: no cover - exotic hosts
                self._active = False
        return self

    def __exit__(self, *exc) -> bool:
        if self._active:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            for signum in self._received:
                os.kill(os.getpid(), signum)
        return False


#: shared per-call inputs for worker functions; in the parent this is set
#: by :func:`map_ordered` (the serial path uses it too, so workers are
#: path-agnostic), in children by the pool initializer.
_POOL_CONTEXT: Any = None


def _init_worker(context: Any) -> None:
    global _POOL_CONTEXT
    _POOL_CONTEXT = context


def _init_pool_worker(context: Any) -> None:
    """Pool initializer: the context, and one intra-op thread (see the
    module docstring)."""
    import torch

    torch.set_num_threads(1)
    _init_worker(context)


def pool_context() -> Any:
    """The ``context=`` object of the in-flight :func:`map_ordered` call."""
    return _POOL_CONTEXT


def env_workers() -> int | None:
    """``$TPUSIM_WORKERS`` as an int, or None when unset/garbage."""
    raw = os.environ.get("TPUSIM_WORKERS", "").strip()
    if not raw:
        return None
    try:
        return max(int(raw), 1)
    except ValueError:
        return None


def resolve_workers(workers: int | None) -> int:
    """Effective worker count: the explicit request, else
    ``$TPUSIM_WORKERS``, else 1 (serial — parallelism is opt-in).
    Inside a pool worker this is always 1: daemonic processes cannot
    fork children, so nested fan-out degrades to the serial path."""
    if multiprocessing.current_process().daemon:
        return 1
    if workers is not None:
        return max(int(workers), 1)
    return env_workers() or 1


def _serial(fn: Callable, items: list, context: Any) -> list:
    # save/restore rather than reset: a nested serial map (e.g. a sweep
    # worker whose driver falls back to serial) must not clobber the
    # outer call's context for its remaining items
    prev = _POOL_CONTEXT
    _init_worker(context)
    try:
        return [fn(item) for item in items]
    finally:
        _init_worker(prev)


def map_ordered(
    fn: Callable,
    items: Iterable,
    workers: int | None = None,
    context: Any = None,
    chunksize: int = 1,
) -> list:
    """``[fn(item) for item in items]``, fanned over ``workers``
    processes, results in input order.

    ``fn`` must be a module-level function when ``workers > 1``;
    ``context`` is exposed to it via :func:`pool_context` on every path
    (serial included), so workers never branch on how they were run."""
    items = list(items)
    w = min(resolve_workers(workers), len(items))
    if w <= 1:
        return _serial(fn, items, context)
    try:
        # dispatchability probe: workers import fn by qualified name, so
        # a closure/local fn can never run in a pool — take the serial
        # path up front instead of interpreting a later AttributeError
        # (which a TASK may legitimately raise) as dispatch failure
        pickle.dumps(fn)
    except Exception:
        return _serial(fn, items, context)
    methods = multiprocessing.get_all_start_methods()
    ctx = multiprocessing.get_context(
        "fork" if "fork" in methods else "spawn"
    )
    try:
        pool = ctx.Pool(w, initializer=_init_pool_worker, initargs=(context,))
    except (OSError, ValueError, ImportError,
            multiprocessing.ProcessError, pickle.PicklingError):
        # pool INFRASTRUCTURE failed (fd limits, a host that forbids fork,
        # unpicklable context on spawn): degrade to the serial loop —
        # same tasks, same order, same results
        return _serial(fn, items, context)
    try:
        # SIGTERM/SIGINT during the map drain the in-flight tasks and
        # reap the children before the signal takes effect (see
        # DeferSignals) — a killed sweep leaves no orphan workers
        with DeferSignals(), pool:
            return pool.map(fn, items, chunksize=chunksize)
    except pickle.PicklingError:
        # items failed to pickle — a dispatch problem (fn was probed
        # above), not a task failure, so the serial loop still applies.
        # Real task exceptions propagate unchanged.
        return _serial(fn, items, context)

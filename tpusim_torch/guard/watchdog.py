"""Memory watchdog + degradation ladder.

Port of ``tpusim/guard/watchdog.py``.  The watchdog samples the process
RSS on a background thread and walks a **degradation ladder** instead of
leaving memory pressure to the kernel's OOM-killer, in the order that
sheds the most reclaimable memory first:

1. **shrink in-memory LRUs** — halve the result cache's entry budget
   and trim it (cached results re-materialize from the disk tier or a
   recompute);
2. **drop the compiled-module tier** — fastpath compiles are pure
   functions of content + config, rebuilt on demand;
3. **force streaming/lean trace mode** — ``TPUSIM_STREAM_THRESHOLD=0``,
   so later parses go through ``StreamingModuleTrace`` regardless of
   size (:func:`tpusim_torch.trace.format.load_trace` reads it);
4. **shed load** — the final step at the hard threshold: the serve tier
   answers 503 + ``Retry-After`` and the CLI refuses cleanly (via the
   run's cancel token) rather than letting the OOM-killer choose.

Soft threshold: one ladder step per sample (progressive, reversible —
dropping below the soft line re-arms the ladder, runs the undos and
clears shedding).  Hard threshold: every remaining step at once, then
shed.  :meth:`MemoryWatchdog.stop` reverts nothing: a process that shed
keeps ``TPUSIM_STREAM_THRESHOLD=0`` until it recovers or exits.

The sampler reads ``/proc/<pid>/status`` (``VmRSS``), which also lets
the serve supervisor enforce **per-worker** RSS caps with the same
primitive: an over-budget worker is restarted deliberately between
requests.
"""

from __future__ import annotations

import threading

__all__ = ["MemoryWatchdog", "default_ladder", "rss_bytes"]


def _rss_current(pid: int | None = None) -> int:
    """CURRENT resident set size via ``/proc`` only; 0 when unreadable
    (process gone, exotic platform) — "no signal", never "no memory".
    This is the watchdog's sampler: a governor needs a value that can
    go DOWN, so the monotone ``ru_maxrss`` fallback in :func:`rss_bytes`
    is deliberately excluded here (sampling a peak would turn one
    transient spike into permanent load-shedding with no possible
    recovery).  Without ``/proc`` the watchdog is inert instead."""
    path = f"/proc/{pid if pid is not None else 'self'}/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def rss_bytes(pid: int | None = None) -> int:
    """Resident set size in bytes of ``pid`` (default: this process).
    Returns 0 when unreadable — callers treat 0 as "no signal", never
    as "no memory".  For reporting, the self-read falls back to the
    process's PEAK RSS where ``/proc`` is absent (an over-estimate, and
    monotone — see :func:`_rss_current` for why the watchdog's sampler
    must not use it)."""
    rss = _rss_current(pid)
    if rss > 0:
        return rss
    if pid is None:
        try:
            # fallback: peak RSS — an over-estimate, but monotone.
            # ru_maxrss units differ by platform: KB on Linux, BYTES on
            # macOS (the obs layer's _peak_rss_kb rule) — multiplying
            # mac bytes by 1024 would trip thresholds 1024x early.
            import resource
            import sys as _sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return int(rss) if _sys.platform == "darwin" \
                else int(rss) * 1024
        except Exception:  # noqa: BLE001 - platform probe
            pass
    return 0


class MemoryWatchdog:
    """RSS sampler driving the degradation ladder (module docstring).

    ``actions`` is the ordered ladder of ``(name, fn)`` steps; ``fn``
    takes no arguments and must be idempotent.  ``on_shed`` /
    ``on_recover`` are optional callbacks around the terminal
    load-shedding state; :attr:`shedding` is what the serve tier polls.
    ``rss_fn`` is injectable for deterministic tests."""

    def __init__(
        self,
        soft_bytes: int | None,
        hard_bytes: int | None,
        interval_s: float = 0.25,
        rss_fn=None,
        on_shed=None,
        on_recover=None,
    ):
        if hard_bytes is not None and soft_bytes is None:
            soft_bytes = int(hard_bytes * 0.8)
        self.soft_bytes = int(soft_bytes) if soft_bytes else None
        self.hard_bytes = int(hard_bytes) if hard_bytes else None
        self.interval_s = max(float(interval_s), 0.01)
        # current-RSS reader, NOT rss_bytes: its peak fallback is
        # monotone, and a governor sampling a peak could shed forever
        self._rss_fn = rss_fn if rss_fn is not None else _rss_current
        self.on_shed = on_shed
        self.on_recover = on_recover
        self.actions: list[tuple] = []
        self._undos: list[tuple] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_step = 0
        # also gossiped cluster-wide on heartbeats: a shedding member
        # is skipped by the affinity ring until it recovers
        self.shedding = False
        # counters (surfaced as guard_* stats / /metrics gauges)
        self.rss_last = 0
        self.rss_peak = 0
        self.samples = 0
        self.soft_trips = 0
        self.hard_trips = 0
        self.ladder_steps = 0
        self.shed_entries = 0
        self.recoveries = 0
        self.steps_taken: list[str] = []

    # -- ladder --------------------------------------------------------------

    def add_action(self, name: str, fn, undo=None) -> "MemoryWatchdog":
        """Append a ladder step.  ``undo`` (optional) reverses the
        step's side effects and runs — newest first — when RSS drops
        back under the soft line: the ladder is REVERSIBLE, not a
        one-way ratchet (a transient excursion must not degrade the
        process for its remaining lifetime).  Steps whose effects heal
        naturally (caches refill on demand) need no undo."""
        self.actions.append((name, fn, undo))
        return self

    def _run_step(self) -> bool:
        """Run the next untried ladder step; False when exhausted."""
        if self._next_step >= len(self.actions):
            return False
        name, fn, undo = self.actions[self._next_step]
        self._next_step += 1
        self.ladder_steps += 1
        self.steps_taken.append(name)
        if undo is not None:
            self._undos.append((name, undo))
        try:
            fn()
        except Exception:  # noqa: BLE001 - a ladder step must not kill the dog
            pass
        return True

    # -- sampling ------------------------------------------------------------

    def poll_once(self) -> int:
        """One sample + ladder decision (the thread loop's body; tests
        call it directly).  Returns the sampled RSS."""
        rss = int(self._rss_fn() or 0)
        with self._lock:
            self.samples += 1
            self.rss_last = rss
            if rss > self.rss_peak:
                self.rss_peak = rss
            if rss <= 0:
                return rss
            if self.hard_bytes is not None and rss >= self.hard_bytes:
                self.hard_trips += 1
                while self._run_step():
                    pass
                if not self.shedding:
                    self.shedding = True
                    self.shed_entries += 1
                    if self.on_shed is not None:
                        try:
                            self.on_shed()
                        except Exception:  # noqa: BLE001
                            pass
            elif self.soft_bytes is not None and rss >= self.soft_bytes:
                self.soft_trips += 1
                self._run_step()
            else:
                if self.shedding:
                    self.shedding = False
                    self.recoveries += 1
                    if self.on_recover is not None:
                        try:
                            self.on_recover()
                        except Exception:  # noqa: BLE001
                            pass
                # below the soft line the ladder re-arms: the next
                # excursion gets the full sequence again (each step is
                # idempotent, and caches refill between excursions).
                # Steps with an undo run it here, newest first — one
                # transient spike must not leave, e.g., forced lean
                # streaming pinned for the process lifetime.
                for _name, undo in reversed(self._undos):
                    try:
                        undo()
                    except Exception:  # noqa: BLE001 - undo best-effort
                        pass
                self._undos.clear()
                self._next_step = 0
        return rss

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.poll_once()

    def start(self) -> "MemoryWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="tpusim-guard-watchdog",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        """Unprefixed counters; consumers stamp them under ``guard_``
        (the driver's ``prefix=`` idiom / the daemon's /metrics merge)."""
        with self._lock:
            return {
                "rss_bytes": self.rss_last,
                "rss_peak_bytes": self.rss_peak,
                "rss_soft_limit_bytes": self.soft_bytes or 0,
                "rss_hard_limit_bytes": self.hard_bytes or 0,
                "rss_samples_total": self.samples,
                "rss_soft_trips_total": self.soft_trips,
                "rss_hard_trips_total": self.hard_trips,
                "ladder_steps_total": self.ladder_steps,
                "shed_active": int(self.shedding),
                "shed_entries_total": self.shed_entries,
                "recoveries_total": self.recoveries,
            }


def default_ladder(
    watchdog: MemoryWatchdog, result_cache=None,
) -> MemoryWatchdog:
    """Install the documented ladder order onto ``watchdog``:
    shrink-LRUs → drop-compiled-tier → force-lean-streaming.  The
    terminal shed step is the watchdog's ``on_shed`` hook, owned by the
    surface (serve flips its shedding flag; the CLI cancels its run
    token)."""
    if result_cache is not None:
        shrink_state: dict = {}

        def shrink() -> None:
            # the step's lasting effect is the BUDGET (contents refill
            # on demand) — remember the pre-excursion value so recovery
            # can restore it (first trip wins, like force_lean below)
            if "prev" not in shrink_state:
                shrink_state["prev"] = result_cache.max_entries
            result_cache.shrink()

        def undo_shrink() -> None:
            prev = shrink_state.pop("prev", None)
            if prev is not None:
                result_cache.restore_entry_budget(prev)

        watchdog.add_action("shrink_lru", shrink, undo=undo_shrink)

    def drop_compiled() -> None:
        from tpusim_torch.perf.cache import clear_compiled_cache

        clear_compiled_cache()

    watchdog.add_action("drop_compiled", drop_compiled)

    lean_state: dict = {}

    def force_lean() -> None:
        import os

        # every later load_trace streams (bounded per-module RSS); the
        # fastpath prices streamed modules lean by construction.
        # The pre-excursion threshold is remembered so recovery can
        # restore it (first trip wins: re-runs must not capture "0").
        if "prev" not in lean_state:
            lean_state["prev"] = os.environ.get("TPUSIM_STREAM_THRESHOLD")
        os.environ["TPUSIM_STREAM_THRESHOLD"] = "0"

    def undo_lean() -> None:
        import os

        prev = lean_state.pop("prev", None)
        if prev is None:
            os.environ.pop("TPUSIM_STREAM_THRESHOLD", None)
        else:
            os.environ["TPUSIM_STREAM_THRESHOLD"] = prev

    watchdog.add_action("force_lean", force_lean, undo=undo_lean)
    return watchdog

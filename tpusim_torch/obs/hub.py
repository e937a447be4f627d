"""Instrumentation hub: named wall-clock spans + counters.

Port of ``tpusim/obs/hub.py``.

The self-profiling half of the observability layer: where does the
*simulator* spend its host time (the ``gpgpu_simulation_rate`` /
``silicon_slowdown`` lines tell you the ratio; the spans tell you the
breakdown).  Phases are nested spans — ``parse``, ``engine`` (with
``engine/cost`` and ``engine/ici`` attributed inside it), ``ici``,
``power``, ``export`` — each recording call count, total seconds, and
the process peak RSS observed at span exit.

The default everywhere is :data:`NULL_OBS`, whose ``span()`` returns a
shared no-op context manager and whose counter methods are empty — the
hot path pays one attribute load and a predictable branch, nothing else
(in the JAX package, pinned by its ``tests/test_sim_throughput.py``).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

__all__ = ["Instrumentation", "NullInstrumentation", "NULL_OBS", "SpanStat"]


def _peak_rss_kb() -> int:
    """Process peak RSS in KB (ru_maxrss is KB on Linux, bytes on mac)."""
    try:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss // 1024) if sys.platform == "darwin" else int(rss)
    except (ImportError, OSError):  # pragma: no cover - non-POSIX
        return 0


@dataclass
class SpanStat:
    """Accumulated record for one span path (``engine``, ``engine/cost``)."""

    path: str
    count: int = 0
    seconds: float = 0.0
    child_seconds: float = 0.0   # wall attributed to nested spans/add_time
    peak_rss_kb: int = 0

    @property
    def self_seconds(self) -> float:
        return max(self.seconds - self.child_seconds, 0.0)

    @property
    def depth(self) -> int:
        return self.path.count("/")


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullInstrumentation:
    """No-op hub — the zero-cost default.  Subclassed by the real one so
    call sites never branch on type, only on the cheap ``enabled`` flag
    when they want to skip argument construction entirely."""

    enabled = False
    sample = False
    window_cycles = 0.0

    def span(self, name: str):
        return _NULL_SPAN

    def add_time(self, name: str, seconds: float, count: int = 1) -> None:
        pass

    def counter_add(self, name: str, delta: float = 1.0) -> None:
        pass

    def counter_set(self, name: str, value) -> None:
        pass


NULL_OBS = NullInstrumentation()


class _Span:
    """One live span; records into the hub on exit."""

    __slots__ = ("_hub", "_path", "_t0")

    def __init__(self, hub: "Instrumentation", path: str):
        self._hub = hub
        self._path = path

    def __enter__(self) -> "_Span":
        self._hub._stack.append(self._path)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        hub = self._hub
        hub._stack.pop()
        hub._record(self._path, dt, 1)
        return False


class Instrumentation(NullInstrumentation):
    """The real hub: span tree + counters.

    ``sample=True`` asks the engine/driver to also run the cycle-window
    sampler; ``window_cycles<=0`` means auto (the sampler starts fine and
    coarsens itself to a bounded window count).
    """

    enabled = True

    def __init__(self, window_cycles: float = 0.0, sample: bool = True):
        self.window_cycles = float(window_cycles)
        self.sample = bool(sample)
        self.counters: dict[str, float] = {}
        self.spans: dict[str, SpanStat] = {}
        self._stack: list[str] = []

    # -- spans ---------------------------------------------------------------

    def span(self, name: str) -> _Span:
        parent = self._stack[-1] if self._stack else ""
        path = f"{parent}/{name}" if parent else name
        return _Span(self, path)

    def add_time(self, name: str, seconds: float, count: int = 1) -> None:
        """Manually attribute wall time under the current span — for hot
        sites where a context manager per event would cost more than the
        event (the engine's per-op cost-model calls)."""
        parent = self._stack[-1] if self._stack else ""
        path = f"{parent}/{name}" if parent else name
        self._record(path, seconds, count)

    def _record(self, path: str, seconds: float, count: int) -> None:
        stat = self.spans.get(path)
        if stat is None:
            stat = self.spans[path] = SpanStat(path)
        stat.count += count
        stat.seconds += seconds
        rss = _peak_rss_kb()
        if rss > stat.peak_rss_kb:
            stat.peak_rss_kb = rss
        parent_path = path.rpartition("/")[0]
        if parent_path:
            p = self.spans.get(parent_path)
            if p is None:
                p = self.spans[parent_path] = SpanStat(parent_path)
            p.child_seconds += seconds

    # -- counters ------------------------------------------------------------

    def counter_add(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def counter_set(self, name: str, value) -> None:
        self.counters[name] = value

    # -- reporting -----------------------------------------------------------

    def span_table(self) -> list[SpanStat]:
        """All span stats in tree order: each parent directly followed by
        its children, siblings ordered by wall time."""
        children: dict[str, list[SpanStat]] = {}
        for s in self.spans.values():
            children.setdefault(s.path.rpartition("/")[0], []).append(s)
        out: list[SpanStat] = []

        def walk(parent: str) -> None:
            for s in sorted(children.get(parent, []), key=lambda x: -x.seconds):
                out.append(s)
                walk(s.path)

        walk("")
        return out

    def stats_dict(self) -> dict[str, float]:
        """Flat view for :class:`~tpusim_torch.sim.stats.StatsRegistry` — keys
        become ``obs_span_<path>_s`` / ``obs_<counter>`` lines in the
        greppable report."""
        d: dict[str, float] = {}
        for s in self.spans.values():
            key = s.path.replace("/", ".")
            d[f"span_{key}_s"] = s.seconds
            d[f"span_{key}_calls"] = s.count
        for k, v in self.counters.items():
            d[k.replace("/", ".")] = v
        return d

    def profile_lines(self, total_seconds: float | None = None) -> list[str]:
        """The ``profile`` table: per-phase wall clock, % of the
        measured total, call counts, and peak RSS at span exit."""
        table = self.span_table()
        top_sum = sum(s.seconds for s in table if s.depth == 0)
        total = total_seconds if total_seconds else top_sum
        lines = [
            f"{'phase':28s} {'calls':>8s} {'wall_s':>10s} "
            f"{'% total':>8s} {'peak_rss_mb':>12s}"
        ]
        for s in table:
            indent = "  " * s.depth
            pct = 100.0 * s.seconds / total if total > 0 else 0.0
            lines.append(
                f"{indent + s.path.rpartition('/')[2]:28s} "
                f"{s.count:8d} {s.seconds:10.4f} {pct:7.1f}% "
                f"{s.peak_rss_kb / 1024.0:12.1f}"
            )
        if total > 0:
            covered = 100.0 * top_sum / total
            lines.append(
                f"{'(phases cover)':28s} {'':8s} {top_sum:10.4f} "
                f"{covered:7.1f}% {'':12s}"
            )
        return lines

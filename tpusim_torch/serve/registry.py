"""Trace registry — the daemon's hot-module layer (port of
``tpusim/serve/registry.py``).

A one-shot ``simulate`` pays trace load (disk read + HLO parse) on every
invocation; the service pays it once per trace and keeps the parsed
:class:`~tpusim_torch.ir.PodTrace` hot for every later request.  Two kinds of
entry:

* **named traces** — subdirectories of ``--trace-root`` (the only
  filesystem the service will read; request bodies cannot name arbitrary
  paths), loaded lazily on first reference and kept for the process
  lifetime.  The trace-level static-analysis diagnostics (``TLxxx``,
  :mod:`tpusim_torch.analysis.trace_passes`) are computed once per entry and
  cached beside the pod — per-request validation then only re-runs the
  cheap config/schedule passes;
* **inline HLO** — request bodies may carry raw HLO module text; the
  parsed single-module pod is cached under the text's content hash, so a
  repeated inline request parses nothing.  The same hash is stamped as
  ``meta["content_hash"]``, which is exactly the module-fingerprint slot
  the :mod:`tpusim_torch.perf` result cache keys on — an inline module's priced
  result is as cacheable as a stored trace's.  Inline text parses through
  the port's Python parser (:func:`tpusim_torch.trace.hlo_text.
  parse_hlo_module`); the port has no native scanner yet (ROADMAP A10).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.ir import CommandKind, PodTrace, TraceCommand

__all__ = ["RegistryEntry", "TraceRegistry", "UnknownTrace"]

#: inline pods kept hot (each is one parsed module; bounded so a client
#: streaming unique programs cannot grow the process without limit)
MAX_INLINE_ENTRIES = 64


class UnknownTrace(KeyError):
    """The request named a trace the registry does not serve."""


@dataclass
class RegistryEntry:
    """One hot trace: the parsed pod + its cached trace diagnostics."""

    name: str
    pod: PodTrace
    #: trace-pass Diagnostics (None until first computed)
    trace_diags: object | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)


class TraceRegistry:
    """Named trace dirs under one root + content-addressed inline pods."""

    def __init__(self, trace_root: str | Path | None = None):
        self.trace_root = Path(trace_root) if trace_root else None
        self._entries: dict[str, RegistryEntry] = {}
        self._inline: dict[str, RegistryEntry] = {}
        self._lock = threading.Lock()
        # single-flight gate per trace name: a thundering herd on a
        # cold daemon (a supervised pool boots N workers that all field their
        # first request at once) parses each trace ONCE per process,
        # not once per thread — parse is seconds for large pods
        self._loading: dict[str, threading.Lock] = {}

    # -- named traces --------------------------------------------------------

    def names(self) -> list[str]:
        """Every servable trace name (a subdir holding meta.json or
        modules/ counts; the registry does not eagerly load them)."""
        if self.trace_root is None or not self.trace_root.is_dir():
            return []
        out = []
        for p in sorted(self.trace_root.iterdir()):
            if p.is_dir() and (
                (p / "meta.json").exists() or (p / "modules").is_dir()
            ):
                out.append(p.name)
        return out

    def get(self, name: str) -> RegistryEntry:
        """The hot entry for ``name``, loading it on first reference.

        Only plain child names of the trace root resolve — path
        separators and ``..`` are rejected so a request body can never
        walk the daemon's filesystem."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is not None:
            return entry
        if self.trace_root is None:
            raise UnknownTrace(
                "this server has no --trace-root; only inline hlo_text "
                "requests are servable"
            )
        if not name or "/" in name or "\\" in name or name in (".", ".."):
            raise UnknownTrace(f"invalid trace name {name!r}")
        path = self.trace_root / name
        if not path.is_dir():
            raise UnknownTrace(
                f"unknown trace {name!r} (known: {self.names()})"
            )
        from tpusim_torch.trace.format import load_trace

        # single-flight: the first thread to reach a cold name parses
        # it; racers block on the per-name gate and then read the hot
        # entry instead of re-parsing the same pod concurrently
        with self._lock:
            gate = self._loading.setdefault(name, threading.Lock())
        with gate:
            with self._lock:
                entry = self._entries.get(name)
            if entry is None:
                pod = load_trace(path)
                with self._lock:
                    entry = self._entries.setdefault(
                        name, RegistryEntry(name=name, pod=pod)
                    )
                    self._loading.pop(name, None)
        return entry

    def trace_diagnostics(self, entry: RegistryEntry):
        """Trace-pass diagnostics for a named entry, computed once.

        Mirrors the ``--validate`` pre-flight's trace half
        (:func:`tpusim_torch.analysis.trace_passes.run_trace_passes` over the
        line-anchored re-walk); config/schedule passes are per-request
        and run in the worker."""
        with entry._lock:
            if entry.trace_diags is None:
                from tpusim_torch.analysis.diagnostics import Diagnostics
                from tpusim_torch.analysis.trace_passes import (
                    load_parsed_trace, run_trace_passes,
                )

                diags = Diagnostics()
                run_trace_passes(
                    load_parsed_trace(self.trace_root / entry.name),
                    diags, lenient=True,
                )
                entry.trace_diags = diags
            return entry.trace_diags

    # -- inline HLO ----------------------------------------------------------

    def get_inline(self, hlo_text: str, num_devices: int = 1) -> RegistryEntry:
        """A single-module pod built from raw HLO text, cached under its
        content hash (keyed with ``num_devices``: the same program on a
        different pod size is a different replay).  Parse errors
        propagate as ``ValueError`` — the HTTP layer maps them to 400."""
        digest = hashlib.sha256(hlo_text.encode()).hexdigest()[:24]
        key = f"{digest}|n{int(num_devices)}"
        with self._lock:
            entry = self._inline.get(key)
        if entry is not None:
            return entry
        from tpusim_torch.trace.hlo_text import parse_hlo_module

        mod = parse_hlo_module(hlo_text, "inline")
        if not mod.computations:
            # the lenient scanners skip lines they cannot read; text
            # that yields NO program is a client error, not a pod
            raise ValueError("no HLO computations parsed from hlo_text")
        # the text hash doubles as the perf-cache module fingerprint —
        # same slot load_trace stamps from the on-disk bytes
        mod.meta.setdefault("content_hash", digest)
        pod = PodTrace(meta={"num_devices": int(num_devices)})
        pod.modules["inline"] = mod
        # one launch per device, mirroring load_trace's
        # modules-without-commandlist path at pod scale
        for dev in range(max(int(num_devices), 1)):
            pod.device(dev).commands.append(
                TraceCommand(
                    kind=CommandKind.KERNEL_LAUNCH, module="inline",
                    device_id=dev,
                )
            )
        entry = RegistryEntry(name=f"inline:{digest}", pod=pod)
        with self._lock:
            self._inline.setdefault(key, entry)
            while len(self._inline) > MAX_INLINE_ENTRIES:
                self._inline.pop(next(iter(self._inline)))
            entry = self._inline[key] if key in self._inline else entry
        return entry

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        with self._lock:
            return {
                "traces_hot": len(self._entries),
                "inline_hot": len(self._inline),
            }

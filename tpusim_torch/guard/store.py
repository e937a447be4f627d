"""Bounded durable stores — quota, GC and integrity for the disk caches.

Port of ``tpusim/guard/store.py``.  The result cache's JSON records and
the compile store's ``.cmod`` records share one directory; this module is
its governance side: scan a store, garbage-collect it down to a byte or
count quota, verify record integrity (quarantining what fails), or clear
it.  The caches stay the data plane (:class:`~tpusim_torch.perf.cache.
ResultCache` and :class:`~tpusim_torch.fastpath.store.CompileStore` call
:func:`gc_store` after quota-crossing writes); the ``cache`` subcommand
calls the rest.

Concurrency contract (many processes may share one directory):

* every mutation is a **whole-record** operation — ``os.replace`` into
  the quarantine dir or ``os.unlink`` — so a reader never sees a torn
  record, only a present or an absent one;
* every delete tolerates having lost the race (``FileNotFoundError``
  passes): two processes collecting the same store both converge;
* eviction order is LRU by mtime — the caches touch a record's mtime on
  use, so "oldest mtime" is "least recently used", and the record a
  writer just published is the newest;
* ``*.tmp`` staging files are reaped only once they are demonstrably
  abandoned (older than :data:`TMP_MAX_AGE_S`), never while a live
  writer may still publish them.

Records of the JAX package and of the port may share a directory: each
stamps its own ``model_version``, so either package's :func:`verify_store`
counts the other's records as stale and leaves them in place.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "GCResult",
    "QUARANTINE_DIR",
    "QuotaEstimate",
    "RECORD_PATTERNS",
    "StoreStats",
    "VerifyResult",
    "clear_store",
    "format_size",
    "gc_store",
    "parse_size",
    "quarantine_record",
    "scan_store",
    "store_bytes",
    "verify_store",
]

#: subdirectory (inside the store) where corrupt/stale-format records
#: are moved — off the lookup path, preserved for post-mortems, cleared
#: by ``cache clear``
QUARANTINE_DIR = "quarantine"

#: a ``*.tmp`` staging file older than this is an abandoned write (the
#: publisher crashed between create and rename) and is reclaimed by GC
TMP_MAX_AGE_S = 3600.0

_UNITS = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(text: str | int | float | None) -> int | None:
    """``"512M"`` / ``"2G"`` / ``"65536"`` → bytes (None passes
    through).  Raises ``ValueError`` on nonsense — a quota typo must
    refuse loudly, not bound nothing."""
    if text is None:
        return None
    if isinstance(text, (int, float)):
        value = int(text)
    else:
        s = str(text).strip().lower()
        if s.endswith("b"):
            s = s[:-1]
        unit = s[-1] if s and s[-1] in _UNITS else ""
        num = s[: len(s) - len(unit)] if unit else s
        try:
            value = int(float(num) * _UNITS[unit])
        except (ValueError, KeyError):
            raise ValueError(f"cannot parse size {text!r} (want e.g. 512M, 2G)")
    if value <= 0:
        raise ValueError(f"size must be positive, got {text!r}")
    return value


def format_size(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(nbytes) < 1024.0 or unit == "TiB":
            return (f"{nbytes:.0f}{unit}" if unit == "B"
                    else f"{nbytes:.1f}{unit}")
        nbytes /= 1024.0
    return f"{nbytes:.1f}TiB"  # pragma: no cover - unreachable


#: the store's record tiers: engine-result records (JSON) and
#: compiled-module records (the fastpath's durable tier, binary .cmod).
#: One directory, one quota, one GC — eviction is whole-record and
#: tier-blind (mtime LRU ranks a cold compiled module against a cold
#: result on equal footing; both rebuild from a recompute)
RECORD_PATTERNS = ("*.json", "*.cmod")


def _record_paths(directory: Path) -> list[Path]:
    try:
        out: list[Path] = []
        for pattern in RECORD_PATTERNS:
            out.extend(directory.glob(pattern))
        return sorted(out)
    except OSError:
        return []


def store_bytes(directory: str | Path) -> int:
    """Total bytes of the store's records (quarantine + tmp excluded —
    the quota governs the *servable* tier)."""
    total = 0
    for p in _record_paths(Path(directory)):
        try:
            total += p.stat().st_size
        except OSError:
            pass  # lost a race with a concurrent delete
    return total


@dataclass
class StoreStats:
    """``cache stats`` — one scan's summary, split by tier
    (engine-result records vs compiled-module records)."""

    directory: str
    entries: int = 0
    bytes: int = 0
    result_entries: int = 0
    result_bytes: int = 0
    compiled_entries: int = 0
    compiled_bytes: int = 0
    quarantined: int = 0
    tmp_files: int = 0
    model_versions: dict[str, int] = field(default_factory=dict)
    oldest_age_s: float | None = None

    def lines(self) -> list[str]:
        out = [
            f"store: {self.directory}",
            f"  entries: {self.entries} ({format_size(self.bytes)})",
            f"    results:  {self.result_entries} "
            f"({format_size(self.result_bytes)})",
            f"    compiled: {self.compiled_entries} "
            f"({format_size(self.compiled_bytes)})",
            f"  quarantined: {self.quarantined}",
            f"  staging tmp files: {self.tmp_files}",
        ]
        if self.oldest_age_s is not None:
            out.append(f"  oldest record: {self.oldest_age_s:.0f}s ago")
        for mv, n in sorted(self.model_versions.items()):
            out.append(f"  model_version {mv}: {n} record(s)")
        return out


def _record_model_version(p: Path) -> str:
    """Best-effort model_version of one record, either tier."""
    try:
        if p.suffix == ".cmod":
            from tpusim_torch.fastpath.store import read_record_header

            return str(read_record_header(p).get("model_version", "?"))
        return str(json.loads(p.read_text()).get("model_version", "?"))
    except (OSError, ValueError, json.JSONDecodeError, AttributeError):
        return "<unreadable>"


def scan_store(directory: str | Path) -> StoreStats:
    d = Path(directory)
    stats = StoreStats(directory=str(d))
    now = time.time()
    for p in _record_paths(d):
        try:
            st = p.stat()
        except OSError:
            continue
        stats.entries += 1
        stats.bytes += st.st_size
        if p.suffix == ".cmod":
            stats.compiled_entries += 1
            stats.compiled_bytes += st.st_size
        else:
            stats.result_entries += 1
            stats.result_bytes += st.st_size
        age = now - st.st_mtime
        if stats.oldest_age_s is None or age > stats.oldest_age_s:
            stats.oldest_age_s = age
        mv = _record_model_version(p)
        stats.model_versions[mv] = stats.model_versions.get(mv, 0) + 1
    qdir = d / QUARANTINE_DIR
    if qdir.is_dir():
        stats.quarantined = sum(1 for _ in qdir.iterdir())
    stats.tmp_files = len(list(d.glob("*.tmp")))
    return stats


def quarantine_record(path: Path) -> bool:
    """Move one bad record into the store's quarantine dir (atomic
    rename; a pid suffix keeps two processes quarantining the same
    record from colliding).  Returns False when the record was already
    gone — someone else quarantined or deleted it first, which is the
    same outcome."""
    path = Path(path)
    qdir = path.parent / QUARANTINE_DIR
    try:
        qdir.mkdir(parents=True, exist_ok=True)
        # lint-allow: TL352 quarantine MOVE of an existing record, not
        # a staged publish — losing it to a crash re-quarantines later
        os.replace(path, qdir / f"{path.name}.{os.getpid()}")
        return True
    except FileNotFoundError:
        return False
    except OSError:
        # quarantine dir unwritable: deleting still heals the lookup
        # path, which is the part that matters
        try:
            path.unlink()
            return True
        except OSError:
            return False


@dataclass
class GCResult:
    deleted: int = 0
    freed_bytes: int = 0
    tmp_reaped: int = 0
    remaining_entries: int = 0
    remaining_bytes: int = 0


def gc_store(
    directory: str | Path,
    quota_bytes: int | None = None,
    max_entries: int | None = None,
) -> GCResult:
    """Delete least-recently-used whole records until the store fits
    ``quota_bytes`` / ``max_entries`` (whichever bounds are given), and
    reap abandoned ``*.tmp`` staging files.  Safe to run from any
    number of processes concurrently — see the module docstring."""
    d = Path(directory)
    res = GCResult()
    now = time.time()
    for tmp in d.glob("*.tmp"):
        try:
            if now - tmp.stat().st_mtime > TMP_MAX_AGE_S:
                tmp.unlink()
                res.tmp_reaped += 1
        except OSError:
            pass
    entries: list[tuple[float, int, Path]] = []
    for p in _record_paths(d):
        try:
            st = p.stat()
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
    entries.sort()  # oldest mtime first = least recently used first
    total = sum(size for _, size, _ in entries)
    count = len(entries)
    idx = 0
    while idx < count and (
        (quota_bytes is not None and total > quota_bytes)
        or (max_entries is not None and count - res.deleted > max_entries)
    ):
        _, size, path = entries[idx]
        idx += 1
        try:
            path.unlink()
        except FileNotFoundError:
            total -= size  # a peer already freed it
            continue
        except OSError:
            continue
        res.deleted += 1
        res.freed_bytes += size
        total -= size
    res.remaining_entries = count - idx
    res.remaining_bytes = max(total, 0)
    return res


class QuotaEstimate:
    """One writer's running estimate of a store directory's size, and the
    quota enforcement after each of its publishes (the result cache and
    the compile store each own one).

    The estimate seeds from a scan of every record (the quota governs the
    whole directory, result and compiled records together), then moves by
    each own publish as a delta against the bytes the key held before (an
    overwrite replaces bytes, it does not add them).  When it crosses the
    quota, :func:`gc_store` runs and the estimate resets to its
    authoritative remainder, so drift from peers' puts is bounded by one
    quota excursion."""

    def __init__(self) -> None:
        self.bytes: int | None = None
        self.entries = 0
        self._lock = threading.Lock()

    def publish(
        self, directory: Path, new_path: Path, old_size: int,
        quota_bytes: int | None, quota_entries: int | None,
    ) -> GCResult | None:
        """Account the record just published at ``new_path``; returns the
        GC's result when this publish crossed the quota, else None."""
        try:
            size = new_path.stat().st_size
        except OSError:
            size = 0
        with self._lock:
            if self.bytes is None:
                self.bytes = self.entries = 0
                for p in _record_paths(directory):
                    try:
                        self.bytes += p.stat().st_size
                        self.entries += 1
                    except OSError:
                        pass
            else:
                self.bytes += size - old_size
                if old_size == 0:
                    self.entries += 1
            over = (
                (quota_bytes is not None and self.bytes > quota_bytes)
                or (quota_entries is not None
                    and self.entries > quota_entries)
            )
        if not over:
            return None
        res = gc_store(directory, quota_bytes=quota_bytes,
                       max_entries=quota_entries)
        with self._lock:
            self.bytes = res.remaining_bytes
            self.entries = res.remaining_entries
        return res


@dataclass
class VerifyResult:
    checked: int = 0
    ok: int = 0
    compiled_checked: int = 0
    quarantined_corrupt: int = 0
    quarantined_stale_format: int = 0
    stale_model: int = 0

    def lines(self) -> list[str]:
        return [
            f"  checked: {self.checked} "
            f"({self.compiled_checked} compiled-tier)",
            f"  ok: {self.ok}",
            f"  quarantined (corrupt): {self.quarantined_corrupt}",
            f"  quarantined (stale format): "
            f"{self.quarantined_stale_format}",
            f"  stale model_version (evictable, left in place): "
            f"{self.stale_model}",
        ]


def verify_store(
    directory: str | Path, model_version: str | None = None,
) -> VerifyResult:
    """The startup integrity sweep: parse every record — engine-result
    (``.json``) and compiled-module (``.cmod``) tiers alike — and
    quarantine anything corrupt (unparsable, wrong shape, key/hash
    mismatch, truncated column blob) or in a stale format version.
    Records from an older *model* version are well-formed and merely
    unreachable (the model version is baked into every lookup key), so
    they are counted but left for GC to age out.

    ``model_version`` defaults to the port's live composite stamp
    (timing model + parser); pass ``""`` to skip the staleness count
    entirely."""
    from tpusim_torch.fastpath.store import (
        COMPILE_STORE_FORMAT_VERSION, read_record_header,
    )
    from tpusim_torch.perf.cache import CACHE_FORMAT_VERSION, parser_version
    from tpusim_torch.timing.model_version import model_version as _live_mv

    if model_version is None:
        model_version = f"{_live_mv()}+{parser_version()}"

    d = Path(directory)
    res = VerifyResult()
    for p in _record_paths(d):
        res.checked += 1
        compiled = p.suffix == ".cmod"
        if compiled:
            res.compiled_checked += 1
        try:
            if compiled:
                doc = read_record_header(p)
                fmt_ok = (
                    doc.get("format_version")
                    == COMPILE_STORE_FORMAT_VERSION
                )
            else:
                doc = json.loads(p.read_text())
                if not isinstance(doc, dict):
                    raise ValueError("record is not an object")
                fmt_ok = doc.get("format_version") == CACHE_FORMAT_VERSION
            if not fmt_ok:
                if quarantine_record(p):
                    res.quarantined_stale_format += 1
                continue
            for key in ("key", "model_version"):
                if key not in doc:
                    raise ValueError(f"record missing {key!r}")
            if not compiled and not isinstance(doc.get("result"), dict):
                raise ValueError("result is not an object")
        except FileNotFoundError:
            res.checked -= 1  # raced a concurrent delete: not ours
            if compiled:
                res.compiled_checked -= 1
            continue
        except (ValueError, json.JSONDecodeError, OSError, TypeError):
            if quarantine_record(p):
                res.quarantined_corrupt += 1
            continue
        if model_version and doc["model_version"] != model_version:
            res.stale_model += 1
        res.ok += 1
    return res


def clear_store(directory: str | Path) -> int:
    """Delete every record, staging file, and quarantined record.
    Returns the number of files removed."""
    d = Path(directory)
    removed = 0
    for pattern in (*RECORD_PATTERNS, "*.tmp"):
        for p in d.glob(pattern):
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
    qdir = d / QUARANTINE_DIR
    if qdir.is_dir():
        for p in qdir.iterdir():
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
        try:
            qdir.rmdir()
        except OSError:
            pass
    return removed

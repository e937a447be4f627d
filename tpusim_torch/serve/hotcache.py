"""Shared mmap hot-response cache — the lock-free warm path (port of
``tpusim/serve/hotcache.py``).

For 100%-cache-hit traffic the per-request cost is HTTP parse +
admission + dispatch + a result-cache lookup + JSON re-serialization,
all under one GIL.  This module removes everything after the parse: the **final serialized
response body** (the exact ``ok_bytes`` envelope a worker would produce)
is published once into an append-only shared segment, and every later
identical request is answered straight from an ``mmap`` of that segment
— no pickling, no dispatch, no re-pricing, no admission slot.  N
acceptor processes share one cache directory; any of them can publish,
all of them read.

Design (one writer discipline, lock-free readers):

* **segment** (``seg-<generation>[-<epoch>].dat``) — append-only raw
  response bytes.  Writers append under an ``flock`` on a sidecar lock
  file; the body is flushed and fsync'd BEFORE the index names it, so an
  index entry always points at fully-durable bytes.
* **index** (``index-<generation>.json``) — ``key -> [offset, length]``
  plus the segment name, published atomically (temp + ``os.replace``).
  Readers reload it only when its ``stat`` changes (one ~1µs stat per
  lookup) and remap the segment only when an entry points past the
  currently-mapped size.  Reads take NO file lock ever: the atomic
  rename is the publication barrier.
* **generation** — a fingerprint of everything that could silently
  change what a cached body means (model_version, the serve format
  version, the tuned-overlay directory state) baked into the file
  names: a model bump orphans the old files instead of serving stale
  bytes.  Init best-effort unlinks other generations.
* **quota** — when an append would push the segment past
  ``quota_bytes``, the writer rotates to a fresh epoch segment with an
  empty index (an epoch flush, not an LRU: hot entries repopulate in
  one request each, and whole-file reclaim is the only operation that
  cannot fragment an append-only file).

Returned values are :class:`memoryview` slices of the mapping — the
HTTP layer writes them to the socket without an intermediate copy.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import mmap
import os
import threading
from pathlib import Path

__all__ = ["HotResponseCache", "hot_generation"]

#: segment size ceiling by default — warm response bodies are ~10 KB, so
#: this holds thousands of distinct hot requests before an epoch flush
DEFAULT_QUOTA_BYTES = 64 * 1024 * 1024

#: a single body larger than this fraction of the quota never publishes
#: (one pathological response must not monopolize the segment)
MAX_ENTRY_FRACTION = 8


def _append_segment(seg_path: Path, body: bytes) -> int:
    """Append one body to the segment, fsync'd; returns its offset
    (the injection seam the ENOSPC regression tests monkeypatch)."""
    with open(seg_path, "ab") as seg:
        offset = seg.tell()
        seg.write(body)
        seg.flush()
        os.fsync(seg.fileno())
    return offset


def hot_generation(model_version: str, format_version: int) -> str:
    """The cache generation fingerprint: everything that could change
    what a cached response body MEANS without changing the request
    body.  The tuned-overlay directory joins because ``tuned: true``
    requests compose whatever flags files are on disk at serve time —
    a refreshed fit must orphan responses priced under the old one."""
    parts = [str(model_version), str(int(format_version))]
    tuned_dir = os.environ.get("TPUSIM_TUNED_DIR")
    if tuned_dir:
        try:
            entries = []
            for p in sorted(Path(tuned_dir).glob("*.flags")):
                st = p.stat()
                entries.append(f"{p.name}:{st.st_size}:{st.st_mtime_ns}")
            parts.append(";".join(entries))
        except OSError:
            parts.append("unreadable")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


class HotResponseCache:
    """One hot-response store under ``directory``, shared by every
    acceptor process that mounts the same path with the same
    generation."""

    def __init__(
        self,
        directory: str | Path,
        generation: str,
        quota_bytes: int = DEFAULT_QUOTA_BYTES,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.generation = str(generation)
        self.quota_bytes = max(int(quota_bytes), 1 << 16)
        self._lock_path = self.dir / "lock"
        self._idx_path = self.dir / f"index-{self.generation}.json"
        # reader state (in-process only; cross-process readers each hold
        # their own and converge via the index stat)
        self._mu = threading.Lock()
        self._entries: dict[str, tuple[int, int]] = {}
        self._segment: str | None = None
        self._idx_stat: tuple[int, int] | None = None
        self._mm: mmap.mmap | None = None
        self._mm_size = 0
        self._mm_segment: str | None = None
        # counters (mirrored on /metrics as serve_hot_*)
        self.hits = 0
        self.misses = 0
        self.publishes = 0
        self.rotations = 0
        # ENOSPC/EIO graceful degradation: a medium-level failure on
        # the publish path disables further publishes for this
        # instance (one warning ever); the read path keeps serving
        # whatever the index already names
        self._publish_disabled = False
        self._reap_other_generations()

    # -- maintenance ---------------------------------------------------------

    def _reap_other_generations(self) -> None:
        """Best-effort unlink of files from older generations — a model
        bump must not leave the previous model's responses on disk
        forever.  Racing peers converge: a lost unlink race is a no-op."""
        for p in self.dir.glob("seg-*.dat"):
            if not p.name.startswith(f"seg-{self.generation}"):
                try:
                    p.unlink()
                except OSError:
                    pass
        for p in self.dir.glob("index-*.json"):
            if p != self._idx_path:
                try:
                    p.unlink()
                except OSError:
                    pass

    # -- write path ----------------------------------------------------------

    def publish(self, key: str, body: bytes) -> bool:
        """Publish one final response body under ``key``.  Serialized
        across processes by an ``flock``; a key a peer already published
        is left alone (first writer wins — both produced byte-identical
        bodies by the serving contract).  Returns True when this call
        made the entry visible."""
        body = bytes(body)
        if self._publish_disabled:
            return False
        if len(body) > self.quota_bytes // MAX_ENTRY_FRACTION:
            return False
        try:
            with open(self._lock_path, "a+b") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                doc = self._read_index_doc()
                entries = doc.get("entries", {})
                if key in entries:
                    return False
                segment = doc.get("segment") \
                    or f"seg-{self.generation}.dat"
                seg_path = self.dir / segment
                size = seg_path.stat().st_size if seg_path.exists() else 0
                if size + len(body) > self.quota_bytes:
                    # epoch flush: a fresh segment + empty index.
                    # Readers follow the index's segment name; the
                    # orphaned file is unlinked (their open mmaps stay
                    # valid until replaced)
                    self.rotations += 1
                    epoch = int(doc.get("epoch", 0)) + 1
                    try:
                        seg_path.unlink()
                    except OSError:
                        pass
                    segment = f"seg-{self.generation}-{epoch}.dat"
                    seg_path = self.dir / segment
                    entries = {}
                    doc["epoch"] = epoch
                    size = 0
                offset = _append_segment(seg_path, body)
                entries[key] = [offset, len(body)]
                doc.update({
                    "format": 1,
                    "generation": self.generation,
                    "segment": segment,
                    "entries": entries,
                })
                tmp = self._idx_path.with_suffix(f".tmp.{os.getpid()}")
                tmp.write_text(json.dumps(doc, sort_keys=True))
                os.replace(tmp, self._idx_path)
        except OSError as e:
            from tpusim_torch.perf.cache import fatal_write_disable

            if fatal_write_disable(
                e,
                f"tpusim_torch.serve: hot-response publish failed under "
                f"{self.dir} ({e}); disabling further hot "
                f"publishes for this instance (reads continue)",
            ):
                self._publish_disabled = True
                return False
            raise  # transient: the daemon counts it and carries on
        self.publishes += 1
        return True

    def _read_index_doc(self) -> dict:
        try:
            doc = json.loads(self._idx_path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}
        if doc.get("generation") != self.generation:
            return {}
        return doc

    # -- read path -----------------------------------------------------------

    def _refresh_index(self) -> None:
        """Reload the index iff its stat moved (caller holds _mu)."""
        try:
            st = self._idx_path.stat()
            stat_sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._entries, self._segment, self._idx_stat = {}, None, None
            return
        if stat_sig == self._idx_stat:
            return
        doc = self._read_index_doc()
        self._entries = {
            k: (int(v[0]), int(v[1]))
            for k, v in (doc.get("entries") or {}).items()
        }
        self._segment = doc.get("segment")
        self._idx_stat = stat_sig

    def _map_for(self, offset: int, length: int) -> mmap.mmap | None:
        """The segment mapping, remapped when the entry points past the
        current map (the segment grew) or the segment rotated (caller
        holds _mu).  Old maps are dropped, never closed — outstanding
        memoryviews keep them alive until the last reader finishes."""
        need = offset + length
        if (
            self._mm is not None
            and self._mm_segment == self._segment
            and self._mm_size >= need
        ):
            return self._mm
        if self._segment is None:
            return None
        try:
            with open(self.dir / self._segment, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < need:
                    return None  # index ahead of visible data: miss
                self._mm = mmap.mmap(
                    f.fileno(), size, prot=mmap.PROT_READ,
                )
                self._mm_size = size
                self._mm_segment = self._segment
        except (OSError, ValueError):
            return None
        return self._mm

    def get(self, key: str) -> memoryview | None:
        """The published body for ``key``, or None.  Lock-free across
        processes: one stat, at most one index reload, a slice of the
        mapping — no flock, no pickling, no dispatch."""
        with self._mu:
            self._refresh_index()
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            offset, length = entry
            mm = self._map_for(offset, length)
            if mm is None:
                self.misses += 1
                return None
            self.hits += 1
            return memoryview(mm)[offset:offset + length]

    def __contains__(self, key: str) -> bool:
        with self._mu:
            self._refresh_index()
            return key in self._entries

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        with self._mu:
            seg_bytes = 0
            if self._segment is not None:
                try:
                    seg_bytes = (self.dir / self._segment).stat().st_size
                except OSError:
                    pass
            return {
                "hot_hits_total": float(self.hits),
                "hot_misses_total": float(self.misses),
                "hot_publishes_total": float(self.publishes),
                "hot_rotations_total": float(self.rotations),
                "hot_entries": float(len(self._entries)),
                "hot_segment_bytes": float(seg_bytes),
            }

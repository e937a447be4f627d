"""Content-addressed caches of the port's pricing.

Port of ``tpusim/perf/cache.py``, in two tiers of its own:

* the **result cache** (:class:`ResultCache`, :class:`CachedEngine`):
  one priced :class:`~tpusim_torch.timing.engine.EngineResult` per key

      (module fingerprint, capture platform, config fingerprint, arch,
       model + parser version, (clock_scale, hbm_scale) [, topology sig])

  where the topology part joins only for modules that contain collective
  ops — a collective-free kernel prices identically on any pod, faulted
  or not, which is why a link sweep prices the healthy-kernel class once.
  An LRU in memory, and on request (``--result-cache[=DIR]``, default
  ``.tpusim_cache/``) JSON records on disk, written atomically (temp +
  ``os.replace``); a corrupt record is moved aside into ``quarantine/``
  and recomputed with one warning.  Under a quota (``--cache-quota``)
  each publish that crosses it runs the LRU garbage collection of
  :mod:`tpusim_torch.guard.store` over the whole store directory.  A
  hit returns the exact float-for-float result the engine would have
  produced (JSON's shortest-repr floats round-trip every counter), so
  cached replays reproduce stats byte for byte.
* the **compiled-module tier** of the pricing fastpath: the process-wide
  LRU of :class:`~tpusim_torch.fastpath.compile.CompiledModule`
  instances keyed on

      (module fingerprint, capture platform, config fingerprint,
       model + parser version)

  Scales and topology are deliberately absent from this key: compiled
  columns hold healthy per-op costs and launch-class transforms apply at
  price time, so every degraded class of a module shares one compile.
  When a durable compile store is active
  (:mod:`tpusim_torch.fastpath.store`, ``--compile-cache``), the tier
  consults it before any compile.

Keys hash the port's own sources (:func:`parser_version`, and
``model_version`` over its timing model), so the port and the JAX package
never read each other's records, even in one cache directory.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import threading
import warnings
from collections import OrderedDict, defaultdict
from pathlib import Path

from tpusim_torch.obs.hub import NULL_OBS
from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.engine import Engine, EngineResult
from tpusim_torch.timing.model_version import model_version

__all__ = [
    "CACHE_FORMAT_VERSION",
    "CachedEngine",
    "DEFAULT_CACHE_DIR",
    "ResultCache",
    "as_result_cache",
    "clear_compiled_cache",
    "compiled_cache_stats",
    "compiled_for",
    "compiled_key_str",
    "config_fingerprint",
    "module_fingerprint",
    "module_uses_ici",
    "parser_version",
    "result_from_doc",
    "result_to_doc",
    "set_compiled_cache_max",
    "topology_signature",
]

CACHE_FORMAT_VERSION = 1

#: the ``--result-cache`` flag's bare form resolves here (cwd-relative)
DEFAULT_CACHE_DIR = ".tpusim_cache"

_REPO = Path(__file__).resolve().parents[2]

#: sources outside the timing model that still decide how hashed module
#: text prices: the IR and the parsers that build it, and the fastpath
#: itself (byte-identical to the engine by contract, but a contract is
#: not a key: an edit that shifts compiled pricing must orphan old
#: compiled columns).  These are the port's own files.
_PARSER_FILES: tuple[str, ...] = (
    "tpusim_torch/ir.py",
    "tpusim_torch/trace/hlo_text.py",
    "tpusim_torch/trace/lazy.py",
    "tpusim_torch/trace/loop_analysis.py",
    "tpusim_torch/trace/format.py",
    "tpusim_torch/fastpath/compile.py",
    "tpusim_torch/fastpath/price.py",
    "tpusim_torch/fastpath/batch.py",
    "tpusim_torch/kernels/scan_rows.py",
    "tpusim_torch/csrc/scan_rows.cu",
    "tpusim_torch/csrc/ptx.cuh",
)

_parser_version_cache: str | None = None


def parser_version() -> str:
    """Digest of the IR/parser/fastpath sources (computed once per
    process)."""
    global _parser_version_cache
    if _parser_version_cache is None:
        h = hashlib.sha256()
        for rel in _PARSER_FILES:
            p = _REPO / rel
            h.update(rel.encode())
            h.update(b"\0")
            h.update(p.read_bytes() if p.is_file() else b"")
            h.update(b"\0")
        _parser_version_cache = h.hexdigest()[:16]
    return _parser_version_cache


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:24]


#: OSError errnos that mean the disk tier's medium is gone (full, failing,
#: or read-only) — one more write will not fare better, so the cache
#: disables its write path for the instance's lifetime instead of warning
#: on every put
FATAL_WRITE_ERRNOS = frozenset({
    errno.ENOSPC, errno.EDQUOT, errno.EIO, errno.EROFS,
})


def fatal_write_disable(exc: OSError, message: str) -> bool:
    """When ``exc`` is a medium-level failure, emit the single disable
    warning (``message``) and return True — the caller sets its instance
    flag and stops writing.  Non-fatal errnos return False and the caller
    keeps writing."""
    if exc.errno not in FATAL_WRITE_ERRNOS:
        return False
    warnings.warn(message, RuntimeWarning, stacklevel=3)
    return True


def _fsync(path: Path) -> None:
    """Flush a staged file's blocks (or a directory's entries) to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _stage_write(tmp: Path, text: str) -> None:
    """Stage one record's bytes to its temp file (the seam a test of the
    full-disk path replaces)."""
    with open(tmp, "w") as f:
        f.write(text)


def module_fingerprint(module) -> str | None:
    """Content digest of one module.

    ``load_trace`` stamps ``meta["content_hash"]`` from the module text;
    lazy modules hash their raw text (fingerprinting must not force a
    parse); modules built in memory fall back to a structural walk over
    their ops.  Returns None when no stable fingerprint exists (the
    shared tier is then skipped for that module, never wrong)."""
    cached = getattr(module, "_fingerprint_cache", None)
    if cached is not None:
        return cached
    fp = None
    content = module.meta.get("content_hash") if module.meta else None
    if content:
        fp = str(content)
    else:
        text = getattr(module, "_text", None)  # LazyModuleTrace
        if isinstance(text, str):
            fp = _sha(text)
        else:
            try:
                fp = _structural_fingerprint(module)
            except (AttributeError, TypeError):
                fp = None
    try:
        module._fingerprint_cache = fp
    except (AttributeError, TypeError):
        pass
    return fp


def _structural_fingerprint(module) -> str:
    h = hashlib.sha256()
    h.update(module.name.encode())
    for cname in sorted(module.computations):
        comp = module.computations[cname]
        h.update(b"\0c")
        h.update(cname.encode())
        for op in comp.ops:
            h.update(b"\0o")
            h.update(
                f"{op.name}|{op.opcode}|{op.result}|{op.operands}|"
                f"{sorted(op.attrs.items()) if op.attrs else ''}".encode()
            )
    return h.hexdigest()[:24]


def config_fingerprint(config: SimConfig) -> str:
    """Digest of the fully composed config (frozen dataclasses serialize
    deterministically), memoized on the instance."""
    cached = config.__dict__.get("_fingerprint_memo")
    if cached is not None:
        return cached
    doc = dataclasses.asdict(config)
    fp = _sha(json.dumps(doc, sort_keys=True, default=str))
    object.__setattr__(config, "_fingerprint_memo", fp)
    return fp


def topology_signature(topo) -> str | None:
    """Stable signature of a (possibly faulted) topology, or None when
    the attached fault view cannot be fingerprinted."""
    if topo is None:
        return "none"
    sig = f"{topo.dims}|{topo.wrap}"
    faults = getattr(topo, "faults", None)
    if faults is not None:
        fsig = getattr(faults, "signature", None)
        if fsig is None:
            return None
        sig += f"|f{fsig}"
    return sig


#: collective base opcodes whose presence makes a module's price
#: topology-dependent; used for the cheap raw-text scan of lazy modules
_COLLECTIVE_MARKERS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)


def module_uses_ici(module) -> bool:
    """Does pricing this module consult the topology (any collective op)?
    Memoized on the module (it is not mutated after parse).

    Conservative for lazy modules: a raw-text marker scan may over-match
    (a comment mentioning ``all-reduce``), which only narrows cache
    sharing — it can never produce a wrong hit."""
    cached = getattr(module, "_uses_ici_cache", None)
    if cached is not None:
        return cached
    text = getattr(module, "_text", None)
    if isinstance(text, str):
        uses = any(m in text for m in _COLLECTIVE_MARKERS)
    else:
        uses = any(op.is_collective for op in module.all_ops())
    try:
        module._uses_ici_cache = uses
    except (AttributeError, TypeError):
        pass
    return uses


# ---------------------------------------------------------------------------
# EngineResult (de)serialization
# ---------------------------------------------------------------------------

#: dict-valued counter fields restored as defaultdict(float)
_FLOAT_MAP_FIELDS = (
    "unit_busy_cycles", "opcode_cycles", "per_op_cycles", "per_op_count",
    "per_op_hbm_bytes", "per_op_flops", "per_op_mxu_flops",
)
#: dict-valued fields restored as plain dicts
_PLAIN_MAP_FIELDS = ("per_op_opcode", "per_op_async")
#: run-scoped fields that are not part of a result's document
_UNDOCUMENTED_FIELDS = ("timeline", "samples")


def result_to_doc(result: EngineResult) -> dict:
    """JSON-safe document of one result: every counter field, in field
    order, dicts in insertion order."""
    doc: dict = {}
    for f in dataclasses.fields(EngineResult):
        if f.name in _UNDOCUMENTED_FIELDS:
            continue
        value = getattr(result, f.name)
        doc[f.name] = dict(value) if isinstance(value, dict) else value
    return doc


def result_from_doc(doc: dict) -> EngineResult:
    """The inverse of :func:`result_to_doc`; raises ValueError on a
    document whose fields are not exactly the result's."""
    expected = {
        f.name for f in dataclasses.fields(EngineResult)
        if f.name not in _UNDOCUMENTED_FIELDS
    }
    if set(doc) != expected:
        raise ValueError(
            f"cache record field mismatch: {sorted(set(doc) ^ expected)}"
        )
    result = EngineResult()
    for name, value in doc.items():
        if name in _FLOAT_MAP_FIELDS:
            value = defaultdict(float, value)
        elif name in _PLAIN_MAP_FIELDS:
            value = dict(value)
        setattr(result, name, value)
    return result


# ---------------------------------------------------------------------------
# The result cache
# ---------------------------------------------------------------------------


class ResultCache:
    """Two-tier content-addressed cache of engine results; see the module
    docstring.

    One instance may be shared across many drivers/engines (a sweep's
    per-link drivers all thread the same cache) — hit/miss counters are
    therefore cumulative over the instance's lifetime."""

    def __init__(
        self,
        disk_dir: str | Path | None = None,
        max_entries: int = 1024,
        quota_bytes: int | None = None,
        quota_entries: int | None = None,
        durable: bool = False,
        obs=None,
    ):
        self.disk_dir = Path(disk_dir) if disk_dir else None
        self.max_entries = max(int(max_entries), 1)
        # instrumentation hub (tpusim_torch.obs): ``cache.*`` counters and
        # a ``cache`` span around each disk read and write
        self.obs = obs if obs is not None else NULL_OBS
        # durable=True fsyncs each record (and its directory entry)
        # before the atomic publish: temp + os.replace already rules out
        # torn files; durability closes the host-crash window where the
        # rename survives but the data blocks do not
        self.durable = bool(durable)
        # byte/count quota on the disk tier.  None = unbounded (zero
        # added work, zero added stats keys).  With a quota, a put that
        # pushes the store's estimated size past it runs the crash-safe
        # LRU GC of tpusim_torch.guard.store (whole-record deletes by
        # mtime; hits touch mtime, so recency is usage, not write order)
        self.quota_bytes = int(quota_bytes) if quota_bytes else None
        self.quota_entries = int(quota_entries) if quota_entries else None
        from tpusim_torch.guard.store import QuotaEstimate

        self._quota = QuotaEstimate()
        self._mem: OrderedDict[str, EngineResult] = OrderedDict()
        # guards the LRU mutations (move_to_end racing an eviction would
        # KeyError), not the disk tier (atomic writes)
        self._lock = threading.Lock()
        # captured once: a key is a statement about the code that computed
        # the result, not about when it is read
        self._model_version = f"{model_version()}+{parser_version()}"
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0
        self.disk_errors = 0
        self.quarantined = 0
        self.gc_runs = 0
        self.gc_deleted = 0
        self.gc_freed_bytes = 0
        # the reference's memory watchdog shrinks the LRU and counts it
        # here; the port has no watchdog yet, so this stays 0
        self.lru_shrinks = 0
        # once a staging write fails with a medium-level errno, this
        # instance stops writing (one warning ever) and keeps serving from
        # memory and the records already on disk
        self._disk_write_disabled = False

    # -- keys ----------------------------------------------------------------

    def key_for(
        self,
        module,
        config: SimConfig,
        scales: tuple[float, float] = (1.0, 1.0),
        topology=None,
    ) -> str | None:
        """The content-addressed key, or None when this (module, run)
        cannot be cached safely."""
        mfp = module_fingerprint(module)
        if mfp is None:
            return None
        topo_part = "-"
        if module_uses_ici(module):
            topo = topology
            if topo is None:
                from tpusim_torch.ici.topology import torus_for

                topo = torus_for(module.num_devices, config.arch.name)
            topo_part = topology_signature(topo)
            if topo_part is None:
                return None
        # capture-time platform joins the key: the cost model normalizes
        # capture-backend dtypes on module.meta["platform"], so identical
        # HLO text captured on two platforms prices differently
        platform = str(module.meta.get("platform", "")) if module.meta \
            else ""
        key = "|".join((
            mfp,
            f"p={platform}",
            config_fingerprint(config),
            config.arch.name,
            self._model_version,
            f"{scales[0]!r},{scales[1]!r}",
            topo_part,
        ))
        if getattr(module, "stream_lean", False):
            # streaming-lean results carry no per-op aggregates; they
            # must never cross-serve a full-fidelity consumer
            key += "|lean"
        return key

    # -- lookup / insert -----------------------------------------------------

    def get(self, key: str) -> EngineResult | None:
        with self._lock:
            result = self._mem.get(key)
            if result is not None:
                self._mem.move_to_end(key)
                self.hits += 1
        if result is not None:
            if self.disk_dir is not None and self._governed():
                # under a quota, a memory hit is still use of the disk
                # record: without the touch, a record the LRU serves for
                # hours looks oldest to every peer's GC and dies first
                try:
                    os.utime(self._path_for(key))
                except OSError:
                    pass  # evicted by a peer / read-only: plain aging
            self.obs.counter_add("cache.hits")
            return result
        if self.disk_dir is not None:
            result = self._disk_get(key)
            if result is not None:
                self._mem_put(key, result)
                self.hits += 1
                self.disk_hits += 1
                self.obs.counter_add("cache.hits")
                self.obs.counter_add("cache.disk_hits")
                return result
        self.misses += 1
        self.obs.counter_add("cache.misses")
        return None

    def put(self, key: str, result: EngineResult) -> None:
        self._mem_put(key, result)
        if self.disk_dir is not None:
            self._disk_put(key, result)

    def _mem_put(self, key: str, result: EngineResult) -> None:
        evicted = 0
        with self._lock:
            self._mem[key] = result
            self._mem.move_to_end(key)
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)
                self.evictions += 1
                evicted += 1
        for _ in range(evicted):
            self.obs.counter_add("cache.evictions")

    # -- disk tier -----------------------------------------------------------

    def _path_for(self, key: str) -> Path:
        return self.disk_dir / f"{_sha(key)}.json"

    def _disk_get(self, key: str) -> EngineResult | None:
        path = self._path_for(key)
        if not path.is_file():
            return None
        with self.obs.span("cache"):
            return self._disk_read(key, path)

    def _disk_read(self, key: str, path: Path) -> EngineResult | None:
        try:
            doc = json.loads(path.read_text())
            if doc.get("format_version") != CACHE_FORMAT_VERSION:
                return None  # older layout: stale, not corrupt
            if doc.get("key") != key:
                raise ValueError("stored key mismatch (hash collision?)")
            if doc.get("model_version") != self._model_version:
                return None  # stale: model bumped under the same name
            result = result_from_doc(doc["result"])
            try:
                # LRU recency lives in the mtime: a disk hit refreshes it
                os.utime(path)
            except OSError:
                pass  # read-only store: GC order degrades to FIFO
            return result
        except FileNotFoundError:
            # replaced or quarantined by a peer between the existence
            # check and the read: a plain miss, never damage
            return None
        except (ValueError, KeyError, TypeError, OSError) as e:
            self.disk_errors += 1
            self.obs.counter_add("cache.disk_errors")
            # move the bad record off the lookup path on first detection,
            # so the recompute's put heals it and no later lookup warns
            from tpusim_torch.guard.store import quarantine_record

            if quarantine_record(path):
                self.quarantined += 1
            warnings.warn(
                f"tpusim_torch.perf: corrupt result-cache entry {path} "
                f"({type(e).__name__}: {e}); quarantined, recomputing",
                RuntimeWarning,
                stacklevel=2,
            )
            return None

    def _disk_put(self, key: str, result: EngineResult) -> None:
        if self._disk_write_disabled:
            return
        with self.obs.span("cache"):
            self._disk_write(key, result)

    def _disk_write(self, key: str, result: EngineResult) -> None:
        tmp = None
        try:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
            path = self._path_for(key)
            doc = {
                "format_version": CACHE_FORMAT_VERSION,
                "model_version": self._model_version,
                "key": key,
                "result": result_to_doc(result),
            }
            # pid AND thread ident: two threads or processes racing the
            # same cold key must not share a tmp file
            tmp = path.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp"
            )
            _stage_write(tmp, json.dumps(doc))
            if self.durable:
                _fsync(tmp)
            governed = self._governed()
            old_size = 0
            if governed:
                # an overwrite replaces bytes: the estimate takes the
                # delta, or re-puts of hot keys cross the quota early
                try:
                    old_size = path.stat().st_size
                except OSError:
                    old_size = 0
            os.replace(tmp, path)  # atomic: readers never see a torn file
            if self.durable:
                _fsync(self.disk_dir)
            if governed:
                self._quota_gc(path, old_size)
        except OSError as e:
            self.disk_errors += 1
            self.obs.counter_add("cache.disk_errors")
            if tmp is not None:
                try:
                    tmp.unlink()
                except OSError:
                    pass
            if fatal_write_disable(
                e,
                f"tpusim_torch.perf: result-cache write failed under "
                f"{self.disk_dir} ({e}); disabling further disk writes "
                f"for this cache instance (reads and in-memory caching "
                f"continue)",
            ):
                self._disk_write_disabled = True
                return
            warnings.warn(
                f"tpusim_torch.perf: result-cache write failed under "
                f"{self.disk_dir} ({e}); continuing uncached",
                RuntimeWarning,
                stacklevel=2,
            )

    # -- quota ---------------------------------------------------------------

    def _governed(self) -> bool:
        return self.quota_bytes is not None or self.quota_entries is not None

    def _quota_gc(self, new_path: Path, old_size: int) -> None:
        """Post-publish quota enforcement
        (:meth:`tpusim_torch.guard.store.QuotaEstimate.publish`), with the
        GC's work counted for the ``guard_*`` stats."""
        res = self._quota.publish(self.disk_dir, new_path, old_size,
                                  self.quota_bytes, self.quota_entries)
        if res is not None:
            with self._lock:
                self.gc_runs += 1
                self.gc_deleted += res.deleted
                self.gc_freed_bytes += res.freed_bytes

    def shrink(self, factor: float = 0.5, floor: int = 16) -> int:
        """Halve (by default) the in-memory LRU's entry budget and trim
        to it — the memory watchdog's first ladder step.  Cached results
        re-materialize from the disk tier or a recompute.  Returns the
        entries dropped."""
        dropped = 0
        with self._lock:
            self.max_entries = max(int(self.max_entries * factor), floor)
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)
                self.evictions += 1
                dropped += 1
            self.lru_shrinks += 1
        for _ in range(dropped):
            self.obs.counter_add("cache.evictions")
        return dropped

    def restore_entry_budget(self, max_entries: int) -> None:
        """Reverse :meth:`shrink` — the watchdog's recovery hook.  Only
        the budget comes back (entries refill on demand), so repeated
        transient excursions do not ratchet a long-lived daemon's L1
        down to the floor."""
        with self._lock:
            self.max_entries = max(int(max_entries), 1)

    def guard_stats_dict(self) -> dict[str, float]:
        """Quota/GC accounting, stamped by the driver under the
        ``guard_`` prefix only when a quota is set (un-governed runs
        stay key-identical)."""
        with self._lock:
            return {
                "store_quota_bytes": self.quota_bytes or 0,
                "store_quota_entries": self.quota_entries or 0,
                "store_bytes_est": self._quota.bytes or 0,
                "store_entries_est": self._quota.entries,
                "store_gc_runs_total": self.gc_runs,
                "store_gc_deleted_total": self.gc_deleted,
                "store_gc_freed_bytes_total": self.gc_freed_bytes,
                "store_quarantined_total": self.quarantined,
                "lru_shrinks_total": self.lru_shrinks,
            }

    def flush(self) -> int:
        """Ensure every in-memory entry has its disk record (no-op for
        memory-only caches).  Normal operation writes through at ``put``
        time; this heals records whose write failed transiently.  Returns
        the number of records written."""
        if self.disk_dir is None or self._disk_write_disabled:
            return 0
        with self._lock:
            items = list(self._mem.items())
        healed = 0
        for key, result in items:
            if self._disk_write_disabled:
                break
            if not self._path_for(key).is_file():
                self._disk_put(key, result)
                healed += 1
        return healed

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        """Counter block the driver stamps under the ``cache_`` prefix
        (only when a cache is active)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "disk_hits": self.disk_hits,
            "disk_errors": self.disk_errors,
            "entries": len(self._mem),
        }


def as_result_cache(spec, obs=None) -> ResultCache | None:
    """Coerce the ``--result-cache`` flag family to a cache instance:
    None/False → no cache; True → disk tier at :data:`DEFAULT_CACHE_DIR`;
    a path → disk tier there; an existing :class:`ResultCache` passes
    through (its obs hub is upgraded if it still has the no-op one)."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, ResultCache):
        if obs is not None and spec.obs is NULL_OBS:
            spec.obs = obs
        return spec
    if spec is True:
        return ResultCache(disk_dir=DEFAULT_CACHE_DIR, obs=obs)
    return ResultCache(disk_dir=spec, obs=obs)


# ---------------------------------------------------------------------------
# Compiled-module cache tier
# ---------------------------------------------------------------------------

#: process-wide LRU of CompiledModule instances (see the module docstring)
_COMPILED: OrderedDict = OrderedDict()
COMPILED_CACHE_MAX = 256
_compiled_hits = 0
_compiled_misses = 0
#: guards the LRU mutations (move_to_end racing an eviction corrupts an
#: OrderedDict), not compilation itself
_compiled_lock = threading.Lock()


def _compiled_key(module, config: SimConfig, lean: bool) -> tuple | None:
    mfp = module_fingerprint(module)
    if mfp is None:
        return None
    platform = str(module.meta.get("platform", "")) if module.meta else ""
    return (
        mfp, platform, config_fingerprint(config),
        f"{model_version()}+{parser_version()}", lean,
    )


def compiled_key_str(key: tuple) -> str:
    """The string form of a compiled-module key (its five components in
    order, the platform tagged, the lean flag spelled out)."""
    mfp, platform, cfg_fp, mv, lean = key
    return "|".join((
        mfp, f"p={platform}", cfg_fp, mv, "lean" if lean else "full",
    ))


def compiled_for(module, engine):
    """The fastpath's one compile per (module content, config): return a
    cached :class:`~tpusim_torch.fastpath.compile.CompiledModule` or mint
    one.  A streaming module (``stream_lean``) compiles lean, releasing
    each computation's IR once its columns exist."""
    global _compiled_hits, _compiled_misses
    from tpusim_torch.fastpath.compile import compile_module

    lean = bool(getattr(module, "stream_lean", False))
    key = _compiled_key(module, engine.config, lean)
    if key is None:
        # no stable fingerprint: pin to the module object so repeated
        # runs of it still compile once
        attr = getattr(module, "_fastpath_cm", None)
        ckey = (config_fingerprint(engine.config), lean)
        if isinstance(attr, dict) and ckey in attr:
            return attr[ckey]
        cm = compile_module(
            module, engine.cost, engine.config, lean=lean,
            release_ir=lean,
        )
        if not isinstance(attr, dict):
            attr = module._fastpath_cm = {}
        attr[ckey] = cm
        return cm

    from tpusim_torch.fastpath.store import get_compile_store

    store = get_compile_store()
    with _compiled_lock:
        cm = _COMPILED.get(key)
        if cm is not None:
            _COMPILED.move_to_end(key)
            _compiled_hits += 1
    if cm is not None:
        # the tier holds only a weak module ref; rebind the live object
        # (same content by key construction, so the columns transfer)
        cm.bind(module, engine.cost)
        if store is not None and cm._store_key is None:
            # a store activated after this instance was minted: adopt
            # it, so the columns publish at the next pricing walk
            cm._store_key = compiled_key_str(key)
        return cm
    if store is not None:
        # durable tier: map the columns a peer process (or an earlier
        # run) compiled — BEFORE any lazy compile, which is what lets a
        # warm store price a lazily-loaded module with zero IR built
        keystr = compiled_key_str(key)
        cm = store.load(keystr, module, engine)
        if cm is not None:
            cm._store_key = keystr
            with _compiled_lock:
                _COMPILED[key] = cm
                while len(_COMPILED) > COMPILED_CACHE_MAX:
                    _COMPILED.popitem(last=False)
            return cm
    cm = compile_module(
        module, engine.cost, engine.config, lean=lean, release_ir=lean,
    )
    if store is not None:
        cm._store_key = compiled_key_str(key)
    with _compiled_lock:
        _compiled_misses += 1
        _COMPILED[key] = cm
        while len(_COMPILED) > COMPILED_CACHE_MAX:
            _COMPILED.popitem(last=False)
    return cm


def clear_compiled_cache() -> int:
    """Drop the process-wide compiled-module tier (compiles are pure
    functions of content + config, rebuilt on demand).  Returns the
    entries dropped."""
    with _compiled_lock:
        n = len(_COMPILED)
        _COMPILED.clear()
    return n


def set_compiled_cache_max(max_entries: int) -> None:
    """Bound the compiled-module tier; trims immediately when lowered."""
    global COMPILED_CACHE_MAX
    COMPILED_CACHE_MAX = max(int(max_entries), 1)
    with _compiled_lock:
        while len(_COMPILED) > COMPILED_CACHE_MAX:
            _COMPILED.popitem(last=False)


def compiled_cache_stats() -> dict[str, float]:
    """Counters of the ``fastpath_`` stats block (stamped by the driver
    only when a pricing backend was explicitly requested or a durable
    compile store is active).  The ``store_*`` keys and ``ir_ops_built``
    ride only in the latter case."""
    out = {
        "compile_hits": _compiled_hits,
        "compile_misses": _compiled_misses,
        "compiled_modules": len(_COMPILED),
    }
    from tpusim_torch.fastpath.store import get_compile_store

    store = get_compile_store()
    if store is not None:
        out.update(store.stats_dict())
        # the cold-path contract's observable: the IR ops this process
        # has built (a warm store holds it at zero)
        from tpusim_torch.ir import ir_build_counter

        out["ir_ops_built"] = ir_build_counter["ops"]
    return out


# ---------------------------------------------------------------------------
# Engine wiring
# ---------------------------------------------------------------------------


class CachedEngine(Engine):
    """An :class:`Engine` whose ``run`` consults a :class:`ResultCache`.

    The cache engages only for runs whose result is pure counters: obs
    cycle-window sampling and timeline recording both attach run-scoped
    objects, so those runs always price live.  A ``result_cache`` of None
    makes this an exact Engine."""

    def __init__(self, *args, result_cache: ResultCache | None = None, **kw):
        super().__init__(*args, **kw)
        self.result_cache = result_cache

    def run(self, module) -> EngineResult:
        cache = self.result_cache
        if (
            cache is None
            or self.record_timeline
            or (self.obs.enabled and self.obs.sample)
        ):
            return super().run(module)
        key = cache.key_for(
            module, self.config,
            (self.clock_scale, self.hbm_scale),
            self.topology,
        )
        if key is None:
            return super().run(module)
        cached = cache.get(key)
        if cached is not None:
            return cached
        result = super().run(module)
        cache.put(key, result)
        return result

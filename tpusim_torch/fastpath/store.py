"""Durable compiled-module store — the fastpath's disk tier.

Port of ``tpusim/fastpath/store.py``.  The compile pass
(:mod:`tpusim_torch.fastpath.compile`) turns a module into float64
columns and a step program once per *process*; this module makes that
form durable, so a module compiles once per store.  Records live beside
the result cache's records in the same directory (``.cmod`` beside
``.json`` — one quota, one GC, one ``cache`` CLI) under the key the
in-memory compiled tier already uses::

    (module content fingerprint, capture platform,
     composed-config fingerprint, model + parser version, lean flag)

The version is the port's own (``model_version()+parser_version()`` over
the port's sources), so the port and the JAX package never load each
other's records, even in one directory: to each, the other's records are
well-formed and stale.

Record format (binary, one file per key; the JAX package's layout, field
for field)::

    TPUCMOD1 | u64 header_len | header JSON | pad to 8 | column blob

The header carries the step programs and identity tables as JSON; every
numeric array (the pricing columns and the run-step index tables) lives
in the blob as raw little-endian 8-byte lanes and is *mapped* on load:
each array becomes a CPU tensor over the mapping, contiguous and never
copied, so a process loading a record builds no IR and N processes
loading one record share the page cache.

Write discipline mirrors the result cache: staged to a ``(pid, thread)``
keyed temp file and published with ``os.replace``, so readers only ever
see whole records.  A corrupt or truncated record is quarantined on
first detection (:func:`tpusim_torch.guard.store.quarantine_record`)
with one warning and a recompile that heals the store; a record of
another version is a plain miss.  A write that fails with a medium-level
errno (full disk, I/O error) disables the instance's writes with one
warning.

Activation is process-wide (:func:`set_compile_store`,
``$TPUSIM_COMPILE_CACHE``, the ``--compile-cache`` flag):
:func:`tpusim_torch.perf.cache.compiled_for` consults the store before
any compile, and :func:`maybe_persist_compiled` publishes after a
pricing walk compiled new columns.  Off by default — runs without it do
no added work and stamp no added stats keys.

A lean record (a streaming module's compile, no per-op names) loads back
lean and releasing IR, exactly as it was compiled.
"""

from __future__ import annotations

import json
import mmap
import os
import sys
import threading
import warnings
from pathlib import Path

import torch

__all__ = [
    "COMPILE_RECORD_SUFFIX",
    "COMPILE_STORE_FORMAT_VERSION",
    "CompileStore",
    "as_compile_store",
    "compile_store_active",
    "get_compile_store",
    "maybe_persist_compiled",
    "read_record_header",
    "set_compile_store",
]

COMPILE_STORE_FORMAT_VERSION = 1
COMPILE_RECORD_SUFFIX = ".cmod"

_MAGIC = b"TPUCMOD1"
_HDR_FIXED = len(_MAGIC) + 8  # magic + u64 header length

#: the blob's array dtypes (the JAX package's numpy ``dtype.str``) and
#: their tensor dtypes: f64 columns and int64 index tables, both 8-byte
#: lanes, which is what keeps every blob offset 8-aligned
_DTYPES = {"<f8": torch.float64, "<i8": torch.int64}
_DTYPE_STR = {v: k for k, v in _DTYPES.items()}


def _fsync(path: Path) -> None:
    """Flush a staged file's blocks (or a directory's entries) to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _stage_bytes(tmp: Path, payload: bytes) -> None:
    """Stage one record's bytes to its temp file (the seam a test of the
    full-disk path replaces)."""
    with open(tmp, "wb") as f:
        f.write(payload)


#: the f64 pricing columns of one CompiledComputation, in a fixed order
#: (the record format's column table)
_COLUMN_ATTRS = (
    "cycles", "compute", "hbm", "vmem", "hrs", "vrs",
    "flops", "mxu", "trans", "ici_bytes",
)


# ---------------------------------------------------------------------------
# (De)serialization of the step program
# ---------------------------------------------------------------------------


class _BlobWriter:
    """Accumulates the record's two binary sections: 8-byte-lane arrays
    (the mapped columns and index tables) and a raw strings tail (per-op
    identity, stored as joined text and index bytes rather than JSON
    arrays: ``json.loads`` of a large module's name table costs more than
    the pricing walk it enables)."""

    def __init__(self):
        self.parts: list[bytes] = []
        self.table: list[list] = []  # [dtype_str, offset, count]
        self.offset = 0
        self.tail_parts: list[bytes] = []
        self.tail_offset = 0

    def add(self, arr: torch.Tensor) -> int:
        arr = arr.contiguous()
        if arr.element_size() != 8:
            arr = arr.to(torch.int64)
        idx = len(self.table)
        self.table.append(
            [_DTYPE_STR[arr.dtype], self.offset, int(arr.shape[0])]
        )
        raw = arr.numpy().tobytes()
        self.parts.append(raw)
        self.offset += len(raw)
        return idx

    def add_tail(self, raw: bytes) -> list[int]:
        span = [self.tail_offset, len(raw)]
        self.tail_parts.append(raw)
        self.tail_offset += len(raw)
        return span


def _encode_indexed(values: list, blob: _BlobWriter) -> dict:
    """Encode a per-op list drawn from a small distinct set (opcode
    bases, unit values) as a header-side table plus one index byte per op
    in the strings tail (u16 when the table overflows a byte)."""
    table: list = []
    index: dict = {}
    ids: list[int] = []
    for v in values:
        i = index.get(v)
        if i is None:
            i = index[v] = len(table)
            table.append(v)
        ids.append(i)
    if len(table) <= 256:
        raw, width = bytes(ids), 1
    else:
        raw, width = b"".join(i.to_bytes(2, "little") for i in ids), 2
    return {"table": table, "span": blob.add_tail(raw), "width": width}


def _decode_indexed(doc: dict, tail: memoryview, intern=None) -> list:
    table = doc["table"]
    if intern is not None:
        table = [v if v is None else intern(v) for v in table]
    off, length = doc["span"]
    raw = bytes(tail[off:off + length])
    if doc["width"] == 2:
        return [
            table[int.from_bytes(raw[i:i + 2], "little")]
            for i in range(0, len(raw), 2)
        ]
    return [table[b] for b in raw]


def _steps_to_doc(steps: list, blob: _BlobWriter) -> list:
    from tpusim_torch.trace.format import _collective_to_json

    out = []
    for step in steps:
        kind = step[0]
        if kind == "run":
            (_, lo, hi, emit, hbm_idx, flops_idx, mxu_idx,
             ugroups, ogroups) = step
            out.append([
                "run", lo, hi,
                blob.add(emit), blob.add(hbm_idx),
                blob.add(flops_idx), blob.add(mxu_idx),
                [[u, blob.add(idx)] for u, idx in ugroups],
                [[b, blob.add(idx)] for b, idx in ogroups],
            ])
        elif kind == "coll":
            _, i, name, base, info, is_start = step
            out.append([
                "coll", i, name, base, _collective_to_json(info), is_start,
            ])
        elif kind == "cond":
            _, i, name, base, branches = step
            out.append(["cond", i, name, base, list(branches)])
        else:
            # crun/while/call/done/dma: plain JSON scalars throughout
            out.append(list(step))
    return out


def _steps_from_doc(doc: list, arrays: list) -> list:
    from tpusim_torch.trace.format import _collective_from_json

    steps = []
    for step in doc:
        kind = step[0]
        if kind == "run":
            (_, lo, hi, a_emit, a_hbm, a_flops, a_mxu,
             ugroups, ogroups) = step
            steps.append((
                "run", lo, hi,
                arrays[a_emit], arrays[a_hbm],
                arrays[a_flops], arrays[a_mxu],
                [(u, arrays[a]) for u, a in ugroups],
                [(b, arrays[a]) for b, a in ogroups],
            ))
        elif kind == "coll":
            _, i, name, base, info, is_start = step
            steps.append((
                "coll", i, name, base, _collective_from_json(info),
                is_start,
            ))
        elif kind == "cond":
            _, i, name, base, branches = step
            steps.append(("cond", i, name, base, tuple(branches)))
        else:
            steps.append(tuple(step))
    return steps


def _map_array(mm: mmap.mmap, dt: str, offset: int, count: int):
    """One blob array as a CPU tensor over the mapping (no copy)."""
    dtype = _DTYPES.get(dt)
    if dtype is None:
        raise ValueError(f"unsupported array dtype {dt!r}")
    if count == 0:
        return torch.empty(0, dtype=dtype)  # frombuffer refuses count 0
    return torch.frombuffer(mm, dtype=dtype, count=count, offset=offset)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class CompileStore:
    """Durable disk tier for :class:`~tpusim_torch.fastpath.compile.
    CompiledModule` instances; see the module docstring.

    One instance may serve many engines and threads — counters are
    cumulative, and the disk protocol (whole-record atomic publish,
    delete-tolerant reads) is the result cache's."""

    def __init__(
        self,
        disk_dir: str | Path,
        quota_bytes: int | None = None,
        quota_entries: int | None = None,
        durable: bool = False,
    ):
        self.disk_dir = Path(disk_dir)
        # durable=True fsyncs each record (and its directory entry)
        # before the atomic publish: temp + os.replace already rules out
        # torn files; durability closes the host-crash window where the
        # rename survives but the data blocks do not
        self.durable = bool(durable)
        self.quota_bytes = int(quota_bytes) if quota_bytes else None
        self.quota_entries = int(quota_entries) if quota_entries else None
        self._lock = threading.Lock()
        from tpusim_torch.guard.store import QuotaEstimate

        self._quota = QuotaEstimate()
        self._model_version: str | None = None
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.errors = 0
        self.quarantined = 0
        # a medium-level staging failure disables this instance's write
        # path (one warning ever); loads keep serving existing records
        self._write_disabled = False

    def model_version(self) -> str:
        # the composite timing+parser stamp of the result cache (a
        # compiled column is a parser-AND-model artifact)
        if self._model_version is None:
            from tpusim_torch.perf.cache import parser_version
            from tpusim_torch.timing.model_version import model_version

            self._model_version = f"{model_version()}+{parser_version()}"
        return self._model_version

    def path_for(self, key: str) -> Path:
        from tpusim_torch.perf.cache import _sha

        return self.disk_dir / f"{_sha(key)}{COMPILE_RECORD_SUFFIX}"

    def _governed(self) -> bool:
        return self.quota_bytes is not None or self.quota_entries is not None

    # -- load ----------------------------------------------------------------

    def load(self, key: str, module, engine):
        """Rebuild a CompiledModule from the record for ``key``, or None
        (miss / stale / quarantined-corrupt)."""
        path = self.path_for(key)
        try:
            cm = self._read(path, key, module, engine)
        except FileNotFoundError:
            # no record yet, or a peer's GC freed it mid-lookup: a plain
            # miss by the store's concurrency contract
            with self._lock:
                self.misses += 1
            return None
        except (ValueError, KeyError, TypeError, IndexError, OSError,
                json.JSONDecodeError) as e:
            with self._lock:
                self.errors += 1
            from tpusim_torch.guard.store import quarantine_record

            if quarantine_record(path):
                with self._lock:
                    self.quarantined += 1
            warnings.warn(
                f"tpusim_torch.fastpath: corrupt compiled-module record "
                f"{path} ({type(e).__name__}: {e}); quarantined, "
                f"recompiling",
                RuntimeWarning,
                stacklevel=2,
            )
            cm = None
        with self._lock:
            if cm is not None:
                self.hits += 1
            else:
                self.misses += 1
        if cm is not None and self._governed():
            # LRU recency lives in the mtime (the GC's contract);
            # un-governed stores skip the syscall
            try:
                os.utime(path)
            except OSError:
                pass
        return cm

    def _read(self, path: Path, key: str, module, engine):
        from tpusim_torch.fastpath.compile import (
            CompiledComputation, CompiledModule,
        )

        with open(path, "rb") as f:
            try:
                # ACCESS_COPY: a private copy-on-write mapping.  torch
                # takes every buffer as writable; a write through a
                # column (no code does one) would then change this
                # process's pages only, never the record, where a
                # read-only mapping would crash the process
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            except ValueError:
                raise ValueError("record is empty") from None
        if len(mm) < _HDR_FIXED or mm[: len(_MAGIC)] != _MAGIC:
            raise ValueError("bad magic")
        hdr_len = int.from_bytes(mm[len(_MAGIC):_HDR_FIXED], "little")
        if hdr_len <= 0 or _HDR_FIXED + hdr_len > len(mm):
            raise ValueError("header length out of bounds")
        header = json.loads(mm[_HDR_FIXED:_HDR_FIXED + hdr_len])
        if header.get("format_version") != COMPILE_STORE_FORMAT_VERSION:
            return None  # older layout: stale, not corrupt
        if header.get("key") != key:
            raise ValueError("stored key mismatch (hash collision?)")
        if header.get("model_version") != self.model_version():
            return None  # stale: model/parser bumped under the same name
        blob_start = _HDR_FIXED + hdr_len
        blob_start += (-blob_start) % 8
        tail_start = blob_start + int(header["blob_bytes"])
        if tail_start + int(header["tail_bytes"]) > len(mm):
            raise ValueError("truncated column blob")
        tail = memoryview(mm)[
            tail_start:tail_start + int(header["tail_bytes"])
        ]
        arrays = [
            _map_array(mm, dt, blob_start + off, count)
            for dt, off, count in header["arrays"]
        ]

        # a lean (streaming) record loads back lean: its per-op name
        # table was never written, and any computation compiled after
        # the load releases its IR like the original compile did
        lean = bool(header["lean"])
        cm = CompiledModule(
            module, engine.cost, engine.config, lean=lean,
            release_ir=lean,
        )
        intern = sys.intern
        for cdoc in header["comps"]:
            cols = {
                attr: arrays[cdoc["cols"][attr]] for attr in _COLUMN_ATTRS
            }
            names = None
            if cdoc["names"] is not None:
                off, length = cdoc["names"]
                text = bytes(tail[off:off + length]).decode()
                names = text.split("\n") if text else []
            cc = CompiledComputation(
                name=cdoc["name"],
                n_ops=int(cdoc["n_ops"]),
                names=names,
                bases=_decode_indexed(cdoc["bases"], tail, intern=intern),
                units=_decode_indexed(cdoc["units"], tail),
                steps=_steps_from_doc(cdoc["steps"], arrays),
                any_vmem=bool(cdoc["any_vmem"]),
                **cols,
            )
            cm.comps[cc.name] = cc
        mod_doc = header.get("module") or {}
        cm.entry_name = mod_doc.get("entry_name")
        cm.residency = mod_doc.get("residency")
        cm.residency_kind = mod_doc.get("residency_kind")
        cm.peak_live = mod_doc.get("peak_live")
        return cm

    # -- save ----------------------------------------------------------------

    def save(self, cm, key: str) -> bool:
        """Serialize every compiled computation of ``cm`` and publish the
        record atomically.  Returns False on (warned) failure."""
        if self._write_disabled:
            return False
        payload = self._serialize(cm, key)
        path = self.path_for(key)
        tmp = path.parent / (
            f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        )
        governed = self._governed()
        try:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
            old_size = 0
            if governed:
                try:
                    old_size = path.stat().st_size
                except OSError:
                    old_size = 0
            _stage_bytes(tmp, payload)
            if self.durable:
                _fsync(tmp)
            os.replace(tmp, path)
            if self.durable:
                _fsync(self.disk_dir)
        except OSError as e:
            with self._lock:
                self.errors += 1
            try:
                tmp.unlink()
            except OSError:
                pass
            from tpusim_torch.perf.cache import fatal_write_disable

            if fatal_write_disable(
                e,
                f"tpusim_torch.fastpath: compiled-module write failed "
                f"under {self.disk_dir} ({e}); disabling further store "
                f"writes for this instance (loads continue)",
            ):
                self._write_disabled = True
                return False
            warnings.warn(
                f"tpusim_torch.fastpath: compiled-module write failed "
                f"under {self.disk_dir} ({e}); continuing undurable",
                RuntimeWarning,
                stacklevel=2,
            )
            return False
        with self._lock:
            self.stores += 1
        if governed:
            # tier-blind: bounds the whole directory, result and compiled
            # records together
            self._quota.publish(self.disk_dir, path, old_size,
                                self.quota_bytes, self.quota_entries)
        return True

    def _serialize(self, cm, key: str) -> bytes:
        blob = _BlobWriter()
        comps = []
        for name, cc in list(cm.comps.items()):
            comps.append({
                "name": name,
                "n_ops": cc.n_ops,
                "any_vmem": bool(cc.any_vmem),
                "names": (
                    None if cc.names is None
                    else blob.add_tail("\n".join(cc.names).encode())
                ),
                "bases": _encode_indexed(cc.bases, blob),
                "units": _encode_indexed(cc.units, blob),
                "steps": _steps_to_doc(cc.steps, blob),
                "cols": {
                    attr: blob.add(getattr(cc, attr))
                    for attr in _COLUMN_ATTRS
                },
            })
        header = json.dumps({
            "format_version": COMPILE_STORE_FORMAT_VERSION,
            "key": key,
            "model_version": self.model_version(),
            "lean": bool(cm.lean),
            "module": {
                "entry_name": cm.entry_name,
                "residency": cm.residency,
                "residency_kind": cm.residency_kind,
                "peak_live": cm.peak_live,
            },
            "comps": comps,
            "arrays": blob.table,
            "blob_bytes": blob.offset,
            "tail_bytes": blob.tail_offset,
        }).encode()
        pad = (-(_HDR_FIXED + len(header))) % 8
        return b"".join([
            _MAGIC,
            len(header).to_bytes(8, "little"),
            header,
            b"\0" * pad,
            *blob.parts,
            *blob.tail_parts,
        ])

    # -- reporting -----------------------------------------------------------

    def stats_dict(self) -> dict[str, float]:
        """Counters of the ``fastpath_`` stats block (ride only when a
        compile store is active)."""
        with self._lock:
            return {
                "store_hits": self.hits,
                "store_misses": self.misses,
                "store_writes": self.stores,
                "store_errors": self.errors,
                "store_quarantined": self.quarantined,
            }


# ---------------------------------------------------------------------------
# Record inspection (the `cache` CLI / verify_store side)
# ---------------------------------------------------------------------------


def read_record_header(path: str | Path) -> dict:
    """Parse and structurally validate one ``.cmod`` record's header
    (raises ``ValueError`` on anything a loader would refuse).  Reads only
    the header bytes; the blob gets a size-against-stat bounds check."""
    path = Path(path)
    with open(path, "rb") as f:
        fixed = f.read(_HDR_FIXED)
        if len(fixed) < _HDR_FIXED or fixed[: len(_MAGIC)] != _MAGIC:
            raise ValueError("bad magic")
        hdr_len = int.from_bytes(fixed[len(_MAGIC):], "little")
        total = os.fstat(f.fileno()).st_size
        if hdr_len <= 0 or _HDR_FIXED + hdr_len > total:
            raise ValueError("header length out of bounds")
        raw_header = f.read(hdr_len)
    if len(raw_header) < hdr_len:
        raise ValueError("short header read")
    header = json.loads(raw_header)
    if not isinstance(header, dict):
        raise ValueError("header is not an object")
    for field in ("format_version", "key", "model_version", "comps",
                  "arrays", "blob_bytes", "tail_bytes"):
        if field not in header:
            raise ValueError(f"header missing {field!r}")
    from tpusim_torch.perf.cache import _sha

    if path.name != f"{_sha(str(header['key']))}{COMPILE_RECORD_SUFFIX}":
        raise ValueError("stored key does not match the record's name")
    blob_start = _HDR_FIXED + hdr_len
    blob_start += (-blob_start) % 8
    end = blob_start + int(header["blob_bytes"]) + int(header["tail_bytes"])
    if end > total:
        raise ValueError("truncated column blob")
    return header


# ---------------------------------------------------------------------------
# Process-wide activation
# ---------------------------------------------------------------------------

_STORE: CompileStore | None = None
_STORE_EXPLICIT = False
#: (env value, store) pair backing $TPUSIM_COMPILE_CACHE resolution
_ENV_STORE: tuple[str, CompileStore] | None = None
_ACT_LOCK = threading.Lock()


def set_compile_store(store: CompileStore | None) -> CompileStore | None:
    """Install (or, with None, deactivate) the process-wide compiled disk
    tier.  An explicit set always wins over the environment."""
    global _STORE, _STORE_EXPLICIT
    with _ACT_LOCK:
        _STORE = store
        _STORE_EXPLICIT = True
    return store


def get_compile_store() -> CompileStore | None:
    """The active store: the explicitly installed one, else one resolved
    from ``$TPUSIM_COMPILE_CACHE`` (a directory path; forked workers and
    subprocesses inherit activation this way)."""
    global _ENV_STORE
    if _STORE_EXPLICIT:
        return _STORE
    env = os.environ.get("TPUSIM_COMPILE_CACHE")
    if not env:
        return None
    with _ACT_LOCK:
        if _ENV_STORE is None or _ENV_STORE[0] != env:
            _ENV_STORE = (env, CompileStore(env))
        return _ENV_STORE[1]


def compile_store_active() -> bool:
    return get_compile_store() is not None


def as_compile_store(
    spec, quota_bytes: int | None = None, durable: bool = False,
) -> CompileStore | None:
    """Coerce the ``--compile-cache`` flag family to a store and install
    it process-wide: None/False → leave activation untouched; True → the
    default cache dir; a path → a store there; an existing
    :class:`CompileStore` passes through.  ``quota_bytes`` (the
    ``--cache-quota`` flag) bounds the store directory; ``durable`` (the
    serve workers) fsyncs each record before it is published."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, CompileStore):
        store = spec
    else:
        if spec is True:
            from tpusim_torch.perf.cache import DEFAULT_CACHE_DIR

            spec = DEFAULT_CACHE_DIR
        store = CompileStore(spec, durable=durable)
    if quota_bytes is not None:
        store.quota_bytes = int(quota_bytes)
    set_compile_store(store)
    return store


def maybe_persist_compiled(cm) -> None:
    """Publish ``cm``'s columns if a store is active, the module is in
    the shared tier, and a pricing walk compiled anything new since the
    last publish (the fastpath calls this after every pricing walk)."""
    key = cm._store_key
    if key is None or not cm._store_dirty:
        return
    store = get_compile_store()
    if store is None:
        return
    if store.save(cm, key):
        cm._store_dirty = False

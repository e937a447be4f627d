"""On-disk trace format.

Port of ``tpusim/trace/format.py``.  The layout is shared with the JAX
package byte for byte, so a dir written by either package loads in the
other::

    <dir>/
      meta.json                  capture metadata (device kind, topology, ...)
      modules/<name>.hlo         HLO text (one per module; .hlo.gz if large)
      commandlist.jsonl          per-device program streams

The loader parses modules eagerly with the port's Python parser, or
lazily (:mod:`tpusim_torch.trace.lazy`) when they are large or a durable
compile store is active.  The JAX package's streaming and native parsers
are host-side accelerators that are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.ir import (
    CollectiveInfo,
    CommandKind,
    PodTrace,
    TraceCommand,
)
from tpusim_torch.trace.hlo_text import parse_hlo_module

__all__ = [
    "TraceDir",
    "save_trace",
    "load_trace",
    "iter_commandlist",
    "parse_commandlist",
]

TRACE_FORMAT_VERSION = 1

#: modules at or above this text size are stored gzipped
COMPRESS_THRESHOLD_BYTES = 1 * 1024 * 1024


@dataclass
class TraceDir:
    """Handle to a trace directory on disk."""

    path: Path
    meta: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Command (de)serialization
# ---------------------------------------------------------------------------


def _collective_to_json(c: CollectiveInfo | None) -> dict | None:
    if c is None:
        return None
    return {
        "kind": c.kind,
        "replica_groups": [list(g) for g in c.replica_groups],
        "channel_id": c.channel_id,
        "use_global_device_ids": c.use_global_device_ids,
        "source_target_pairs": [list(p) for p in c.source_target_pairs],
        "split_dimension": c.split_dimension,
        "dimensions": list(c.dimensions),
    }


def _collective_from_json(d: dict | None) -> CollectiveInfo | None:
    if d is None:
        return None
    return CollectiveInfo(
        kind=d["kind"],
        replica_groups=tuple(tuple(g) for g in d.get("replica_groups", [])),
        channel_id=d.get("channel_id"),
        use_global_device_ids=d.get("use_global_device_ids", False),
        source_target_pairs=tuple(
            (p[0], p[1]) for p in d.get("source_target_pairs", [])
        ),
        split_dimension=d.get("split_dimension"),
        dimensions=tuple(d.get("dimensions", [])),
    )


def command_to_json(cmd: TraceCommand) -> dict:
    return {
        "kind": cmd.kind.value,
        "stream": cmd.stream_id,
        "device": cmd.device_id,
        "bytes": cmd.nbytes,
        "module": cmd.module,
        "collective": _collective_to_json(cmd.collective),
        "attrs": cmd.attrs,
    }


def command_from_json(d: dict) -> TraceCommand:
    return TraceCommand(
        kind=CommandKind(d["kind"]),
        stream_id=d.get("stream", 0),
        device_id=d.get("device", 0),
        nbytes=d.get("bytes", 0),
        module=d.get("module"),
        collective=_collective_from_json(d.get("collective")),
        attrs=d.get("attrs", {}),
    )


def iter_commandlist(path: str | Path):
    """Yield ``(lineno, record_dict | None, error | None)`` per non-blank
    ``commandlist.jsonl`` line (1-based line numbers).

    The shared walk of :func:`parse_commandlist` and the static analyzer
    (:mod:`tpusim_torch.analysis.trace_passes`): the loader wants the
    records, the linter wants the *line anchors* and the per-line parse
    errors — one walk serves both so they can never disagree about which
    line a record came from."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                yield lineno, None, f"invalid JSON: {e}"
                continue
            if not isinstance(rec, dict):
                yield lineno, None, f"record is not an object: {rec!r}"
                continue
            yield lineno, rec, None


def parse_commandlist(path: str | Path) -> list[TraceCommand]:
    """Parse a ``commandlist.jsonl`` into commands (blank and ``#`` lines
    skipped); raises ``ValueError`` naming the line on a bad record."""
    cmds = []
    for lineno, rec, err in iter_commandlist(path):
        if err is not None:
            raise ValueError(f"{path}:{lineno}: {err}")
        cmds.append(command_from_json(rec))
    return cmds


# ---------------------------------------------------------------------------
# Save / load full pod traces
# ---------------------------------------------------------------------------


def save_trace(
    path: str | Path,
    modules: dict[str, str],
    commands: list[TraceCommand],
    meta: dict | None = None,
    compress: bool | str = "auto",
) -> TraceDir:
    """Write a trace directory.  ``modules`` maps module name → HLO text.

    ``compress``: True = always gzip module text, False = never, "auto" =
    gzip modules of :data:`COMPRESS_THRESHOLD_BYTES` or more."""
    if compress not in (True, False, "auto"):
        raise ValueError(f"compress={compress!r}: want True, False or 'auto'")
    path = Path(path)
    (path / "modules").mkdir(parents=True, exist_ok=True)
    meta = dict(meta or {})
    meta.setdefault("format_version", TRACE_FORMAT_VERSION)
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    for name, text in modules.items():
        safe = name.replace(os.sep, "_")
        gz = compress is True or (
            compress == "auto" and len(text) >= COMPRESS_THRESHOLD_BYTES
        )
        if gz:
            with gzip.open(
                path / "modules" / f"{safe}.hlo.gz", "wt",
                compresslevel=6,
            ) as f:
                f.write(text)
        else:
            with open(path / "modules" / f"{safe}.hlo", "w") as f:
                f.write(text)
    with open(path / "commandlist.jsonl", "w") as f:
        for cmd in commands:
            f.write(json.dumps(command_to_json(cmd)) + "\n")
    return TraceDir(path=path, meta=meta)


def load_trace(
    path: str | Path, lenient: bool = False,
    defer_parse: bool | None = None,
) -> PodTrace:
    """Load a trace directory into a :class:`PodTrace`.

    Modules load in the reference's order: plain ``.hlo`` files sorted by
    name, then gzipped ``.hlo.gz`` files sorted by name (a name present
    in both keeps its first position and the gzipped text).  A trace
    without a command list launches each module once on device 0 in that
    order.

    ``lenient=True`` skips malformed HLO lines with a counted warning
    instead of raising on the first one; lenient parsing is always eager.
    ``defer_parse=True`` builds every module lazily (computations parse
    on first IR access, :mod:`tpusim_torch.trace.lazy`).  The default
    (``None``) defers exactly when a durable compile store is active
    (:func:`tpusim_torch.fastpath.store.compile_store_active`), so a warm
    store prices from its stored columns and the parse never happens.
    Modules of :data:`~tpusim_torch.trace.lazy.LAZY_THRESHOLD_BYTES` or
    more parse lazily either way.  The lazy module stamps the same
    ``content_hash`` as the eager path, so every cache key is identical."""
    path = Path(path)
    # one directory read answers every existence question
    try:
        with os.scandir(path) as it:
            root_names = {de.name for de in it}
    except (FileNotFoundError, NotADirectoryError):
        raise FileNotFoundError(
            f"trace directory not found: {path}"
        ) from None
    if "modules" not in root_names and \
            "commandlist.jsonl" not in root_names:
        raise FileNotFoundError(
            f"{path} is not a trace directory (no modules/ or "
            f"commandlist.jsonl)"
        )
    meta: dict = {}
    if "meta.json" in root_names:
        with open(path / "meta.json") as f:
            meta = json.load(f)

    from tpusim_torch.trace.lazy import (
        LAZY_THRESHOLD_BYTES,
        parse_hlo_module_lazy,
    )

    if defer_parse is None and not lenient:
        from tpusim_torch.fastpath.store import compile_store_active

        defer_parse = compile_store_active()

    pod = PodTrace(meta=meta)
    plain: list[tuple[str, str]] = []
    gzipped: list[tuple[str, str]] = []
    try:
        with os.scandir(path / "modules") as it:
            for de in it:
                n = de.name
                if n.endswith(".hlo"):
                    plain.append((n[:-4], de.path))
                elif n.endswith(".hlo.gz"):
                    gzipped.append((n[: -len(".hlo.gz")], de.path))
    except (FileNotFoundError, NotADirectoryError):
        pass
    entries: list[tuple[str, str]] = []
    for key, fp in sorted(plain):
        with open(fp) as f:
            entries.append((key, f.read()))
    for key, fp in sorted(gzipped):
        with gzip.open(fp, "rt") as f:
            entries.append((key, f.read()))
    for key, text in entries:
        if lenient:
            mod = parse_hlo_module(text, name_hint=key, strict=False)
        elif defer_parse or len(text) >= LAZY_THRESHOLD_BYTES:
            mod = parse_hlo_module_lazy(text, name_hint=key)
        else:
            mod = parse_hlo_module(text, name_hint=key)
        # file name is the trace key; HloModule header name may differ
        pod.modules[key] = mod
        mod.meta.setdefault("trace_key", key)
        # content digest of the module text — the address half of every
        # cache key (computed here, where the text is in hand)
        mod.meta.setdefault(
            "content_hash", hashlib.sha256(text.encode()).hexdigest()[:24]
        )
        # capture-time facts ride on every module: the cost model gates
        # capture-backend dtype normalization on the platform
        for k in ("platform", "device_kind"):
            if k in meta:
                mod.meta.setdefault(k, meta[k])

    if "commandlist.jsonl" in root_names:
        for cmd in parse_commandlist(path / "commandlist.jsonl"):
            pod.device(cmd.device_id).commands.append(cmd)
    else:
        # modules but no command stream: one launch per module on device 0
        for name in pod.modules:
            pod.device(0).commands.append(
                TraceCommand(kind=CommandKind.KERNEL_LAUNCH, module=name)
            )
    return pod

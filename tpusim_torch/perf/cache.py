"""The compiled-module cache tier of the pricing fastpath.

Port of the part of ``tpusim/perf/cache.py`` that the fastpath needs: the
content fingerprints, the process-wide LRU of
:class:`~tpusim_torch.fastpath.compile.CompiledModule` instances keyed on

    (module fingerprint, capture platform, config fingerprint,
     model + parser version)

and :func:`result_to_doc`, the JSON document of one
:class:`~tpusim_torch.timing.engine.EngineResult` by which results are
compared.  Scales and topology are deliberately absent from the key:
compiled columns hold healthy per-op costs and launch-class transforms
apply at price time, so every degraded class of a module shares one
compile.

Not ported yet (ROADMAP A6): the result cache (``ResultCache``,
``CachedEngine``), the worker pool and the durable compile store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import OrderedDict
from pathlib import Path

from tpusim_torch.timing.config import SimConfig
from tpusim_torch.timing.engine import EngineResult
from tpusim_torch.timing.model_version import model_version

__all__ = [
    "clear_compiled_cache",
    "compiled_cache_stats",
    "compiled_for",
    "compiled_key_str",
    "config_fingerprint",
    "module_fingerprint",
    "parser_version",
    "result_to_doc",
    "set_compiled_cache_max",
    "topology_signature",
]

_REPO = Path(__file__).resolve().parents[2]

#: sources outside the timing model that still decide how hashed module
#: text prices: the IR and the parsers that build it, and the fastpath
#: itself (byte-identical to the engine by contract, but a contract is
#: not a key: an edit that shifts compiled pricing must orphan old
#: compiled columns).  These are the port's own files.
_PARSER_FILES: tuple[str, ...] = (
    "tpusim_torch/ir.py",
    "tpusim_torch/trace/hlo_text.py",
    "tpusim_torch/trace/loop_analysis.py",
    "tpusim_torch/trace/format.py",
    "tpusim_torch/fastpath/compile.py",
    "tpusim_torch/fastpath/price.py",
    "tpusim_torch/fastpath/batch.py",
    "tpusim_torch/kernels/scan_rows.py",
    "tpusim_torch/csrc/scan_rows.cu",
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


def module_fingerprint(module) -> str | None:
    """Content digest of one module.

    ``load_trace`` stamps ``meta["content_hash"]`` from the module text;
    modules built in memory fall back to a structural walk over their
    ops.  Returns None when no stable fingerprint exists (the shared tier
    is then skipped for that module, never wrong)."""
    cached = getattr(module, "_fingerprint_cache", None)
    if cached is not None:
        return cached
    content = module.meta.get("content_hash") if module.meta else None
    if content:
        fp = str(content)
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


# ---------------------------------------------------------------------------
# EngineResult document
# ---------------------------------------------------------------------------

#: run-scoped fields that are not part of a result's document
_UNDOCUMENTED_FIELDS = ("timeline",)


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


def _compiled_key(module, config: SimConfig) -> tuple | None:
    mfp = module_fingerprint(module)
    if mfp is None:
        return None
    platform = str(module.meta.get("platform", "")) if module.meta else ""
    return (
        mfp, platform, config_fingerprint(config),
        f"{model_version()}+{parser_version()}",
    )


def compiled_key_str(key: tuple) -> str:
    """The string form of a compiled-module key (its components in
    order, the platform tagged)."""
    mfp, platform, cfg_fp, mv = key
    return "|".join((mfp, f"p={platform}", cfg_fp, mv))


def compiled_for(module, engine):
    """The fastpath's one compile per (module content, config): return a
    cached :class:`~tpusim_torch.fastpath.compile.CompiledModule` or mint
    one."""
    global _compiled_hits, _compiled_misses
    from tpusim_torch.fastpath.compile import compile_module

    key = _compiled_key(module, engine.config)
    if key is None:
        # no stable fingerprint: pin to the module object so repeated
        # runs of it still compile once
        attr = getattr(module, "_fastpath_cm", None)
        ckey = config_fingerprint(engine.config)
        if isinstance(attr, dict) and ckey in attr:
            return attr[ckey]
        cm = compile_module(module, engine.cost, engine.config)
        if not isinstance(attr, dict):
            attr = module._fastpath_cm = {}
        attr[ckey] = cm
        return cm

    with _compiled_lock:
        cm = _COMPILED.get(key)
        if cm is not None:
            _COMPILED.move_to_end(key)
            _compiled_hits += 1
    if cm is not None:
        # the tier holds only a weak module ref; rebind the live object
        # (same content by key construction, so the columns transfer)
        cm.bind(module, engine.cost)
        return cm
    cm = compile_module(module, engine.cost, engine.config)
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
    only when a pricing backend was explicitly requested)."""
    return {
        "compile_hits": _compiled_hits,
        "compile_misses": _compiled_misses,
        "compiled_modules": len(_COMPILED),
    }

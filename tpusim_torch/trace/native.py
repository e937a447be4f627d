"""ctypes bridge to the native HLO scanner (``native/hlo_scan.cpp``).

Port of ``tpusim/trace/native.py``.  The structural pass (line
classification, balanced-delimiter splitting, operand extraction) runs in
C++; this module rebuilds :mod:`tpusim_torch.ir` objects from the
pre-split record stream.  Falls back to the pure-Python parser when the
shared library is unavailable — the two paths are held to each other by
``tests/test_torch_native.py``.

The library is built from ``native/`` at first use
(:mod:`tpusim_torch.kernels.native_build`, which also honours
``TPUSIM_NO_NATIVE``).
"""

from __future__ import annotations

import ctypes

from tpusim_torch.ir import Computation, ModuleTrace, TraceOp
from tpusim_torch.kernels.native_build import load_shared_lib
from tpusim_torch.trace import hlo_text as pyparse

__all__ = ["native_available", "parse_hlo_module_native",
           "parse_hlo_module_fast"]

_RS = "\x1e"
_US = "\x1f"
#: sub-field separator of the v2 (parse-to-columns) attr-token field
_GS = "\x1d"

_LIB: ctypes.CDLL | None = None
_LIB_TRIED = False
#: True when the library also exports the v2 parse-to-columns scan
_HAS_V2 = False
#: native parses run in this process (a module each; the chip check reads
#: it to show the native path was taken)
NATIVE_PARSES = 0


def _load() -> ctypes.CDLL | None:
    global _LIB, _LIB_TRIED, _HAS_V2
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    lib = load_shared_lib()
    if lib is None:
        return None
    try:
        lib.hlo_scan.restype = ctypes.POINTER(ctypes.c_char)
        lib.hlo_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.hlo_scan_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.hlo_scan_abi_version.restype = ctypes.c_int
        if lib.hlo_scan_abi_version() != 1:
            return None
        _LIB = lib
    except (OSError, AttributeError):
        return None
    try:
        # the v2 (parse-to-columns) scan is optional: an older library
        # without it still serves the v1 record stream
        lib.hlo_scan2.restype = ctypes.POINTER(ctypes.c_char)
        lib.hlo_scan2.argtypes = lib.hlo_scan.argtypes
        lib.hlo_scan2_abi_version.restype = ctypes.c_int
        _HAS_V2 = lib.hlo_scan2_abi_version() == 1
    except (OSError, AttributeError):
        _HAS_V2 = False
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _scan(text: str, v2: bool = False) -> str:
    lib = _load()
    assert lib is not None
    raw = text.encode("utf-8", errors="replace")
    out_len = ctypes.c_uint64(0)
    entry = lib.hlo_scan2 if v2 else lib.hlo_scan
    ptr = entry(raw, len(raw), ctypes.byref(out_len))
    if not ptr:
        raise MemoryError("hlo_scan allocation failed")
    try:
        return ctypes.string_at(ptr, out_len.value).decode(
            "utf-8", errors="replace"
        )
    finally:
        lib.hlo_scan_free(ptr)


def parse_hlo_module_native(text: str, name_hint: str = "module") -> ModuleTrace:
    """Parse using the native scanner (raises if unavailable).

    With a library exporting the v2 parse-to-columns scan, shapes
    arrive pre-parsed and attrs pre-split — IR assembly then runs no
    regex and no balanced-delimiter splitting (byte-identical modules
    either way, pinned by tests/test_torch_native.py)."""
    global NATIVE_PARSES
    v2 = _load() is not None and _HAS_V2
    stream = _scan(text, v2=v2)
    NATIVE_PARSES += 1
    build = _build_op2 if v2 else _build_op
    module = ModuleTrace(name=name_hint)
    current: Computation | None = None

    for record in stream.split(_RS):
        if not record:
            continue
        fields = record.split(_US)
        kind = fields[0]
        if kind == "M":
            module.name = fields[1] or name_hint
            attr_text = fields[2] if len(fields) > 2 else ""
            pyparse.parse_module_attrs(attr_text, module.meta)
        elif kind == "C":
            current = Computation(name=fields[1], is_entry=fields[2] == "1")
        elif kind == "E":
            if current is not None:
                module.add_computation(current)
            current = None
        elif kind == "I" and current is not None:
            current.add(build(fields))
    if current is not None:
        module.add_computation(current)
    return module


def _finish_op(
    fields: list[str], result, attrs: dict, metadata: dict
) -> TraceOp:
    """Shared tail of the v1/v2 op builders (identical by contract)."""
    from tpusim_torch.ir import base_opcode

    opcode = fields[4]
    literal = fields[7] if len(fields) > 7 else ""
    if opcode == "constant" and literal:
        attrs.setdefault("literal", literal)
    elif opcode == "parameter" and literal:
        attrs.setdefault("param_index", literal)
    return TraceOp(
        name=fields[1],
        opcode=opcode,
        result=result,
        operands=tuple(o for o in fields[5].split(",") if o),
        called=pyparse._collect_called(attrs),
        fusion_kind=attrs.get("kind"),
        collective=pyparse._maybe_collective(base_opcode(opcode), attrs),
        attrs=attrs,
        metadata=metadata,
        is_root=fields[2] == "1",
    )


def _build_op(fields: list[str]) -> TraceOp:
    # I, name, root, shape, opcode, operands, attrs, literal
    result = pyparse.parse_shape(fields[3])
    attr_text = fields[6] if len(fields) > 6 else ""
    attrs: dict[str, str] = {}
    metadata: dict[str, str] = {}
    if attr_text:
        for tok in pyparse.split_top_level(attr_text):
            if not tok:
                continue
            key, eq, val = tok.partition("=")
            key = key.strip()
            if not eq:
                attrs[key] = ""
            elif key == "metadata":
                metadata = pyparse._parse_metadata(val.strip())
            else:
                attrs[key] = val.strip()
    return _finish_op(fields, result, attrs, metadata)


def _decode_shape(enc: str):
    """Rebuild a shape from the v2 scan's prefix token stream (see the
    hlo_scan.cpp header comment for the grammar)."""
    from tpusim_torch.ir import TensorSpec, TupleSpec

    tokens = enc.split(";")
    pos = 0

    def build():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok.startswith("("):
            n = int(tok[1:])
            return TupleSpec(tuple(build() for _ in range(n)))
        dtype, dims, layout, tiling, space = tok.split(":")
        return TensorSpec(
            dtype=dtype,
            shape=(
                tuple(int(d) for d in dims.split(",")) if dims else ()
            ),
            layout=(
                None if layout == "n"
                else tuple(int(x) for x in layout.split(","))
            ),
            tiling=None if tiling == "n" else tiling,
            memory_space=int(space),
        )

    return build()


def _build_op2(fields: list[str]) -> TraceOp:
    # I, name, root, shape_enc, opcode, operands, attr_tokens, literal —
    # shapes decoded from pre-parsed numerics ('!' = per-shape fallback
    # to the reference parser, same error semantics), attr tokens
    # pre-split at depth 0 by the C++ pass
    shape_enc = fields[3]
    if shape_enc.startswith("!"):
        result = pyparse.parse_shape(shape_enc[1:])
    else:
        result = _decode_shape(shape_enc)
    attr_field = fields[6] if len(fields) > 6 else ""
    attrs: dict[str, str] = {}
    metadata: dict[str, str] = {}
    if attr_field:
        for tok in attr_field.split(_GS):
            key, eq, val = tok.partition("=")
            key = key.strip()
            if not eq:
                attrs[key] = ""
            elif key == "metadata":
                metadata = pyparse._parse_metadata(val.strip())
            else:
                attrs[key] = val.strip()
    return _finish_op(fields, result, attrs, metadata)


def parse_hlo_module_fast(
    text: str, name_hint: str = "module", strict: bool = True
) -> ModuleTrace:
    """Native parse when the library is built, Python otherwise.

    ``strict=False`` (skip malformed lines with a counted warning) always
    takes the Python path: the C++ scanner's record stream has no
    per-line error recovery, and salvage mode is for damaged captures
    where robustness beats speed."""
    if strict and native_available():
        return parse_hlo_module_native(text, name_hint)
    return pyparse.parse_hlo_module(text, name_hint, strict=strict)

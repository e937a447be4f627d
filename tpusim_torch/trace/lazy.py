"""Lazy per-computation HLO parsing.

Port of the in-memory half of ``tpusim/trace/lazy.py``.  One cheap
O(text) scan finds computation boundaries, and each computation's ops
are parsed only when the engine first asks for it: a schedule walk
touches the entry plus the computations it calls, leaving unreachable
ones unparsed.  ``load_trace`` builds modules this way when they are
large (:data:`LAZY_THRESHOLD_BYTES`) or when a durable compile store is
active, where a warm store prices from stored columns and never parses.

:class:`LazyModuleTrace` is a drop-in :class:`~tpusim_torch.ir.ModuleTrace`:
``computations`` is a dict subclass that parses on first access.  Bulk
iteration (``values()``/``items()``) forces everything and is avoided by
the engine's capacity pass, which uses the raw-text ``S(1)`` scan
(:meth:`LazyModuleTrace.vmem_resident_bytes`) instead.

Not ported yet: the file-backed streaming module and its lean compile
(ROADMAP A10).
"""

from __future__ import annotations

import re

from tpusim_torch.ir import FREE_OPCODES, ModuleTrace
from tpusim_torch.trace.hlo_text import parse_hlo_module, parse_module_attrs

__all__ = [
    "LAZY_THRESHOLD_BYTES",
    "LazyModuleTrace",
    "STREAM_THRESHOLD_BYTES",
    "parse_hlo_module_lazy",
]

#: load_trace switches to lazy parsing at or above this module-text size
LAZY_THRESHOLD_BYTES = 8 * 1024 * 1024

#: the reference's file-backed streaming threshold (override with
#: $TPUSIM_STREAM_THRESHOLD): ``lint`` walks a module file at or past
#: it one computation at a time instead of materializing it
STREAM_THRESHOLD_BYTES = 64 * 1024 * 1024

# a computation starts at a column-0 header: `%name (args) -> ... {` or
# `ENTRY %name ...` and ends at the next column-0 `}`.  The parameter
# list may contain NESTED parens (tuple-typed parameters) and may wrap
# across lines, so the open is matched by regex and the close by a
# balanced-paren scan (see _match_header).
_COMP_HEAD_OPEN_RE = re.compile(
    r"^(?P<entry>ENTRY\s+)?%?(?P<name>[A-Za-z_][\w.\-]*)\s*\(",
    re.MULTILINE,
)

#: headers longer than this are not headers (balanced-scan cap)
_HEADER_SCAN_CAP = 1 << 20


def _match_header(text: str, start: int = 0) -> tuple[str, bool] | None:
    """``(name, is_entry)`` when ``text[start:]`` begins a computation
    header (``name(params) ->``, params possibly nested or multi-line),
    else None."""
    m = _COMP_HEAD_OPEN_RE.match(text, start)
    if not m:
        return None
    depth = 0
    limit = min(len(text), m.end() + _HEADER_SCAN_CAP)
    for k in range(m.end() - 1, limit):
        c = text[k]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                if text[k + 1:k + 64].lstrip().startswith("->"):
                    return m.group("name"), bool(m.group("entry"))
                return None
    return None


_MODULE_RE = re.compile(r"^HloModule\s+(?P<name>[\w.\-]+),?(?P<attrs>[^\n]*)")

# cheap filter for lines that can possibly pin vmem: a definition (`=`)
# mentioning an `S(n)` layout anywhere.  Deliberately broad — a tuple
# result whose FIRST leaf is an HBM alias but whose second leaf is the
# S(1) allocation must still be scanned; the result-side leaf walk
# decides what counts
_VMEM_DEF_RE = re.compile(r"=.*S\([1-9]\d*\)")
#: every result leaf, positionally (layout optional — an HBM alias leaf
#: still occupies its tuple slot, which the copy-start rule needs)
_VMEM_SHAPE_RE = re.compile(
    r"(?P<dtype>[a-z][a-z0-9]*)\[(?P<dims>[^\]]*)\](?:\{(?P<layout>[^}]*)\})?"
)
_VMEM_SPACE_RE = re.compile(r"S\([1-9]\d*\)")
#: opcode following the result: `...} opcode(` for array results,
#: `...}) opcode(` for tuple results
_OPCODE_AFTER_SHAPE_RE = re.compile(r"[})]\s*([a-z][\w\-]*)\(")

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3": 1,
    "f8e5m2": 1, "f8e4m3fn": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


def _span_end(text: str, start: int) -> int:
    """Index just past the column-0 closing brace of a computation whose
    header starts at ``start``."""
    i = text.find("\n}", start)
    if i < 0:
        return len(text)
    return i + 2


class _LazyComputationDict(dict):
    """name -> Computation, parsing each span on first access."""

    def __init__(self, module: "LazyModuleTrace"):
        super().__init__()
        self._module = module

    def __missing__(self, key: str):
        span = self._module._spans.get(key)
        if span is None:
            raise KeyError(key)
        comp = self._module._parse_span(key, span)
        self[key] = comp
        return comp

    def __contains__(self, key) -> bool:  # noqa: D105
        return dict.__contains__(self, key) or key in self._module._spans

    def get(self, key, default=None):
        # dict.get skips __missing__: without this override the engine's
        # peak-live walk would see no computations on a lazy module and
        # record 0 bytes where the eager walk records the real peak (the
        # JAX package's lazy module does, unless a process-wide memo was
        # filled by an eager parse of the same text first)
        try:
            return self[key]
        except KeyError:
            return default

    def __iter__(self):
        return iter(self._module._spans)

    def __len__(self) -> int:
        return len(self._module._spans)

    def keys(self):  # noqa: D102
        return self._module._spans.keys()

    def values(self):  # noqa: D102 - forces full parse
        return [self[k] for k in self]

    def items(self):  # noqa: D102 - forces full parse
        return [(k, self[k]) for k in self]


class LazyModuleTrace(ModuleTrace):
    """A ModuleTrace whose computations parse on demand.

    Even the computation *span index* (one regex pass over the text)
    builds lazily: a module priced from the durable compile store (whose
    columns carry the entry name) never needs to know where its
    computations live.  ``entry_name`` on an unindexed module, or any
    ``computations`` access, forces the index exactly once."""

    #: class-level defaults so the entry_name property (a data
    #: descriptor, which shadows the dataclass field) works during
    #: ModuleTrace.__init__'s own assignment
    _entry_name: str | None = None
    _spans_cache: dict | None = None

    def __init__(self, text: str, name_hint: str = "module"):
        super().__init__(name=name_hint)
        self._text = text
        self.computations = _LazyComputationDict(self)

        m = _MODULE_RE.search(text)
        if m:
            self.name = m.group("name")
            parse_module_attrs(m.group("attrs") or "", self.meta)

    @property
    def entry_name(self) -> str | None:
        if self._entry_name is None and self._spans_cache is None:
            self._build_spans()
        return self._entry_name

    @entry_name.setter
    def entry_name(self, value) -> None:
        self._entry_name = value

    @property
    def _spans(self) -> dict[str, tuple[int, int]]:
        spans = self._spans_cache
        if spans is None:
            spans = self._build_spans()
        return spans

    def _build_spans(self) -> dict[str, tuple[int, int]]:
        text = self._text
        spans: dict[str, tuple[int, int]] = {}
        for hm in _COMP_HEAD_OPEN_RE.finditer(text):
            # only column-0 headers open computations (ops are indented)
            if hm.start() > 0 and text[hm.start() - 1] != "\n":
                continue
            got = _match_header(text, hm.start())
            if got is None:
                continue
            name, is_entry = got
            spans[name] = (hm.start(), _span_end(text, hm.start()))
            if is_entry:
                self._entry_name = name
        self._spans_cache = spans
        return spans

    @property
    def parsed_count(self) -> int:
        return dict.__len__(self.computations)

    def _parse_span(self, name: str, span: tuple[int, int]):
        fragment = (
            "HloModule __lazy_fragment__\n\n" + self._text[span[0]:span[1]]
        )
        sub = parse_hlo_module(fragment, name_hint="__lazy_fragment__")
        comp = sub.computations.get(name)
        if comp is None:
            # header/name normalization mismatch: take the only computation
            comps = list(sub.computations.values())
            if len(comps) != 1:
                raise KeyError(
                    f"lazy parse of {name!r} produced {len(comps)} "
                    f"computations"
                )
            comp = comps[0]
        comp.is_entry = name == self.entry_name
        return comp

    # -- cheap whole-module scans (no IR construction) ---------------------

    def vmem_resident_bytes(self) -> float:
        """Raw-text equivalent of the engine's S(1) residency walk: sum
        result-layout vmem bytes over *allocating* lines, without parsing
        any computation.  Mirrors ``_vmem_resident_bytes``'s alias rules
        (while/conditional/*-done results, non-entry dynamic-update-slice,
        and all but the destination leaf of copy-start alias existing
        buffers).  Only the RESULT side of each line is scanned: operand
        references carry layouts too, and counting an S(1) operand
        mention would re-count its defining op's buffer."""
        entry_span = (
            self._spans.get(self.entry_name)
            if self.entry_name is not None else None
        )

        def lines():
            offset = 0  # running char offset: O(text), no str.find
            for line in self._text.splitlines(keepends=True):
                yield offset, line
                offset += len(line)

        return _residency_scan(lines(), entry_span)


def parse_hlo_module_lazy(
    text: str, name_hint: str = "module"
) -> LazyModuleTrace:
    return LazyModuleTrace(text, name_hint=name_hint)


def _residency_scan(lines, entry_span: tuple[int, int] | None) -> float:
    """The S(1) residency line scan; ``lines`` yields
    ``(char_offset, line)`` pairs.  Alias rules mirror the engine's
    ``_vmem_resident_bytes`` (see :meth:`LazyModuleTrace.
    vmem_resident_bytes`)."""
    total = 0.0
    for idx, line in lines:
        dm = _VMEM_DEF_RE.search(line)
        if not dm:
            continue
        op_m = _OPCODE_AFTER_SHAPE_RE.search(line)
        if op_m is None:
            # no `shape opcode(` structure: a wrapped header line or
            # degenerate text, never an allocating definition
            continue
        opcode = op_m.group(1)
        in_entry = (
            entry_span is not None
            and entry_span[0] <= idx < entry_span[1]
        )
        if opcode in FREE_OPCODES:
            # entry parameters are real allocations; nested ones alias
            if opcode != "parameter" or not in_entry:
                continue
        if opcode in ("while", "conditional", "call") \
                or opcode.endswith("-done"):
            continue
        if opcode == "dynamic-update-slice" and not in_entry:
            continue
        # the opcode regex anchors on the result's closing brace — keep
        # it in the slice so the shape regex still matches
        result_side = line[:op_m.start() + 1]
        leaves = []  # (bytes, is_vmem) per result leaf, positionally
        for sm in _VMEM_SHAPE_RE.finditer(result_side):
            layout = sm.group("layout")
            vmem = bool(layout and _VMEM_SPACE_RE.search(layout))
            elems = 1
            dims = sm.group("dims").strip()
            if dims:
                for d in dims.split(","):
                    try:
                        elems *= int(d)
                    except ValueError:
                        elems = 0
                        break
            leaves.append(
                (elems * _DTYPE_BYTES.get(sm.group("dtype"), 4), vmem)
            )
        if opcode == "copy-start":
            # result is (dst, src-alias, ctx): only a vmem DST leaf is a
            # new allocation — an S(1) src alias must not re-count
            if leaves and leaves[0][1]:
                total += leaves[0][0]
        elif opcode.endswith("-start"):
            # collective starts carry (operand-alias, result, ...): count
            # one buffer, not the alias pair
            total += max(
                (b for b, vmem in leaves if vmem), default=0.0
            )
        else:
            total += sum(b for b, vmem in leaves if vmem)
    return total

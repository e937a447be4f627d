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

:class:`StreamingModuleTrace` is the file-backed form for modules too
large to hold as text (:data:`STREAM_THRESHOLD_BYTES`): one chunked pass
over the file builds the span index, the content hash and the ICI flag,
computations parse on demand from their span, at most ``parsed_cap``
stay resident, and the fastpath compiles them *lean* (no per-op name
table), releasing each computation's IR once its columns exist.
"""

from __future__ import annotations

import re

from tpusim_torch.ir import FREE_OPCODES, ModuleTrace
from tpusim_torch.trace.hlo_text import parse_module_attrs

__all__ = [
    "LAZY_THRESHOLD_BYTES",
    "LazyModuleTrace",
    "STREAM_THRESHOLD_BYTES",
    "StreamingModuleTrace",
    "parse_hlo_module_lazy",
    "parse_hlo_module_streaming",
]

#: load_trace switches to lazy parsing at or above this module-text size
LAZY_THRESHOLD_BYTES = 8 * 1024 * 1024

#: load_trace switches from in-memory lazy parsing to file-backed
#: streaming at or above this module-text size (override with
#: $TPUSIM_STREAM_THRESHOLD; plain .hlo files only — gzipped modules
#: decompress to memory and take the lazy path); ``lint`` walks such a
#: module file one computation at a time too
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


def _match_header(text: str, start: int = 0):
    """Does ``text[start:]`` begin a computation header (``name(params)
    ->``, params possibly nested or multi-line)?

    ``(name, is_entry)`` on a confirmed header, None when it is not one,
    or the string ``"partial"`` when the text ends before the parameter
    list closes (a streaming caller buffers more lines and retries)."""
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
                rest = text[k + 1:k + 64].lstrip()
                if rest.startswith("->"):
                    return m.group("name"), bool(m.group("entry"))
                if not rest:
                    # params closed at the end of the available text: the
                    # -> may be on a line the caller has not read yet
                    return "partial"
                return None
    return "partial" if limit >= len(text) else None


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


def _unwrap_header(span: str) -> str:
    """A computation's text with a header wrapped over several lines
    joined into one, so that its span parses without the native scanner
    too (the Python parser reads a header from one line; the scanner
    reads either form to the same computation).  A header that fits its
    first line is left as it is."""
    end = span.find("{\n")
    first = span.find("\n")
    if end < 0 or first < 0 or first > end:
        return span
    head = " ".join(part.strip() for part in span[:end].split("\n"))
    return head + span[end:]


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
            if not isinstance(got, tuple):
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
        from tpusim_torch.trace.native import parse_hlo_module_fast

        fragment = (
            "HloModule __lazy_fragment__\n\n"
            + _unwrap_header(self._text[span[0]:span[1]])
        )
        sub = parse_hlo_module_fast(fragment,
                                    name_hint="__lazy_fragment__")
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


# ---------------------------------------------------------------------------
# Streaming (file-backed) modules — bounded-RSS pricing for multi-GB pods
# ---------------------------------------------------------------------------

#: substrings whose presence makes a module's price topology-dependent
#: (mirror of tpusim_torch.perf.cache's collective markers, scanned during
#: the index pass so the result cache never forces a full parse)
_ICI_MARKERS = (
    b"all-reduce", b"all-gather", b"reduce-scatter", b"all-to-all",
    b"collective-permute", b"collective-broadcast",
)
_ICI_OVERLAP = max(len(m) for m in _ICI_MARKERS) - 1

_INDEX_CHUNK = 4 * 1024 * 1024

_libc = None
_libc_tried = False


def _malloc_trim() -> None:
    """Best-effort glibc heap trim (no-op off glibc/Linux)."""
    global _libc, _libc_tried
    if not _libc_tried:
        _libc_tried = True
        try:
            import ctypes

            lib = ctypes.CDLL("libc.so.6", use_errno=False)
            lib.malloc_trim.argtypes = [ctypes.c_size_t]
            _libc = lib
        except (OSError, AttributeError):
            _libc = None
    if _libc is not None:
        try:
            _libc.malloc_trim(0)
        except OSError:
            pass


class _StreamingComputationDict(_LazyComputationDict):
    """Parse-on-demand with bounded retention: at most ``cap`` parsed
    computations stay resident; the oldest parse is dropped when a new
    one would exceed it (spans persist, so an evicted computation simply
    re-parses on its next access)."""

    def __init__(self, module: "StreamingModuleTrace", cap: int):
        super().__init__(module)
        self._cap = max(int(cap), 1)

    def __missing__(self, key: str):
        comp = super().__missing__(key)
        while dict.__len__(self) > self._cap:
            oldest = next(dict.__iter__(self))
            if oldest == key:
                break
            dict.__delitem__(self, oldest)
        return comp


class StreamingModuleTrace(ModuleTrace):
    """A ModuleTrace backed by an on-disk HLO file.

    One chunked pass over the file builds the computation span index,
    the content hash and the ICI-marker flag **without ever holding the
    full text**; computations parse on demand by seeking their span and
    at most ``parsed_cap`` stay resident.  The fastpath prices such
    modules *lean* (``stream_lean``): each reached computation is
    compiled to columns and its parsed IR released at once, so peak RSS
    is bounded by the span index + columns + a handful of parsed
    computations — far below the trace size."""

    #: marks this module for lean fastpath compilation (per-op
    #: aggregates dropped — their name table is the O(trace) term)
    stream_lean = True

    #: a header's parameter list may wrap, but not without bound — drop
    #: a pending candidate past this many buffered chars (not a header)
    _PENDING_CAP = 1 << 20

    def __init__(self, path, name_hint: str = "module",
                 parsed_cap: int = 8):
        import hashlib

        super().__init__(name=name_hint)
        self._path = str(path)
        self._spans: dict[str, tuple[int, int]] = {}
        self.computations = _StreamingComputationDict(self, parsed_cap)

        h = hashlib.sha256()
        uses_ici = False
        self._open_name: str | None = None
        self._open_start = 0
        self._header_seen = False
        # multi-line computation headers (long parameter lists wrap): a
        # column-0 line that starts like a header but whose parameter
        # list is still open buffers continuation lines until the
        # header completes
        self._pending: str | None = None
        self._pending_start = 0
        offset = 0
        with open(self._path, "rb") as f:
            carry = b""
            while True:
                chunk = f.read(_INDEX_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
                if not uses_ici:
                    uses_ici = any(
                        m in carry[-_ICI_OVERLAP:] + chunk
                        for m in _ICI_MARKERS
                    )
                buf = carry + chunk
                lines = buf.split(b"\n")
                carry = lines.pop()  # partial trailing line
                for raw in lines:
                    self._index_line(raw, offset)
                    offset += len(raw) + 1
            if carry:
                self._index_line(carry, offset)
                offset += len(carry)
            if self._open_name is not None:
                # unterminated final computation: span to EOF
                self._spans[self._open_name] = (self._open_start, offset)
        del self._pending, self._pending_start
        del self._open_name, self._open_start, self._header_seen
        self.meta.setdefault("content_hash", h.hexdigest()[:24])
        self._uses_ici_cache = uses_ici

    def _index_line(self, raw: bytes, offset: int) -> None:
        """One line of the index pass (a state machine over column-0
        structure; ``raw`` has no trailing newline)."""
        if self._pending is not None:
            self._pending += "\n" + raw.decode("utf-8", errors="replace")
            got = _match_header(self._pending)
            if isinstance(got, tuple):
                self._open_name, is_entry = got
                self._open_start = self._pending_start
                if is_entry:
                    self.entry_name = self._open_name
                self._pending = None
            elif got is None or len(self._pending) > self._PENDING_CAP:
                # the parameter list closed without the header pattern
                # completing (or grew absurd): not a computation header
                self._pending = None
            return
        if not self._header_seen and raw.startswith(b"HloModule"):
            self._header_seen = True
            m = _MODULE_RE.match(raw.decode("utf-8", errors="replace"))
            if m:
                self.name = m.group("name")
                parse_module_attrs(m.group("attrs") or "", self.meta)
        elif raw[:1] == b"}":
            if self._open_name is not None:
                self._spans[self._open_name] = (
                    self._open_start, offset + len(raw),
                )
                self._open_name = None
        elif raw[:1] not in (b"", b" ", b"\t"):
            text = raw.decode("utf-8", errors="replace")
            got = _match_header(text)
            if isinstance(got, tuple):
                self._open_name, is_entry = got
                self._open_start = offset
                if is_entry:
                    self.entry_name = self._open_name
            elif got == "partial":
                self._pending = text
                self._pending_start = offset

    @property
    def parsed_count(self) -> int:
        return dict.__len__(self.computations)

    _releases = 0

    def release_computation(self, name: str) -> None:
        """Drop a parsed computation's IR (the fastpath calls this right
        after compiling it to columns; the span survives, so a later
        access simply re-parses).  Every 8th release trims the glibc
        heap: parse churn routes the long metadata strings through
        malloc, whose freed chunks otherwise sit in arena free lists and
        count against the bounded-RSS contract."""
        if dict.__contains__(self.computations, name):
            dict.__delitem__(self.computations, name)
        self._releases += 1
        if self._releases % 8 == 0:
            _malloc_trim()

    def _read_span(self, span: tuple[int, int]) -> str:
        with open(self._path, "rb") as f:
            f.seek(span[0])
            return f.read(span[1] - span[0]).decode(
                "utf-8", errors="replace"
            )

    def _parse_span(self, name: str, span: tuple[int, int]):
        from tpusim_torch.trace.native import parse_hlo_module_fast

        fragment = (
            "HloModule __lazy_fragment__\n\n"
            + _unwrap_header(self._read_span(span))
        )
        sub = parse_hlo_module_fast(fragment,
                                    name_hint="__lazy_fragment__")
        comp = sub.computations.get(name)
        if comp is None:
            comps = list(sub.computations.values())
            if len(comps) != 1:
                raise KeyError(
                    f"streaming parse of {name!r} produced {len(comps)} "
                    f"computations"
                )
            comp = comps[0]
        comp.is_entry = name == self.entry_name
        return comp

    def vmem_resident_bytes(self) -> float:
        """Chunk-streamed S(1) residency scan (the contract of the
        in-memory lazy scan; the file is read once, never held)."""
        entry_span = (
            self._spans.get(self.entry_name)
            if self.entry_name is not None else None
        )

        def lines():
            offset = 0
            with open(self._path, "rb") as f:
                carry = b""
                while True:
                    chunk = f.read(_INDEX_CHUNK)
                    if not chunk:
                        break
                    buf = carry + chunk
                    parts = buf.split(b"\n")
                    carry = parts.pop()
                    for raw in parts:
                        yield offset, raw.decode(
                            "utf-8", errors="replace"
                        )
                        offset += len(raw) + 1
                if carry:
                    yield offset, carry.decode("utf-8", errors="replace")

        return _residency_scan(lines(), entry_span)


def parse_hlo_module_streaming(
    path, name_hint: str = "module", parsed_cap: int = 8
) -> StreamingModuleTrace:
    return StreamingModuleTrace(path, name_hint=name_hint,
                                parsed_cap=parsed_cap)

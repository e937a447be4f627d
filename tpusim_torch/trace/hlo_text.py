"""Parser for XLA optimized-HLO text → :mod:`tpusim_torch.ir`.

Port of ``tpusim/trace/hlo_text.py``: the Python parser with its
lenient mode.  The native scanner and the lazy/streaming parsers of the
JAX package are host-side accelerators and are not ported yet.

This is the rebuild of the reference's trace parser
(``gpu-simulator/trace-parser/trace_parser.cc``): where that parses per-warp
SASS instruction lines (``inst_trace_t::parse_from_string``,
``trace_parser.cc:127``) with base+stride/base+delta address decompression,
we parse scheduled HLO text as emitted by ``jax.jit(f).lower(...).compile()
.as_text()`` — the format XLA itself round-trips.  HLO already *is* the right
IR for TPU timing (SURVEY.md §7), so no binary instrumentation or address
decompression is needed; the collective metadata the reference failed to
record (sizes, replica groups — SURVEY.md §5) is right in the op text.

The parser is pure and standalone: text in, :class:`tpusim_torch.ir.ModuleTrace`
out.
"""

from __future__ import annotations

import re

from tpusim_torch.ir import (
    Computation,
    CollectiveInfo,
    ModuleTrace,
    TensorSpec,
    TraceOp,
    TupleSpec,
)

__all__ = ["parse_hlo_module", "parse_shape", "split_top_level"]

#: cap on distinct malformed-line samples kept in lenient-parse meta
#: (``parse_skipped_samples``) — enough to diagnose, bounded for multi-GB
#: traces where every line of a region is torn
_SKIP_SAMPLE_CAP = 8


# ---------------------------------------------------------------------------
# Low-level tokenizing helpers
# ---------------------------------------------------------------------------

_OPENERS = {"(": ")", "{": "}", "[": "]"}
_CLOSERS = {")": "(", "}": "{", "]": "["}


def split_top_level(s: str, sep: str = ",") -> list[str]:
    """Split ``s`` on ``sep`` at nesting depth 0, respecting (), {}, [] and
    double-quoted strings."""
    parts: list[str] = []
    depth = 0
    in_str = False
    start = 0
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c in _OPENERS:
            depth += 1
        elif c in _CLOSERS:
            depth -= 1
        elif c == sep and depth == 0:
            parts.append(s[start:i].strip())
            start = i + 1
        i += 1
    tail = s[start:].strip()
    if tail:
        parts.append(tail)
    return parts


def _find_matching(s: str, open_idx: int) -> int:
    """Index of the closer matching the opener at ``open_idx`` (respects
    quotes)."""
    opener = s[open_idx]
    closer = _OPENERS[opener]
    depth = 0
    in_str = False
    i = open_idx
    n = len(s)
    while i < n:
        c = s[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == opener:
            depth += 1
        elif c == closer:
            depth -= 1
            if depth == 0:
                return i
        i += 1
    raise ValueError(f"unbalanced {opener!r} in: {s[open_idx:open_idx + 80]!r}")


# ---------------------------------------------------------------------------
# Shape parsing
# ---------------------------------------------------------------------------

_SHAPE_RE = re.compile(
    r"^(?P<dtype>[a-z][a-z0-9]*)"          # bf16, f32, pred, token, ...
    r"(?:\[(?P<dims>[^\]]*)\])?"           # [256,512] ([] for scalar)
    r"(?:\{(?P<layout>[^}]*)\})?"          # {1,0:T(8,128)(2,1)S(1)}
    r"$"
)

_COMMENT_RE = re.compile(r"/\*.*?\*/")
_TILING_RE = re.compile(r"T(\([0-9,]*\))+")
_SPACE_RE = re.compile(r"S\((\d+)\)")


def parse_shape(text: str) -> TensorSpec | TupleSpec:
    """Parse one HLO shape string, e.g. ``bf16[256,512]{1,0:T(8,128)(2,1)}``
    or a tuple ``(f32[8]{0}, u32[])``."""
    text = _COMMENT_RE.sub("", text).strip()
    if text.startswith("("):
        end = _find_matching(text, 0)
        inner = text[1:end]
        parts = tuple(parse_shape(p) for p in split_top_level(inner))
        return TupleSpec(parts)
    m = _SHAPE_RE.match(text)
    if not m:
        raise ValueError(f"unparseable HLO shape: {text!r}")
    dtype = m.group("dtype")
    dims_s = m.group("dims")
    shape: tuple[int, ...] = ()
    if dims_s:
        dims = []
        for d in dims_s.split(","):
            d = d.strip().lstrip("<=")  # dynamic dims: "<=128" → bound
            if d:
                dims.append(int(d))
        shape = tuple(dims)
    layout = None
    tiling = None
    space = 0
    lay_s = m.group("layout")
    if lay_s is not None:
        # layout text: "1,0:T(8,128)(2,1)S(1)" / "1,0" / ":T(256)"
        minor, _, extras = lay_s.partition(":")
        minor = minor.strip()
        if minor:
            layout = tuple(int(x) for x in minor.split(",") if x.strip())
        if extras:
            tm = _TILING_RE.search(extras)
            if tm:
                tiling = tm.group(0)[1:]  # drop the 'T'
            sm = _SPACE_RE.search(extras)
            if sm:
                space = int(sm.group(1))
    return TensorSpec(
        dtype=dtype, shape=shape, layout=layout, tiling=tiling,
        memory_space=space,
    )


# ---------------------------------------------------------------------------
# Attribute parsing
# ---------------------------------------------------------------------------

#: attr keys whose values name other computations.
_CALLED_KEYS = (
    "calls", "to_apply", "condition", "body", "true_computation",
    "false_computation", "branch_computations", "called_computations",
    "select", "scatter",
)

_REPLICA_GROUPS_IOTA_RE = re.compile(
    r"\[(?P<dims>[0-9,]+)\]<=\[(?P<total>[0-9,]+)\]"
    r"(?:T\((?P<perm>[0-9,]+)\))?"
)


def _parse_replica_groups(val: str) -> tuple[tuple[int, ...], ...]:
    """Parse ``{{0,1},{2,3}}`` or iota form ``[2,2]<=[4]``.

    The iota form may carry a transpose suffix — ``[2,2]<=[2,2]T(1,0)``
    reshapes ``[0..4)`` to a 2x2 grid, transposes it, and reads groups
    along the last dim, yielding the STRIDED groups ``{0,2},{1,3}``
    (how XLA encodes a major-mesh-axis collective, e.g. the dp gradient
    all-reduce of a dp x tp mesh).  Group membership matters: the
    rendezvous keys of the replay driver and the mesh-axis role
    classification of ``tpusim.advise`` both read it."""
    val = val.strip()
    m = _REPLICA_GROUPS_IOTA_RE.match(val)
    if m:
        dims = [int(x) for x in m.group("dims").split(",")]
        reshape = [int(x) for x in m.group("total").split(",")]
        total = 1
        for x in reshape:
            total *= x
        ids = list(range(total))
        perm = m.group("perm")
        if perm is not None and len(reshape) > 1:
            # reshape to `reshape`, transpose by perm, then flatten:
            # out[j] = ids at the source multi-index perm-mapped from j
            axes = [int(x) for x in perm.split(",")]
            if sorted(axes) == list(range(len(reshape))):
                out_dims = [reshape[a] for a in axes]
                strides = [1] * len(reshape)
                for i in range(len(reshape) - 2, -1, -1):
                    strides[i] = strides[i + 1] * reshape[i + 1]
                flat: list[int] = []
                idx = [0] * len(out_dims)
                for _ in range(total):
                    src = sum(
                        idx[j] * strides[axes[j]]
                        for j in range(len(axes))
                    )
                    flat.append(ids[src])
                    for j in range(len(out_dims) - 1, -1, -1):
                        idx[j] += 1
                        if idx[j] < out_dims[j]:
                            break
                        idx[j] = 0
                ids = flat
        # iota groups: reshape [0..total) to dims; groups along last dim.
        group_size = dims[-1] if dims else 1
        n_groups = max(total // max(group_size, 1), 1)
        it = iter(ids)
        return tuple(
            tuple(next(it) for _ in range(group_size)) for _ in range(n_groups)
        )
    if not val.startswith("{"):
        return ()
    inner = val[1:-1].strip()
    if not inner:
        return ()
    groups = []
    for part in split_top_level(inner):
        part = part.strip()
        if part.startswith("{"):
            part = part[1:-1]
        nums = tuple(int(x) for x in part.split(",") if x.strip())
        groups.append(nums)
    return tuple(groups)


def _parse_int_set(val: str) -> tuple[int, ...]:
    val = val.strip().strip("{}")
    return tuple(int(x) for x in val.split(",") if x.strip())


def _parse_pairs(val: str) -> tuple[tuple[int, int], ...]:
    """Parse ``{{0,1},{1,2}}`` into pairs."""
    val = val.strip()
    if val.startswith("{"):
        val = val[1:-1]
    pairs = []
    for part in split_top_level(val):
        part = part.strip()
        if not part:
            continue
        nums = _parse_int_set(part)
        if len(nums) == 2:
            pairs.append((nums[0], nums[1]))
    return tuple(pairs)


def _collect_called(attrs: dict[str, str]) -> tuple[str, ...]:
    called: list[str] = []
    for key in _CALLED_KEYS:
        if key not in attrs:
            continue
        val = attrs[key].strip()
        if val.startswith("{"):
            val = val[1:-1]
        for tok in split_top_level(val):
            tok = tok.strip()
            if tok.startswith("%"):
                called.append(tok[1:])
            elif tok:
                called.append(tok)
    return tuple(called)


def _maybe_collective(opcode_base: str, attrs: dict[str, str]) -> CollectiveInfo | None:
    from tpusim_torch.ir import COLLECTIVE_OPCODES

    if opcode_base not in COLLECTIVE_OPCODES:
        return None
    rg = ()
    if "replica_groups" in attrs:
        rg = _parse_replica_groups(attrs["replica_groups"])
    channel = None
    if "channel_id" in attrs:
        try:
            channel = int(attrs["channel_id"])
        except ValueError:
            pass
    pairs = ()
    if "source_target_pairs" in attrs:
        pairs = _parse_pairs(attrs["source_target_pairs"])
    dims = ()
    if "dimensions" in attrs:
        dims = _parse_int_set(attrs["dimensions"])
    split_dim = None
    for k in ("split_dimension", "dimension"):
        if k in attrs:
            try:
                split_dim = int(attrs[k])
            except ValueError:
                pass
            break
    return CollectiveInfo(
        kind=opcode_base,
        replica_groups=rg,
        channel_id=channel,
        use_global_device_ids=attrs.get("use_global_device_ids", "") == "true",
        source_target_pairs=pairs,
        split_dimension=split_dim,
        dimensions=dims,
    )


# ---------------------------------------------------------------------------
# Instruction-line parsing
# ---------------------------------------------------------------------------

_INSTR_RE = re.compile(
    r"^(?P<root>ROOT\s+)?%?(?P<name>[\w.\-]+)\s*=\s*(?P<rest>.+)$"
)

_METADATA_FIELD_RE = re.compile(r'(\w+)=(?:"((?:[^"\\]|\\.)*)"|(\S+))')


def _parse_metadata(val: str) -> dict[str, str]:
    val = val.strip()
    if val.startswith("{"):
        val = val[1:-1]
    out = {}
    for m in _METADATA_FIELD_RE.finditer(val):
        out[m.group(1)] = m.group(2) if m.group(2) is not None else m.group(3)
    return out


def _parse_operands(operand_str: str) -> tuple[str, ...]:
    """Extract operand value names from the call parens.  Tolerates both
    typed (``f32[2]{0} %a``) and untyped (``%a``) operand syntax; skips
    literals (constants) which carry no ``%``."""
    names = []
    for part in split_top_level(operand_str):
        part = part.strip()
        if not part:
            continue
        # the operand name is the last %-token in the fragment
        idx = part.rfind("%")
        if idx >= 0:
            tok = part[idx + 1:]
            tok = tok.split()[0] if tok.split() else ""
            names.append(tok.rstrip(","))
    return tuple(names)


def parse_instruction(line: str) -> TraceOp | None:
    """Parse one instruction line of a computation body.  Returns None for
    non-instruction lines (blank, comments, closing braces)."""
    line = line.strip()
    if not line or line in ("}", "{") or line.startswith("//"):
        return None
    m = _INSTR_RE.match(line)
    if not m:
        return None
    rest = m.group("rest").strip()

    # result shape: either a tuple "(...)" or "dtype[...]{...}"
    if rest.startswith("("):
        end = _find_matching(rest, 0)
        shape_text = rest[: end + 1]
        rest = rest[end + 1:].strip()
    else:
        sp = rest.find(" ")
        if sp < 0:
            return None
        shape_text = rest[:sp]
        rest = rest[sp + 1:].strip()
    result = parse_shape(shape_text)

    # opcode and its argument parens
    paren = rest.find("(")
    if paren < 0:
        return None
    opcode = rest[:paren].strip()
    close = _find_matching(rest, paren)
    operand_str = rest[paren + 1: close]
    attr_str = rest[close + 1:].lstrip(", ")

    operands = _parse_operands(operand_str)

    attrs: dict[str, str] = {}
    metadata: dict[str, str] = {}
    if attr_str:
        for tok in split_top_level(attr_str):
            if not tok:
                continue
            key, eq, val = tok.partition("=")
            key = key.strip()
            if not eq:
                attrs[key] = ""
                continue
            val = val.strip()
            if key == "metadata":
                metadata = _parse_metadata(val)
            else:
                attrs[key] = val

    from tpusim_torch.ir import base_opcode

    if opcode == "constant":
        # preserve the literal so loop analysis can resolve scalar bounds
        attrs.setdefault("literal", operand_str.strip())
    elif opcode == "parameter":
        # preserve the index so fusion costing can map operands to params
        attrs.setdefault("param_index", operand_str.strip())

    op = TraceOp(
        name=m.group("name"),
        opcode=opcode,
        result=result,
        operands=operands,
        called=_collect_called(attrs),
        fusion_kind=attrs.get("kind"),
        collective=_maybe_collective(base_opcode(opcode), attrs),
        attrs=attrs,
        metadata=metadata,
        is_root=bool(m.group("root")),
    )
    return op


# ---------------------------------------------------------------------------
# Module-level parsing
# ---------------------------------------------------------------------------

_COMP_HEADER_RE = re.compile(
    r"^(?P<entry>ENTRY\s+)?%?(?P<name>[\w.\-]+)\s*"
    r"\((?P<params>.*)\)\s*->\s*(?P<ret>.+?)\s*\{\s*$"
)

_MODULE_RE = re.compile(r"^HloModule\s+(?P<name>[\w.\-]+)\s*(?:,\s*(?P<attrs>.*))?$")

_MODULE_INT_ATTRS = ("replica_count", "num_partitions")


def parse_module_attrs(attr_text: str, meta: dict) -> None:
    """Parse the HloModule header attr list into ``meta``."""
    for tok in split_top_level(attr_text):
        key, eq, val = tok.partition("=")
        if not eq:
            continue
        key, val = key.strip(), val.strip()
        if key in _MODULE_INT_ATTRS:
            try:
                meta[key] = int(val)
            except ValueError:
                pass
        elif key == "is_scheduled":
            meta[key] = val == "true"


def parse_hlo_module(
    text: str, name_hint: str = "module", strict: bool = True
) -> ModuleTrace:
    """Parse a full HLO module text dump into a :class:`ModuleTrace`.

    Accepts the output of ``compiled.as_text()`` (scheduled, optimized TPU
    HLO with layouts) as well as unoptimized ``lowered.as_text()`` dumps and
    hand-written fixtures.  Trailing sections (e.g. the ``FileLocations`` /
    ``StackFrames`` tables emitted by newer XLA) are ignored.

    ``strict=False`` is the salvage mode for flaky captures: a malformed
    instruction line (truncated write, corrupted shape, unbalanced
    delimiters) is SKIPPED with a counted warning instead of raising
    mid-file — one corrupt line no longer loses a whole multi-GB trace.
    The skip count lands in ``module.meta['parse_skipped_lines']`` and a
    single ``UserWarning`` summarizes the damage; repeated copies of the
    same corrupt line (a torn buffer flushed in a loop writes thousands
    of identical ones) are DEDUPLICATED — the warning and the
    ``parse_skipped_samples`` meta field carry only the distinct line
    texts (first :data:`_SKIP_SAMPLE_CAP`), with
    ``parse_skipped_distinct`` holding the distinct count.  The static
    analyzer surfaces the same damage as a warning-level ``TL012``
    diagnostic (``tpusim lint``).  Strict (raising) parsing remains the
    default: silent data loss must be opted into.
    """
    module = ModuleTrace(name=name_hint)
    current: Computation | None = None
    skipped = 0
    # distinct corrupt lines are tracked by HASH (O(1) memory per line,
    # not the line text — a multi-GB damaged region must not be held in
    # RAM); only the first few full texts are kept as samples
    skipped_hashes: set[int] = set()
    skipped_samples: list[str] = []

    for raw in text.splitlines():
        line = raw.rstrip()
        stripped = line.strip()
        if not stripped:
            continue

        # Auxiliary tables XLA interleaves into dumps (FileNames,
        # FunctionNames, FileLocations, StackFrames): a section-name line
        # followed by numbered entries.  Skip both forms outside
        # computation bodies.
        if current is None and (
            stripped in (
                "FileNames", "FunctionNames", "FileLocations", "StackFrames",
            )
            or stripped[0].isdigit()
        ):
            continue

        mm = _MODULE_RE.match(stripped)
        if mm and current is None:
            module.name = mm.group("name")
            parse_module_attrs(mm.group("attrs") or "", module.meta)
            continue

        ch = _COMP_HEADER_RE.match(stripped)
        if ch and current is None:
            current = Computation(
                name=ch.group("name"), is_entry=bool(ch.group("entry"))
            )
            continue

        if current is not None:
            if stripped == "}":
                module.add_computation(current)
                current = None
                continue
            try:
                op = parse_instruction(stripped)
            except ValueError as e:
                if strict:
                    raise ValueError(
                        f"{name_hint}: malformed HLO line "
                        f"{stripped[:120]!r}: {e}"
                    ) from e
                skipped += 1
                h = hash(stripped)
                if h not in skipped_hashes:
                    skipped_hashes.add(h)
                    if len(skipped_samples) < _SKIP_SAMPLE_CAP:
                        skipped_samples.append(
                            f"{stripped[:80]!r}: {e}"
                        )
                continue
            if op is not None:
                current.add(op)

    if current is not None:  # unterminated last computation (tolerate)
        module.add_computation(current)
    if skipped:
        import warnings

        module.meta["parse_skipped_lines"] = skipped
        module.meta["parse_skipped_distinct"] = len(skipped_hashes)
        module.meta["parse_skipped_samples"] = list(skipped_samples)
        warnings.warn(
            f"lenient HLO parse of {module.name!r}: skipped {skipped} "
            f"malformed line(s) ({len(skipped_hashes)} distinct); "
            f"first: {skipped_samples[0]}",
            UserWarning,
            stacklevel=2,
        )
    return module

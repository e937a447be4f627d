"""Trace passes: static checks over a trace directory, pre cycle 0.

The Accel-Sim pipeline silently trusts its trace directories — a
malformed ``kernelslist.g`` entry or a config/trace mismatch surfaces as
a crash (or a wrong number) deep inside the cycle loop.  These passes
verify the cross-artifact contracts a tpusim trace dir carries
(``meta.json`` ↔ ``modules/*.hlo`` ↔ ``commandlist.jsonl``) *before*
anything is priced:

* **HLO dataflow** — def-before-use and schedule-order use (TL001/002,
  riding the def-use chains of :mod:`tpusim_torch.analysis.dataflow`), opcode
  arity (TL003), elementwise shape/dtype agreement (TL004), while
  body/condition shape contracts (TL005), called-computation
  referential integrity (TL013), ENTRY presence (TL011);
* **collective semantics** — result bytes vs operand shapes and group
  size (TL008), replica-group range/duplication (TL009) and pod tiling
  (TL014);
* **commandlist referential integrity** — JSONL syntax (TL010), module
  references (TL006), device-id range (TL007), zero-byte standalone
  collectives (TL015);
* **cross-device collective matching** — the TL41x deadlock shapes
  (:mod:`tpusim_torch.analysis.collective_passes`) over the aligned
  per-device command streams;
* **salvage damage** — malformed lines a lenient parse would skip
  (TL012).

Anchors: every module diagnostic carries ``modules/<name>.hlo:<line>``
and every command diagnostic ``commandlist.jsonl:<line>``, so findings
are jump-to-able from an editor or CI log.

**Streaming discipline**: every module pass consumes computations one
at a time through :meth:`ParsedModule.iter_computations`.  Modules past
the trace layer's streaming threshold are never materialized — the
same line-anchored parser runs incrementally over the file, each
computation is checked and summarized (def-use defects, liveness
summary for the TL4xx memory passes, while/call signatures for the
deferred cross-computation checks) and then dropped, so ``tpusim
lint`` on a multi-GB pod holds the same RSS bound streaming pricing
does.

Port of ``tpusim/analysis/trace_passes.py``.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.analysis.dataflow import ModuleDataflow, ModuleDataflowBuilder
from tpusim_torch.analysis.diagnostics import Diagnostics
from tpusim_torch.ir import (
    COLLECTIVE_OPCODES,
    Computation,
    ModuleTrace,
    TensorSpec,
    TraceOp,
    TupleSpec,
    base_opcode,
)
from tpusim_torch.trace.hlo_text import (
    _COMP_HEADER_RE,
    _MODULE_RE,
    parse_instruction,
    parse_module_attrs,
)

__all__ = ["ParsedTrace", "load_parsed_trace", "run_trace_passes"]


# ---------------------------------------------------------------------------
# Line-anchored module parse (mirrors hlo_text.parse_hlo_module, but keeps
# the line number of every op — the parser discards it, the linter is
# *about* it)
# ---------------------------------------------------------------------------


_AUX_SECTIONS = (
    "FileNames", "FunctionNames", "FileLocations", "StackFrames",
)


def _lint_stream_threshold() -> int:
    """Module files at or past this size lint incrementally (deferred
    per-computation parse) instead of materializing — the same
    threshold + override the trace layer's streaming parse uses."""
    from tpusim_torch.trace.lazy import STREAM_THRESHOLD_BYTES

    try:
        return int(os.environ.get(
            "TPUSIM_STREAM_THRESHOLD", STREAM_THRESHOLD_BYTES
        ))
    except ValueError:
        return STREAM_THRESHOLD_BYTES


@dataclass
class ParsedModule:
    """One module plus the artifact anchors the passes report against.

    Eager form: ``module`` carries every parsed computation and
    ``op_lines`` every op's line anchor.  Deferred form
    (``deferred_path`` set): only the module header is parsed at load;
    :meth:`iter_computations` re-walks the file one computation at a
    time and nothing op-sized is retained."""

    key: str                     # trace key (file stem)
    file: str                    # anchor path, e.g. "modules/foo.hlo"
    module: ModuleTrace = field(default_factory=lambda: ModuleTrace(""))
    #: (computation name, op name) -> 1-based line number (eager only)
    op_lines: dict[tuple[str, str], int] = field(default_factory=dict)
    #: computation name -> header line number
    comp_lines: dict[str, int] = field(default_factory=dict)
    #: malformed lines a lenient parse would skip: (lineno, error)
    skipped: list[tuple[int, str]] = field(default_factory=list)
    #: set for above-threshold modules: lint re-walks this file
    #: incrementally instead of holding its text
    deferred_path: Path | None = None
    #: per-space liveness result, filled by run_trace_passes (the
    #: TL4xx memory passes and advise consume it)
    dataflow: ModuleDataflow | None = None

    def iter_computations(self):
        """Yield ``(comp, header_line, op_lines)`` per computation —
        from memory (eager) or straight off the file (deferred)."""
        if self.deferred_path is None:
            by_comp: dict[str, dict[str, int]] = {}
            for (cname, oname), line in self.op_lines.items():
                by_comp.setdefault(cname, {})[oname] = line
            for name, comp in self.module.computations.items():
                yield (
                    comp,
                    self.comp_lines.get(name, 1),
                    by_comp.get(name, {}),
                )
            return
        feed = _ModuleLineFeed(self)
        with open(self.deferred_path, "rt", errors="replace") as f:
            for lineno, raw in enumerate(f, 1):
                done = feed.feed(lineno, raw.rstrip("\n"))
                if done is not None:
                    yield done
        done = feed.flush()
        if done is not None:
            yield done


class _ModuleLineFeed:
    """The incremental line-anchored parser both module forms share —
    one state machine, so the eager and streaming lint paths can never
    drift.  ``feed`` returns ``(comp, header_line, op_lines)`` when a
    computation closes."""

    def __init__(self, pm: ParsedModule):
        self.pm = pm
        self.current: Computation | None = None
        self.current_line = 0
        self.op_lines: dict[str, int] = {}

    def feed(self, lineno: int, raw: str):
        pm = self.pm
        stripped = raw.strip()
        if not stripped:
            return None
        if self.current is None and (
            stripped in _AUX_SECTIONS or stripped[0].isdigit()
        ):
            return None
        mm = _MODULE_RE.match(stripped)
        if mm and self.current is None:
            pm.module.name = mm.group("name")
            parse_module_attrs(mm.group("attrs") or "", pm.module.meta)
            return None
        ch = _COMP_HEADER_RE.match(stripped)
        if ch and self.current is None:
            self.current = Computation(
                name=ch.group("name"), is_entry=bool(ch.group("entry"))
            )
            self.current_line = lineno
            self.op_lines = {}
            pm.comp_lines[self.current.name] = lineno
            if self.current.is_entry:
                pm.module.entry_name = self.current.name
            return None
        if self.current is not None:
            if stripped == "}":
                return self._close()
            try:
                op = parse_instruction(stripped)
            except ValueError as e:
                pm.skipped.append((lineno, f"{stripped[:80]!r}: {e}"))
                return None
            if op is not None:
                self.current.add(op)
                self.op_lines[op.name] = lineno
        return None

    def _close(self):
        done = (self.current, self.current_line, self.op_lines)
        self.current = None
        self.op_lines = {}
        return done

    def flush(self):
        if self.current is not None:
            return self._close()
        return None


@dataclass
class ParsedTrace:
    """A trace dir loaded for analysis: modules with line maps, raw
    command records with line numbers, and the declared pod size."""

    path: Path
    meta: dict = field(default_factory=dict)
    meta_error: str | None = None
    modules: dict[str, ParsedModule] = field(default_factory=dict)
    #: (lineno, record | None, error | None) from commandlist.jsonl
    commands: list[tuple[int, dict | None, str | None]] = field(
        default_factory=list
    )
    has_commandlist: bool = False

    @property
    def meta_devices(self) -> int | None:
        """Pod size ``meta.json`` EXPLICITLY declares, or None.  Only
        this gates the device-id/group range checks: a module's
        replica*partition product is not a pod declaration (a 1-wide
        module legitimately replays on every lane of a wider pod)."""
        try:
            n = int(self.meta.get("num_devices", 0) or 0)
        except (TypeError, ValueError):
            return None
        return n if n > 0 else None

    @property
    def replay_devices(self) -> int:
        """The pod size the driver would actually replay with — mirrors
        ``SimDriver.run``'s ``n_devices`` (max of the meta declaration,
        the widest module, and the command-stream lane count), so the
        schedule passes bind faults against the same topology the
        replay builds."""
        lanes = {
            rec.get("device", 0)
            for _, rec, err in self.commands
            if err is None and isinstance(rec.get("device", 0), int)
        }
        return max(
            self.meta_devices or 0,
            max(
                (pm.module.num_devices for pm in self.modules.values()),
                default=1,
            ),
            len(lanes) or 1,
            1,
        )


def _parse_module_lines(key: str, file: str, text: str) -> ParsedModule:
    pm = ParsedModule(key=key, file=file)
    pm.module.name = key
    feed = _ModuleLineFeed(pm)

    def retain(done) -> None:
        comp, _line, op_lines = done
        pm.module.add_computation(comp)
        for oname, lineno in op_lines.items():
            pm.op_lines[(comp.name, oname)] = lineno

    for lineno, raw in enumerate(text.splitlines(), 1):
        done = feed.feed(lineno, raw)
        if done is not None:
            retain(done)
    done = feed.flush()
    if done is not None:
        retain(done)
    return pm


def _parse_module_header(key: str, file: str, path: Path) -> ParsedModule:
    """Deferred form: parse only the ``HloModule`` header line (name +
    meta — ``replay_devices`` needs ``num_partitions`` before any pass
    runs), leave the computations on disk."""
    pm = ParsedModule(key=key, file=file, deferred_path=path)
    pm.module.name = key
    with open(path, "rt", errors="replace") as f:
        for _ in range(64):  # the header leads every XLA dump
            line = f.readline()
            if not line:
                break
            mm = _MODULE_RE.match(line.strip())
            if mm:
                pm.module.name = mm.group("name")
                parse_module_attrs(
                    mm.group("attrs") or "", pm.module.meta
                )
                break
    return pm


def load_parsed_trace(path: str | Path) -> ParsedTrace:
    """Load a trace dir for analysis (never raises on artifact damage —
    damage becomes diagnostics, that's the point).  Module files at or
    past the streaming threshold load in deferred form and are
    re-walked one computation at a time by the passes."""
    from tpusim_torch.trace.format import iter_commandlist

    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"trace directory not found: {path}")
    pt = ParsedTrace(path=path)
    meta_path = path / "meta.json"
    if meta_path.exists():
        try:
            pt.meta = json.loads(meta_path.read_text())
        except json.JSONDecodeError as e:
            pt.meta_error = f"invalid JSON: {e}"
        else:
            if not isinstance(pt.meta, dict):
                pt.meta_error = "meta.json is not an object"
                pt.meta = {}

    threshold = _lint_stream_threshold()
    modules_dir = path / "modules"
    if modules_dir.is_dir():
        # parse each module as it is read — holding every module's text
        # at once would double peak memory on multi-GB trace dirs; past
        # the streaming threshold the text is never held at all
        for mp in sorted(modules_dir.glob("*.hlo")):
            anchor = f"modules/{mp.name}"
            try:
                big = mp.stat().st_size >= threshold
            except OSError:
                big = False
            if big:
                pt.modules[mp.stem] = _parse_module_header(
                    mp.stem, anchor, mp
                )
            else:
                pt.modules[mp.stem] = _parse_module_lines(
                    mp.stem, anchor, mp.read_text()
                )
        for mp in sorted(modules_dir.glob("*.hlo.gz")):
            key = mp.name[: -len(".hlo.gz")]
            with gzip.open(mp, "rt") as f:
                pt.modules[key] = _parse_module_lines(
                    key, f"modules/{mp.name}", f.read()
                )

    cl = path / "commandlist.jsonl"
    if cl.exists():
        pt.has_commandlist = True
        pt.commands = list(iter_commandlist(cl))
    return pt


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------


def _shape_key(spec) -> object:
    """Structural (dtype, dims) key — layouts/tilings excluded: two specs
    with the same key hold the same logical data."""
    if isinstance(spec, TupleSpec):
        return tuple(_shape_key(p) for p in spec.parts)
    return (spec.dtype, spec.shape)


# ---------------------------------------------------------------------------
# Opcode arity table (curated: only opcodes whose arity is fixed; variadic
# opcodes — concatenate, fusion, reduce, dynamic-slice... — are skipped)
# ---------------------------------------------------------------------------

_UNARY = frozenset({
    "abs", "cbrt", "ceil", "convert", "copy", "cos", "cosh", "erf", "exp",
    "expm1", "floor", "imag", "is-finite", "log", "log1p", "logistic",
    "negate", "not", "popcnt", "real", "round-nearest-afz",
    "round-nearest-even", "rsqrt", "sign", "sin", "sinh", "sqrt", "tan",
    "tanh", "bitcast", "bitcast-convert", "broadcast", "reshape",
    "reverse", "transpose", "slice", "get-tuple-element", "while",
    "copy-start", "copy-done", "optimization-barrier",
})

#: elementwise binaries with matching operand/result shapes AND dtypes
_ELEMENTWISE_BINARY = frozenset({
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "power", "remainder", "atan2", "and", "or", "xor", "shift-left",
    "shift-right-arithmetic", "shift-right-logical",
})

_BINARY = _ELEMENTWISE_BINARY | frozenset({"compare", "pad", "dot"})

_TERNARY = frozenset({"select", "clamp"})


def _expected_arity(base: str) -> int | None:
    if base in _UNARY:
        return 1
    if base in _BINARY:
        return 2
    if base in _TERNARY:
        return 3
    return None


# ---------------------------------------------------------------------------
# Per-computation passes (fed one computation at a time)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _CompSig:
    """The O(1) signature of a computation the deferred
    cross-computation checks (TL005 while contracts) resolve against
    after the module's one-at-a-time walk completes."""

    n_params: int
    param0_key: object
    param0_str: str
    root_key: object
    root_str: str
    root_is_scalar_pred: bool
    has_ops: bool


def _comp_sig(comp: Computation) -> _CompSig:
    params = comp.parameters
    root = comp.root if comp.ops else None
    r = root.result if root is not None else None
    return _CompSig(
        n_params=len(params),
        param0_key=(
            _shape_key(params[0].result) if params else None
        ),
        param0_str=str(params[0].result) if params else "",
        root_key=_shape_key(r) if r is not None else None,
        root_str=str(r) if r is not None else "",
        root_is_scalar_pred=bool(
            isinstance(r, TensorSpec)
            and r.dtype == "pred" and r.shape == ()
        ),
        has_ops=bool(comp.ops),
    )


@dataclass
class _PendingWhile:
    """One while op awaiting its body/condition signatures."""

    comp_name: str
    op_name: str
    result_str: str
    want: object
    body: str
    cond: str
    line: int | None


class _ModuleChecks:
    """All module-family passes over one module, one computation at a
    time.  Cross-computation state is O(#computations + #unresolved
    references), never O(ops) — the streaming lint bound."""

    def __init__(self, pm: ParsedModule, diags: Diagnostics):
        self.pm = pm
        self.diags = diags
        self.builder = ModuleDataflowBuilder()
        self.sigs: dict[str, _CompSig] = {}
        #: called targets not yet seen: name -> [(comp, op, line)]
        self.pending_called: dict[str, list] = {}
        self.pending_while: list[_PendingWhile] = []

    def feed(self, comp: Computation, op_lines: dict[str, int]) -> None:
        pm, diags = self.pm, self.diags
        module = pm.module
        is_entry = comp.is_entry or module.entry_name == comp.name
        cdf = self.builder.feed(comp, is_entry)
        pos = cdf.defs

        def anchor(op: TraceOp) -> int | None:
            return op_lines.get(op.name)

        # TL001/TL002 straight off the def-use chains
        for i, operand in cdf.undefined:
            op = comp.ops[i]
            diags.emit(
                "TL001",
                f"{module.name}/{comp.name}: %{op.name} reads "
                f"%{operand}, which is never defined in this "
                f"computation",
                file=pm.file, line=anchor(op),
            )
        for i, operand, j in cdf.misordered:
            op = comp.ops[i]
            diags.emit(
                "TL002",
                f"{module.name}/{comp.name}: %{op.name} reads "
                f"%{operand} before its definition (schedule "
                f"position {j} >= {i})",
                file=pm.file, line=anchor(op),
            )

        for i, op in enumerate(comp.ops):
            base = op.base
            want = _expected_arity(base)
            if want is not None and len(op.operands) != want:
                diags.emit(
                    "TL003",
                    f"{module.name}/{comp.name}: {op.opcode} "
                    f"%{op.name} has {len(op.operands)} operand(s); "
                    f"{base} takes exactly {want}",
                    file=pm.file, line=anchor(op),
                )
            for called in op.called:
                # XLA dumps define callees before callers, so almost
                # every target resolves immediately; the rest wait for
                # finish() (a target that never appears is TL013)
                if called not in self.sigs and \
                        called not in pm.comp_lines:
                    self.pending_called.setdefault(called, []).append(
                        (comp.name, op.name, anchor(op))
                    )
            if base == "while":
                line = anchor(op)
                self.pending_while.append(_PendingWhile(
                    comp_name=comp.name,
                    op_name=op.name,
                    result_str=str(op.result),
                    want=_shape_key(op.result),
                    body=op.attrs.get("body", "").lstrip("%"),
                    cond=op.attrs.get("condition", "").lstrip("%"),
                    line=line,
                ))
            if (
                base in _ELEMENTWISE_BINARY
                and len(op.operands) == 2
                and isinstance(op.result, TensorSpec)
            ):
                specs = []
                for operand in op.operands:
                    j = pos.get(operand)
                    if j is None or j >= i:
                        break
                    r = comp.ops[j].result
                    if not isinstance(r, TensorSpec):
                        break
                    specs.append(r)
                if len(specs) == 2:
                    keys = {_shape_key(s) for s in specs}
                    keys.add(_shape_key(op.result))
                    if len(keys) > 1:
                        shapes = ", ".join(str(s) for s in specs)
                        diags.emit(
                            "TL004",
                            f"{module.name}/{comp.name}: {base} "
                            f"%{op.name} -> {op.result} has "
                            f"inconsistent operand shapes ({shapes})",
                            file=pm.file, line=anchor(op),
                        )

        self._check_collectives(comp, pos, op_lines)
        self.sigs[comp.name] = _comp_sig(comp)
        self.pending_called.pop(comp.name, None)

    def _check_collectives(
        self, comp: Computation, pos: dict[str, int],
        op_lines: dict[str, int],
    ) -> None:
        """TL008 byte-count consistency + TL009/TL014 on module
        collectives."""
        pm, diags = self.pm, self.diags
        module = pm.module
        for i, op in enumerate(comp.ops):
            base = base_opcode(op.opcode)
            if base not in COLLECTIVE_OPCODES or op.collective is None:
                continue
            line = op_lines.get(op.name)
            ci = op.collective
            _check_groups(
                ci.replica_groups, module.num_devices,
                f"{module.name}/{comp.name}: {op.opcode} %{op.name}",
                diags, pm.file, line,
            )
            # byte-count relation: sync ops with resolvable operands only
            # (async -start results interpose buffer tuples; variadic
            # forms compare the summed element counts)
            if op.is_async_start or op.is_async_done:
                continue
            in_elems = 0.0
            ok = bool(op.operands)
            for operand in op.operands:
                j = pos.get(operand)
                if j is None or j >= i:
                    ok = False
                    break
                in_elems += comp.ops[j].result.elems
            if not ok:
                continue
            out_elems = float(op.result.elems)
            gs = ci.group_size if ci.replica_groups else None
            expect: float | None = None
            if base == "all-reduce":
                expect = in_elems
            elif base == "all-gather" and gs:
                expect = in_elems * gs
            elif base == "reduce-scatter" and gs:
                expect = in_elems / gs
            if expect is not None and out_elems != expect:
                diags.emit(
                    "TL008",
                    f"{module.name}/{comp.name}: {base} %{op.name} "
                    f"result has {out_elems:g} elements; operands "
                    f"({in_elems:g} elements"
                    + (f", group size {gs}" if gs else "")
                    + f") imply {expect:g}",
                    file=pm.file, line=line,
                )

    def finish(self, check_entry: bool) -> None:
        pm, diags = self.pm, self.diags
        module = pm.module
        if check_entry and module.entry_name is None:
            diags.emit(
                "TL011",
                f"module {module.name!r} has no ENTRY computation — "
                f"the engine cannot replay it",
                file=pm.file,
                line=min(pm.comp_lines.values(), default=1),
            )
        for called, sites in sorted(self.pending_called.items()):
            for comp_name, op_name, line in sites:
                diags.emit(
                    "TL013",
                    f"{module.name}/{comp_name}: %{op_name} calls "
                    f"computation %{called}, which the module does "
                    f"not contain (truncated trace?)",
                    file=pm.file, line=line,
                )
        for w in self.pending_while:
            for role, name in (("body", w.body), ("condition", w.cond)):
                sig = self.sigs.get(name)
                if sig is None:
                    continue  # TL013 already reported missing targets
                if sig.n_params != 1:
                    diags.emit(
                        "TL005",
                        f"{module.name}: while %{w.op_name} {role} "
                        f"%{name} has {sig.n_params} parameters "
                        f"(expected exactly 1)",
                        file=pm.file, line=w.line,
                    )
                    continue
                if sig.param0_key != w.want:
                    diags.emit(
                        "TL005",
                        f"{module.name}: while %{w.op_name} carries "
                        f"{w.result_str} but {role} %{name} parameter "
                        f"is {sig.param0_str}",
                        file=pm.file, line=w.line,
                    )
                if role == "body" and sig.has_ops and \
                        sig.root_key != w.want:
                    diags.emit(
                        "TL005",
                        f"{module.name}: while %{w.op_name} carries "
                        f"{w.result_str} but body %{name} returns "
                        f"{sig.root_str}",
                        file=pm.file, line=w.line,
                    )
                if role == "condition" and sig.has_ops and \
                        not sig.root_is_scalar_pred:
                    diags.emit(
                        "TL005",
                        f"{module.name}: while %{w.op_name} "
                        f"condition %{name} returns {sig.root_str} "
                        f"(expected pred[])",
                        file=pm.file, line=w.line,
                    )
        pm.dataflow = self.builder.finish(module.entry_name)


def _check_groups(
    groups, n_devices: int | None, what: str, diags: Diagnostics,
    file: str, line: int | None,
) -> None:
    """TL009 range/duplication + TL014 pod tiling, shared between module
    collective ops and standalone collective commands."""
    if not groups:
        return
    seen: dict[int, int] = {}
    dups: set[int] = set()
    for g in groups:
        for member in g:
            if member in seen:
                dups.add(member)
            seen[member] = seen.get(member, 0) + 1
    if dups:
        diags.emit(
            "TL009",
            f"{what}: device(s) {sorted(dups)} appear in more than one "
            f"replica group (groups must be disjoint)",
            file=file, line=line,
        )
    if n_devices is not None:
        out = sorted(m for m in seen if not 0 <= m < n_devices)
        if out:
            diags.emit(
                "TL009",
                f"{what}: replica group member(s) {out} out of range "
                f"for a {n_devices}-device pod",
                file=file, line=line,
            )
        elif not dups and len(seen) != n_devices:
            diags.emit(
                "TL014",
                f"{what}: replica groups cover {len(seen)} of "
                f"{n_devices} devices (groups should tile the pod "
                f"exactly)",
                file=file, line=line,
            )


def _check_commands(pt: ParsedTrace, diags: Diagnostics) -> None:
    """TL006/TL007/TL009/TL010/TL014/TL015 over commandlist.jsonl.

    Range checks gate on the EXPLICIT ``meta.json`` pod declaration
    (:attr:`ParsedTrace.meta_devices`): without one, the driver infers
    the pod from the command lanes themselves and any device id is
    self-consistent."""
    from tpusim_torch.ir import CommandKind

    kinds = {k.value for k in CommandKind}
    n_devices = pt.meta_devices
    file = "commandlist.jsonl"
    for lineno, rec, err in pt.commands:
        if err is not None:
            diags.emit("TL010", err, file=file, line=lineno)
            continue
        kind = rec.get("kind")
        if kind not in kinds:
            diags.emit(
                "TL010",
                f"unknown command kind {kind!r} "
                f"(valid: {sorted(kinds)})",
                file=file, line=lineno,
            )
            continue
        device = rec.get("device", 0)
        if not isinstance(device, int) or isinstance(device, bool):
            diags.emit(
                "TL010",
                f"device id must be an integer, got {device!r}",
                file=file, line=lineno,
            )
        elif device < 0:
            diags.emit(
                "TL007",
                f"{kind} on device {device} — device ids cannot be "
                f"negative",
                file=file, line=lineno,
            )
        elif n_devices is not None and device >= n_devices:
            diags.emit(
                "TL007",
                f"{kind} on device {device}, but the trace declares "
                f"{n_devices} device(s)",
                file=file, line=lineno,
            )
        if kind == "kernel_launch":
            module = rec.get("module")
            if module not in pt.modules:
                diags.emit(
                    "TL006",
                    f"kernel_launch references module {module!r}; "
                    f"trace carries {sorted(pt.modules)}",
                    file=file, line=lineno,
                )
        if kind == "collective":
            coll = rec.get("collective") or {}
            groups = [
                tuple(g) for g in coll.get("replica_groups", [])
                if isinstance(g, (list, tuple))
            ]
            _check_groups(
                groups, n_devices,
                f"collective {coll.get('kind', '?')}",
                diags, file, lineno,
            )
            nbytes = rec.get("bytes", 0)
            if not nbytes:
                diags.emit(
                    "TL015",
                    f"standalone {coll.get('kind', 'collective')} "
                    f"carries zero bytes — it will be priced as free",
                    file=file, line=lineno,
                )


def run_trace_passes(
    pt: ParsedTrace, diags: Diagnostics, lenient: bool = True,
) -> None:
    """All trace-family passes over one loaded trace dir.

    ``lenient`` mirrors the parse mode the replay would use: under the
    DEFAULT strict loader a malformed HLO line is fatal mid-parse, so
    TL012 escalates to error severity when ``lenient`` is False; a
    lenient replay skips the line with a counted warning, and the
    diagnostic stays at its registry (warning) severity."""
    from tpusim_torch.analysis.collective_passes import run_collective_matching

    if pt.meta_error is not None:
        diags.emit("TL010", pt.meta_error, file="meta.json", line=1)
    launched = {
        rec.get("module")
        for _, rec, err in pt.commands
        if err is None and rec.get("kind") == "kernel_launch"
    }
    for key, pm in sorted(pt.modules.items()):
        run_module_passes(
            pm, diags, lenient=lenient,
            check_entry=key in launched or not pt.has_commandlist,
        )
    _check_commands(pt, diags)
    run_collective_matching(pt, diags)


def run_module_passes(
    pm: ParsedModule, diags: Diagnostics, lenient: bool = True,
    check_entry: bool = True,
) -> None:
    """Every module-family pass over one module, one computation at a
    time (the serving tier lints inline HLO through this entry point;
    the streaming path never materializes the module)."""
    from tpusim_torch.analysis.diagnostics import Severity

    checks = _ModuleChecks(pm, diags)
    for comp, _header_line, op_lines in pm.iter_computations():
        checks.feed(comp, op_lines)
    for lineno, err in pm.skipped:
        if lenient:
            diags.emit(
                "TL012",
                f"malformed HLO line (the lenient parse skips it): "
                f"{err}",
                file=pm.file, line=lineno,
            )
        else:
            diags.emit(
                "TL012",
                f"malformed HLO line (the strict parse the replay "
                f"uses will REJECT this module; pass "
                f"--lenient-parse to salvage): {err}",
                file=pm.file, line=lineno,
                severity=Severity.ERROR,
            )
    checks.finish(check_entry=check_entry)

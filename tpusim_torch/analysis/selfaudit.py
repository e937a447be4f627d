"""Self-audit passes (TL35x): the analyzer turned on the simulator.

The last five PRs hand-verified two contracts on every review: the
seeded subsystems (campaign, fleet traffic, the serve jitter paths)
are **deterministic by construction** — every draw comes from a named
``random.Random(seed…)`` / ``default_rng`` substream, never the global
RNG or the wall clock — and the durable stores **stage with
fsync-before-``os.replace``** so a crash can never publish a torn
record.  This module makes both CI-enforced: an AST walk over the
repo's own sources (the ``statskeys.py`` idiom, upgraded from token
scanning to real syntax) that fails the build when a new draw or a new
store write path breaks the discipline.

* **TL350** (error) — a call that draws from the process-global RNG
  (``random.random()``, ``np.random.normal()``, ``random.seed()`` …)
  inside a seeded subsystem.  Constructing a seeded instance
  (``random.Random(…)``, ``np.random.default_rng(…)``) is the
  sanctioned form;
* **TL351** (error) — wall-clock reads that can leak into seeded
  results (``time.time``/``time_ns``, ``datetime.now``/``utcnow``,
  ``date.today``) inside a seeded subsystem.  ``time.monotonic`` /
  ``perf_counter`` stay legal: they time *reporting*, not decisions;
* **TL352** (error) — an ``os.replace`` publish whose function neither
  calls ``os.fsync`` nor a module-local staging helper that fsyncs
  (``_stage_write``-style) before the rename: a host crash could
  replay a short-read record the durable tiers exist to rule out;
* **TL353** (error) — a ``threading.Lock``/``RLock`` held across a
  fork/spawn point (``os.fork``, a ``multiprocessing`` ``Process``
  ``.start()``) in the process-spawning tier (``tpusim/serve/`` —
  the front, the supervisor, the cluster overlay).  Under the fork
  start method the child inherits the lock in its LOCKED state with
  no owner thread to release it, so its first acquire deadlocks
  forever; the audit flags both ``with lock:`` bodies and
  ``.acquire()``/``.release()`` windows that contain a spawn.

**Allowlist pragma**: a finding is suppressed by
``# lint-allow: TL35x <reason>`` on the flagged line or the line above
— every deliberate exception (a derived report whose journal is the
durable record, a best-effort quarantine move) is documented exactly
where it lives, and a new exception is a reviewed diff line, not a
silent drift.

Port of ``tpusim/analysis/selfaudit.py``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = [
    "DURABLE_AUDIT_GLOBS",
    "FORKSAFE_AUDIT_GLOBS",
    "PACKAGE",
    "SEEDED_SUBSYSTEM_GLOBS",
    "run_selfaudit_passes",
]

#: the package whose sources the globs below name; an audit of another
#: package's tree (the reference's ``tpusim``, whose layout the port
#: mirrors) reads every glob with this prefix swapped for its name
PACKAGE = "tpusim_torch"

#: the subsystems whose determinism contract is seeded substreams —
#: campaign sampling, fleet traffic/fault streams, and the serve tier's
#: deterministic-jitter paths (client backoff, front restart jitter,
#: supervisor restart jitter)
SEEDED_SUBSYSTEM_GLOBS = (
    "tpusim_torch/campaign/*.py",
    "tpusim_torch/fleet/*.py",
    "tpusim_torch/serve/client.py",
    "tpusim_torch/serve/front.py",
    "tpusim_torch/serve/supervisor.py",
)

#: everything under the package is audited for the staging discipline —
#: os.replace is rare enough that a repo-wide walk stays cheap, and a
#: NEW durable store is audited the day it lands
DURABLE_AUDIT_GLOBS = (
    "tpusim_torch/**/*.py",
    "ci/*.py",
    "bench.py",
)

#: the tier that forks/spawns OS processes while also juggling
#: threading locks — the serve daemon, front (multi-process acceptors),
#: supervisor (worker children), and the cluster overlay all live here
FORKSAFE_AUDIT_GLOBS = (
    "tpusim_torch/serve/*.py",
)

#: constructors/state plumbing on the stdlib ``random`` module that do
#: NOT draw from the global stream
_RANDOM_ALLOWED = frozenset({"Random", "SystemRandom"})

#: seeded-generator constructors on ``numpy.random``
_NP_RANDOM_ALLOWED = frozenset({
    "default_rng", "Generator", "SeedSequence", "RandomState",
    "PCG64", "Philox", "MT19937", "BitGenerator",
})

#: wall-clock reads on the ``time`` module (monotonic/perf_counter are
#: duration clocks and stay legal)
_TIME_WALLCLOCK = frozenset({"time", "time_ns"})

_DATETIME_WALLCLOCK = frozenset({"now", "utcnow", "today"})

#: codes only — the free-text reason after them must not be swallowed
#: into the code token (an uppercase-leading reason like "CI artifact"
#: would otherwise break the suppression it documents)
_PRAGMA_RE = re.compile(
    r"#\s*lint-allow:\s*(TL\d+(?:\s*,\s*TL\d+)*)"
)


class _Pragmas:
    """``# lint-allow: TLxxx <reason>`` suppression map: a finding is
    allowed when the pragma sits on its line or anywhere in the
    contiguous comment block directly above it (reasons wrap)."""

    def __init__(self, text: str):
        self.codes: dict[int, frozenset[str]] = {}
        self.comment_lines: set[int] = set()
        for lineno, line in enumerate(text.splitlines(), 1):
            if line.lstrip().startswith("#"):
                self.comment_lines.add(lineno)
            m = _PRAGMA_RE.search(line)
            if m:
                self.codes[lineno] = frozenset(
                    tok.strip() for tok in m.group(1).split(",")
                    if tok.strip()
                )

    def allows(self, code: str, lineno: int) -> bool:
        if code in self.codes.get(lineno, ()):
            return True
        k = lineno - 1
        while k >= 1 and k in self.comment_lines:
            if code in self.codes.get(k, ()):
                return True
            k -= 1
        return False


class _Bindings(ast.NodeVisitor):
    """Track which local names are bound to the modules/classes the
    audit cares about (aliases included) plus directly-imported draw
    and clock functions."""

    def __init__(self) -> None:
        self.random_mods: set[str] = set()      # -> stdlib random
        self.np_mods: set[str] = set()          # -> numpy
        self.np_random_mods: set[str] = set()   # -> numpy.random
        self.time_mods: set[str] = set()        # -> time
        self.datetime_mods: set[str] = set()    # -> datetime (module)
        self.datetime_classes: set[str] = set()  # datetime/date classes
        #: name -> description, for `from random import random` forms
        self.direct_draws: dict[str, str] = {}
        self.direct_clocks: dict[str, str] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            if alias.name == "random":
                self.random_mods.add(name)
            elif alias.name == "numpy":
                self.np_mods.add(name)
            elif alias.name == "numpy.random":
                if alias.asname:
                    self.np_random_mods.add(alias.asname)
                else:
                    self.np_mods.add("numpy")
            elif alias.name == "time":
                self.time_mods.add(name)
            elif alias.name == "datetime":
                self.datetime_mods.add(name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            bound = alias.asname or alias.name
            if mod == "random" and alias.name not in _RANDOM_ALLOWED:
                self.direct_draws[bound] = f"random.{alias.name}"
            elif mod in ("numpy", "numpy.random"):
                if mod == "numpy" and alias.name == "random":
                    self.np_random_mods.add(bound)
                elif mod == "numpy.random" and \
                        alias.name not in _NP_RANDOM_ALLOWED:
                    self.direct_draws[bound] = f"np.random.{alias.name}"
            elif mod == "time" and alias.name in _TIME_WALLCLOCK:
                self.direct_clocks[bound] = f"time.{alias.name}"
            elif mod == "datetime" and alias.name in (
                "datetime", "date",
            ):
                self.datetime_classes.add(bound)


def _audit_seeded_file(
    rel: str, text: str, diags: Diagnostics,
    allow: _Pragmas,
) -> None:
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError:
        return  # the repo lint tier owns syntax errors
    binds = _Bindings()
    binds.visit(tree)

    def emit(code: str, lineno: int, message: str) -> None:
        if not allow.allows(code, lineno):
            diags.emit(code, message, file=rel, line=lineno)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in binds.direct_draws:
                emit(
                    "TL350", node.lineno,
                    f"{binds.direct_draws[func.id]}() draws from the "
                    f"process-global RNG inside a seeded subsystem — "
                    f"use a named random.Random/default_rng substream",
                )
            elif func.id in binds.direct_clocks:
                emit(
                    "TL351", node.lineno,
                    f"{binds.direct_clocks[func.id]}() reads the wall "
                    f"clock inside a seeded subsystem — results must "
                    f"be a function of the seed, not the start time",
                )
            continue
        if not isinstance(func, ast.Attribute):
            continue
        base = func.value
        attr = func.attr
        if isinstance(base, ast.Name):
            if base.id in binds.random_mods and \
                    attr not in _RANDOM_ALLOWED:
                emit(
                    "TL350", node.lineno,
                    f"random.{attr}() draws from the process-global "
                    f"RNG inside a seeded subsystem — use a named "
                    f"random.Random(seed…) substream",
                )
            elif base.id in binds.np_random_mods and \
                    attr not in _NP_RANDOM_ALLOWED:
                emit(
                    "TL350", node.lineno,
                    f"np.random.{attr}() draws from numpy's global "
                    f"RNG inside a seeded subsystem — use "
                    f"default_rng(seed…)",
                )
            elif base.id in binds.time_mods and \
                    attr in _TIME_WALLCLOCK:
                emit(
                    "TL351", node.lineno,
                    f"time.{attr}() reads the wall clock inside a "
                    f"seeded subsystem — results must be a function "
                    f"of the seed, not the start time "
                    f"(monotonic/perf_counter stay legal for "
                    f"duration reporting)",
                )
            elif base.id in binds.datetime_classes and \
                    attr in _DATETIME_WALLCLOCK:
                emit(
                    "TL351", node.lineno,
                    f"datetime {attr}() reads the wall clock inside "
                    f"a seeded subsystem",
                )
        elif isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name):
            # numpy.random.X via the numpy module; datetime.datetime.now
            if base.value.id in binds.np_mods and \
                    base.attr == "random" and \
                    attr not in _NP_RANDOM_ALLOWED:
                emit(
                    "TL350", node.lineno,
                    f"np.random.{attr}() draws from numpy's global "
                    f"RNG inside a seeded subsystem — use "
                    f"default_rng(seed…)",
                )
            elif base.value.id in binds.datetime_mods and \
                    base.attr in ("datetime", "date") and \
                    attr in _DATETIME_WALLCLOCK:
                emit(
                    "TL351", node.lineno,
                    f"datetime.{base.attr}.{attr}() reads the wall "
                    f"clock inside a seeded subsystem",
                )


def _is_os_call(node: ast.AST, attr: str) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == attr
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "os"
    )


def _called_name(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _audit_durable_file(
    rel: str, text: str, diags: Diagnostics,
    allow: _Pragmas,
) -> None:
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError:
        return

    # pass 1: module-local helpers whose bodies fsync (the staging
    # seams: _stage_write/_stage_bytes/_append_segment and kin) — a
    # publish that stages through one of them carries the guarantee
    fsync_helpers: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if _is_os_call(sub, "fsync"):
                    fsync_helpers.add(node.name)
                    break

    def iter_scope(scope):
        """Every node of one scope, stopping at nested function
        definitions (they audit as their own scopes)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def check_scope(body_node) -> None:
        replaces: list[int] = []
        syncs: list[int] = []
        for sub in iter_scope(body_node):
            if _is_os_call(sub, "replace"):
                replaces.append(sub.lineno)
            elif _is_os_call(sub, "fsync"):
                syncs.append(sub.lineno)
            elif isinstance(sub, ast.Call):
                name = _called_name(sub)
                if name in fsync_helpers:
                    syncs.append(sub.lineno)
        for lineno in replaces:
            if any(s < lineno for s in syncs):
                continue
            if allow.allows("TL352", lineno):
                continue
            diags.emit(
                "TL352",
                f"os.replace publish without fsync-before-replace: "
                f"no os.fsync (or fsync-carrying staging helper) "
                f"precedes it in this function — a crash can "
                f"publish a short-read record (stage with "
                f"fsync, or document the exception with "
                f"'# lint-allow: TL352 <reason>')",
                file=rel, line=lineno,
            )

    for func in (
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ):
        check_scope(func)
    # module-level code (rare): audit the module body as one scope,
    # with function bodies excluded by the nested-def rule above
    check_scope(tree)


def _audit_forksafe_file(
    rel: str, text: str, diags: Diagnostics,
    allow: _Pragmas,
) -> None:
    """TL353: a threading lock held across a fork/spawn point.  Locks
    are the names/attributes assigned ``threading.Lock()``/``RLock()``
    anywhere in the file (the ``self._x_lock = threading.Lock()``
    constructor idiom); spawn points are ``os.fork``/``forkpty`` and
    ``.start()`` on a ``multiprocessing`` ``Process`` — direct, via a
    ``get_context(...)`` handle, or chained ``ctx.Process(…).start()``.
    Flagged when a spawn sits lexically inside a ``with lock:`` body or
    between a lock's ``.acquire()`` and its ``.release()`` in the same
    scope (nested function bodies audit as their own scopes — they run
    later, not under this lock)."""
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError:
        return

    # pass 1 (file-wide): lock bindings + Process/context variables
    lock_names: set[str] = set()
    lock_attrs: set[str] = set()
    ctx_names: set[str] = {"multiprocessing", "mp"}
    proc_names: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        is_lock = (
            isinstance(f, ast.Attribute)
            and f.attr in ("Lock", "RLock")
            and isinstance(f.value, ast.Name)
            and f.value.id == "threading"
        ) or (isinstance(f, ast.Name) and f.id in ("Lock", "RLock"))
        is_ctx = (
            isinstance(f, ast.Attribute) and f.attr == "get_context"
        ) or (isinstance(f, ast.Name) and f.id == "get_context")
        is_proc = (
            isinstance(f, ast.Attribute) and f.attr == "Process"
            and isinstance(f.value, ast.Name)
            and f.value.id in ctx_names
        ) or (isinstance(f, ast.Name) and f.id == "Process")
        for t in node.targets:
            if isinstance(t, ast.Name):
                if is_lock:
                    lock_names.add(t.id)
                elif is_ctx:
                    ctx_names.add(t.id)
                elif is_proc:
                    proc_names.add(t.id)
            elif isinstance(t, ast.Attribute):
                if is_lock:
                    lock_attrs.add(t.attr)
                elif is_proc:
                    proc_names.add(t.attr)

    def lock_key(e: ast.AST) -> str | None:
        if isinstance(e, ast.Name) and e.id in lock_names:
            return e.id
        if isinstance(e, ast.Attribute) and e.attr in lock_attrs:
            return f".{e.attr}"
        return None

    def spawn_desc(n: ast.AST) -> str | None:
        for attr in ("fork", "forkpty"):
            if _is_os_call(n, attr):
                return f"os.{attr}()"
        if isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr == "start":
            base = n.func.value
            if isinstance(base, ast.Name) and base.id in proc_names:
                return f"{base.id}.start()"
            if isinstance(base, ast.Attribute) and \
                    base.attr in proc_names:
                return f"{base.attr}.start()"
            if isinstance(base, ast.Call) and \
                    isinstance(base.func, ast.Attribute) and \
                    base.func.attr == "Process":
                return "Process(...).start()"
        return None

    def iter_scope(scope):
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def emit(lineno: int, key: str, desc: str) -> None:
        if allow.allows("TL353", lineno):
            return
        diags.emit(
            "TL353",
            f"threading lock '{key.lstrip('.')}' is held across "
            f"{desc} — under the fork start method the child "
            f"inherits the lock LOCKED with no owner to release "
            f"it and deadlocks on first acquire (spawn outside "
            f"the lock, or document with "
            f"'# lint-allow: TL353 <reason>')",
            file=rel, line=lineno,
        )

    # ``with lock:`` bodies
    for wnode in ast.walk(tree):
        if not isinstance(wnode, (ast.With, ast.AsyncWith)):
            continue
        keys = [
            k for k in (
                lock_key(item.context_expr) for item in wnode.items
            ) if k is not None
        ]
        if not keys:
            continue
        for stmt in wnode.body:
            for sub in [stmt, *iter_scope(stmt)]:
                d = spawn_desc(sub)
                if d is not None:
                    emit(sub.lineno, keys[0], d)

    # ``.acquire()`` … spawn … ``.release()`` windows, per scope
    scopes = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ] + [tree]
    for scope in scopes:
        events: list[tuple[int, str, str]] = []
        for sub in iter_scope(scope):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("acquire", "release"):
                k = lock_key(sub.func.value)
                if k is not None:
                    events.append((sub.lineno, sub.func.attr, k))
                continue
            d = spawn_desc(sub)
            if d is not None:
                events.append((sub.lineno, "spawn", d))
        held: dict[str, int] = {}
        for lineno, kind, what in sorted(events):
            if kind == "acquire":
                held[what] = lineno
            elif kind == "release":
                held.pop(what, None)
            elif held:
                key = next(iter(held))
                emit(lineno, key, what)


def _globbed(root: Path, patterns, package: str) -> list[Path]:
    """The files of ``patterns`` under ``root``, in ``package``'s tree."""
    out: list[Path] = []
    for pat in patterns:
        if pat.startswith(PACKAGE + "/"):
            pat = package + pat[len(PACKAGE):]
        out.extend(sorted(root.glob(pat)))
    return out


def run_selfaudit_passes(
    diags: Diagnostics, root: str | Path | None = None,
    package: str = PACKAGE,
) -> None:
    """TL35x discipline audit of ``package``'s sources in the repo at
    ``root`` (defaults to the repo this module lives in — ``lint
    --self-audit``)."""
    root = Path(root) if root is not None else \
        Path(__file__).resolve().parents[2]

    seeded = _globbed(root, SEEDED_SUBSYSTEM_GLOBS, package)
    for path in seeded:
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        _audit_seeded_file(rel, text, diags, _Pragmas(text))

    durable = _globbed(root, DURABLE_AUDIT_GLOBS, package)
    seen: set[Path] = set()
    for path in durable:
        if path in seen or "__pycache__" in path.parts:
            continue
        seen.add(path)
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        _audit_durable_file(rel, text, diags, _Pragmas(text))

    forksafe = _globbed(root, FORKSAFE_AUDIT_GLOBS, package)
    for path in forksafe:
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        _audit_forksafe_file(rel, text, diags, _Pragmas(text))

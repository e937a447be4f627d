"""Shared diagnostics core for the static analyzer.

Port of ``tpusim/analysis/diagnostics.py``, the code registry whole.
Every check reports through this module: a stable diagnostic **code**
(``TL001`` — never renumbered), a **severity** (error / warning / info),
an optional ``file:line`` **anchor** into the artifact that triggered
it, and a machine-readable JSON form.  The registry below is the single
source of truth; every family's owning pass module is ported.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field

__all__ = [
    "CODES",
    "CODE_FAMILIES",
    "CodeInfo",
    "Diagnostic",
    "Diagnostics",
    "Severity",
    "family_of",
    "list_code_lines",
]

JSON_FORMAT_VERSION = 1


class Severity(enum.Enum):
    """Diagnostic severity — errors gate (nonzero exit / ``--validate``
    refusal), warnings inform, info narrates."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    @property
    def rank(self) -> int:
        return {"error": 2, "warning": 1, "info": 0}[self.value]


@dataclass(frozen=True)
class CodeInfo:
    """One registry entry: stable code, default severity, one-liner."""

    code: str
    severity: Severity
    summary: str


CODES: dict[str, CodeInfo] = {}


def _code(code: str, severity: Severity, summary: str) -> None:
    if code in CODES:
        raise ValueError(f"duplicate diagnostic code {code}")
    CODES[code] = CodeInfo(code, severity, summary)


_E, _W, _I = Severity.ERROR, Severity.WARNING, Severity.INFO

# --- trace passes (TL0xx) --------------------------------------------------
_code("TL001", _E, "operand references a value never defined in its "
                   "computation")
_code("TL002", _E, "operand used before its definition in the schedule "
                   "order")
_code("TL003", _W, "operand count outside the opcode's known arity")
_code("TL004", _E, "elementwise operand/result shape or dtype mismatch")
_code("TL005", _E, "while body/condition parameter or result shape "
                   "disagreement")
_code("TL006", _E, "kernel_launch references a module the trace does not "
                   "carry")
_code("TL007", _E, "command device id outside the declared pod")
_code("TL008", _E, "collective result bytes inconsistent with operand "
                   "shapes and group size")
_code("TL009", _E, "replica group member out of range or duplicated")
_code("TL010", _E, "malformed trace artifact line (commandlist/meta JSON)")
_code("TL011", _E, "module has no ENTRY computation")
_code("TL012", _W, "parse skipped malformed HLO lines (salvage-mode "
                   "damage)")
_code("TL013", _E, "op calls a computation the module does not contain")
_code("TL014", _W, "replica groups do not tile the pod exactly")
_code("TL015", _W, "standalone collective command with zero byte count")

# --- config passes (TL1xx) -------------------------------------------------
_code("TL101", _E, "config field must be positive (clock/bandwidth/"
                   "dimension)")
_code("TL102", _W, "derived roofline number outside plausible bounds")
_code("TL103", _W, "trace device kind maps to a different arch than the "
                   "chosen config")
_code("TL104", _E, "efficiency/fraction config field outside (0, 1]")
_code("TL105", _E, "unknown enum value (topology/network_mode)")
_code("TL106", _E, "config field must be non-negative (latency/cycle "
                   "count)")
_code("TL107", _E, "config does not compose (unknown preset, missing "
                   "or unparseable overlay)")
_code("TL108", _W, "chips_per_slice does not evenly tile the chip count "
                   "(the partial slice prices as a full one)")

# --- schedule passes (TL2xx) -----------------------------------------------
_code("TL201", _E, "fault schedule fails format/window validation")
_code("TL202", _E, "fault endpoint/link does not exist on the declared "
                   "torus")
_code("TL203", _W, "overlapping faults target the same link or chip")
_code("TL204", _I, "fault with scale 1.0 has no effect")

# --- campaign passes (TL21x) -----------------------------------------------
_code("TL210", _E, "campaign spec fails format validation (unknown fault "
                   "kind, bad distribution, scale out of range)")
_code("TL211", _E, "campaign candidate-slice list empty or invalid")
_code("TL212", _E, "campaign SLO percentile outside (0, 100]")
_code("TL213", _E, "campaign correlated group references links or axes "
                   "absent from the slice torus")

# --- advise passes (TL22x) -------------------------------------------------
_code("TL220", _E, "advise spec fails format validation (bad field, "
                   "type, or range)")
_code("TL221", _E, "advise spec names an unknown parallelism strategy")
_code("TL222", _E, "pinned mesh shape does not factor any candidate "
                   "slice's chip count")
_code("TL223", _E, "advise candidate slice names an arch with no preset")
_code("TL224", _E, "advise SLO given without candidate slices to rank")

# --- dcn passes (TL23x) ----------------------------------------------------
_code("TL230", _E, "dcn block fails format validation (bad field, type, "
                   "or range)")
_code("TL231", _E, "DCN fault kinds sampled without a configured dcn "
                   "fabric")
_code("TL232", _W, "DCN fault targets a slice index outside the "
                   "configured fabric")

# --- fleet passes (TL24x) --------------------------------------------------
_code("TL240", _E, "fleet spec fails format validation (bad field, "
                   "policy, or fault model)")
_code("TL241", _E, "fleet traffic model invalid (shape, mix, or a load "
                   "point past the per-cell arrival ceiling)")
_code("TL242", _E, "fleet SLO/frontier invalid (percentile range, "
                   "frontier without an SLO)")
_code("TL243", _E, "fleet correlated group references links or axes "
                   "absent from the pod torus")

# --- stats-key contract (TL3xx) --------------------------------------------
_code("TL301", _E, "stats key written outside its namespace's owning "
                   "subsystem")
_code("TL302", _W, "stats prefix not in the documented namespace registry")
_code("TL303", _E, "schema-required stats key not found in audited "
                   "sources")

# --- self-audit passes (TL35x) ---------------------------------------------
_code("TL350", _E, "unseeded global-RNG draw inside a seeded subsystem")
_code("TL351", _E, "wall-clock read inside a seeded subsystem")
_code("TL352", _E, "os.replace publish without fsync-before-replace "
                   "staging")
_code("TL353", _E, "threading lock held across a fork/spawn point (the "
                   "forked child inherits a locked lock)")

# --- memory passes (TL40x) -------------------------------------------------
_code("TL400", _E, "peak-live HBM bytes exceed the chosen arch's "
                   "capacity (will not fit)")
_code("TL401", _W, "peak-live vmem bytes exceed the arch budget (the "
                   "engine prices the overflow as spill)")
_code("TL402", _W, "peak-live HBM within 5% of the arch capacity "
                   "(near-fit)")

# --- collective-matching passes (TL41x) ------------------------------------
_code("TL410", _E, "group members issue mismatched collective kinds at "
                   "the matching position (deadlock)")
_code("TL411", _E, "group members declare inconsistent replica groups "
                   "for the matched collective (deadlock)")
_code("TL412", _E, "a device never issues a collective its group is "
                   "blocked on (hang)")
_code("TL413", _E, "byte-count disagreement between matched collective "
                   "participants")

# --- perf passes (TL50x) ---------------------------------------------------
_code("TL500", _I, "critical-path summary (length, bound mix, exposed "
                   "collective cycles) for a priced computation")
_code("TL501", _W, "collective mostly exposed while independently "
                   "schedulable compute sits in its issue window")
_code("TL502", _W, "serialization bubble: a dependency chain through a "
                   "small op pins a large op off the critical path")
_code("TL503", _W, "HBM-bound op dominates the critical path despite an "
                   "arithmetic intensity above the arch ridge point")
_code("TL504", _E, "cost model returned a non-finite or negative cost "
                   "for a reachable op")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: code + severity + message + optional artifact anchor."""

    code: str
    severity: Severity
    message: str
    file: str | None = None
    line: int | None = None

    @property
    def anchor(self) -> str:
        if self.file is None:
            return "<repo>"
        if self.line is None:
            return self.file
        return f"{self.file}:{self.line}"

    def text(self) -> str:
        return (
            f"{self.anchor}: {self.severity.value} {self.code}: "
            f"{self.message}"
        )

    def to_doc(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity.value,
            "message": self.message,
            "file": self.file,
            "line": self.line,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "Diagnostic":
        return cls(
            code=doc["code"],
            severity=Severity(doc["severity"]),
            message=doc["message"],
            file=doc.get("file"),
            line=doc.get("line"),
        )


@dataclass
class Diagnostics:
    """Collector shared by all passes of one analysis run."""

    items: list[Diagnostic] = field(default_factory=list)

    def emit(
        self,
        code: str,
        message: str,
        file: str | None = None,
        line: int | None = None,
        severity: Severity | None = None,
    ) -> Diagnostic:
        info = CODES.get(code)
        if info is None:
            raise KeyError(f"unregistered diagnostic code {code!r}")
        d = Diagnostic(
            code=code,
            severity=severity or info.severity,
            message=message,
            file=file,
            line=line,
        )
        self.items.append(d)
        return d

    # -- queries -----------------------------------------------------------

    def count(self, severity: Severity) -> int:
        return sum(1 for d in self.items if d.severity is severity)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.items if d.severity is Severity.ERROR]

    @property
    def has_errors(self) -> bool:
        return any(d.severity is Severity.ERROR for d in self.items)

    def codes(self) -> set[str]:
        return {d.code for d in self.items}

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.items if d.code == code]

    # -- output ------------------------------------------------------------

    def sorted_items(self) -> list[Diagnostic]:
        """Stable presentation order: severity first, then anchor."""
        return sorted(
            self.items,
            key=lambda d: (
                -d.severity.rank, d.file or "", d.line or 0, d.code,
            ),
        )

    def summary(self) -> str:
        return (
            f"{self.count(Severity.ERROR)} error(s), "
            f"{self.count(Severity.WARNING)} warning(s), "
            f"{self.count(Severity.INFO)} info"
        )

    def text_lines(self) -> list[str]:
        return [d.text() for d in self.sorted_items()]

    def to_doc(self) -> dict:
        return {
            "format_version": JSON_FORMAT_VERSION,
            "diagnostics": [d.to_doc() for d in self.sorted_items()],
            "counts": {
                s.value: self.count(s) for s in Severity
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2)

    @classmethod
    def from_doc(cls, doc: dict) -> "Diagnostics":
        return cls(
            items=[Diagnostic.from_doc(d) for d in doc["diagnostics"]]
        )


#: code-prefix -> (family name, owning pass module), longest match
#: first, so a new family registers its owner exactly once
CODE_FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("TL0", "trace passes", "tpusim_torch/analysis/trace_passes.py"),
    ("TL1", "config passes", "tpusim_torch/analysis/config_passes.py"),
    ("TL20", "schedule passes", "tpusim_torch/analysis/schedule_passes.py"),
    ("TL21", "campaign passes", "tpusim_torch/analysis/campaign_passes.py"),
    ("TL22", "advise passes", "tpusim_torch/analysis/advise_passes.py"),
    ("TL23", "dcn passes", "tpusim_torch/analysis/dcn_passes.py"),
    ("TL24", "fleet passes", "tpusim_torch/analysis/fleet_passes.py"),
    ("TL30", "stats-key contract", "tpusim_torch/analysis/statskeys.py"),
    ("TL35", "self-audit passes", "tpusim_torch/analysis/selfaudit.py"),
    ("TL40", "memory passes", "tpusim_torch/analysis/memory_passes.py"),
    ("TL41", "collective-matching passes",
     "tpusim_torch/analysis/collective_passes.py"),
    ("TL50", "perf passes", "tpusim_torch/analysis/perf_passes.py"),
)


def family_of(code: str) -> tuple[str, str]:
    """(family name, owning pass module) for a registered code."""
    best = ("", "unregistered", "")
    for prefix, family, module in CODE_FAMILIES:
        if code.startswith(prefix) and len(prefix) > len(best[0]):
            best = (prefix, family, module)
    return best[1], best[2]


def list_code_lines() -> list[str]:
    """The code table, grouped by family with the owning pass module: a
    ``[family — module]`` header line per group, then one ``CODE
    severity summary`` line per registered code, in code order."""
    lines: list[str] = []
    last_family = None
    for c in sorted(CODES.values(), key=lambda c: c.code):
        family, module = family_of(c.code)
        if family != last_family:
            lines.append(f"[{family} — {module}]")
            last_family = family
        lines.append(f"{c.code}  {c.severity.value:7s}  {c.summary}")
    return lines

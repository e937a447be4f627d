"""tpusim_torch.analysis — static analysis of specs before they price.

Port of the parts of ``tpusim/analysis/`` the campaign and fleet layers
run: the shared diagnostics core (:mod:`~tpusim_torch.analysis.
diagnostics`, the code registry whole), :class:`ValidationError`, and
the spec passes — campaign (TL21x), advise (TL22x), DCN (TL23x) and
fleet (TL24x) — and the two analyzers the advisor reads: the
whole-trace dataflow engine (:mod:`~tpusim_torch.analysis.dataflow`,
per-space liveness and peaks) and the critical-path analyzer
(:mod:`~tpusim_torch.analysis.critpath`).  The trace, config,
schedule, memory, collective, perf, stats-key and self-audit passes,
``lint``, ``perf-report`` and ``simulate --validate`` are ROADMAP A9.
"""

from __future__ import annotations

from tpusim_torch.analysis.advise_passes import analyze_advise_spec
from tpusim_torch.analysis.campaign_passes import analyze_campaign_spec
from tpusim_torch.analysis.critpath import (
    CritBuilder,
    ModulePerf,
    analyze_module_perf,
    module_perf_doc,
)
from tpusim_torch.analysis.diagnostics import (
    CODE_FAMILIES,
    CODES,
    CodeInfo,
    Diagnostic,
    Diagnostics,
    Severity,
    family_of,
    list_code_lines,
)
from tpusim_torch.analysis.fleet_passes import analyze_fleet_spec

__all__ = [
    "CODES",
    "CODE_FAMILIES",
    "CodeInfo",
    "CritBuilder",
    "Diagnostic",
    "Diagnostics",
    "ModulePerf",
    "Severity",
    "ValidationError",
    "analyze_advise_spec",
    "analyze_campaign_spec",
    "analyze_fleet_spec",
    "analyze_module_perf",
    "family_of",
    "list_code_lines",
    "module_perf_doc",
]


class ValidationError(ValueError):
    """A pre-flight refused to price the run.

    Carries the full :class:`Diagnostics` so callers can render or
    serialize every finding, not just the first."""

    def __init__(self, diags: Diagnostics, strict: bool = False):
        self.diags = diags
        gate = "error-or-warning" if strict else "error"
        lines = "\n".join(
            f"  {line}" for line in diags.text_lines()
        )
        super().__init__(
            f"static analysis found {diags.summary()} "
            f"({gate}-level diagnostics refuse the replay; see "
            f"'tpusim lint'):\n{lines}"
        )

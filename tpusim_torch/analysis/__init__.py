"""tpusim_torch.analysis — static analysis of specs before they price.

Port of the parts of ``tpusim/analysis/`` the campaign and fleet layers
run: the shared diagnostics core (:mod:`~tpusim_torch.analysis.
diagnostics`, the code registry whole), :class:`ValidationError`, and
the spec passes — campaign (TL21x), DCN (TL23x) and fleet (TL24x).  The
trace, config, schedule, memory, collective, perf, stats-key and
self-audit passes, ``lint`` and ``simulate --validate`` are ROADMAP A9.
"""

from __future__ import annotations

from tpusim_torch.analysis.campaign_passes import analyze_campaign_spec
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
    "Diagnostic",
    "Diagnostics",
    "Severity",
    "ValidationError",
    "analyze_campaign_spec",
    "analyze_fleet_spec",
    "family_of",
    "list_code_lines",
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

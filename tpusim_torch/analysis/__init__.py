"""tpusim_torch.analysis — static trace/config/schedule analyzer.

Port of ``tpusim/analysis/``, whole.  Multi-pass static analysis with a
shared diagnostics core: stable codes (``TL001``...), error/warning/info
severities, ``file:line`` anchors into ``commandlist.jsonl`` / ``.hlo``
modules / schedule files, and a machine-readable JSON form.  Pass
families: trace (syntax + dataflow over the whole-trace liveness engine
in :mod:`~tpusim_torch.analysis.dataflow`), config, schedule,
campaign/advise/DCN/fleet specs, TL40x memory-capacity checks, TL41x
cross-device collective-deadlock matching, TL50x performance passes
(critical path, per-op slack, exposed-communication accounting over
:mod:`~tpusim_torch.analysis.critpath`), the repo-level stats-key
contract audit and the TL35x determinism/durability self-audit, both of
a package's own sources (``tpusim_torch`` unless asked otherwise).
Reached through the ``lint`` and ``perf-report`` CLIs and the opt-in
``simulate --validate`` pre-flight; the served ``--strict-lint`` refusal
waits for the serving tier (ROADMAP A11).
"""

from __future__ import annotations

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
from tpusim_torch.analysis.advise_passes import analyze_advise_spec
from tpusim_torch.analysis.campaign_passes import analyze_campaign_spec
from tpusim_torch.analysis.critpath import (
    CritBuilder,
    ModulePerf,
    analyze_module_perf,
    module_perf_doc,
)
from tpusim_torch.analysis.fleet_passes import analyze_fleet_spec
from tpusim_torch.analysis.runner import (
    ValidationError,
    analyze_config,
    analyze_schedule,
    analyze_self_audit,
    analyze_stats_keys,
    analyze_trace_dir,
)
from tpusim_torch.analysis.statskeys import STATS_NAMESPACES

__all__ = [
    "CODES",
    "CODE_FAMILIES",
    "CodeInfo",
    "CritBuilder",
    "Diagnostic",
    "Diagnostics",
    "ModulePerf",
    "Severity",
    "STATS_NAMESPACES",
    "ValidationError",
    "analyze_advise_spec",
    "analyze_campaign_spec",
    "analyze_config",
    "analyze_fleet_spec",
    "analyze_module_perf",
    "analyze_schedule",
    "analyze_self_audit",
    "analyze_stats_keys",
    "analyze_trace_dir",
    "family_of",
    "list_code_lines",
    "module_perf_doc",
]

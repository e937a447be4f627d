"""Memory passes (TL40x): static peak-HBM / peak-VMEM vs the chosen
arch's capacities — "will not fit" as a lint error before any pricing.

The numbers come from the dataflow engine's aliasing-aware liveness
walk (:mod:`tpusim_torch.analysis.dataflow`), whose vmem side is pinned
byte-equal to the engine's own capacity model and whose HBM side is
exactly what the advisor's fits-HBM column reports — the ranked table,
the linter, and the spill model can never disagree.

* **TL400** (error) — the module's peak concurrently-live HBM bytes
  exceed ``arch.hbm_gib``: the replay would price a program that can
  never load on the part;
* **TL401** (warning) — peak-live ``S(1)`` bytes exceed
  ``arch.vmem_bytes``: the engine completes the replay but prices the
  overflow fraction of vmem traffic at HBM rate (the spill model), so
  the number is a degraded-mode number;
* **TL402** (warning) — peak HBM within ``NEAR_CAPACITY_FRACTION`` of
  the budget: it fits, but fragmentation or a slightly larger batch
  tips it over.

Port of ``tpusim/analysis/memory_passes.py``.
"""

from __future__ import annotations

from tpusim_torch.analysis.dataflow import ModuleDataflow, analyze_module
from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["NEAR_CAPACITY_FRACTION", "run_memory_passes"]

#: TL402 fires when peak HBM exceeds this fraction of the capacity
NEAR_CAPACITY_FRACTION = 0.95


def _check_one(
    name: str,
    df: ModuleDataflow,
    cfg,
    diags: Diagnostics,
    file: str | None = None,
    line: int | None = None,
) -> None:
    hbm_cap = float(cfg.arch.hbm_gib) * float(1 << 30)
    vmem_cap = float(cfg.arch.vmem_bytes)
    peak_hbm = df.peak_live("hbm")
    peak_vmem = df.peak_live("vmem")
    gib = float(1 << 30)
    if hbm_cap > 0 and peak_hbm > hbm_cap:
        diags.emit(
            "TL400",
            f"module {name!r} needs {peak_hbm / gib:.2f} GiB of HBM "
            f"at its liveness peak but {cfg.arch.name} has "
            f"{cfg.arch.hbm_gib:g} GiB — the program will not fit",
            file=file, line=line,
        )
    elif hbm_cap > 0 and peak_hbm > NEAR_CAPACITY_FRACTION * hbm_cap:
        diags.emit(
            "TL402",
            f"module {name!r} peaks at {peak_hbm / gib:.2f} GiB of "
            f"HBM — within {(1 - NEAR_CAPACITY_FRACTION) * 100:.0f}% "
            f"of {cfg.arch.name}'s {cfg.arch.hbm_gib:g} GiB budget",
            file=file, line=line,
        )
    if vmem_cap > 0 and peak_vmem > vmem_cap:
        diags.emit(
            "TL401",
            f"module {name!r} pins {peak_vmem / 1e6:.1f} MB of vmem "
            f"at its liveness peak but {cfg.arch.name} has "
            f"{vmem_cap / 1e6:.0f} MB — the engine prices the "
            f"overflow at HBM rate (spill)",
            file=file, line=line,
        )


def run_memory_passes(
    source, cfg, diags: Diagnostics,
) -> None:
    """TL40x over every module of ``source`` against ``cfg.arch``.

    ``source`` is either a :class:`~tpusim_torch.analysis.trace_passes.
    ParsedTrace` whose trace passes already ran (each module carries
    its streamed liveness summary — nothing re-parses) or a plain
    ``{name: ModuleTrace}`` mapping (the serve pre-flight's hot pod),
    analyzed one computation at a time and memoized on the module."""
    modules = getattr(source, "modules", source)
    for key in sorted(modules):
        entry = modules[key]
        file = line = None
        df = getattr(entry, "dataflow", None)
        if df is not None or hasattr(entry, "iter_computations"):
            # a ParsedModule from the lint walk
            file = entry.file
            if entry.comp_lines:
                ename = entry.module.entry_name
                line = entry.comp_lines.get(
                    ename, min(entry.comp_lines.values())
                )
            name = entry.module.name
            if df is None:
                continue  # trace passes did not run (nothing to check)
        else:
            df = analyze_module(entry)
            name = entry.name
        _check_one(name, df, cfg, diags, file=file, line=line)

"""Advise-spec passes: validate a strategy sweep before it prices.

Port of ``tpusim/analysis/advise_passes.py``.  ``run_advise`` and
``lint --advise`` run these passes.

An advise sweep can price hundreds of cells from one JSON document; a
typo'd strategy name or a pinned mesh that factors nothing must fail in
the analyzer — reachable via ``tpusim lint --advise SPEC`` — and is
also enforced by :func:`tpusim_torch.advise.run_advise` itself before cell 0
prices.  The spec loader (:mod:`tpusim_torch.advise.spec`) raises
:class:`~tpusim_torch.advise.spec.AdviseSpecError` tagged with the stable
code (TL220 format, TL221 unknown strategy, TL224 SLO without
candidates), so these passes never duplicate the format rules; the
slice-aware checks (TL222 mesh factorization, TL223 arch preset) run
here because only the analyzer composes the resolved slice list.
"""

from __future__ import annotations

from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["analyze_advise_spec", "run_advise_passes"]


def run_advise_passes(
    spec_src,
    diags: Diagnostics,
    default_chips: int = 1,
    file: str | None = None,
) -> None:
    """Validate one advise spec.

    ``spec_src`` is whatever :func:`tpusim_torch.advise.load_advise_spec`
    accepts (path / JSON text / dict / parsed spec); ``default_chips``
    sizes the default slices when the spec doesn't pin any (the runner
    passes the trace's pod size).  ``file`` anchors diagnostics.

    * TL220 — format violations (unknown field, bad type or range);
    * TL221 — unknown parallelism strategy name;
    * TL222 — a pinned mesh whose axis product factors none of the
      candidate slices (it would never produce a priceable cell);
    * TL223 — a candidate slice naming an arch with no preset;
    * TL224 — an SLO with explicitly empty candidate slices;
    * TL230 — surfaced from the loader (malformed ``dcn`` block);
    * TL232 — fabric geometry no candidate slice can stand up
      (:func:`tpusim_torch.analysis.dcn_passes.run_dcn_passes`).
    """
    from tpusim_torch.advise.spec import AdviseSpecError, load_advise_spec
    from tpusim_torch.timing.arch import ARCH_PRESETS

    try:
        spec = load_advise_spec(spec_src)
    except AdviseSpecError as e:
        diags.emit(e.code, str(e), file=file)
        return

    slices = spec.resolved_slices(default_chips)
    if spec.dcn is not None:
        from tpusim_torch.analysis.dcn_passes import run_dcn_passes

        for sl in slices:
            run_dcn_passes(spec.dcn, diags, num_chips=sl.chips,
                           file=file)
    chip_counts = set()
    for sl in slices:
        if sl.arch.lower() not in ARCH_PRESETS:
            diags.emit(
                "TL223",
                f"slice {sl.label!r}: no arch preset {sl.arch!r} "
                f"(available: {sorted(ARCH_PRESETS)})",
                file=file,
            )
        # mesh factorization is about chip counts, not arch validity —
        # a bad preset must not mask a mesh that factors nothing
        chip_counts.add(sl.chips)
    for i, mesh in enumerate(spec.meshes):
        if chip_counts and mesh.product not in chip_counts:
            diags.emit(
                "TL222",
                f"meshes[{i}] ({mesh.label}): axis product "
                f"{mesh.product} factors none of the candidate slices "
                f"(chips: {sorted(chip_counts)})",
                file=file,
            )


def analyze_advise_spec(
    spec_src,
    diags: Diagnostics | None = None,
    default_chips: int = 1,
) -> Diagnostics:
    """Entry point mirroring :func:`tpusim_torch.analysis.
    analyze_campaign_spec`: advise passes over one spec, anchored to
    its file when given a path."""
    diags = diags if diags is not None else Diagnostics()
    file = (
        str(spec_src)
        if isinstance(spec_src, (str, Path))
        and Path(str(spec_src)).suffix == ".json" else None
    )
    run_advise_passes(spec_src, diags, default_chips=default_chips,
                      file=file)
    return diags

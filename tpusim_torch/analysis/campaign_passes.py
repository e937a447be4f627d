"""Campaign-spec passes: validate a Monte-Carlo campaign before it
prices anything.

A campaign is hours of compute driven by one JSON document; a typo'd
fault kind or a percentile of 999 must fail in the analyzer — it is
enforced by
:func:`tpusim_torch.campaign.run_campaign` itself before scenario 0 prices.
The spec loader (:mod:`tpusim_torch.campaign.spec`) raises
:class:`~tpusim_torch.campaign.spec.CampaignSpecError` tagged with the stable
code, so these passes never duplicate the format rules; the
topology-aware checks (correlated groups against each slice's torus)
run here because only the analyzer composes the slices.

Port of ``tpusim/analysis/campaign_passes.py``.
"""

from __future__ import annotations

from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["analyze_campaign_spec", "run_campaign_passes"]


def run_campaign_passes(
    spec_src,
    diags: Diagnostics,
    default_chips: int = 1,
    file: str | None = None,
) -> None:
    """Validate one campaign spec.

    ``spec_src`` is whatever :func:`tpusim_torch.campaign.load_campaign_spec`
    accepts (path / JSON text / dict / parsed spec); ``default_chips``
    sizes the primary slice when the spec doesn't pin ``chips`` (the
    runner passes the trace's pod size).  ``file`` anchors diagnostics.

    * TL210 — format violations (unknown fault kind, bad distribution,
      scale outside (0, 1], ...);
    * TL211 — candidate-slice problems (empty list, malformed entry,
      SLO without candidates);
    * TL212 — SLO percentile outside (0, 100];
    * TL213 — correlated group referencing links/axes the slice torus
      does not have;
    * TL230/TL231 — surfaced from the loader (malformed ``dcn`` block /
      DCN fault kinds without a fabric);
    * TL232 — fabric geometry the candidate shapes cannot stand up
      (:func:`tpusim_torch.analysis.dcn_passes.run_dcn_passes`).
    """
    from tpusim_torch.campaign.spec import (
        CampaignSpecError,
        load_campaign_spec,
    )
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.timing.config import load_config

    try:
        spec = load_campaign_spec(spec_src)
    except CampaignSpecError as e:
        diags.emit(e.code, str(e), file=file)
        return

    if spec.dcn is not None:
        from tpusim_torch.analysis.dcn_passes import run_dcn_passes

        for sl in spec.slices(default_chips):
            run_dcn_passes(spec.dcn, diags, num_chips=sl.chips,
                           file=file)

    for sl in spec.slices(default_chips):
        try:
            arch_name = load_config(arch=sl.arch, tuned=False).arch.name
        except (KeyError, ValueError, FileNotFoundError) as e:
            diags.emit(
                "TL211",
                f"slice {sl.label!r}: arch does not compose: {e}",
                file=file,
            )
            continue
        topo = torus_for(sl.chips, arch_name)
        for g in spec.groups:
            try:
                g.resolve_links(topo)
            except CampaignSpecError as e:
                dims = "x".join(str(d) for d in topo.dims)
                diags.emit(
                    e.code,
                    f"slice {sl.label!r} ({dims} torus): {e}",
                    file=file,
                )


def analyze_campaign_spec(
    spec_src,
    diags: Diagnostics | None = None,
    default_chips: int = 1,
) -> Diagnostics:
    """Entry point mirroring :func:`tpusim_torch.analysis.analyze_schedule`:
    campaign passes over one spec, anchored to its file when given a
    path."""
    diags = diags if diags is not None else Diagnostics()
    file = (
        str(spec_src)
        if isinstance(spec_src, (str, Path))
        and Path(str(spec_src)).suffix == ".json" else None
    )
    run_campaign_passes(spec_src, diags, default_chips=default_chips,
                        file=file)
    return diags

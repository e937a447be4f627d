"""Fleet-spec passes: validate a fleet digital-twin run before it
prices anything.

A fleet twin is minutes-to-hours of pricing driven by one JSON
document; a typo'd policy knob or a load point implying millions of
arrivals must fail in the analyzer — and is also enforced by
:func:`tpusim_torch.fleet.run_fleet` itself before anything prices.  The spec
loader (:mod:`tpusim_torch.fleet.spec`) raises
:class:`~tpusim_torch.fleet.spec.FleetSpecError` tagged with the stable code,
so these passes never duplicate the format rules; the topology-aware
check (correlated groups against the pod torus) runs here because only
the analyzer composes the slice.

Port of ``tpusim/analysis/fleet_passes.py``.
"""

from __future__ import annotations

from pathlib import Path

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["analyze_fleet_spec", "run_fleet_passes"]


def run_fleet_passes(
    spec_src,
    diags: Diagnostics,
    default_chips: int = 1,
    file: str | None = None,
) -> None:
    """Validate one fleet spec.

    ``spec_src`` is whatever :func:`tpusim_torch.fleet.load_fleet_spec`
    accepts; ``default_chips`` sizes the pod when the spec doesn't pin
    ``chips`` (the runner passes the trace's pod size).  ``file``
    anchors diagnostics.

    * TL240 — format/policy violations (unknown field, bad fault model,
      policy knob out of range);
    * TL241 — traffic-model violations (bad shape/mix, a load point
      past the per-cell arrival ceiling);
    * TL242 — SLO/frontier violations (percentile outside (0, 100],
      frontier without an SLO);
    * TL243 — correlated group referencing links/axes the pod torus
      does not have;
    * TL230/TL231 — surfaced from the loader (malformed ``dcn`` block /
      DCN fault kinds without a fabric);
    * TL232 — fabric geometry the pod shape cannot stand up
      (:func:`tpusim_torch.analysis.dcn_passes.run_dcn_passes`).
    """
    from tpusim_torch.campaign.spec import CampaignSpecError
    from tpusim_torch.fleet.spec import FleetSpecError, load_fleet_spec
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.timing.config import load_config

    try:
        spec = load_fleet_spec(spec_src)
    except FleetSpecError as e:
        diags.emit(e.code, str(e), file=file)
        return

    try:
        arch_name = load_config(arch=spec.arch, tuned=False).arch.name
    except (KeyError, ValueError, FileNotFoundError) as e:
        diags.emit(
            "TL240",
            f"fleet arch {spec.arch!r} does not compose: {e}",
            file=file,
        )
        return
    chips = spec.chips or default_chips
    if spec.dcn is not None:
        from tpusim_torch.analysis.dcn_passes import run_dcn_passes

        run_dcn_passes(spec.dcn, diags, num_chips=chips, file=file)
    topo = torus_for(chips, arch_name)
    for g in spec.groups:
        try:
            g.resolve_links(topo)
        except CampaignSpecError as e:
            dims = "x".join(str(d) for d in topo.dims)
            diags.emit(
                "TL243",
                f"pod slice ({dims} torus): {e}",
                file=file,
            )


def analyze_fleet_spec(
    spec_src,
    diags: Diagnostics | None = None,
    default_chips: int = 1,
) -> Diagnostics:
    """Entry point mirroring :func:`tpusim_torch.analysis.analyze_campaign_
    spec`: fleet passes over one spec, anchored to its file when given
    a path."""
    diags = diags if diags is not None else Diagnostics()
    file = (
        str(spec_src)
        if isinstance(spec_src, (str, Path))
        and Path(str(spec_src)).suffix == ".json" else None
    )
    run_fleet_passes(spec_src, diags, default_chips=default_chips,
                     file=file)
    return diags

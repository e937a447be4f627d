"""DCN passes: ``dcn`` spec blocks and slice-targeted faults against
the fabric they configure.

The block parser (:mod:`tpusim_torch.dcn.spec`) already *raises* on format
violations — the campaign/fleet/advise spec loaders surface those as
TL230 through their own error types, and sampling DCN fault kinds
without a fabric refuses at spec load (TL231).  What is left for a
pass is the cross-artifact geometry the parser cannot see: a fabric
whose slice count the chip count cannot stand up, and explicit fault
records naming slice indices the fabric does not have (TL232 — a
warning, because the sampler folds indices and the executor simply
never matches them, but the spec author almost certainly typoed).

Port of ``tpusim/analysis/dcn_passes.py``.
"""

from __future__ import annotations

from tpusim_torch.analysis.diagnostics import Diagnostics

__all__ = ["run_dcn_passes"]


def run_dcn_passes(
    block,
    diags: Diagnostics,
    num_chips: int | None = None,
    faults=None,
    file: str | None = None,
) -> None:
    """Validate one parsed :class:`~tpusim_torch.dcn.spec.DcnBlock` against
    the system it stands up.

    ``num_chips`` is the chip count the fabric tiles (one campaign
    candidate slice, the fleet pod, an advise cell); ``faults`` an
    optional iterable of bound fault records (``Fault`` objects or raw
    docs) whose slice targets are range-checked."""
    if block is None:
        return
    ns = block.num_slices
    if num_chips is not None and ns > num_chips:
        diags.emit(
            "TL232",
            f"dcn.num_slices={ns} exceeds the {num_chips}-chip "
            f"system — at most {num_chips} slices can hold a chip",
            file=file,
        )
    for i, f in enumerate(faults or ()):
        s = f.get("slice") if isinstance(f, dict) else \
            getattr(f, "slice", None)
        if s is not None and s >= ns:
            diags.emit(
                "TL232",
                f"fault[{i}]: slice {s} out of range for the "
                f"configured fabric ({ns} slices)",
                file=file,
            )

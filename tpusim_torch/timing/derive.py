"""Cross-generation derivation of a timing overlay.

Port of ``tpusim/timing/derive.py``.

Only v5e silicon is reachable from this environment, but the north-star
metric names v5p.  The reference ships per-card tuner-built configs
(``gpu-simulator/configs/tested-cfgs/``); with no v5p silicon to tune
against, the honest equivalent is an explicit partition of the
calibrated model into:

* **published absolutes** — per-generation spec values (clock, MXU
  count/shape, HBM bandwidth/capacity, ICI topology/link rate) that the
  presets in :mod:`tpusim_torch.timing.arch` carry and a derivation must NOT
  touch;
* **transferable calibrations** — dimensionless fractions and
  cycle-count constants of the shared TensorCore microarchitecture
  (same 128x128 MXU, (8,128) vmem tile geometry, DMA engine and
  sequencer design across v4/v5e/v5p), fitted on v5e silicon and
  carried across;
* **non-transferable fits** — values that encode a v5e-specific
  physical quantity (the measured v5e clock) and stay home.

``derive_overlay`` applies the committed v5e-calibrated transferables
over the destination preset and writes ``configs/<dst>.derived.flags``,
which ``load_config`` picks up whenever no real ``<dst>.tuned.flags``
exists.  The partition (with per-knob justification) is
:data:`TRANSFERABLE_KNOBS`; the full confidence argument lives in
``docs/V5P.md``.
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["TRANSFERABLE_KNOBS", "NON_TRANSFERABLE_KNOBS", "derive_overlay"]

#: knob -> why it transfers across TensorCore generations.  These are
#: dimensionless efficiencies or cycle counts of mechanisms that are
#: compiler- or microarchitecture-shaped, not process/spec-shaped.
TRANSFERABLE_KNOBS: dict[str, str] = {
    "hbm_efficiency": (
        "achieved fraction of pin bandwidth under streaming access; "
        "memory-controller quality, consistently ~0.8 of spec across "
        "TPU generations (v5e measured 0.835)"
    ),
    "mxu_efficiency": (
        "sustained fraction of the systolic-pass rate on large matmuls; "
        "pipeline-bubble property of the same 128x128 array (v5p has "
        "more MXUs, not different ones)"
    ),
    "mxu_weight_stall_cycles": (
        "double-buffered weight-load floor per pass, a property of the "
        "128x128 array depth shared by v4/v5e/v5p"
    ),
    "mxu_fill_cycles": (
        "systolic fill/drain latency of the same 128-deep array"
    ),
    "mxu_conv_tap_efficiency": (
        "im2col/emitter overhead of spatial convs — an XLA:TPU code-"
        "generation property, not a chip one"
    ),
    "vpu_transcendental_per_cycle": (
        "transcendental issue rate of the 8x128x4 VPU, same vector unit "
        "layout across generations"
    ),
    "vpu_reduce_slowdown": (
        "dtype-width accumulation law of the VPU reduce tree"
    ),
    "vpu_lane_cross_cycles": (
        "lane-shuffle tail per output element for minor-dim reduces; "
        "lane-crossbar property of the shared VPU geometry"
    ),
    "gather_row_overhead_cycles": (
        "per-noncontiguous-row DMA descriptor cost; DMA-engine design "
        "shared across generations"
    ),
    "dma_issue_latency": (
        "async DMA descriptor setup + first byte (seconds); engine "
        "design constant, not bandwidth-dependent"
    ),
    "relayout_efficiency": (
        "sub-lane shuffle rate as a fraction of stream rate; fixed by "
        "the (8,128) tile geometry all generations share"
    ),
    "relayout_lane_efficiency": (
        "tile-reordering relayout fraction, same tile geometry argument"
    ),
    "vmem_copy_efficiency": (
        "vmem load/store port rate as a fraction of banked operand "
        "bandwidth; same vmem design family"
    ),
    "vmem_slice_efficiency": (
        "movement-fusion port fraction, same argument"
    ),
    "op_overhead_cycles": (
        "per-op sequencer dispatch cycles; core sequencer design"
    ),
    "small_kernel_floor_cycles": (
        "sub-tile standalone-kernel dispatch floor in CYCLES (scales "
        "with clock when converted to time, as a dispatch cost should)"
    ),
}

#: calibrated-on-v5e values that must NOT be carried to another
#: generation, with the reason.
NON_TRANSFERABLE_KNOBS: dict[str, str] = {
    "clock_ghz": (
        "v5e silicon measured 1.737 GHz against a 1.67 announced clock; "
        "each generation's published clock stands until its own silicon "
        "says otherwise"
    ),
    "hbm_bandwidth": "published spec absolute per generation",
    "mxu_count": "published spec absolute per generation",
    "dtype_mult": (
        "fitted s8 multiplier rides the preset default table; dtype "
        "ratios are published per generation"
    ),
}


def derive_overlay(
    src_arch: str = "v5e",
    dst_arch: str = "v5p",
    *,
    out_path: str | Path | None = None,
) -> list[str]:
    """Overlay flag lines carrying ``src_arch``'s calibrated transferable
    knobs onto ``dst_arch``'s published preset.  Writes ``out_path`` when
    given (the canonical location is ``configs/<dst>.derived.flags``)."""
    from tpusim_torch.timing.config import load_config

    src = load_config(arch=src_arch).arch      # preset + committed overlay
    dst = load_config(arch=dst_arch, tuned=False).arch

    lines = [
        f"# tpusim cross-generation derivation: {src_arch} -> {dst_arch}",
        "# transferable TensorCore calibrations over published "
        f"{dst_arch} absolutes — see docs/V5P.md and "
        "tpusim/timing/derive.py for the per-knob argument",
    ]
    for knob in sorted(TRANSFERABLE_KNOBS):
        sv = getattr(src, knob)
        if sv == getattr(dst, knob):
            continue  # preset already agrees; keep the file minimal
        if isinstance(sv, int):
            lines.append(f"-arch.{knob} {sv}")
        else:
            lines.append(f"-arch.{knob} {float(sv):.6g}")
    if out_path is not None:
        p = Path(out_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(lines) + "\n")
    return lines

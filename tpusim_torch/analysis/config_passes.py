"""Config passes: timing/arch cross-field sanity, pre cycle 0.

AccelWattch (MICRO 2021) showed how an unvalidated config/model mismatch
quietly corrupts every downstream fit — a zeroed clock or a bandwidth
typo doesn't crash, it just prices every op wrong.  These passes check a
composed :class:`~tpusim_torch.timing.config.SimConfig` (preset + tuned
overlay + CLI overlays, i.e. exactly what the driver would run):

* **field classes** (TL101/TL104/TL105/TL106) — driven by the
  :data:`~tpusim_torch.timing.config.CONFIG_FIELD_RULES` table declared next
  to the dataclasses, so a new knob gets its rule in the same diff;
* **derived rooflines** (TL102) — the numbers the cost model actually
  uses (peak bf16 FLOP/s, HBM bytes/cycle, vmem multiple) must land in
  physically plausible ranges, and MXU/VPU dims in hardware-idiomatic
  multiples;
* **trace/config agreement** (TL103) — a trace captured on one TPU
  generation priced under another generation's config is usually a
  mistake; flagged when the capture's ``device_kind`` confidently maps
  to a different preset.

Port of ``tpusim/analysis/config_passes.py``.
"""

from __future__ import annotations

import math

from tpusim_torch.analysis.diagnostics import Diagnostics
from tpusim_torch.timing.config import CONFIG_FIELD_RULES, SimConfig

__all__ = ["run_config_passes"]


def _resolve(cfg: SimConfig, dotted: str):
    obj = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_field_rules(
    cfg: SimConfig, diags: Diagnostics, file: str | None
) -> None:
    for dotted, rule in sorted(CONFIG_FIELD_RULES.items()):
        try:
            val = _resolve(cfg, dotted)
        except AttributeError:
            continue  # field removed/renamed; the rules table lags
        if rule == "positive":
            if not _is_number(val) or not math.isfinite(val) or val <= 0:
                diags.emit(
                    "TL101",
                    f"{dotted} must be a positive finite number, "
                    f"got {val!r}",
                    file=file,
                )
        elif rule == "nonneg":
            if not _is_number(val) or not math.isfinite(val) or val < 0:
                diags.emit(
                    "TL106",
                    f"{dotted} must be a non-negative finite number, "
                    f"got {val!r}",
                    file=file,
                )
        elif rule == "fraction":
            if not _is_number(val) or not 0.0 < val <= 1.0:
                diags.emit(
                    "TL104",
                    f"{dotted} must be in (0, 1], got {val!r}",
                    file=file,
                )
        elif rule.startswith("enum:"):
            valid = rule[len("enum:"):].split(",")
            if val not in valid:
                diags.emit(
                    "TL105",
                    f"{dotted} must be one of {valid}, got {val!r}",
                    file=file,
                )
    for dtype, mult in sorted(cfg.arch.dtype_mult.items()):
        if not _is_number(mult) or not math.isfinite(mult) or mult <= 0:
            diags.emit(
                "TL101",
                f"arch.dtype_mult[{dtype!r}] must be a positive finite "
                f"number, got {mult!r}",
                file=file,
            )


#: plausible derived-roofline bounds (an order of magnitude around every
#: shipped TPU generation: v2 ~46 TF/s bf16 ... conceivable successors)
_PEAK_FLOPS_RANGE = (1e12, 1e17)
_HBM_BYTES_PER_CYCLE_RANGE = (1.0, 1e5)


def _check_rooflines(
    cfg: SimConfig, diags: Diagnostics, file: str | None
) -> None:
    arch = cfg.arch
    # field-rule errors already explain a broken derivation; the roofline
    # pass only adds signal when the inputs are individually plausible
    try:
        peak = arch.peak_bf16_flops
        hbm_cyc = arch.hbm_bytes_per_cycle
    except (TypeError, ZeroDivisionError):
        return
    if not math.isfinite(peak):
        return
    lo, hi = _PEAK_FLOPS_RANGE
    if peak > 0 and not lo <= peak <= hi:
        diags.emit(
            "TL102",
            f"derived peak bf16 compute {peak:.3g} FLOP/s "
            f"(= 2 * mxu_count * rows * cols * clock) is outside the "
            f"plausible TPU range [{lo:.0g}, {hi:.0g}]",
            file=file,
        )
    lo, hi = _HBM_BYTES_PER_CYCLE_RANGE
    if hbm_cyc > 0 and not lo <= hbm_cyc <= hi:
        diags.emit(
            "TL102",
            f"derived HBM streaming rate {hbm_cyc:.3g} bytes/cycle is "
            f"outside the plausible range [{lo:.0g}, {hi:.0g}] — check "
            f"hbm_bandwidth/hbm_efficiency/clock_ghz agree on units",
            file=file,
        )
    # non-numeric fields already earned a TL101/TL104 above — the idiom
    # checks only add signal on values arithmetic can reach
    if _is_number(arch.mxu_rows) and _is_number(arch.mxu_cols) and (
        arch.mxu_rows % 8 or arch.mxu_cols % 8
    ):
        diags.emit(
            "TL102",
            f"MXU dims {arch.mxu_rows}x{arch.mxu_cols} are not "
            f"multiples of 8 — real systolic arrays tile in 8s; the "
            f"pass-count model will mis-tile",
            file=file,
        )
    if _is_number(arch.vpu_lanes) and arch.vpu_lanes % 128:
        diags.emit(
            "TL102",
            f"vpu_lanes={arch.vpu_lanes} is not a multiple of 128 — "
            f"TPU vregs are (sublanes, 128) tiles; lane occupancy math "
            f"assumes it",
            file=file,
        )
    if _is_number(arch.vmem_bandwidth_mult) and \
            0 < arch.vmem_bandwidth_mult < 1:
        diags.emit(
            "TL102",
            f"vmem_bandwidth_mult={arch.vmem_bandwidth_mult:g} makes "
            f"vmem SLOWER than HBM — the roofline will never choose "
            f"the scratchpad",
            file=file,
        )


def _check_trace_agreement(
    cfg: SimConfig, trace_meta: dict, diags: Diagnostics,
    file: str | None,
) -> None:
    kind = str(trace_meta.get("device_kind", "") or "")
    if not kind or "tpu" not in kind.lower():
        # CPU/GPU-backend captures (tests, CI) price under any arch by
        # design — only a confident TPU-generation mapping is a signal
        return
    from tpusim_torch.timing.arch import match_device_kind

    detected = match_device_kind(kind)
    if detected is None:
        # unrecognized TPU generation: detect_arch would fall back to
        # v5e, but a guess is not a mismatch — stay silent
        return
    if detected != cfg.arch.name:
        diags.emit(
            "TL103",
            f"trace was captured on {kind!r} (arch {detected}) but the "
            f"chosen config models {cfg.arch.name} — timings will "
            f"reflect the wrong generation",
            file=file,
        )


def _check_slice_tiling(
    cfg: SimConfig, trace_meta: dict, diags: Diagnostics,
    file: str | None,
) -> None:
    """TL108: a ``chips_per_slice`` that does not evenly tile the
    trace's chip count prices silently through ``math.ceil`` — the
    partial last slice participates in the DCN ring as a FULL slice
    (``S = ceil(chips / chips_per_slice)``), which is usually a typo
    in one of the two numbers."""
    cps = cfg.arch.ici.chips_per_slice
    if not _is_number(cps) or cps <= 0:
        return
    chips = int(trace_meta.get("num_devices", 0) or 0)
    if chips > cps and chips % cps:
        s = math.ceil(chips / cps)
        diags.emit(
            "TL108",
            f"chips_per_slice={cps} does not evenly tile the trace's "
            f"{chips} chips — the collective model rounds UP to "
            f"{s} slices and prices the {chips % cps}-chip partial "
            f"slice as a full DCN participant",
            file=file,
        )


def run_config_passes(
    cfg: SimConfig,
    diags: Diagnostics,
    trace_meta: dict | None = None,
    file: str | None = None,
) -> None:
    """All config-family passes over one composed :class:`SimConfig`.

    ``file`` anchors the diagnostics (e.g. the overlay flag file that
    produced the value); None means the composed in-memory config."""
    _check_field_rules(cfg, diags, file)
    _check_rooflines(cfg, diags, file)
    if trace_meta:
        _check_trace_agreement(cfg, trace_meta, diags, file)
        _check_slice_tiling(cfg, trace_meta, diags, file)

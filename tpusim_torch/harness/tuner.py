"""Microbenchmark tuner — port of ``tpusim/harness/tuner.py``, the
rebuild of ``util/tuner/tuner.py``.

The reference runs ~30 CUDA microbenchmarks that each print config lines,
then splices them into ``gpgpusim.config`` templates
(``tuner.py:23-67``).  Ours runs the reference's unit-isolating
microbenchmarks, looped (:func:`~tpusim_torch.harness.correlate.loopify`),
on the port's device — the card unless the caller asks for the CPU — and
*fits* the arch parameters they expose:

* ``clock_ghz``        from sustained bf16 matmul throughput (MXU peak)
* ``hbm_efficiency``   from streamed elementwise bandwidth
* ``vpu_reduce_slowdown`` from large-reduction throughput
* ``mxu_fill_cycles``  from a chain of MXU-tile-sized matmuls
* ``op_overhead_cycles`` from a long chain of dependent tiny ops
* ``vpu_transcendental_per_cycle`` from an exp/tanh stream
* ``dtype_mult['f32']`` from the f32/bf16 matmul throughput ratio
* ``dtype_mult['s8']``  from the int8/bf16 matmul throughput ratio
* ``host_bandwidth``   from pageable host-to-device copies
* ``ici.link_bandwidth`` from a psum sweep (multi-chip hosts only)

emitting a reference-style flag-file overlay (``-arch.clock_ghz 1.67``)
that ``load_config`` composes from ``$TPUSIM_TUNED_DIR``.  The base arch
is a TPU preset (the card kind falls back to ``v5e``), so on the card the
overlay says what that preset's knobs would have to be to match it.  The
formulas and rounding are the reference's; the CLI writes the overlay
under :data:`TUNED_OUT`, never ``configs/``.  ``tune_power`` (``tune
--power``) needs no device: it fits from telemetry when a source answers,
else from the documented anchor fixtures.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["POWER_OUT", "TUNED_OUT", "TunerResult", "tune", "tune_power",
           "write_overlay"]

#: where ``tune_power`` writes by default (relative to the working dir,
#: like the CLI's other reports; git-ignored)
POWER_OUT = Path("build") / "tpusim_torch_reports" / "power_fitted"
#: where ``tune --out auto`` writes ``<arch>.tuned.flags``; point
#: ``$TPUSIM_TUNED_DIR`` here to apply it
TUNED_OUT = Path("build") / "tpusim_torch_reports" / "tuned"


@dataclass
class TunerResult:
    device_kind: str
    base_arch: str
    clock_ghz: float | None = None
    hbm_efficiency: float | None = None
    vpu_reduce_slowdown: float | None = None
    mxu_fill_cycles: float | None = None
    op_overhead_cycles: float | None = None
    transcendental_per_cycle: float | None = None
    f32_dtype_mult: float | None = None
    s8_dtype_mult: float | None = None
    host_bandwidth: float | None = None
    ici_link_bandwidth: float | None = None
    details: dict | None = None

    def overlay_lines(self) -> list[str]:
        lines = [f"# tpusim tuner fit for {self.device_kind}"]
        if self.clock_ghz:
            lines.append(f"-arch.clock_ghz {self.clock_ghz:.4g}")
        if self.hbm_efficiency:
            lines.append(f"-arch.hbm_efficiency {self.hbm_efficiency:.4g}")
        if self.vpu_reduce_slowdown:
            lines.append(
                f"-arch.vpu_reduce_slowdown {self.vpu_reduce_slowdown:.4g}"
            )
        if self.mxu_fill_cycles:
            lines.append(
                f"-arch.mxu_fill_cycles {round(self.mxu_fill_cycles)}"
            )
        if self.op_overhead_cycles:
            lines.append(
                f"-arch.op_overhead_cycles {round(self.op_overhead_cycles)}"
            )
        if self.transcendental_per_cycle:
            lines.append(
                "-arch.vpu_transcendental_per_cycle "
                f"{round(self.transcendental_per_cycle)}"
            )
        if self.f32_dtype_mult:
            lines.append(
                f"-arch.dtype_mult.f32 {self.f32_dtype_mult:.4g}"
            )
        if self.s8_dtype_mult:
            lines.append(
                f"-arch.dtype_mult.s8 {self.s8_dtype_mult:.4g}"
            )
        if self.host_bandwidth:
            lines.append(f"-arch.host_bandwidth {self.host_bandwidth:.4g}")
        if self.ici_link_bandwidth:
            lines.append(
                f"-arch.ici.link_bandwidth {self.ici_link_bandwidth:.4g}"
            )
        return lines


def _per_step(workload: str, n_steps: int, iters: int = 3, **build_kw):
    """Per-step DEVICE seconds for one looped workload (``device=`` in
    ``build_kw`` picks where it runs).

    Fit measurements use the profiler's device timeline, not wall clock:
    an eager program leaves the device idle between its kernels while the
    host dispatches, and fitting bandwidth/rate parameters against wall
    time would bake that host artifact into the hardware model.  Falls
    back, loudly, to wall time off the card."""
    from tpusim_torch.harness.correl_ops import measure_device_time
    from tpusim_torch.harness.correlate import loopify
    from tpusim_torch.models import get_workload
    from tpusim_torch.tracer.capture import measure_wall_time

    fn, args = get_workload(workload).build(**build_kw)
    looped = loopify(fn, n_steps)
    try:
        t = measure_device_time(looped, *args, iters=iters)
    except Exception as e:
        # a wall-clock fit bakes dispatch gaps into the overlay — record
        # the downgrade loudly so a corrupted fit is attributable
        _WALL_FALLBACKS.append(f"{workload}: {type(e).__name__}: {e}")
        print(
            f"tuner[{workload}]: device timing failed "
            f"({type(e).__name__}: {e}); fitting against WALL time "
            f"(includes dispatch gaps)", file=sys.stderr,
        )
        t = measure_wall_time(looped, *args, iters=iters)
    return t["median_s"] / n_steps


#: workloads whose fit fell back to wall-clock timing in the running
#: tune(); it drains this into TunerResult.details["wall_time_fallbacks"]
_WALL_FALLBACKS: list[str] = []


def _fit_clock(arch, n_steps: int = 16, device=None) -> tuple[float, float]:
    """Sustained big-matmul rate → implied clock (MXU count/size fixed)."""
    per_step = _per_step("matmul", n_steps, m=4096, n=4096, k=4096,
                         device=device)
    flops = 2.0 * 4096 ** 3
    achieved = flops / per_step
    flops_per_cycle = 2.0 * arch.mxu_count * arch.mxu_rows * arch.mxu_cols
    implied_clock = achieved / flops_per_cycle / 1e9
    return implied_clock, achieved


def _fit_hbm(arch, n_steps: int = 16, device=None) -> tuple[float, float]:
    """Streamed elementwise bandwidth → HBM efficiency."""
    elems = 32 * 1024 * 1024
    per_step = _per_step("elementwise_stream", n_steps, elems=elems,
                         device=device)
    nbytes = 2.0 * elems * 4            # read + write f32
    achieved = nbytes / per_step
    return min(achieved / arch.hbm_bandwidth, 1.0), achieved


def _fit_reduce(arch, clock_ghz: float, n_steps: int = 64,
                device=None) -> float:
    """Large lane-dim reduction rate → VPU reduce slowdown factor."""
    rows = cols = 4096
    per_step = _per_step("reduction", n_steps, rows=rows, cols=cols,
                         device=device)
    elems = float(rows * cols)
    elems_per_cycle = elems / (per_step * clock_ghz * 1e9)
    vpu_rate = arch.vpu_sublanes * arch.vpu_lanes * arch.vpu_alus
    return max(vpu_rate / max(elems_per_cycle, 1e-9), 1.0)


def _fit_fill(arch, clock_ghz: float, device=None) -> float:
    """Tile-sized matmul chain: per-matmul time at the fitted clock minus
    the streaming term is the pipeline fill/drain."""
    depth = 64
    per_step = _per_step("small_matmul_chain", 8, size=128, depth=depth,
                         device=device)
    per_mm_cycles = per_step / depth * clock_ghz * 1e9
    # the cost model prices a single 128^3 matmul as one serial pass of
    # m_pad + fill cycles (cost.py mxu_cycles: passes=1 -> serial=1, so
    # mxu_count does NOT divide it); subtract the m_pad=128 streaming term
    del arch
    stream_cycles = 128.0
    return max(per_mm_cycles - stream_cycles, 1.0)


def _fit_op_overhead(clock_ghz: float, device=None) -> float:
    """Dependent tiny-op chain: marginal per-op cycles."""
    shallow, deep = 64, 256
    t_shallow = _per_step("op_overhead_chain", 8, depth=shallow,
                          device=device)
    t_deep = _per_step("op_overhead_chain", 8, depth=deep, device=device)
    per_op = (t_deep - t_shallow) / (deep - shallow)
    return max(per_op * clock_ghz * 1e9, 0.0)


def _fit_transcendental(clock_ghz: float, device=None) -> float:
    """exp+tanh stream: transcendentals retired per cycle."""
    elems = 8 * 1024 * 1024
    per_step = _per_step("transcendental", 16, elems=elems, device=device)
    # tanh(exp(x)) = 2 transcendental ops per element
    ops = 2.0 * elems
    return ops / (per_step * clock_ghz * 1e9)


def _fit_f32_mult(mxu_achieved_bf16: float, device=None) -> float:
    """f32/bf16 matmul throughput ratio (the dtype_mult table entry)."""
    n = 4096
    per_step = _per_step(
        "matmul", 8, m=n, n=n, k=n, dtype="float32", device=device
    )
    achieved_f32 = 2.0 * n ** 3 / per_step
    return achieved_f32 / max(mxu_achieved_bf16, 1.0)


def _fit_s8_mult(mxu_achieved_bf16: float, device=None) -> float:
    """int8/bf16 matmul throughput ratio — the quantized-serving
    dtype_mult entry (nominally 2.0)."""
    n = 4096
    per_step = _per_step("matmul_int8", 8, m=n, n=n, k=n, device=device)
    achieved_s8 = 2.0 * n ** 3 / per_step
    return achieved_s8 / max(mxu_achieved_bf16, 1.0)


def _fit_host_bw(device=None) -> float:
    """Copy of a large pageable host buffer to the device: host->HBM
    bandwidth, best of 3 (the reference's ``device_put`` of a numpy
    array)."""
    import time

    import torch

    from tpusim_torch.harness.correl_ops import _sync
    from tpusim_torch.models.registry import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no host-to-device copy to time on {dev.type}")
    nbytes = 256 * 1024 * 1024
    host = torch.ones(nbytes // 4, dtype=torch.float32)
    host[:1024].to(dev)                 # warm path
    _sync(dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        buf = host.to(dev)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
        del buf
    return nbytes / best


def _fit_ici(arch, device=None) -> float | None:
    """psum over the local mesh -> achieved per-link bandwidth.  Needs
    more than one device; returns None on single-card hosts."""
    import torch

    from tpusim_torch.models.registry import resolve_device

    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 2:
        return None
    raise NotImplementedError(
        f"{n} cards: the port runs every rank of ici_allreduce on one card "
        f"(tpusim_torch.spmd.run_ranks), so no link carries its traffic")


def tune(arch_name: str | None = None, device=None) -> TunerResult:
    """Run the fit suite on the device (default ``cuda``)."""
    from tpusim_torch.harness.correlate import _device_kind
    from tpusim_torch.models.registry import resolve_device
    from tpusim_torch.timing.arch import arch_preset, detect_arch

    dev = resolve_device(device)
    kind = _device_kind(dev)
    arch = arch_preset(arch_name) if arch_name else detect_arch(kind)
    _WALL_FALLBACKS.clear()

    clock, mxu_achieved = _fit_clock(arch, device=dev)
    hbm_eff, hbm_achieved = _fit_hbm(arch, device=dev)
    reduce_slow = _fit_reduce(arch, clock, device=dev)

    fit_errors: dict[str, str] = {}

    def _try(label, fn, *a):
        try:
            return fn(*a, device=dev)
        except Exception as e:  # record, don't abort the whole tune
            fit_errors[label] = f"{type(e).__name__}: {e}"
            return None

    fill = _try("mxu_fill_cycles", _fit_fill, arch, clock)
    overhead = _try("op_overhead_cycles", _fit_op_overhead, clock)
    transc = _try("transcendental_per_cycle", _fit_transcendental, clock)
    f32_mult = _try("f32_dtype_mult", _fit_f32_mult, mxu_achieved)
    s8_mult = _try("s8_dtype_mult", _fit_s8_mult, mxu_achieved)
    host_bw = _try("host_bandwidth", _fit_host_bw)
    ici_bw = _try("ici_link_bandwidth", _fit_ici, arch)

    return TunerResult(
        device_kind=kind,
        base_arch=arch.name,
        clock_ghz=round(clock, 3),
        hbm_efficiency=round(hbm_eff, 3),
        vpu_reduce_slowdown=round(reduce_slow, 2),
        mxu_fill_cycles=round(fill, 1) if fill else None,
        op_overhead_cycles=round(overhead, 1) if overhead else None,
        transcendental_per_cycle=round(transc, 1) if transc else None,
        f32_dtype_mult=round(f32_mult, 4) if f32_mult else None,
        s8_dtype_mult=round(s8_mult, 4) if s8_mult else None,
        host_bandwidth=round(host_bw, 1) if host_bw else None,
        ici_link_bandwidth=round(ici_bw, 1) if ici_bw else None,
        details={
            "mxu_achieved_tflops": mxu_achieved / 1e12,
            "hbm_achieved_gbps": hbm_achieved / 1e9,
            **({"fit_errors": fit_errors} if fit_errors else {}),
            **({"wall_time_fallbacks": list(_WALL_FALLBACKS)}
               if _WALL_FALLBACKS else {}),
        },
    )


def write_overlay(result: TunerResult, path: str | Path) -> None:
    Path(path).write_text("\n".join(result.overlay_lines()) + "\n")


def tune_power(
    arch_name: str, out_dir: str | Path | None = None,
    probe: dict | None = None,
) -> "Path":
    """Fit power coefficients for one generation and persist them under
    ``out_dir`` (default :data:`POWER_OUT`, never the committed
    ``power/fitted/``) — the AccelWattch hw-profiler + quadprog pipeline
    (``AccelWattch.md:110-125``).  The document is the reference's, byte
    for byte, in the same environment.

    Prefers live telemetry samples (TPU-VM power metrics via
    :func:`tpusim_torch.power.telemetry.read_power_watts`); when no telemetry
    source exists — the usual case on tunneled images — fits against the
    documented TDP-class anchor fixtures instead, so the committed
    coefficients always have a stated provenance."""
    from tpusim_torch.power.telemetry import (
        PowerSample,
        anchor_samples,
        fit_power_coefficients,
        probe_power_sources,
        save_fitted,
    )

    # Callers that already probed (and platform-verified) pass their
    # result in, vouching for it — that keeps logged and committed
    # provenance from disagreeing across two reads AND means a bare
    # `tune_power()` on a workstation whose hwmon exposes a battery rail
    # cannot relabel committed TPU coefficients as source=telemetry.
    trusted = probe is not None
    if probe is None:
        probe = probe_power_sources()
    watts = probe.get("watts")
    use_measurement = trusted and watts is not None
    samples = anchor_samples(arch_name)
    meta: dict = {
        "source": "telemetry" if use_measurement else "anchors",
        # the committed evidence: every source tried and what it said
        "telemetry_probe": probe["tried"],
    }
    if use_measurement:
        # one real measured point (chips at rest when tune_power runs),
        # normalized per chip (anchors are per-chip operating points; an
        # 8-chip VM's summed idle watts is not one chip's idle), replaces
        # the guessed idle anchor
        chips = max(int(probe.get("chips") or 1), 1)
        per_chip = float(watts) / chips
        samples = [PowerSample("measured_idle", per_chip)] + [
            s for s in samples if s.name != "idle"
        ]
        meta["measured_idle_watts"] = per_chip
        meta["measured_chips"] = chips
    elif watts is not None:
        meta["note"] = (
            "a power reading exists but was self-probed without platform "
            "verification — pass probe= from a TPU-guarded caller (bench) "
            "to use it; keeping anchor fixtures"
        )
    else:
        meta["note"] = (
            "no power source exposed on this VM (see telemetry_probe); "
            "anchor fixtures are published TDP-class estimates — re-run "
            "tune_power on a telemetry-capable TPU-VM"
        )
    meta["samples"] = [s.name for s in samples]
    coeffs = fit_power_coefficients(samples, arch_name)
    return save_fitted(coeffs, out_dir or POWER_OUT, meta=meta)

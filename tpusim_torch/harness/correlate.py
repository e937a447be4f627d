"""Sim-vs-silicon correlation (port of ``tpusim/harness/correlate.py``).

The rebuild of the reference's correlator (``util/plotting/
plot-correlation.py`` + ``correl_mappings.py``): where that compares
simulated cycles against nvprof ``Duration × clock`` per kernel per card,
we compare the timing engine's estimate for a captured HLO module against
a measurement of the same program on the port's device, the card.

A workload is wrapped in a ``scan`` of K steps *before* capture
(:func:`loopify`), so the same K-step program is both simulated (the
capture's ``while``, whose trip count
:mod:`tpusim_torch.trace.loop_analysis` recovers) and timed: by the
profiler's device timeline on the card
(:func:`tpusim_torch.harness.correl_ops.measure_device_time`), by CUDA
events or the host clock otherwise.  The arch is a TPU preset (the card
kind falls back to ``v5e``), so a point says how far that preset's
knobs are from this device.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
from torch import nn

from tpusim_torch.spmd import SpmdModule

__all__ = ["CorrelationPoint", "correlate_workload", "loopify", "Looped",
           "LoopedSpmd"]


@dataclass
class CorrelationPoint:
    name: str
    sim_seconds: float
    real_seconds: float
    sim_cycles: float
    flops: float
    hbm_bytes: float
    #: where real_seconds came from: "device" (profiler device timeline)
    #: or "wall" (CUDA events or the host clock; includes dispatch gaps)
    real_source: str = "wall"

    @property
    def error_pct(self) -> float:
        """Signed cycle error vs silicon, percent (the headline metric —
        BASELINE.md north-star is |error| <= 15%)."""
        if self.real_seconds <= 0:
            return float("inf")
        return 100.0 * (self.sim_seconds - self.real_seconds) / self.real_seconds

    @property
    def abs_error_pct(self) -> float:
        return abs(self.error_pct)


def _leaves(x: Any) -> list:
    if isinstance(x, (tuple, list)):
        return [t for o in x for t in _leaves(o)]
    return [x]


def _signature(leaves: list) -> tuple | None:
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        return None
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


class Looped(nn.Module):
    """``module`` run ``n_steps`` times in one ``scan``: see
    :func:`loopify`."""

    def __init__(self, module: nn.Module, n_steps: int):
        super().__init__()
        self.inner = module
        self.n_steps = n_steps
        #: capture traces a train step with make_fx (it takes autograd)
        self.train_step = getattr(module, "train_step", False)
        #: how many leading arguments form the reference's first argument
        #: (a train step's flattened parameters)
        self.carry_leaves = getattr(module, "carry_leaves", 1)
        self.__name__ = (f"loop{n_steps}_"
                         f"{getattr(module, '__name__', type(module).__name__)}")

    def forward(self, *args: torch.Tensor):
        from tpusim_torch.models.decode import dynamic_update_slice
        from tpusim_torch.models.loop import scan

        n = self.carry_leaves
        first, rest = list(args[:n]), args[n:]
        first_sig = _signature(first)
        inner = self.inner

        def body(carry, _):
            out = inner(*carry, *rest)
            # prefer threading a structurally matching output (the
            # updated params of a train step, or the activation chain)
            candidates = [_leaves(out)]
            if isinstance(out, (tuple, list)):
                candidates += [list(out[i:i + n])
                               for i in range(len(out) - n + 1)]
            for cand in candidates:
                if first_sig is not None and _signature(cand) == first_sig:
                    return cand, []
            # no structural match: feed a vanishing function of the output
            # back into ONE element of the carry (through a one-row
            # dynamic-update-slice — negligible cost, but a true data
            # dependency, so the captured loop is not empty)
            leaves = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
            s = (sum(t.float().sum() for t in leaves) if leaves
                 else torch.zeros((), device=carry[0].device))
            tiny = (s * 1e-30).to(carry[0].dtype)
            c = carry[0]
            if c.dim() == 0:
                new = c + tiny
            else:
                row = c[0:1]
                first_elem = (torch.arange(row.numel(), dtype=torch.int32,
                                           device=c.device) == 0)
                row = torch.where(first_elem.reshape(row.shape), row + tiny,
                                  row)
                at = torch.zeros((), dtype=torch.int32, device=c.device)
                new = dynamic_update_slice(c, row, at, 0)
            # the scan op refuses an output that aliases the carry
            return [new, *(t.clone() for t in carry[1:])], []

        # traced (capture): one scan, which lowers to one while; run: the
        # trips from Python, each body once
        steps = torch.zeros(self.n_steps, dtype=torch.int32,
                            device=first[0].device)
        final, _ = scan(body, first, steps)
        return final[0] if n == 1 else tuple(final)


class LoopedSpmd(Looped, SpmdModule):
    """A multi-device workload looped: still one rank's program, on the
    same mesh, so each rank loops its own program with the collectives
    inside the ``scan``.  It returns the final carry, laid out as the
    arguments it threads."""

    def __init__(self, module: SpmdModule, n_steps: int):
        super().__init__(module, n_steps)
        self.mesh, self.in_specs = module.mesh, module.in_specs
        carried = module.in_specs[:self.carry_leaves]
        self.out_specs = carried[0] if self.carry_leaves == 1 else carried


def loopify(module: nn.Module, n_steps: int) -> Looped:
    """Wrap ``module`` in a K-step ``scan`` with a loop-carried
    dependency (the reference wraps its function in ``lax.scan``).

    The dependency is essential: a body with no carry is loop-invariant,
    and a compiler may hoist it, leaving an empty loop.  The first
    argument (the module's ``carry_leaves`` leading arguments, default 1)
    is threaded as carry — replaced by a structurally matching output
    (same leaves, shapes and dtypes) when one exists, otherwise kept
    alive by adding ``sum(outputs) * 1e-30`` into one element.  The other
    arguments are loop-invariant inputs.  A multi-device workload stays
    one (:class:`LoopedSpmd`)."""
    if isinstance(module, SpmdModule):
        return LoopedSpmd(module, n_steps)
    return Looped(module, n_steps)


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def correlate_workload(
    module: nn.Module,
    args: tuple,
    *,
    name: str = "workload",
    n_steps: int = 16,
    arch: str | None = None,
    iters: int = 3,
    fixture_dir: Any | None = None,
    op_profile_out: dict | None = None,
) -> CorrelationPoint:
    """Capture, simulate, and time one workload on its device; returns
    the point.

    ``arch=None`` detects the preset from the device kind (the card's
    name falls back to ``v5e``).  With ``fixture_dir`` set, the captured
    trace is also written to ``<fixture_dir>/<name>`` so the measurement
    can be replayed offline.  With ``op_profile_out`` (a dict) the
    device-time profile is reused for per-op correlation: the dict is
    filled with ``ops`` (per-instruction device durations from the SAME
    profile that produced the truth), ``engine_result``, ``clock_hz``,
    ``arch``, ``iters`` and ``module`` (and the executions' median
    ``idle_share`` on the device) — callers feed these straight into
    :func:`tpusim_torch.harness.correl_ops.correlate_ops` without
    profiling the workload a second time."""
    from tpusim_torch.timing.arch import detect_arch
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.tracer.capture import (
        _device_of, capture, measure_wall_time,
    )

    looped = loopify(module, n_steps)
    dev = _device_of(args)

    cap = capture(looped, *args, name=name)
    if fixture_dir is not None:
        from tpusim_torch.ir import CommandKind, TraceCommand
        from tpusim_torch.trace.format import save_trace

        save_trace(
            Path(fixture_dir) / name,
            modules={name: cap.hlo_text},
            commands=[TraceCommand(
                kind=CommandKind.KERNEL_LAUNCH, module=name,
            )],
            meta=cap.meta,
        )
    if arch is None:
        # named-preset route so a tuner overlay in $TPUSIM_TUNED_DIR applies
        arch = detect_arch(_device_kind(dev)).name
    cfg = load_config(arch=arch)
    res = Engine(cfg).run(cap.module)

    # ground truth = the device's own busy time per execution from the
    # profiler (the nvprof-Duration analogue); CUDA-event wall time is
    # the fallback, and it includes the host's dispatch gaps between the
    # kernels of an eager program
    real_source = "wall"
    t = None
    # TPUSIM_FORCE_DEVICE_TIMING=1 lets tests drive the device-timing
    # path off the card (with measure_device_time stubbed)
    if (dev.type == "cuda"
            or os.environ.get("TPUSIM_FORCE_DEVICE_TIMING") == "1"):
        try:
            from tpusim_torch.harness.correl_ops import measure_device_time

            t = measure_device_time(
                looped, *args, iters=iters,
                with_ops=op_profile_out is not None,
            )
            real_source = "device"
            if op_profile_out is not None and "ops" in t:
                op_profile_out.update(
                    ops=t["ops"], engine_result=res,
                    clock_hz=cfg.arch.clock_hz, arch=cfg.arch,
                    iters=iters, module=cap.module,
                    idle_share=t.get("idle_share"),
                )
        except Exception as e:
            print(
                f"correlate[{name}]: device timing failed "
                f"({type(e).__name__}: {e}); falling back to wall clock "
                f"(includes dispatch gaps)", file=sys.stderr,
            )
    if t is None:
        t = measure_wall_time(looped, *args, iters=iters)
    return CorrelationPoint(
        name=name,
        sim_seconds=res.seconds / n_steps,
        real_seconds=t["median_s"] / n_steps,
        sim_cycles=res.cycles / n_steps,
        flops=res.flops / n_steps,
        hbm_bytes=res.hbm_bytes / n_steps,
        real_source=real_source,
    )

"""Trace-replay driver.

Port of ``tpusim/sim/driver.py`` for memcpy and kernel-launch commands:
parse the command list, keep per-stream order with cross-stream overlap
under the kernel window, model memcpys, launch kernels into the timing
engine, and emit the same stats keys as the JAX package (the collective
counters stay 0).

Not ported yet: standalone collective commands (ROADMAP A2 — they raise
``NotImplementedError``), faults, the result cache, worker pools, the
compile store, validation, power and the observability layer.
"""

from __future__ import annotations

import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from tpusim_torch.ir import CommandKind, PodTrace
from tpusim_torch.sim.stats import EXIT_SENTINEL, StatsRegistry
from tpusim_torch.timing.arch import detect_arch
from tpusim_torch.timing.config import SimConfig, load_config
from tpusim_torch.timing.engine import COLLECTIVES_TODO, Engine, EngineResult
from tpusim_torch.trace.format import load_trace

__all__ = ["SimDriver", "SimReport", "simulate_trace"]


@dataclass
class KernelRecord:
    module: str
    device_id: int
    stream_id: int
    start_cycle: float
    end_cycle: float
    result: EngineResult


@dataclass
class SimReport:
    """Result of replaying one pod trace."""

    config_name: str
    num_devices: int
    device_cycles: dict[int, float] = field(default_factory=dict)
    kernels: list[KernelRecord] = field(default_factory=list)
    totals: EngineResult = field(default_factory=EngineResult)
    memcpy_cycles: float = 0.0
    collective_cmd_cycles: float = 0.0
    wall_seconds: float = 0.0       # host time spent simulating
    stats: StatsRegistry = field(default_factory=StatsRegistry)

    @property
    def cycles(self) -> float:
        return max(self.device_cycles.values(), default=0.0)

    @property
    def sim_rate_kops(self) -> float:
        """Simulated HLO ops per host-second, in K."""
        if self.wall_seconds <= 0:
            return 0.0
        return self.totals.op_count / self.wall_seconds / 1e3

    def silicon_slowdown(self, arch_clock_hz: float) -> float:
        """Host-seconds per simulated device-second."""
        sim_s = self.cycles / arch_clock_hz if arch_clock_hz > 0 else 0.0
        if sim_s <= 0:
            return 0.0
        return self.wall_seconds / sim_s

    def finalize(self, arch_clock_hz: float) -> None:
        # totals accumulates per-kernel counters; its wall-clock view is the
        # pod's critical path, needed for the derived utilization stats
        self.totals.cycles = self.cycles
        self.totals.seconds = self.cycles / arch_clock_hz
        s = self.stats
        s.set("num_devices", self.num_devices)
        s.set("sim_cycle", self.cycles)
        s.set("sim_elapsed_s", self.cycles / arch_clock_hz)
        s.set("kernel_launches", len(self.kernels))
        s.set("memcpy_cycles", self.memcpy_cycles)
        s.set("collective_cmd_cycles", self.collective_cmd_cycles)
        s.set("simulation_rate_kops", self.sim_rate_kops)
        s.set("silicon_slowdown", self.silicon_slowdown(arch_clock_hz))
        s.update(self.totals.stats_dict(), prefix="tot_")

    def print_report(self, out=None) -> None:
        out = out or sys.stdout
        self.stats.print_text(out)
        print(EXIT_SENTINEL, file=out)


class SimDriver:
    """Replays a :class:`PodTrace` under a :class:`SimConfig`."""

    def __init__(self, config: SimConfig):
        self.config = config
        self.arch = config.arch

    def run(self, pod: PodTrace) -> SimReport:
        t_start = time.perf_counter()
        cfg = self.config
        arch = self.arch

        n_devices = max(
            (int(pod.meta.get("num_devices", 0) or 0)),
            max((m.num_devices for m in pod.modules.values()), default=1),
            len(pod.devices) or 1,
        )
        engine = Engine(cfg)
        report = SimReport(config_name=arch.name, num_devices=n_devices)

        # kernel timing is per-module (SPMD: all devices run the same
        # program), so each module prices once
        module_results: dict[str, EngineResult] = {}

        def module_result(name: str) -> EngineResult:
            if name not in module_results:
                if name not in pod.modules:
                    raise KeyError(
                        f"command references unknown module {name!r}; "
                        f"trace has {sorted(pod.modules)}"
                    )
                module_results[name] = engine.run(pod.modules[name])
            return module_results[name]

        device_ids = sorted(pod.devices) or [0]
        # per-device resource timelines
        core_free = {d: 0.0 for d in device_ids}
        dma_free = {d: 0.0 for d in device_ids}
        ici_free = {d: 0.0 for d in device_ids}
        stream_free: dict[tuple[int, int], float] = defaultdict(float)

        # checkpoint/resume at kernel granularity
        resume_k = max(cfg.resume_kernel, 0)
        checkpoint_k = max(cfg.checkpoint_kernel, 0)
        window = max(cfg.kernel_window, 1)

        for dev_id in device_ids:
            dev = pod.devices.get(dev_id)
            if dev is None:
                continue
            kernel_index = 0
            # completion times of this device's kernel launches, in launch
            # order — the stream-window gate
            kernel_ends: list[float] = []
            for cmd in dev.commands:
                key = (dev_id, cmd.stream_id)
                ready = stream_free[key]
                if len(kernel_ends) >= window:
                    ready = max(ready, kernel_ends[-window])

                # kernel-granularity boundary "after kernel K completes":
                # the k-th kernel is in the first half iff k <= K; any
                # other command iff fewer than K kernels precede it
                is_kernel = cmd.kind == CommandKind.KERNEL_LAUNCH
                if is_kernel:
                    kernel_index += 1
                in_first_half = (
                    kernel_index <= resume_k if is_kernel
                    else kernel_index < resume_k
                )
                if cmd.kind == CommandKind.COLLECTIVE and cmd.collective:
                    raise NotImplementedError(COLLECTIVES_TODO)
                if resume_k and in_first_half:
                    continue  # fast-forward already-simulated work
                if checkpoint_k and (
                    kernel_index > checkpoint_k if is_kernel
                    else kernel_index >= checkpoint_k
                ):
                    report.stats.set("checkpoint_stop_kernel", checkpoint_k)
                    break

                if is_kernel:
                    res = module_result(cmd.module)
                    start = max(ready, core_free[dev_id])
                    end = start + res.cycles
                    core_free[dev_id] = end
                    stream_free[key] = end
                    kernel_ends.append(end)
                    report.kernels.append(KernelRecord(
                        cmd.module, dev_id, cmd.stream_id, start, end, res
                    ))
                    report.totals.merge_scaled(res, 1.0)

                elif cmd.kind in (CommandKind.MEMCPY_H2D, CommandKind.MEMCPY_D2H):
                    if cfg.perf_sim_memcpy and cmd.nbytes > 0:
                        secs = arch.host_latency + cmd.nbytes / arch.host_bandwidth
                        dur = arch.seconds_to_cycles(secs)
                    else:
                        dur = 0.0
                    start = max(ready, dma_free[dev_id])
                    end = start + dur
                    dma_free[dev_id] = end
                    stream_free[key] = end
                    report.memcpy_cycles += dur

                else:
                    # comm_init/destroy/group markers: logged no-ops
                    stream_free[key] = ready

            report.device_cycles[dev_id] = max(
                core_free[dev_id], dma_free[dev_id], ici_free[dev_id],
                max((v for (d, _), v in stream_free.items() if d == dev_id),
                    default=0.0),
            )

        # runaway detection: a corrupt trace or unresolved loop bound can
        # send the cycle count to absurdity — flag the biggest offenders
        if cfg.deadlock_detect and report.cycles > cfg.deadlock_cycles:
            report.stats.set("deadlock_suspected", 1)
            launches = Counter(k.module for k in report.kernels)
            worst = sorted(
                module_results.items(),
                key=lambda kv: -(
                    kv[1].cycles * max(launches.get(kv[0], 0), 1)
                ),
            )[:3]
            report.stats.set(
                "deadlock_suspects",
                ";".join(
                    f"{name}:x{max(launches.get(name, 0), 1)}:"
                    f"{r.cycles * max(launches.get(name, 0), 1):.3g}cy"
                    for name, r in worst
                ),
            )

        report.wall_seconds = time.perf_counter() - t_start
        report.finalize(arch.clock_hz)
        return report


def simulate_trace(
    trace_path: str | Path,
    config: SimConfig | None = None,
    arch: str | None = None,
    overlays: list[Any] | None = None,
    tuned: bool = True,
    lenient: bool = False,
) -> SimReport:
    """Load a trace dir, compose the config, replay.

    ``tuned=False`` skips the committed tuner overlay, as the golden cells
    do.  With neither ``arch`` nor ``config`` the arch defaults to the
    one the trace was captured on (v5e when the device kind is not a
    TPU)."""
    pod = load_trace(trace_path, lenient=lenient)
    if arch is None and config is None:
        kind = str(pod.meta.get("device_kind", ""))
        if kind:
            arch = detect_arch(kind).name
    cfg = load_config(config, arch=arch, overlays=overlays, tuned=tuned)
    return SimDriver(cfg).run(pod)

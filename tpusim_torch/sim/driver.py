"""Trace-replay driver.

Port of ``tpusim/sim/driver.py``: parse the command list, keep per-stream
order with cross-stream overlap under the kernel window, model memcpys,
launch kernels into the timing engine, price standalone collective
commands on the pod's ICI model with a ``(group, k)`` rendezvous across
the group's devices, and emit the same stats keys as the JAX package —
``dcn_*`` when the pod spans DCN slices, ``power_*``/``energy_*`` under
``power_enabled``.

Every engine prices through the backend ``pricing_backend`` requests
(None: auto-resolved); an explicit request, or an active durable compile
store (``compile_cache=``), stamps ``fastpath_*`` stats.

Degraded pods: a fault schedule (``faults=``) is bound to the pod's
topology once; kernels price under their chip's multipliers and
standalone collectives under the link view active at their issue cycle,
and the report carries the schedule's ``faults_*`` stats.  An engine-
result cache (``result_cache=``, ``cache_*`` stats) and a worker count
(``workers=``: the distinct launch classes priced over a process pool
up front, ``pool_*`` stats) leave every other stat unchanged; a cache
under a quota adds ``guard_*`` stats.  A cancel token (``cancel=``,
:mod:`tpusim_torch.guard.cancel`) is checked before every command and
before the pool forks, and rides into every engine.

``validate=`` (the ``--validate[=strict]`` flag) runs the static
pre-flight of :mod:`tpusim_torch.analysis` over the trace, the composed
config and the fault schedule first.

Not ported yet: the observability layer and its "faults" lane (ROADMAP
A10), the wall-clock and memory limits of ``simulate`` (A11).
"""

from __future__ import annotations

import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from tpusim_torch.dcn.topology import slice_topology_for
from tpusim_torch.ici.detailed import make_collective_model
from tpusim_torch.ici.topology import Topology, torus_for
from tpusim_torch.ir import CommandKind, PodTrace, TraceCommand
from tpusim_torch.perf.cache import CachedEngine, as_result_cache
from tpusim_torch.perf.pool import map_ordered, pool_context, resolve_workers
from tpusim_torch.power.model import PowerModel, PowerReport
from tpusim_torch.sim.stats import EXIT_SENTINEL, StatsRegistry
from tpusim_torch.timing.arch import detect_arch
from tpusim_torch.timing.config import SimConfig, load_config
from tpusim_torch.timing.engine import Engine, EngineResult
from tpusim_torch.trace.format import load_trace

__all__ = ["SimDriver", "SimReport", "simulate_trace"]


def _price_segment_worker(item):
    """:mod:`tpusim_torch.perf.pool` worker: price one ``(module, scales)``
    launch class — the unit of the driver's segment-parallel replay.
    Pure: same engine math as the serial path, so the returned counters
    are bit-identical to an in-process run."""
    name, scales = item
    # tokens are process-local: a worker prices its segment to completion
    cfg, topo, modules, cache, backend = pool_context()
    return CachedEngine(
        cfg, topology=topo, clock_scale=scales[0], hbm_scale=scales[1],
        result_cache=cache, pricing_backend=backend,
    ).run(modules[name])


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
    power: PowerReport | None = None  # when power_enabled

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

    def __init__(
        self,
        config: SimConfig,
        topology: Topology | None = None,
        faults=None,
        result_cache=None,
        workers: int | None = None,
        pricing_backend: str | None = None,
        compile_cache=None,
        cancel=None,
    ):
        self.config = config
        self.arch = config.arch
        # cooperative cancellation (tpusim_torch.guard.CancelToken | None):
        # checked at command grain here and inside every engine walk
        self.cancel = cancel
        # None = the default torus for the pod's device count
        self.topology = topology
        # fault schedule (FaultSchedule | path | JSON text | dict); None =
        # healthy pod, zero added work and zero added stats keys
        self.faults = faults
        # engine-result cache (ResultCache | dir path | True for the
        # default disk dir) and the worker count of segment-parallel
        # pricing (None = $TPUSIM_WORKERS, else serial).  Both default
        # off: the healthy serial path is unchanged, key-identical.
        self.result_cache = as_result_cache(result_cache)
        self.workers = workers
        # tpusim_torch.fastpath: pricing-backend request (None = auto; an
        # EXPLICIT request also stamps the fastpath_* stats block, so
        # default runs stay key-identical)
        self.pricing_backend = pricing_backend
        # the durable compiled-module tier (a CompileStore, a dir path, or
        # True for the default dir).  Activation is process-wide —
        # compiled_for consults it before any compile, the pricing walks
        # publish after — so the driver only coerces it and stamps its
        # stats.  None leaves whatever is already active untouched.
        from tpusim_torch.fastpath.store import as_compile_store

        self.compile_store = as_compile_store(compile_cache)

    def run(self, pod: PodTrace) -> SimReport:
        t_start = time.perf_counter()
        cfg = self.config
        arch = self.arch
        cancel = self.cancel

        n_devices = max(
            (int(pod.meta.get("num_devices", 0) or 0)),
            max((m.num_devices for m in pod.modules.values()), default=1),
            len(pod.devices) or 1,
        )
        base_topo = self.topology or torus_for(n_devices, arch.name)
        # fault binding: resolve the schedule against this pod's topology
        # once (validates coords/adjacency), then attach the cycle-0 view.
        # Windowed schedules re-resolve the view at each command's issue
        # cycle — kernels pick their chip multipliers and standalone
        # collectives their link view at command grain (a fault window
        # cannot split a single kernel: the whole launch prices under the
        # view active when it issues).
        fault_state = None
        fault_view = None
        if self.faults is not None:
            from tpusim_torch.faults import FaultSchedule, load_fault_schedule

            sched = (
                self.faults if isinstance(self.faults, FaultSchedule)
                else load_fault_schedule(self.faults)
            )
            fault_state = sched.bind(base_topo)
            fault_view = fault_state.view_at(0.0)
        topo = (
            base_topo.with_faults(fault_view) if fault_view is not None
            else base_topo
        )
        coll = make_collective_model(topo, arch.ici)

        # one engine per (clock_scale, hbm_scale) launch class: degraded
        # chips (straggler clock / HBM throttle) run their own; with no
        # result cache a CachedEngine is an exact Engine
        engines: dict[tuple[float, float], Engine] = {}

        def engine_for(scales: tuple[float, float]) -> Engine:
            e = engines.get(scales)
            if e is None:
                e = engines[scales] = CachedEngine(
                    cfg, topology=topo, clock_scale=scales[0],
                    hbm_scale=scales[1], result_cache=self.result_cache,
                    pricing_backend=self.pricing_backend, cancel=cancel,
                )
            return e

        # windowed link faults: standalone collectives are priced with the
        # view active at their issue cycle (one model per distinct view)
        coll_models = {
            (fault_view.signature if fault_view is not None else None): coll
        }

        def coll_for(cycle: float):
            if fault_state is None or not fault_state.windowed:
                return coll
            v = fault_state.view_at(cycle)
            m = coll_models.get(v.signature)
            if m is None:
                m = coll_models[v.signature] = make_collective_model(
                    base_topo.with_faults(v), arch.ici
                )
            return m

        report = SimReport(config_name=arch.name, num_devices=n_devices)

        # kernel timing is per-module (SPMD: all devices run the same
        # program), so each (module, chip multipliers) launch class prices
        # once; degraded chips form their own classes
        module_results: dict[tuple[str, tuple[float, float]], EngineResult] \
            = {}

        def module_result(
            name: str, scales: tuple[float, float] = (1.0, 1.0)
        ) -> EngineResult:
            key = (name, scales)
            if key not in module_results:
                if name not in pod.modules:
                    raise KeyError(
                        f"command references unknown module {name!r}; "
                        f"trace has {sorted(pod.modules)}"
                    )
                module_results[key] = engine_for(scales).run(
                    pod.modules[name]
                )
            return module_results[key]

        # Cross-device collective rendezvous: the k-th standalone collective
        # *over a given replica group* must align across that group's
        # members (NCCL call-order matching).  Keyed by (group, index) so
        # disjoint groups never synchronize with each other.
        coll_ready: dict[tuple, list[float]] = defaultdict(list)

        device_ids = sorted(pod.devices) or [0]

        def _group_of(cmd: TraceCommand, d: int) -> tuple:
            groups = cmd.collective.replica_groups or []
            mine = next((tuple(g) for g in groups if d in g), None)
            # no groups recorded: all devices participate
            return mine if mine is not None else tuple(device_ids)
        # per-device resource timelines
        core_free = {d: 0.0 for d in device_ids}
        dma_free = {d: 0.0 for d in device_ids}
        ici_free = {d: 0.0 for d in device_ids}
        stream_free: dict[tuple[int, int], float] = defaultdict(float)

        # checkpoint/resume at kernel granularity
        resume_k = max(cfg.resume_kernel, 0)
        checkpoint_k = max(cfg.checkpoint_kernel, 0)
        window = max(cfg.kernel_window, 1)

        # --- segment-parallel pricing -----------------------------------
        # The replay decomposes into per-(module, chip-multiplier) launch
        # classes whose pricing is pure and independent.  With workers,
        # the distinct classes price CONCURRENTLY up front; the stream
        # walk below stays serial and consumes the pre-priced results, so
        # every scalar accumulates in the exact serial order (bit-identical
        # reports).  The parallel path disengages under windowed faults
        # (multipliers depend on the issue cycle) and checkpoint/resume
        # (classes past the barrier must not price).
        workers = resolve_workers(self.workers)
        pool_segments = 0
        if (
            workers > 1
            and not (fault_state is not None and fault_state.windowed)
            and not resume_k and not checkpoint_k
        ):
            classes: list[tuple[str, tuple[float, float]]] = []
            seen_classes: set[tuple[str, tuple[float, float]]] = set()
            for dev_id in device_ids:
                dev = pod.devices.get(dev_id)
                if dev is None:
                    continue
                scales = (
                    fault_view.chip_scales(dev_id)
                    if fault_view is not None else (1.0, 1.0)
                )
                for cmd in dev.commands:
                    if (
                        cmd.kind == CommandKind.KERNEL_LAUNCH
                        and cmd.module in pod.modules
                        and (cmd.module, scales) not in seen_classes
                    ):
                        seen_classes.add((cmd.module, scales))
                        classes.append((cmd.module, scales))
            # classes the parent's cache already holds skip the pool
            # entirely (a warm-cache run forks nothing and runs no engine)
            remaining: list[tuple[str, tuple[float, float]]] = []
            for mkey in classes if len(classes) > 1 else []:
                res = None
                if self.result_cache is not None:
                    ck = self.result_cache.key_for(
                        pod.modules[mkey[0]], cfg, mkey[1], topo
                    )
                    if ck is not None:
                        res = self.result_cache.get(ck)
                if res is not None:
                    module_results[mkey] = res
                else:
                    remaining.append(mkey)
            if len(remaining) > 1:
                if cancel is not None:
                    # last check before forking; the parent checks again
                    # at every command below
                    cancel.check()
                priced = map_ordered(
                    _price_segment_worker, remaining, workers=workers,
                    context=(cfg, topo, pod.modules, self.result_cache,
                             self.pricing_backend),
                )
                pool_segments = len(remaining)
                for mkey, res in zip(remaining, priced):
                    module_results[mkey] = res
                    if self.result_cache is not None:
                        ck = self.result_cache.key_for(
                            pod.modules[mkey[0]], cfg, mkey[1], topo
                        )
                        if ck is not None:
                            self.result_cache.put(ck, res)

        for dev_id in device_ids:
            dev = pod.devices.get(dev_id)
            if dev is None:
                continue
            dev_scales = (
                fault_view.chip_scales(dev_id)
                if fault_view is not None else (1.0, 1.0)
            )

            def scales_at(cycle: float) -> tuple[float, float]:
                """Chip multipliers for this device at a kernel's issue
                cycle — windowed stragglers/throttles hit only the
                launches their window overlaps."""
                if fault_state is None or not fault_state.windowed:
                    return dev_scales
                return fault_state.view_at(cycle).chip_scales(dev_id)

            coll_counts: Counter = Counter()  # per-group issue index
            kernel_index = 0
            # completion times of this device's kernel launches, in launch
            # order — the stream-window gate
            kernel_ends: list[float] = []
            for cmd in dev.commands:
                # a cancel cannot split a command: the whole launch
                # prices or the walk raises before it starts
                if cancel is not None:
                    cancel.check()
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
                if resume_k and in_first_half:
                    if cmd.kind == CommandKind.COLLECTIVE and cmd.collective:
                        # keep rendezvous indices aligned
                        coll_counts[_group_of(cmd, dev_id)] += 1
                    continue  # fast-forward already-simulated work
                if checkpoint_k and (
                    kernel_index > checkpoint_k if is_kernel
                    else kernel_index >= checkpoint_k
                ):
                    report.stats.set("checkpoint_stop_kernel", checkpoint_k)
                    break

                if is_kernel:
                    res = module_result(
                        cmd.module,
                        scales_at(max(ready, core_free[dev_id])),
                    )
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

                elif cmd.kind == CommandKind.COLLECTIVE and cmd.collective:
                    secs = coll_for(max(ready, ici_free[dev_id])).seconds(
                        cmd.collective, float(cmd.nbytes)
                    )
                    dur = arch.seconds_to_cycles(secs)
                    start = max(ready, ici_free[dev_id])
                    # rendezvous with the group's k-th collective: all
                    # participants start together at the latest arrival
                    grp = _group_of(cmd, dev_id)
                    k = coll_counts[grp]
                    coll_counts[grp] += 1
                    peers = coll_ready[(grp, k)]
                    if peers:
                        start = max(start, max(peers))
                    coll_ready[(grp, k)].append(start)
                    end = start + dur
                    ici_free[dev_id] = end
                    stream_free[key] = end
                    report.collective_cmd_cycles += dur
                    report.totals.collective_count += 1
                    report.totals.ici_bytes += cmd.nbytes
                    report.totals.collective_cycles += dur

                else:
                    # comm_init/destroy/group markers: logged no-ops
                    stream_free[key] = ready

            report.device_cycles[dev_id] = max(
                core_free[dev_id], dma_free[dev_id], ici_free[dev_id],
                max((v for (d, _), v in stream_free.items() if d == dev_id),
                    default=0.0),
            )

        # failure detection: devices that share a replica group must issue
        # the same number of collectives over that group — a ragged count
        # means a device would hang waiting at a rendezvous (the NCCL-hang
        # analog).  Disjoint groups and non-participating devices are fine.
        if coll_ready:
            per_dev_groups: dict[int, Counter] = {}
            for d in device_ids:
                dev = pod.devices.get(d)
                if dev is None:
                    continue
                counts: Counter = Counter()
                for cmd in dev.commands:
                    if cmd.kind != CommandKind.COLLECTIVE or not cmd.collective:
                        continue
                    counts[_group_of(cmd, d)] += 1
                per_dev_groups[d] = counts
            ragged: list[str] = []
            for d, counts in per_dev_groups.items():
                for grp, n in counts.items():
                    for peer in grp:
                        if peer == d or peer not in per_dev_groups:
                            continue
                        if per_dev_groups[peer].get(grp, 0) != n:
                            ragged.append(
                                f"dev{d}:{n}!=dev{peer}:"
                                f"{per_dev_groups[peer].get(grp, 0)}@{grp}"
                            )
            if ragged:
                report.stats.set("collective_rendezvous_mismatch", 1)
                report.stats.set(
                    "collective_counts_per_device", ";".join(sorted(set(ragged)))
                )

        # runaway detection: a corrupt trace or unresolved loop bound can
        # send the cycle count to absurdity — flag the biggest offenders
        if cfg.deadlock_detect and report.cycles > cfg.deadlock_cycles:
            report.stats.set("deadlock_suspected", 1)
            launches = Counter(k.module for k in report.kernels)
            worst = sorted(
                module_results.items(),
                key=lambda kv: -(
                    kv[1].cycles * max(launches.get(kv[0][0], 0), 1)
                ),
            )[:3]
            report.stats.set(
                "deadlock_suspects",
                ";".join(
                    f"{name}:x{max(launches.get(name, 0), 1)}:"
                    f"{r.cycles * max(launches.get(name, 0), 1):.3g}cy"
                    for (name, _), r in worst
                ),
            )

        report.wall_seconds = time.perf_counter() - t_start
        report.finalize(arch.clock_hz)
        # perf-layer accounting rides the report ONLY when the feature is
        # active: serial/uncached runs stay key-identical, and byte-
        # identity comparisons strip these keys
        if self.result_cache is not None:
            report.stats.update(
                self.result_cache.stats_dict(), prefix="cache_"
            )
            if (
                self.result_cache.quota_bytes is not None
                or self.result_cache.quota_entries is not None
            ):
                # guard_* keys ride the report ONLY when a store quota is
                # governing (un-governed runs stay key-identical)
                report.stats.update(
                    self.result_cache.guard_stats_dict(), prefix="guard_"
                )
        if pool_segments:
            report.stats.update(
                {"workers": workers, "parallel_segments": pool_segments},
                prefix="pool_",
            )
        from tpusim_torch.fastpath.store import get_compile_store

        if self.pricing_backend is not None or \
                get_compile_store() is not None:
            # fastpath accounting rides the report ONLY when a backend was
            # explicitly requested or a durable compile store is active
            # (default runs stay key-identical).  The stamped name is what
            # actually priced: under op-granularity checkpoint/resume the
            # fastpath disengages and every run took the serial walk.
            from tpusim_torch.fastpath.price import resolve_backend
            from tpusim_torch.perf.cache import compiled_cache_stats

            resolved = resolve_backend(self.pricing_backend)
            if cfg.resume_op or cfg.checkpoint_op:
                resolved = "serial"
            report.stats.set("fastpath_backend", resolved)
            report.stats.update(compiled_cache_stats(), prefix="fastpath_")
        if fault_state is not None:
            # faults_* keys ride the report ONLY when a schedule is active.
            # Counts describe the whole schedule (windowed faults
            # included), not just the cycle-0 snapshot.
            report.stats.update(fault_state.full_view().stats_dict())
        slice_topo = slice_topology_for(topo.num_chips, arch.ici)
        if slice_topo is not None and slice_topo.num_slices > 1:
            # dcn_* keys ride the report ONLY when a DCN fabric is
            # configured AND this pod actually spans slices, so
            # single-slice and fabric-less runs stay key-identical
            report.stats.update({
                "dcn_slices": slice_topo.num_slices,
                "dcn_chips_per_slice": slice_topo.chips_per_slice,
                "dcn_nics_per_slice": slice_topo.nics_per_slice,
                "dcn_slice_bandwidth": slice_topo.slice_bandwidth(),
            })
        if cfg.power_enabled:
            preport = PowerModel(
                arch.name, dvfs_scale=cfg.dvfs_scale
            ).report(report.totals)
            report.stats.update(preport.stats_dict(), prefix="")
            report.power = preport
        return report


def simulate_trace(
    trace_path: str | Path,
    config: SimConfig | None = None,
    arch: str | None = None,
    overlays: list[Any] | None = None,
    tuned: bool = True,
    faults=None,
    topology: Topology | None = None,
    lenient: bool = False,
    validate: str | bool | None = None,
    result_cache=None,
    workers: int | None = None,
    pricing_backend: str | None = None,
    compile_cache=None,
) -> SimReport:
    """Load a trace dir, compose the config, replay.

    ``tuned=False`` skips the committed tuner overlay, as the golden cells
    do.  With neither ``arch`` nor ``config`` the arch defaults to the
    one the trace was captured on (v5e when the device kind is not a
    TPU).  ``faults`` is a fault schedule (FaultSchedule / path / JSON
    text / dict — the ``--faults`` flag) bound to ``topology`` (default:
    the pod's torus).  ``result_cache`` (the ``--result-cache[=DIR]``
    flag: a ResultCache, a directory, or True for the default dir)
    memoizes engine results across runs; ``workers`` (``--workers`` /
    ``$TPUSIM_WORKERS``) fans module pricing over a process pool — both
    give the serial path's stats.  ``pricing_backend`` (the
    ``--pricing-backend`` flag / ``$TPUSIM_PRICING_BACKEND``) pins the
    pricing backend; all backends give the same stats.  ``compile_cache``
    (the ``--compile-cache[=DIR]`` flag) activates the durable compiled-
    module tier before the trace loads, so the parse defers and a warm
    store prices with zero IR built.  ``validate`` opts into the static
    pre-flight (the ``--validate[=strict]`` flag): the trace, the config
    as composed here (the passed ``config`` and ``topology`` are what
    replays, so they are what is analyzed) and the fault schedule run
    through :mod:`tpusim_torch.analysis` first, and error-level
    diagnostics (warnings too under ``"strict"``) raise
    :class:`tpusim_torch.analysis.ValidationError` instead of pricing."""
    # activated BEFORE the load: load_trace defers the parse exactly when
    # the compiled tier may serve it (the coerced instance rides into the
    # driver, so its counters are not split across two instances)
    from tpusim_torch.fastpath.store import as_compile_store

    compile_cache = as_compile_store(compile_cache)
    if validate:
        from tpusim_torch.analysis import (
            Severity, ValidationError, analyze_trace_dir,
        )

        strict = validate == "strict"
        # `lenient` decides whether salvage damage is fatal (strict
        # parse) or a warning
        diags = analyze_trace_dir(
            trace_path, arch=arch, overlays=overlays, faults=faults,
            tuned=tuned, config=config, topology=topology, lenient=lenient,
        )
        if diags.has_errors or (
            strict and diags.count(Severity.WARNING) > 0
        ):
            raise ValidationError(diags, strict=strict)
    pod = load_trace(trace_path, lenient=lenient)
    if arch is None and config is None:
        kind = str(pod.meta.get("device_kind", ""))
        if kind:
            arch = detect_arch(kind).name
    cfg = load_config(config, arch=arch, overlays=overlays, tuned=tuned)
    return SimDriver(
        cfg, topology=topology, faults=faults, result_cache=result_cache,
        workers=workers, pricing_backend=pricing_backend,
        compile_cache=compile_cache,
    ).run(pod)

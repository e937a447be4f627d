"""The fleet digital-twin executor.

Composes the repo's existing robustness pieces into one capacity-
planning simulation:

* **pricing** — every distinct degradation state (the set of faults
  active in one window) prices ONCE through the cached engine via the
  campaign executor's own ``_price`` (same config composition,
  same power join), so a 64-pod fleet with a handful of distinct states
  runs a handful of engine walks;
* **fault streams** — campaign-style seeded sampling
  (:mod:`tpusim_torch.fleet.traffic`), windowed in fleet seconds; a window's
  state re-prices at its activation boundary, and partition detection is
  the campaign executor's own BFS;
* **admission** — each simulated pod runs the exact policies the
  reference's serve daemon implements: a bounded FIFO wait queue past
  ``max_inflight`` in-flight steps (shed at ``queue_depth``, the 429),
  a per-request deadline with guard's cooperative-cancel semantics (a request that
  cannot finish inside its budget occupies the server only UNTIL the
  deadline, then 504s — the worker survives), and pod crashes healed
  after ``restart_backoff_s`` (supervisor restart backoff) that kill
  whatever was queued or in flight;
* **elastic recovery** — on pod loss the twin re-ranks the survivors
  with the advise transforms (:func:`~tpusim_torch.advise.transform.
  scaled_module` / :func:`~tpusim_torch.advise.transform.build_cell_pod`),
  prices the re-shard migration over DCN, and reports time-to-recover.

Determinism contract: the report document is a pure function of the
seed, the spec, and the priced rows — fixed seed ⇒ byte-identical doc.
Crash-safety:
every priced state and recovery row journals through
:class:`tpusim_torch.campaign.journal.Journal` before the simulation walks,
so ``--resume`` re-prices ZERO journaled intervals (the event walk
itself is pure arithmetic and replays identically).

Port of ``tpusim/fleet/runner.py``.  ``scenario_batch="cuda"`` warms
each pod's pending states through
:func:`~tpusim_torch.fastpath.batch.warm_states` with its row scans on
the card; unlike a host backend's warm, whose failure leaves the state
loop to price per state, any error of that warm propagates, so a kernel
that fails to build or launch is never hidden.
"""

from __future__ import annotations

import heapq
import json
import os
import time
from bisect import bisect_left, bisect_right
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.campaign.journal import Journal
# the campaign executor's pricing + partition primitives are reused
# verbatim: the fleet twin must price a degraded window EXACTLY as a
# campaign scenario would, or the two layers' answers drift apart
from tpusim_torch.campaign.runner import (
    _dcn_lost_slices, _disconnected, _pod_devices, _price,
)
from tpusim_torch.fleet.report import build_report
from tpusim_torch.fleet.spec import (
    FleetSpec,
    Policies,
    load_fleet_spec,
    spec_hash,
)
from tpusim_torch.fleet.traffic import sample_arrivals, sample_pod_stream

__all__ = [
    "FleetResult",
    "FleetStats",
    "PodState",
    "run_fleet",
    "simulate_cell",
]


@dataclass
class FleetStats:
    """Executor accounting — the ``fleet_*`` stats namespace
    (registered in the reference's stats-key audit).  Ride reports and
    ``/metrics`` only when a fleet twin actually ran — the healthy
    simulate path never stamps them.  Request/loss totals cover the
    CURVE cells (the spec fleet at every load point); frontier search
    cells count only in ``cells``."""

    pods: int = 0
    states_priced: int = 0
    states_resumed: int = 0
    states_partitioned: int = 0
    recoveries_resumed: int = 0
    pod_losses: int = 0
    cells: int = 0
    requests: int = 0
    served: int = 0
    shed: int = 0
    deadline: int = 0
    partition: int = 0
    restart: int = 0

    def stats_dict(self) -> dict[str, float]:
        return {
            "fleet_pods_total": self.pods,
            "fleet_states_priced": self.states_priced,
            "fleet_states_resumed": self.states_resumed,
            "fleet_states_partitioned": self.states_partitioned,
            "fleet_recoveries_resumed": self.recoveries_resumed,
            "fleet_pod_losses_total": self.pod_losses,
            "fleet_cells_total": self.cells,
            "fleet_requests_total": self.requests,
            "fleet_served_total": self.served,
            "fleet_lost_shed_total": self.shed,
            "fleet_lost_deadline_total": self.deadline,
            "fleet_lost_partition_total": self.partition,
            "fleet_lost_restart_total": self.restart,
        }


@dataclass
class FleetResult:
    """One fleet run's report document + executor accounting."""

    doc: dict
    stats: FleetStats
    out_dir: Path | None = None
    report_path: Path | None = None
    wall_seconds: float = 0.0
    #: scenario-batched pricing accounting
    #: (:class:`tpusim_torch.fastpath.batch.BatchStats`) when the warm phase
    #: ran; None when batching was disabled.  Report/journal bytes are
    #: the per-state walk's either way — the batch only publishes
    #: cache entries the state replays then hit.
    batch_stats: object | None = None


# ---------------------------------------------------------------------------
# Degradation timelines
# ---------------------------------------------------------------------------


def state_signature(fault_docs: list[dict]) -> str:
    """Canonical identity of one degradation state: the sorted JSON of
    its active (window-stripped) fault records.  Identical states across
    pods and windows price once."""
    return json.dumps(
        sorted(
            fault_docs,
            key=lambda d: json.dumps(d, sort_keys=True),
        ),
        sort_keys=True, separators=(",", ":"),
    )


def build_intervals(
    stream: dict, horizon_s: float,
) -> list[tuple[float, float, str, list[dict]]]:
    """One pod's piecewise-constant degradation timeline:
    ``[(start_s, end_s, signature, active_fault_docs)]`` covering
    ``[0, horizon_s)``.  Boundaries are the sampled fault windows'
    edges; the healthy state's signature is ``"[]"``."""
    recs = stream["faults"]
    boundaries = {0.0, horizon_s}
    for r in recs:
        if r["start_s"] < horizon_s:
            boundaries.add(max(r["start_s"], 0.0))
            boundaries.add(min(r["end_s"], horizon_s))
    cuts = sorted(boundaries)
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        if hi <= lo:
            continue
        active = [
            r["fault"] for r in recs
            if r["start_s"] <= lo < r["end_s"]
        ]
        out.append((lo, hi, state_signature(active), active))
    return out


@dataclass
class PodState:
    """One simulated pod's inputs to the event walk: its degradation
    timeline (rows joined from the priced states) and its crash
    windows."""

    #: [(start_s, end_s, priced_row)] covering [0, horizon)
    intervals: list[tuple[float, float, dict]]
    #: [(death_s, back_s)] sorted, non-overlapping
    deaths: list[tuple[float, float]]
    _starts: list[float] = field(default_factory=list, repr=False)
    _death_starts: list[float] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self._starts = [iv[0] for iv in self.intervals]
        self._death_starts = [d[0] for d in self.deaths]

    def row_at(self, t: float) -> dict:
        i = bisect_right(self._starts, t) - 1
        return self.intervals[max(i, 0)][2]

    def alive(self, t: float) -> bool:
        i = bisect_right(self._death_starts, t) - 1
        return not (i >= 0 and t < self.deaths[i][1])

    def death_in(self, lo: float, hi: float) -> bool:
        """Is there a crash instant d strictly inside ``(lo, hi)``?"""
        return bisect_left(self._death_starts, hi) \
            > bisect_right(self._death_starts, lo)

    def alive_seconds(self, horizon_s: float) -> float:
        down = sum(
            max(min(end, horizon_s) - max(d, 0.0), 0.0)
            for d, end in self.deaths
        )
        return max(horizon_s - down, 0.0)


def _deaths_for(stream: dict, restart_s: float, horizon_s: float) \
        -> list[tuple[float, float]]:
    return [
        (d, min(d + restart_s, horizon_s) if restart_s > 0 else d)
        for d in sorted(stream["deaths"])
        if d < horizon_s
    ]


# ---------------------------------------------------------------------------
# The event walk (pure arithmetic — no pricing, no rng)
# ---------------------------------------------------------------------------


def simulate_cell(
    arrivals: list[tuple[float, int]],
    pod_states: list[PodState],
    policies: Policies,
    horizon_s: float,
    healthy_step_s: float,
    mix_steps: list[int],
) -> dict:
    """Walk one cell (one offered stream over one fleet shape) through
    the admission policies.  Pure and deterministic: counts, latencies,
    energy — no rng, no pricing, no wall clock.

    Attribution taxonomy (each dispatched request lands in exactly one
    bucket):

    * ``served`` — completed inside its deadline;
    * ``shed`` — the target pod's wait queue was at ``queue_depth``
      (the daemon's 429/memory-shed refusal class);
    * ``deadline`` — could not start, or could not finish, inside
      ``deadline_s`` (guard's queued-504 and cooperative-cancel 504;
      a cancelled request occupies the server only until its deadline);
    * ``partition`` — dispatched into a window whose faults partition
      the pod's replaying chips (the campaign outcome, served live);
    * ``restart`` — killed by a pod crash while queued or in flight,
      or arrived while every pod was down (supervisor restart window).
    """
    n = len(pod_states)
    c = policies.max_inflight
    counts = {"shed": 0, "deadline": 0, "partition": 0, "restart": 0}
    latencies: list[float] = []
    energy_j = 0.0
    energy_known = True
    served_steps = 0

    # dispatch: round-robin over pods alive at arrival (content-hash
    # affinity would pin classes to pods; round-robin keeps the walk
    # independent of the mix draw order, which is what lets the
    # frontier reuse one arrival stream across fleet shapes)
    per_pod: list[list[tuple[float, int]]] = [[] for _ in range(n)]
    rr = 0
    for t, cls in arrivals:
        target = None
        for k in range(n):
            p = (rr + k) % n
            if pod_states[p].alive(t):
                target = p
                break
        rr += 1
        if target is None:
            counts["restart"] += 1
            continue
        per_pod[target].append((t, cls))

    for p, arr in enumerate(per_pod):
        state = pod_states[p]
        servers = [0.0] * c
        heapq.heapify(servers)
        pending: deque[float] = deque()  # start times not yet reached
        deaths = state.deaths
        di = 0
        for t, cls in arr:
            while di < len(deaths) and deaths[di][0] <= t:
                # the crash reset: every server (and the wait line)
                # comes back empty when the pod returns
                end = deaths[di][1]
                servers = [end] * c
                heapq.heapify(servers)
                pending.clear()
                di += 1
            row = state.row_at(t)
            if row.get("partitioned"):
                counts["partition"] += 1
                continue
            while pending and pending[0] <= t:
                pending.popleft()
            free = heapq.heappop(servers)
            start = max(t, free)
            if start > t and len(pending) >= policies.queue_depth:
                # no free lane and the wait line is full — the
                # daemon's bounded-queue refusal (shed)
                heapq.heappush(servers, free)
                counts["shed"] += 1
                continue
            if start - t >= policies.deadline_s:
                # queued past the deadline: the 504 without ever
                # holding a server (admission's waiter-abandon rule) —
                # unless the pod crashes FIRST, which kills the whole
                # wait line (restart loss, per the taxonomy)
                heapq.heappush(servers, free)
                if state.death_in(t, t + policies.deadline_s):
                    counts["restart"] += 1
                else:
                    counts["deadline"] += 1
                continue
            srow = state.row_at(start)
            if srow.get("partitioned"):
                heapq.heappush(servers, free)
                counts["partition"] += 1
                continue
            steps = mix_steps[cls]
            service = float(srow["step_s"]) * steps
            budget_left = policies.deadline_s - (start - t)
            if service > budget_left:
                # guard's cooperative cancel: the server is busy only
                # until the deadline instant, then freed warm
                busy_until = start + budget_left
                outcome = "deadline"
            else:
                busy_until = start + service
                outcome = "served"
            if state.death_in(t, busy_until):
                # the pod crashed under it (queued or in flight)
                outcome = "restart"
            heapq.heappush(servers, busy_until)
            if start > t:
                pending.append(start)
            if outcome == "served":
                latencies.append(busy_until - t)
                served_steps += steps
                e = srow.get("energy_j")
                if e is None:
                    energy_known = False
                else:
                    energy_j += float(e) * steps
            else:
                counts[outcome] += 1

    requests = len(arrivals)
    served = len(latencies)
    capacity_s = sum(
        s.alive_seconds(horizon_s) for s in pod_states
    ) * c
    mfu = (
        served_steps * healthy_step_s / capacity_s
        if capacity_s > 0 else 0.0
    )
    return {
        "requests": requests,
        "served": served,
        "losses": dict(sorted(counts.items())),
        "latencies_s": latencies,
        "served_steps": served_steps,
        "mfu": mfu,
        "energy_j": energy_j if (energy_known and served) else None,
    }


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def _state_partitions(
    topo, view, replay_chips: int, dcn=None,
) -> bool:
    """Fleet window partition test: dead links disconnecting the
    replaying chips, or — with a configured fabric — a whole
    participating TPU slice lost (``slice_down`` / every DCN NIC dead).
    The event walk attributes requests landing in such a window to the
    ``partition`` loss bucket."""
    if _disconnected(topo, view, replay_chips):
        return True
    if dcn is not None:
        lost, _s = _dcn_lost_slices(
            view, dcn, topo.num_chips, replay_chips,
        )
        if lost:
            return True
    return False


def _price_state(
    sig: str, fault_docs: list[dict], pod, cfg, topo, cache, workers,
    healthy: dict | None, replay_chips: int, check_partition: bool,
    dcn=None,
) -> dict:
    """Price one degradation state (or detect its partition).  The row
    is what the event walk consumes: step seconds + energy, or a
    partitioned marker."""
    from tpusim_torch.faults import TopologyPartitionedError, load_fault_schedule

    if fault_docs:
        sched = load_fault_schedule({"faults": fault_docs})
        if check_partition and _state_partitions(
            topo, sched.bind(topo).view_at(0.0), replay_chips, dcn,
        ):
            return {"partitioned": True, "step_s": None,
                    "energy_j": None, "inflation": None}
    else:
        sched = None
    try:
        cycles, step_s, watts, energy = _price(
            pod, cfg, topo, sched, cache, workers,
        )
    except TopologyPartitionedError:
        return {"partitioned": True, "step_s": None,
                "energy_j": None, "inflation": None}
    row = {
        "partitioned": False,
        "cycles": cycles,
        "step_s": step_s,
        "watts": watts,
        "energy_j": energy,
        "inflation": (
            step_s / healthy["step_s"]
            if healthy is not None and healthy["step_s"] > 0 else None
        ),
    }
    return row


def _recovery_rows(
    spec: FleetSpec, pod, cfg, chips: int, cache, workers,
    deaths_by_pod, completed: dict[int, dict], journal, cancel,
    stats: FleetStats, progress,
) -> list[dict]:
    """Elastic-recovery pricing, one row per pod-loss event: re-rank
    the survivors with the advise transforms, price the re-shard
    migration over DCN — through the modeled fabric's per-slice
    injection bandwidth when the spec configures one, else the flat
    ``recovery.dcn_gbps`` constant — and report time-to-recover."""
    events = sorted(
        (d, p) for p, ds in enumerate(deaths_by_pod) for d, _end in ds
    )
    if not events:
        return []
    from tpusim_torch.advise.transform import (
        build_cell_pod, build_profile, scaled_module,
    )
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.sim.driver import SimDriver

    fabric = None
    if spec.dcn is not None:
        from tpusim_torch.dcn import DcnFabric, slice_topology_for

        st = slice_topology_for(chips, cfg.arch.ici)
        if st is not None:
            # migration prices over the HEALTHY fabric: the recovering
            # pod is a fresh stand-in, not the degraded one
            fabric = DcnFabric(st)
    profile = None
    rows: list[dict] = []
    for i, (at_s, pod_idx) in enumerate(events):
        if cancel is not None:
            cancel.check()
        stats.pod_losses += 1
        prior = completed.get(i)
        if prior is not None:
            # its own counter: states_priced + states_resumed must
            # stay the distinct-degradation-state total
            stats.recoveries_resumed += 1
            rows.append(prior)
            continue
        survivors = sum(
            1 for p in range(spec.pods)
            if p != pod_idx and not any(
                d <= at_s < end for d, end in deaths_by_pod[p]
            )
        )
        if profile is None:
            profile = build_profile(pod)
        if fabric is not None:
            migration_s = fabric.transfer_seconds(
                profile.param_bytes_total, 0,
            )
        else:
            migration_s = profile.param_bytes_total \
                / (spec.recovery.dcn_gbps * 1e9 / 8.0)
        rerank: list[dict] = []
        if survivors >= 1:
            degrees = {}
            if profile.dp0 > 1:
                degrees["dp"] = profile.dp0
            if profile.tp0 > 1:
                degrees["tp"] = profile.tp0
            topo_r = torus_for(profile.chips0, cfg.arch.name)
            candidates = [("keep", 1.0)]
            if survivors < spec.pods:
                # the survivors absorb the lost pod's share: each
                # prices the same step at pods/survivors x the work
                candidates.append(
                    ("rebalance", spec.pods / float(survivors))
                )
            for label, factor in candidates:
                compute = scaled_module(
                    pod.modules[profile.module_name], factor,
                    f"{profile.module_name}__fleet_{factor!r}",
                    profile.capture_fp,
                )
                cell_pod = build_cell_pod(
                    profile, compute, profile.chips0, degrees,
                )
                report = SimDriver(
                    cfg, topology=topo_r, result_cache=cache,
                    workers=workers,
                ).run(cell_pod)
                clock_hz = cfg.arch.clock_hz
                step_ms = (
                    report.cycles / clock_hz * 1e3 if clock_hz else 0.0
                )
                # the ranking metric: requests-worth of the ORIGINAL
                # per-step load the survivor fleet completes per
                # second.  A rebalanced step does `factor` x the work,
                # so it serves `factor` requests-worth — raw step_ms
                # alone would always favor 'keep' (smaller steps) and
                # the re-rank could never change outcome
                rerank.append({
                    "candidate": label,
                    "load_factor": factor,
                    "step_ms": step_ms,
                    "fleet_rps": (
                        survivors * factor * 1e3 / step_ms
                        if step_ms > 0 else 0.0
                    ),
                })
        chosen = max(rerank, key=lambda r: (r["fleet_rps"],
                                            r["candidate"] == "keep")) \
            if rerank else None
        row = {
            "at_s": at_s,
            "pod": pod_idx,
            "survivors": survivors,
            "migration_bytes": profile.param_bytes_total,
            "migration_s": migration_s,
            "restart_s": spec.policies.restart_backoff_s,
            "time_to_recover_s": max(
                spec.policies.restart_backoff_s, migration_s,
            ),
            "rerank": rerank,
            "chosen": chosen["candidate"] if chosen else None,
        }
        if journal is not None:
            journal.append({"kind": "recovery", "index": i, "row": row})
        rows.append(row)
        if progress is not None:
            progress(
                f"pod {pod_idx} lost at {at_s:.1f}s: {survivors} "
                f"survivors, recover in {row['time_to_recover_s']:.1f}s"
            )
    return rows


def run_fleet(
    spec_src,
    trace_path: str | Path | None = None,
    pod=None,
    trace_name: str | None = None,
    out_dir: str | Path | None = None,
    resume: bool = False,
    result_cache=None,
    workers: int | None = None,
    validate: bool = True,
    progress=None,
    cancel=None,
    compile_cache=None,
    scenario_batch: bool | str | None = None,
) -> FleetResult:
    """Execute one fleet twin end to end.

    ``spec_src`` is whatever :func:`~tpusim_torch.fleet.spec.load_fleet_spec`
    accepts.  The workload comes from ``trace_path`` or an
    already-parsed ``pod`` (the serve tier passes its hot registry
    entry).  ``out_dir`` enables the crash-safe journal +
    ``report.json``; ``resume=True`` continues a killed run with zero
    journaled pricing intervals re-priced.  ``result_cache`` is shared
    across every replay; ``workers`` fans each replay's module pricing.
    ``validate`` runs the TL24x fleet passes first and refuses on
    errors.  ``cancel`` (a :class:`tpusim_torch.guard.CancelToken`) cancels
    cooperatively at state/recovery/cell grain with everything priced
    so far journaled — the serve tier's ``DELETE /v1/jobs/<id>`` and
    the CLI's ``--max-wall-s`` both arrive here.

    ``scenario_batch`` controls the scenario-batched pricing fastpath
    (:mod:`tpusim_torch.fastpath.batch`): ``None``/``True`` (the default)
    batch-warms the pending degradation states of each timeline group
    into the shared result cache before the state loop prices them,
    ``False`` disables it (the ``--no-scenario-batch`` flag), and a
    backend name from ``BATCH_BACKENDS`` pins the batch backend.
    Batching never changes journal or report bytes."""
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.perf.cache import ResultCache, as_result_cache
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.model_version import model_version

    t0 = time.perf_counter()
    if compile_cache is not None and compile_cache is not False:
        from tpusim_torch.fastpath.store import as_compile_store

        as_compile_store(compile_cache)
    if resume and out_dir is None:
        raise ValueError(
            "resume=True needs the fleet directory that holds the "
            "journal (--out DIR on the CLI)"
        )
    spec = load_fleet_spec(spec_src)
    if pod is None:
        if trace_path is None:
            raise ValueError("run_fleet needs trace_path or pod")
        from tpusim_torch.trace.format import load_trace

        pod = load_trace(trace_path)
    if trace_name is None:
        trace_name = (
            Path(trace_path).name if trace_path is not None
            else str(pod.meta.get("name", "inline"))
        )
    default_chips = _pod_devices(pod)

    if validate:
        from tpusim_torch.analysis import ValidationError
        from tpusim_torch.analysis.diagnostics import Diagnostics
        from tpusim_torch.analysis.fleet_passes import run_fleet_passes

        diags = Diagnostics()
        run_fleet_passes(spec, diags, default_chips=default_chips)
        if diags.has_errors:
            raise ValidationError(diags)

    digest = spec_hash(spec)
    header = {
        "name": spec.name,
        "spec_hash": digest,
        "seed": spec.seed,
        "model_version": model_version(),
        "trace": trace_name,
    }

    stats = FleetStats()
    stats.pods = spec.pods
    batch_stats = None
    if scenario_batch is not False:
        from tpusim_torch.fastpath.batch import BatchStats

        batch_stats = BatchStats()
    cache = as_result_cache(result_cache) or ResultCache()
    chips = spec.chips or default_chips
    overlays = [{"power_enabled": True}]
    if spec.dcn is not None:
        # stand the modeled DCN fabric up over the pod shape: the
        # collective model's hierarchical decomposition and the
        # recovery migration both read the overlaid arch.ici.* fields
        from tpusim_torch.dcn.spec import fabric_overlay

        overlays.append(fabric_overlay(spec.dcn, chips))
    cfg = load_config(
        arch=spec.arch, overlays=overlays,
        tuned=spec.tuned,
    )
    topo = torus_for(chips, cfg.arch.name)
    check_partition = any(
        m.collectives() for m in pod.modules.values()
    )
    replay_chips = min(default_chips, topo.num_chips)

    journal = None
    state_done: dict[str, dict] = {}
    recovery_done: dict[int, dict] = {}
    if out_dir is not None:
        out_dir = Path(out_dir)
        journal = Journal(out_dir)
        if resume:
            _, records = journal.open_resume(header)
            for rec in records:
                if rec.get("kind") == "state":
                    state_done[rec["sig"]] = rec["row"]
                elif rec.get("kind") == "recovery":
                    recovery_done[int(rec["index"])] = rec["row"]
        else:
            journal.open_fresh(header)

    try:
        # -- sample the degradation inputs (pure functions of the seed)
        n_model = spec.max_pods_modeled()
        streams = [
            sample_pod_stream(spec, topo, p) for p in range(n_model)
        ]
        timelines = [
            build_intervals(s, spec.horizon_s) for s in streams
        ]
        deaths_by_pod = [
            _deaths_for(s, spec.policies.restart_backoff_s,
                        spec.horizon_s)
            for s in streams
        ]

        # -- price every distinct state exactly once, healthy first
        def priced(sig: str, docs: list[dict], healthy) -> dict:
            row = state_done.get(sig)
            if row is not None:
                stats.states_resumed += 1
                state_done.pop(sig)  # count each restore once
                rows_by_sig[sig] = row
                return row
            if cancel is not None:
                cancel.check()
            row = _price_state(
                sig, docs, pod, cfg, topo, cache, workers, healthy,
                replay_chips, check_partition, dcn=spec.dcn,
            )
            stats.states_priced += 1
            if row["partitioned"]:
                stats.states_partitioned += 1
            if journal is not None:
                journal.append({"kind": "state", "sig": sig, "row": row})
            rows_by_sig[sig] = row
            if progress is not None:
                n_faults = len(docs)
                progress(
                    f"state {len(rows_by_sig)}: {n_faults} fault(s) -> "
                    + ("partitioned" if row["partitioned"] else
                       f"{row['step_s'] * 1e3:.3f}ms/step")
                )
            return row

        rows_by_sig: dict[str, dict] = {}
        healthy_sig = state_signature([])

        def warm_timelines(tls) -> None:
            """Scenario-batched cache warm: bind every pending distinct
            degradation state across ``tls`` and batch-price its launch
            classes into the shared result cache, so the ``priced``
            calls that follow consume pure hits.  Strictly an
            optimization (cancellation excepted) on the host backends —
            a failure leaves the state loop to price per-state with
            identical journal/report bytes; under ``cuda`` it raises."""
            if batch_stats is None:
                return
            from tpusim_torch.guard import OperationCancelled

            try:
                from tpusim_torch.faults import load_fault_schedule
                from tpusim_torch.fastpath.batch import warm_states

                states, seen = [], set()
                for tl in tls:
                    for _lo, _hi, sig, docs in tl:
                        if (
                            not docs or sig in seen
                            or sig in rows_by_sig or sig in state_done
                        ):
                            continue
                        seen.add(sig)
                        st = load_fault_schedule(
                            {"faults": docs}
                        ).bind(topo)
                        if check_partition and _state_partitions(
                            topo, st.view_at(0.0), replay_chips,
                            spec.dcn,
                        ):
                            continue  # becomes a partitioned row
                        states.append(st)
                if states:
                    batch_stats.merge(warm_states(
                        pod, cfg, topo, states, cache,
                        backend=(scenario_batch
                                 if isinstance(scenario_batch, str)
                                 else None),
                        cancel=cancel,
                    ))
            except OperationCancelled:
                raise
            except Exception:  # noqa: BLE001 — warming is best-effort
                # ... on the host backends; the card's route never hides
                if scenario_batch == "cuda":
                    raise

        healthy = priced(healthy_sig, [], None)
        if healthy["partitioned"] or not healthy["step_s"]:
            raise ValueError(
                "fleet: the healthy replay did not produce a positive "
                "step time — nothing to serve"
            )
        # the spec fleet's states price eagerly (every curve cell
        # consumes them); pods beyond it exist only for the frontier
        # ladder and price LAZILY when a rung first stands them up —
        # a ladder meeting its SLO at 3 pods never replays pod 40's
        # fault states (resume stays sig-keyed, order-free)
        warm_timelines(timelines[: spec.pods])
        for tl in timelines[: spec.pods]:
            for _lo, _hi, sig, docs in tl:
                if sig not in rows_by_sig:
                    priced(sig, docs, healthy)

        pod_state_cache: dict[int, PodState] = {}

        def pod_state(p: int) -> PodState:
            ps = pod_state_cache.get(p)
            if ps is None:
                tl = timelines[p]
                warm_timelines([tl])
                for _lo, _hi, sig, docs in tl:
                    if sig not in rows_by_sig:
                        priced(sig, docs, healthy)
                ps = pod_state_cache[p] = PodState(
                    intervals=[
                        (lo, hi, rows_by_sig[sig])
                        for lo, hi, sig, _d in tl
                    ],
                    deaths=deaths_by_pod[p],
                )
            return ps

        # -- elastic recovery (prices through the same shared cache)
        recovery = _recovery_rows(
            spec, pod, cfg, chips, cache, workers,
            deaths_by_pod[: spec.pods], recovery_done, journal, cancel,
            stats, progress,
        )

        # -- the event walks: curve cells, then the frontier search
        mix_steps = [c.steps for c in spec.traffic.mix]
        # arrival streams key on the RATE alone, so the frontier's
        # ladder (same rate, growing fleets) samples each stream once
        arrivals_by_rate: dict[float, list] = {}

        def run_cell(rate: float, n_pods: int) -> dict:
            if cancel is not None:
                cancel.check()
            stats.cells += 1
            arrivals = arrivals_by_rate.get(rate)
            if arrivals is None:
                arrivals = arrivals_by_rate[rate] = sample_arrivals(
                    spec.traffic, spec.seed, rate, spec.horizon_s,
                )
            return simulate_cell(
                arrivals, [pod_state(p) for p in range(n_pods)],
                spec.policies, spec.horizon_s, healthy["step_s"],
                mix_steps,
            )

        curve_cells = []
        for rate in spec.traffic.load_points:
            cell = run_cell(rate, spec.pods)
            curve_cells.append((rate, spec.pods, cell))
            stats.requests += cell["requests"]
            stats.served += cell["served"]
            for k, v in cell["losses"].items():
                setattr(stats, k, getattr(stats, k) + v)
            if progress is not None:
                progress(
                    f"load {rate:g} req/s: {cell['served']}/"
                    f"{cell['requests']} served"
                )

        frontier_cells = []
        if spec.frontier is not None:
            for target in spec.frontier.target_rps:
                tried = []
                for n_pods in range(1, spec.frontier.max_pods + 1):
                    cell = run_cell(target, n_pods)
                    tried.append((target, n_pods, cell))
                    if _cell_meets_slo(cell, spec.slo):
                        break
                frontier_cells.append((target, tried))
    finally:
        if journal is not None:
            journal.close()

    doc = build_report(
        spec=spec,
        spec_digest=digest,
        model_version=header["model_version"],
        trace_name=trace_name,
        chips=chips,
        healthy=healthy,
        timelines=timelines[: spec.pods],
        deaths_by_pod=deaths_by_pod[: spec.pods],
        curve_cells=curve_cells,
        frontier_cells=frontier_cells,
        recovery=recovery,
    )
    report_path = None
    if out_dir is not None:
        report_path = out_dir / "report.json"
        tmp = report_path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        # lint-allow: TL352 derived artifact — the fsync'd journal is
        # the durable record; a torn report rebuilds from it on resume
        os.replace(tmp, report_path)
    return FleetResult(
        doc=doc, stats=stats, out_dir=out_dir, report_path=report_path,
        wall_seconds=time.perf_counter() - t0,
        batch_stats=batch_stats,
    )


def _cell_meets_slo(cell: dict, slo) -> bool:
    """One source of truth: the frontier ladder stops exactly where the
    report's own SLO block says ``meets`` — the two can never drift."""
    from tpusim_torch.fleet.report import _slo_block

    if slo is None:
        return False
    return _slo_block(cell, slo)["meets"]

"""Compound-fault campaign executor.

Prices N Monte-Carlo-sampled fault scenarios per pod slice through the
shared engine-result cache and journals every outcome to disk before
moving on.  The three contracts:

* **Reproducible** — scenario schedules come from per-scenario PRNG
  substreams (:mod:`tpusim_torch.campaign.sample`) and the report is a pure
  function of the outcome rows, so a fixed seed reproduces the report
  document byte-for-byte.
* **Cheap where it can be** — all replays (baselines and every scenario
  of every slice) share ONE :class:`tpusim_torch.perf.ResultCache`: modules
  without collectives price identically on any pod, so the healthy
  kernel class prices once per campaign, not once per scenario — the
  same trick that makes ``trace_step_sweep`` linear only in the
  fault-sensitive work.
* **Crash-safe** — completed scenarios journal incrementally
  (:mod:`tpusim_torch.campaign.journal`); ``resume=True`` (the
  ``--resume`` flag) re-prices nothing that already landed.
  Per-scenario failures retry with exponential backoff + deterministic
  jitter; scenarios that still fail
  — a partitioned topology above all — are recorded as OUTCOME rows
  (``status: "partitioned"`` / ``"failed"``), never crashes: a fleet
  campaign's whole point is measuring how often the pod breaks.

Port of ``tpusim/campaign/runner.py``.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from tpusim_torch.campaign.journal import Journal
from tpusim_torch.campaign.report import build_report
from tpusim_torch.campaign.sample import sample_schedule_doc, scenario_rng
from tpusim_torch.campaign.spec import (
    CampaignSpec,
    load_campaign_spec,
    spec_hash,
)

__all__ = ["CampaignResult", "CampaignStats", "run_campaign"]

#: backoff ceiling (mirrors harness.procman's discipline)
_MAX_BACKOFF_S = 30.0


@dataclass
class CampaignStats:
    """Executor accounting — the ``campaign_*`` stats namespace
    (registered in the reference's stats-key audit).  Ride reports and
    ``/metrics`` only when a campaign actually ran — the healthy
    simulate path never stamps them."""

    slices: int = 0
    scenarios: int = 0
    #: scenarios whose replay actually priced to completion this run
    #: (partitioned/failed outcomes and journal-restored rows are
    #: counted by their own fields, never here)
    priced: int = 0
    resumed: int = 0
    partitioned: int = 0
    failed: int = 0
    retries: int = 0

    def stats_dict(self) -> dict[str, float]:
        return {
            "campaign_slices_total": self.slices,
            "campaign_scenarios_total": self.scenarios,
            "campaign_scenarios_priced": self.priced,
            "campaign_scenarios_resumed": self.resumed,
            "campaign_partitioned_total": self.partitioned,
            "campaign_failed_total": self.failed,
            "campaign_retries_total": self.retries,
        }


@dataclass
class CampaignResult:
    """One campaign's report document + executor accounting."""

    doc: dict
    stats: CampaignStats
    out_dir: Path | None = None
    report_path: Path | None = None
    wall_seconds: float = 0.0
    rows_by_slice: dict = field(default_factory=dict, repr=False)
    #: scenario-batched pricing accounting
    #: (:class:`tpusim_torch.fastpath.batch.BatchStats`) when the warm phase
    #: ran; None when batching was disabled.  Carried on the result
    #: object only — report/journal bytes are the per-state walk's
    #: either way (the batch publishes cache entries, nothing else).
    batch_stats: object | None = None


def _pod_devices(pod) -> int:
    """The driver's pod-size rule, mirrored (the default primary-slice
    chip count when the spec doesn't pin one)."""
    return max(
        int(pod.meta.get("num_devices", 0) or 0),
        max((m.num_devices for m in pod.modules.values()), default=1),
        len(pod.devices) or 1,
    )


def _fault_summary(doc: dict) -> dict[str, int]:
    out: dict[str, int] = {}
    for rec in doc["faults"]:
        out[rec["kind"]] = out.get(rec["kind"], 0) + 1
    return dict(sorted(out.items()))


def _disconnected(topo, view, replay_chips: int) -> bool:
    """Do the dead links disconnect any two replaying chips?

    BFS over directed live links (route-around may pass through
    non-replaying chips).  The detailed ICI model discovers this itself
    and raises :class:`TopologyPartitionedError` mid-pricing; the
    analytic model degrades torus→mesh but never partitions, so the
    campaign executor owns the check — "would this degradation
    partition my job's communication?" must not depend on which network
    model priced the scenario."""
    if not view.dead:
        return False
    from collections import deque

    adj: dict[int, list[int]] = {}
    for a, b in topo.undirected_links():
        if view.link_alive(a, b):
            adj.setdefault(a, []).append(b)
        if view.link_alive(b, a):
            adj.setdefault(b, []).append(a)
    want = set(range(replay_chips))
    seen = {0}
    q = deque([0])
    while q:
        c = q.popleft()
        for n in adj.get(c, ()):
            if n not in seen:
                seen.add(n)
                q.append(n)
    return not want <= seen


def _dcn_lost_slices(
    view, dcn, num_chips: int, replay_chips: int,
) -> tuple[list[int], int]:
    """Participating TPU slices this view takes out, plus the
    participating-slice count.  A slice is lost when ``slice_down``
    kills its chips outright, or — only when the job actually spans
    slices — when every one of its DCN NICs is dead (``dcn_link_down``
    records stack per-NIC)."""
    cps = max(math.ceil(num_chips / dcn.num_slices), 1)
    s_count = min(math.ceil(replay_chips / cps), dcn.num_slices)
    lost = []
    for s in range(s_count):
        if s in view.slices_down:
            lost.append(s)
        elif s_count > 1 and \
                view.dcn_nics_down.get(s, 0) >= dcn.nics_per_slice:
            lost.append(s)
    return lost, s_count


def _dcn_row(state, dcn, num_chips: int, replay_chips: int) -> dict:
    """The per-scenario slice-survival block (``row["dcn"]``): how many
    TPU slices participate, and how many are lost at ANY point in the
    schedule — the numbers the report's ``dcn`` section aggregates to
    answer "how many slices survive this degradation model"."""
    boundaries = {0.0}
    if state.windowed:
        boundaries.update(f.start_cycle for f, _ in state.bound_faults())
    lost: set[int] = set()
    s_count = 0
    for b in sorted(boundaries):
        ls, s_count = _dcn_lost_slices(
            state.view_at(b), dcn, num_chips, replay_chips,
        )
        lost.update(ls)
    return {
        "slices": s_count,
        "slices_lost": len(lost),
        "slices_ok": s_count - len(lost),
    }


def _schedule_partitions(
    state, replay_chips: int, dcn=None, num_chips: int = 0,
) -> str | None:
    """Partition test for one bound schedule: any activation window
    whose live-link graph disconnects the replaying chips counts (view
    sets only change at fault start cycles), as does any window that
    loses a whole participating TPU slice when a DCN fabric is
    configured.  Returns the attribution string (the row's ``error``
    field), None when connected throughout."""
    topo = state.topo
    boundaries = {0.0}
    if state.windowed:
        boundaries.update(f.start_cycle for f, _ in state.bound_faults())
    for b in sorted(boundaries):
        view = state.view_at(b)
        if _disconnected(topo, view, replay_chips):
            return "dead links disconnect replaying chips"
        if dcn is not None:
            lost, s_count = _dcn_lost_slices(
                view, dcn, num_chips, replay_chips,
            )
            if lost:
                return (
                    f"slice loss: slice(s) {lost} of {s_count} "
                    f"unreachable over the DCN fabric"
                )
    return None


def _price(pod, cfg, topo, faults, cache, workers):
    """One replay → (cycles, step_s, watts, energy_j)."""
    from tpusim_torch.sim.driver import SimDriver

    report = SimDriver(
        cfg, topology=topo, faults=faults, result_cache=cache,
        workers=workers,
    ).run(pod)
    cycles = report.cycles
    step_s = cycles / cfg.arch.clock_hz if cfg.arch.clock_hz else 0.0
    watts = energy = None
    if report.power is not None:
        watts = report.power.avg_watts
        energy = report.power.total_joules
    return cycles, step_s, watts, energy


def _warm_slice(
    spec: CampaignSpec, pod, cfg, topo, slice_label: str, indices,
    cache, batch_stats, *, backend, cancel, replay_chips: int,
    check_partition: bool, dcn=None,
) -> None:
    """Scenario-batched cache warm for one slice: re-sample every
    pending scenario's schedule (pure substream functions — the rows
    the scenario loop samples later are identical), drop the ones the
    partition check will refuse anyway, and batch-price the remaining
    degradation states' launch classes straight into the shared result
    cache.  The per-scenario replays below then consume pure hits.

    Strictly an optimization on the host backends: any failure there
    (short of cooperative cancellation, which must propagate) leaves the
    campaign to price per-state exactly as if batching were off —
    journal and report bytes are identical either way.  With
    ``backend="cuda"`` every error propagates (a missing card, a kernel
    that fails to build or launch): the card's route is never hidden
    behind the per-state walk."""
    from tpusim_torch.guard import OperationCancelled

    try:
        from tpusim_torch.faults import load_fault_schedule
        from tpusim_torch.fastpath.batch import warm_states

        states = []
        for i in indices:
            sched_doc = sample_schedule_doc(spec, topo, slice_label, i)
            state = load_fault_schedule(sched_doc).bind(topo)
            if check_partition and _schedule_partitions(
                state, replay_chips, dcn=dcn, num_chips=topo.num_chips,
            ):
                continue  # becomes a partitioned row, never priced
            states.append(state)
        if states:
            batch_stats.merge(warm_states(
                pod, cfg, topo, states, cache,
                backend=backend, cancel=cancel,
            ))
    except OperationCancelled:
        raise
    except Exception:  # noqa: BLE001 — warming must not fail a campaign
        if backend == "cuda":
            raise


def _run_scenario(
    spec: CampaignSpec, pod, cfg, topo, slice_label: str, index: int,
    healthy: dict, cache, workers, stats: CampaignStats,
    replay_chips: int, check_partition: bool, dcn=None,
    sleep=time.sleep,
) -> tuple[dict, dict]:
    """Price scenario ``index``: returns ``(row, schedule_doc)``.
    Failures become outcome rows, never exceptions."""
    from tpusim_torch.faults import (
        TopologyPartitionedError,
        load_fault_schedule,
    )

    sched_doc = sample_schedule_doc(spec, topo, slice_label, index)
    row = {
        "slice": slice_label,
        "index": index,
        # "num_faults", not "faults_total": row fields live in the
        # report document, and a faults_* literal here would trip the
        # stats-key ownership audit for the faults_* report namespace
        "faults": _fault_summary(sched_doc),
        "num_faults": len(sched_doc["faults"]),
    }
    sched = load_fault_schedule(sched_doc)
    state = sched.bind(topo) if (check_partition or dcn is not None) \
        else None
    if dcn is not None:
        # slice-survival accounting rides EVERY outcome row (ok /
        # partitioned / failed) so the report can distribute over the
        # whole sampled population, not just the rows that priced
        row["dcn"] = _dcn_row(state, dcn, topo.num_chips, replay_chips)
    if check_partition:
        reason = _schedule_partitions(
            state, replay_chips, dcn=dcn, num_chips=topo.num_chips,
        )
        if reason:
            stats.partitioned += 1
            row.update({
                "status": "partitioned", "partitioned": True,
                "error": reason,
            })
            return row, sched_doc
    attempts = 0
    while True:
        attempts += 1
        try:
            cycles, step_s, watts, energy = _price(
                pod, cfg, topo, sched, cache, workers,
            )
        except TopologyPartitionedError as e:
            # deterministic refusal: the sampled faults disconnect chips
            # that must communicate — THE outcome fleet campaigns exist
            # to count, and retrying cannot change it
            stats.partitioned += 1
            row.update({
                "status": "partitioned", "partitioned": True,
                "error": f"{type(e).__name__}: {e}",
            })
            return row, sched_doc
        except Exception as e:  # noqa: BLE001 - scenario boundary
            if attempts <= spec.retries:
                # procman-style: exponential backoff + deterministic
                # jitter (a seeded stream, so reruns sleep identically)
                stats.retries += 1
                base = spec.backoff_s * (2.0 ** (attempts - 1))
                jitter = 0.25 * base * scenario_rng(
                    spec.seed, f"retry:{slice_label}:{attempts}", index
                ).random()
                sleep(min(base + jitter, _MAX_BACKOFF_S))
                continue
            stats.failed += 1
            row.update({
                "status": "failed", "partitioned": False,
                "error": f"{type(e).__name__}: {e}",
                "attempts": attempts,
            })
            return row, sched_doc
        stats.priced += 1
        h = healthy["cycles"]
        row.update({
            "status": "ok",
            "partitioned": False,
            "cycles": cycles,
            "inflation": cycles / h if h > 0 else float("inf"),
            "step_s": step_s,
            "watts": watts,
            "energy_j": energy,
            "energy_delta_j": (
                energy - healthy["energy_j"]
                if energy is not None
                and healthy.get("energy_j") is not None else None
            ),
            "perf_per_watt": (
                (1.0 / step_s) / watts
                if watts and step_s > 0 else None
            ),
        })
        return row, sched_doc


def run_campaign(
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
    sleep=time.sleep,
    cancel=None,
    compile_cache=None,
    scenario_batch: bool | str | None = None,
) -> CampaignResult:
    """Execute one campaign end to end.

    ``spec_src`` is whatever :func:`load_campaign_spec` accepts.  The
    workload comes from ``trace_path`` or an already-parsed ``pod``.
    ``out_dir`` enables the
    crash-safe journal + ``report.json``; ``resume=True`` continues a
    killed campaign from its last completed scenario.  ``result_cache``
    is shared across every replay (None = fresh in-memory cache);
    ``workers`` fans each replay's module pricing (scenarios themselves
    run serially so the journal is always a true prefix).  ``validate``
    runs the TL2xx campaign passes first and refuses on errors.
    ``cancel`` (a :class:`tpusim_torch.guard.CancelToken`) makes the campaign
    cooperatively cancellable at scenario grain: a tripped token raises
    :class:`tpusim_torch.guard.OperationCancelled` with every completed
    scenario already journaled, so a later ``resume=True`` re-prices
    nothing that finished — the CLI's ``--max-wall-s`` arrives here.

    ``scenario_batch`` controls the scenario-batched pricing fastpath
    (:mod:`tpusim_torch.fastpath.batch`): ``None``/``True`` (the default)
    batch-warms each slice's pending degradation states into the
    shared result cache before the scenario loop, ``False`` disables
    it (the ``--no-scenario-batch`` flag), and a backend name from
    ``BATCH_BACKENDS`` pins the batch backend (``"cuda"``: the lanes' row
    scans run on the card, and any error of that warm raises).  Batching
    never changes journal or report bytes — it only decides whether the
    per-scenario replays price or hit the cache.

    Not ported yet: the sharded run (``only=``, ``--nodes``; ROADMAP
    A11)."""
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.perf.cache import ResultCache, as_result_cache
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.model_version import model_version

    t0 = time.perf_counter()
    if compile_cache is not None and compile_cache is not False:
        # mount the durable compiled tier (tpusim_torch.fastpath.store)
        # before the trace loads: every scenario of every slice shares
        # one compile, and a fresh campaign over an already-compiled
        # trace parses and compiles nothing
        from tpusim_torch.fastpath.store import as_compile_store

        as_compile_store(compile_cache)
    if resume and out_dir is None:
        # silently re-pricing a whole campaign the caller believes is
        # resuming would be the worst possible interpretation
        raise ValueError(
            "resume=True needs the campaign directory that holds the "
            "journal (--out DIR on the CLI)"
        )
    spec = load_campaign_spec(spec_src)
    if pod is None:
        if trace_path is None:
            raise ValueError("run_campaign needs trace_path or pod")
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
        from tpusim_torch.analysis.campaign_passes import run_campaign_passes
        from tpusim_torch.analysis.diagnostics import Diagnostics

        diags = Diagnostics()
        run_campaign_passes(spec, diags, default_chips=default_chips)
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

    stats = CampaignStats()
    batch_stats = None
    if scenario_batch is not False:
        from tpusim_torch.fastpath.batch import BatchStats

        batch_stats = BatchStats()
    cache = as_result_cache(result_cache) or ResultCache()
    # partition semantics need communicating chips: a pod with no
    # collectives has nothing to disconnect
    check_partition = any(
        m.collectives() for m in pod.modules.values()
    )
    journal = None
    completed: dict[tuple[str, int], dict] = {}
    healthy_done: dict[str, dict] = {}
    if out_dir is not None:
        out_dir = Path(out_dir)
        journal = Journal(out_dir)
        if resume:
            _, records = journal.open_resume(header)
            for rec in records:
                if rec.get("kind") == "scenario":
                    completed[(rec["slice"], rec["index"])] = rec["row"]
                elif rec.get("kind") == "healthy":
                    healthy_done[rec["slice"]] = rec["row"]
        else:
            journal.open_fresh(header)

    slices_doc: list[dict] = []
    rows_by_slice: dict[str, list[dict]] = {}
    try:
        for sl in spec.slices(default_chips):
            if cancel is not None:
                cancel.check()
            stats.slices += 1
            overlays = [{"power_enabled": True}]
            if spec.dcn is not None:
                # stand the modeled DCN fabric up over this candidate
                # shape: the collective model's hierarchical
                # decomposition and the flat scalar tail both read the
                # overlaid arch.ici.* fields
                from tpusim_torch.dcn.spec import fabric_overlay

                overlays.append(fabric_overlay(spec.dcn, sl.chips))
            cfg = load_config(
                arch=sl.arch, overlays=overlays,
                tuned=spec.tuned,
            )
            topo = torus_for(sl.chips, cfg.arch.name)
            healthy = healthy_done.get(sl.label)
            if healthy is None:
                cycles, step_s, watts, energy = _price(
                    pod, cfg, topo, None, cache, workers,
                )
                healthy = {
                    "cycles": cycles, "step_s": step_s,
                    "watts": watts, "energy_j": energy,
                }
                if journal is not None:
                    journal.append({
                        "kind": "healthy", "slice": sl.label,
                        "row": healthy,
                    })
            if batch_stats is not None:
                pend = [
                    i for i in range(spec.scenarios)
                    if (sl.label, i) not in completed
                ]
                if pend:
                    _warm_slice(
                        spec, pod, cfg, topo, sl.label, pend, cache,
                        batch_stats,
                        backend=(scenario_batch
                                 if isinstance(scenario_batch, str)
                                 else None),
                        cancel=cancel,
                        replay_chips=min(default_chips, topo.num_chips),
                        check_partition=check_partition,
                        dcn=spec.dcn,
                    )
            slices_doc.append({
                "label": sl.label,
                "arch": sl.arch,
                "chips": sl.chips,
                "healthy_cycles": healthy["cycles"],
                "healthy_step_s": healthy["step_s"],
                "healthy_watts": healthy.get("watts"),
                "healthy_energy_j": healthy.get("energy_j"),
            })
            rows = rows_by_slice.setdefault(sl.label, [])
            for i in range(spec.scenarios):
                # scenario-grain cancellation: everything journaled so
                # far stays durable; the raise reaches the caller with
                # the journal closed (the finally below) and a later
                # --resume re-prices nothing already completed
                if cancel is not None:
                    cancel.check()
                stats.scenarios += 1
                prior = completed.get((sl.label, i))
                if prior is not None:
                    stats.resumed += 1
                    rows.append(prior)
                    continue
                row, sched_doc = _run_scenario(
                    spec, pod, cfg, topo, sl.label, i, healthy, cache,
                    workers, stats,
                    replay_chips=min(default_chips, topo.num_chips),
                    check_partition=check_partition,
                    dcn=spec.dcn,
                    sleep=sleep,
                )
                if journal is not None:
                    journal.append({
                        "kind": "scenario", "slice": sl.label,
                        "index": i, "schedule": sched_doc, "row": row,
                    })
                rows.append(row)
                if progress is not None:
                    progress(
                        f"{sl.label} scenario {i + 1}/{spec.scenarios}: "
                        f"{row['status']}"
                    )
    finally:
        if journal is not None:
            journal.close()

    doc = build_report(
        spec=spec,
        spec_digest=digest,
        model_version=header["model_version"],
        trace_name=trace_name,
        slices=slices_doc,
        rows_by_slice=rows_by_slice,
    )
    report_path = None
    if out_dir is not None:
        report_path = out_dir / "report.json"
        tmp = report_path.with_suffix(
            f".tmp.{os.getpid()}"
        )
        tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        # lint-allow: TL352 derived artifact — the fsync'd journal is
        # the durable record; a torn report rebuilds from it on resume
        os.replace(tmp, report_path)
    return CampaignResult(
        doc=doc, stats=stats, out_dir=out_dir, report_path=report_path,
        wall_seconds=time.perf_counter() - t0,
        rows_by_slice=rows_by_slice,
        batch_stats=batch_stats,
    )

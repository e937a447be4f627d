"""Distributed campaign execution — shard, journal, merge (port of
``tpusim/campaign/shard.py``).

``tpusim_torch campaign --nodes N`` turns the multi-node cluster into a
compute surface: the coordinator assigns every ``(slice, index)``
scenario signature to a node via the SAME consistent-hash ring the
serve tier uses for trace affinity (:mod:`tpusim_torch.serve.cluster`), each
node prices only its share (``run_campaign(only=...)``) into its own
fsync'd journal shard at ``<out>/shards/n<i>/``, and the coordinator
merges the union of shard journals by signature into ONE report built
by the same pure :func:`tpusim_torch.campaign.report.build_report` — so the
merged document is byte-identical to an uninterrupted single-node run.

Robustness contract (the reason this module exists):

* **Node death is a reassignment, not a loss** — a shard process that
  dies (SIGKILL included) is dropped from the ring and its REMAINING
  scenarios re-shard across the survivors in the next wave; the ring
  guarantees only the dead node's keys move.  Everything its journal
  already holds stays priced exactly once.
* **Zero re-priced scenarios** — each wave subtracts the union of all
  shard journals before assigning, so no ``(slice, index)`` is ever
  priced twice, across waves or across ``--resume`` runs.
* **Identity-checked merge** — every shard journal's header must match
  the coordinator's ``(spec_hash, seed, model_version)``; splicing two
  campaigns into one report is refused, exactly as single-node resume
  refuses it.

The nodes are forked (``fork`` where it exists), as the reference's are.
A forked child cannot use a CUDA context its parent holds, so a run with
``scenario_batch="cuda"`` (the lanes' row scans on the card) is refused
up front rather than priced on another backend: shard it with a host
batch backend, or run it on one node.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

from tpusim_torch.campaign.journal import Journal, JournalError
from tpusim_torch.campaign.report import build_report
from tpusim_torch.campaign.runner import CampaignResult, CampaignStats, run_campaign
from tpusim_torch.campaign.spec import load_campaign_spec, spec_hash

__all__ = ["run_sharded_campaign", "shard_assignment"]

#: ceiling on reassignment waves: every wave either finishes the work
#: or removes at least one dead node, so nodes+1 waves always suffice —
#: anything past that is a coordinator bug, not a slow fleet
_EXTRA_WAVES = 1


def _shard_dir(out_dir: Path, node: int) -> Path:
    return out_dir / "shards" / f"n{node}"


def shard_assignment(
    work, nodes, digest: str,
) -> dict[int, set[tuple[str, int]]]:
    """Map each ``(slice_label, index)`` in ``work`` to a node in
    ``nodes`` (a list of node indices) by consistent-hashing its
    journal signature ``{spec_hash}:{slice}:{index}``.  Removing a node
    from ``nodes`` remaps ONLY that node's signatures — the property
    the resume-elsewhere path leans on."""
    from tpusim_torch.serve.cluster import AffinityRing

    ring = AffinityRing([f"n{i}" for i in nodes])
    out: dict[int, set[tuple[str, int]]] = {int(i): set() for i in nodes}
    for label, index in work:
        owner = ring.owner(f"{digest}:{label}:{index}")
        out[int(owner[1:])].add((label, index))
    return out


def _scan_shard(shard_dir: Path, header: dict):
    """Read one shard journal: ``(rows, healthy, duplicates)`` where
    ``rows`` maps ``(slice, index)`` to the outcome row and ``healthy``
    maps slice label to the baseline row.  Refuses a journal whose
    header identity differs from this campaign's (the single-node
    resume discipline, applied shard-wise)."""
    rows: dict[tuple[str, int], dict] = {}
    healthy: dict[str, dict] = {}
    duplicates = 0
    head = None
    for rec in Journal(shard_dir).iter_records():
        if head is None:
            if rec.get("kind") != "header":
                raise JournalError(
                    f"{shard_dir}: first record is not a header"
                )
            for key in ("spec_hash", "seed", "model_version"):
                if rec.get(key) != header.get(key):
                    raise JournalError(
                        f"{shard_dir}: shard journal {key} "
                        f"{rec.get(key)!r} does not match this "
                        f"campaign's {header.get(key)!r} — refusing to "
                        f"merge a different campaign"
                    )
            head = rec
            continue
        if rec.get("kind") == "scenario":
            sig = (rec["slice"], rec["index"])
            if sig in rows:
                duplicates += 1
            rows[sig] = rec["row"]
        elif rec.get("kind") == "healthy":
            healthy.setdefault(rec["slice"], rec["row"])
    return rows, healthy, duplicates


def _scan_all_shards(out_dir: Path, header: dict):
    """Union of every shard journal under ``<out>/shards/`` (sorted by
    node index so the merge is deterministic).  Healthy baselines are
    first-wins — they are pure functions of (spec, slice), so every
    shard that journaled one journaled the same row."""
    rows: dict[tuple[str, int], dict] = {}
    healthy: dict[str, dict] = {}
    duplicates = 0
    shards_root = out_dir / "shards"
    if not shards_root.is_dir():
        return rows, healthy, duplicates
    for d in sorted(
        shards_root.iterdir(),
        key=lambda p: (len(p.name), p.name),
    ):
        if not (d / "journal.jsonl").is_file():
            continue
        srows, shealthy, sdup = _scan_shard(d, header)
        duplicates += sdup
        for sig, row in srows.items():
            if sig in rows:
                duplicates += 1
                continue
            rows[sig] = row
        for label, row in shealthy.items():
            healthy.setdefault(label, row)
    return rows, healthy, duplicates


def _shard_node_main(
    spec_src, trace_path, shard_dir, only, resume,
    result_cache, workers, compile_cache, scenario_batch=None,
):
    """One shard process: price exactly ``only`` into this shard's
    journal.  Module-level so every multiprocessing start method can
    pickle it; exceptions become a nonzero exit the coordinator reads
    as node death.

    A forked child inherits torch's intra-op pool in the state the parent
    left it, so the node runs one intra-op thread, as the pricing pool's
    workers do (pricing's float64 scans are serial anyway)."""
    import torch

    torch.set_num_threads(1)
    try:
        run_campaign(
            spec_src,
            trace_path=trace_path,
            out_dir=shard_dir,
            resume=resume,
            result_cache=result_cache,
            workers=workers,
            # the coordinator already validated the spec once
            validate=False,
            compile_cache=compile_cache,
            only=only,
            scenario_batch=scenario_batch,
        )
    except Exception as e:  # noqa: BLE001 - process boundary
        print(
            f"tpusim_torch campaign shard {Path(shard_dir).name}: "
            f"{type(e).__name__}: {e}",
            file=sys.stderr,
        )
        raise SystemExit(1) from None


def run_sharded_campaign(
    spec_src,
    trace_path: str | Path | None = None,
    out_dir: str | Path | None = None,
    nodes: int = 2,
    resume: bool = False,
    result_cache=None,
    workers: int | None = None,
    compile_cache=None,
    progress=None,
    validate: bool = True,
    on_spawn=None,
    scenario_batch: bool | str | None = None,
) -> CampaignResult:
    """Execute one campaign sharded across ``nodes`` local node
    processes; returns a :class:`CampaignResult` whose report document
    is byte-identical to an uninterrupted single-node run.

    ``out_dir`` is required (the shard journals live under it and the
    merged ``report.json`` lands in it).  ``resume=True`` re-prices
    nothing any shard journal already holds — including journals left
    by a run with a DIFFERENT node count, which is exactly the
    node-died-resume-elsewhere path.  ``on_spawn`` (tests/chaos
    harnesses) receives the dict of live ``{node: Process}`` after each
    wave's spawn — SIGKILLing one exercises the reassignment wave."""
    from tpusim_torch.timing.model_version import model_version
    from tpusim_torch.trace.format import load_trace

    t0 = time.perf_counter()
    if out_dir is None:
        raise ValueError(
            "sharded campaigns need --out DIR: the per-node journal "
            "shards and the merged report live there"
        )
    nodes = int(nodes)
    if nodes < 1:
        raise ValueError(f"--nodes wants a positive count, got {nodes}")
    if scenario_batch == "cuda":
        raise ValueError(
            "sharded campaigns fork their nodes, and a forked node cannot "
            "use the card: pass a host scenario_batch backend, or run "
            "scenario_batch='cuda' on one node"
        )
    if trace_path is None:
        raise ValueError("run_sharded_campaign needs trace_path")
    out_dir = Path(out_dir)
    spec = load_campaign_spec(spec_src)
    pod = load_trace(trace_path)
    trace_name = Path(trace_path).name
    from tpusim_torch.campaign.runner import _pod_devices

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
    slices = spec.slices(default_chips)
    work = [
        (sl.label, i) for sl in slices for i in range(spec.scenarios)
    ]

    done_at_start, _, _ = _scan_all_shards(out_dir, header)
    if done_at_start and not resume:
        raise JournalError(
            f"{out_dir / 'shards'} already holds journaled scenarios; "
            f"resume them (--resume) or choose a fresh directory"
        )

    ctx = multiprocessing.get_context(
        "fork" if "fork" in multiprocessing.get_all_start_methods()
        else "spawn"
    )
    alive = list(range(nodes))
    wave = 0
    while True:
        done, _, _ = _scan_all_shards(out_dir, header)
        remaining = [sig for sig in work if sig not in done]
        if not remaining:
            break
        if not alive:
            raise JournalError(
                f"{out_dir}: every shard node died with "
                f"{len(remaining)} scenario(s) unpriced; the journals "
                f"are intact — re-run with --resume"
            )
        if wave > nodes + _EXTRA_WAVES:
            raise JournalError(
                f"{out_dir}: shard reassignment did not converge after "
                f"{wave} waves ({len(remaining)} scenario(s) left)"
            )
        assignment = shard_assignment(remaining, alive, digest)
        procs: dict[int, multiprocessing.process.BaseProcess] = {}
        for node in alive:
            only = assignment.get(node) or set()
            if not only:
                continue
            shard_dir = _shard_dir(out_dir, node)
            procs[node] = ctx.Process(
                target=_shard_node_main,
                args=(
                    spec_src, str(trace_path), str(shard_dir), only,
                    # wave > 0 always resumes: the shard journal may
                    # already exist from an earlier wave of THIS run
                    resume or wave > 0
                    or (shard_dir / "journal.jsonl").exists(),
                    result_cache, workers, compile_cache,
                    scenario_batch,
                ),
                name=f"tpusim-campaign-shard-{node}",
            )
        if progress is not None:
            progress(
                f"wave {wave}: {len(remaining)} scenario(s) across "
                f"{len(procs)} node(s)"
            )
        for p in procs.values():
            p.start()
        if on_spawn is not None:
            on_spawn(dict(procs))
        died = []
        for node, p in procs.items():
            p.join()
            if p.exitcode != 0:
                died.append(node)
        for node in died:
            alive.remove(node)
            if progress is not None:
                progress(
                    f"wave {wave}: node {node} died (exit "
                    f"{procs[node].exitcode}); resuming its shard on "
                    f"{len(alive)} survivor(s)"
                )
        wave += 1

    rows, healthy, _ = _scan_all_shards(out_dir, header)
    missing = [sig for sig in work if sig not in rows]
    if missing:
        raise JournalError(
            f"{out_dir}: merge found {len(missing)} unpriced "
            f"scenario(s) (first: {missing[0]!r}) — shard journals are "
            f"incomplete"
        )
    slices_doc = []
    rows_by_slice: dict[str, list[dict]] = {}
    for sl in slices:
        h = healthy.get(sl.label)
        if h is None:
            raise JournalError(
                f"{out_dir}: no shard journaled a healthy baseline "
                f"for slice {sl.label!r}"
            )
        slices_doc.append({
            "label": sl.label,
            "arch": sl.arch,
            "chips": sl.chips,
            "healthy_cycles": h["cycles"],
            "healthy_step_s": h["step_s"],
            "healthy_watts": h.get("watts"),
            "healthy_energy_j": h.get("energy_j"),
        })
        rows_by_slice[sl.label] = [
            rows[(sl.label, i)] for i in range(spec.scenarios)
        ]

    doc = build_report(
        spec=spec,
        spec_digest=digest,
        model_version=header["model_version"],
        trace_name=trace_name,
        slices=slices_doc,
        rows_by_slice=rows_by_slice,
    )
    report_path = out_dir / "report.json"
    tmp = report_path.with_suffix(f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    # lint-allow: TL352 derived artifact — the fsync'd shard journals
    # are the durable record; a torn report rebuilds from them
    os.replace(tmp, report_path)

    stats = CampaignStats()
    stats.slices = len(slices)
    stats.scenarios = len(work)
    stats.resumed = len(done_at_start)
    for sig, row in rows.items():
        if sig in done_at_start:
            continue
        status = row.get("status")
        if status == "ok":
            stats.priced += 1
        elif status == "partitioned":
            stats.partitioned += 1
        elif status == "failed":
            stats.failed += 1
    return CampaignResult(
        doc=doc, stats=stats, out_dir=out_dir, report_path=report_path,
        wall_seconds=time.perf_counter() - t0,
        rows_by_slice=rows_by_slice,
    )

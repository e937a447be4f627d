"""Command-line interface of the port (counterpart of ``tpusim/__main__.py``).

    python -m tpusim_torch capture  <workload> <out-dir> [--launches N]
                                    [--snapshot] [--set K=V] [--device cuda|cpu]
    python -m tpusim_torch simulate <trace-dir> [--arch v5e] [--config F] [--json F]
                                    [--power] [--network-mode analytic|detailed]
                                    [--resume-kernel N] [--checkpoint-kernel N]
                                    [--resume-op N] [--checkpoint-op N]
                                    [--lenient-parse]
                                    [--pricing-backend auto|serial|vectorized|native]
                                    [--faults SCHEDULE.json] [--workers N]
                                    [--result-cache[=DIR]] [--cache-quota SIZE]
                                    [--compile-cache[=DIR]]
                                    [--validate[=on|strict]]
    python -m tpusim_torch lint     [<trace-dir>] [--arch A] [--config F]
                                    [--faults F] [--campaign F] [--advise F]
                                    [--stats-keys] [--self-audit] [--perf]
                                    [--list-codes] [--format text|json]
                                    [--strict]
    python -m tpusim_torch perf-report <trace-dir> [--arch A] [--config F]
                                    [--module M] [--top N]
                                    [--format text|json]
    python -m tpusim_torch faults   [--arch v5p] [--chips 64] [--trace DIR]
                                    [--kind K] [--payload-mb MB] [--top N]
                                    [--max-scenarios N] [--json F]
                                    [--workers N] [--result-cache[=DIR]]
                                    [--compile-cache[=DIR]]
    python -m tpusim_torch cache    {stats,verify,gc,clear} [--dir DIR]
                                    [--quota SIZE] [--max-entries N]
    python -m tpusim_torch campaign <spec.json> --trace DIR [--out DIR]
                                    [--resume] [--workers N]
                                    [--result-cache[=DIR]]
                                    [--compile-cache[=DIR]] [--max-wall-s S]
                                    [--no-scenario-batch] [--json F]
                                    [--verbose]
    python -m tpusim_torch fleet    <spec.json> --trace DIR [--out DIR]
                                    [--resume] [--workers N]
                                    [--result-cache[=DIR]]
                                    [--compile-cache[=DIR]] [--max-wall-s S]
                                    [--no-scenario-batch] [--json F]
                                    [--verbose]
    python -m tpusim_torch advise   <spec.json> --trace DIR [--top N]
                                    [--workers N] [--result-cache[=DIR]]
                                    [--compile-cache[=DIR]] [--json F]
                                    [--verbose]
    python -m tpusim_torch info     <trace-dir>
    python -m tpusim_torch workloads

The output format is the reference's (errors and refusals on stderr
under the ``tpusim_torch`` prefix; a cancelled campaign or fleet run
exits 3, a refused spec 1; ``lint`` exits 1 on errors, and on warnings
under ``--strict``).  ``lint --self-audit`` and ``--stats-keys`` audit
the port's own sources.  ``campaign`` has no ``--nodes`` yet.  The other
subcommands wait for their slices of the port (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _cmd_simulate(args: argparse.Namespace) -> int:
    from tpusim_torch.sim.driver import simulate_trace

    overlays = list(args.config or [])
    if args.power:
        overlays.append({"power_enabled": True})
    if args.resume_kernel:
        overlays.append({"resume_kernel": args.resume_kernel})
    if args.checkpoint_kernel:
        overlays.append({"checkpoint_kernel": args.checkpoint_kernel})
    if args.resume_op:
        overlays.append({"resume_op": args.resume_op})
    if args.checkpoint_op:
        overlays.append({"checkpoint_op": args.checkpoint_op})
    if args.network_mode:
        overlays.append({"arch": {"ici": {"network_mode": args.network_mode}}})
    faults = None
    if args.faults:
        from tpusim_torch.faults import load_fault_schedule

        faults = load_fault_schedule(args.faults)
    # --cache-quota bounds the disk store: it implies --result-cache and
    # governs the compile tier's publishes too (one quota, one directory)
    result_cache = args.result_cache
    compile_cache = args.compile_cache
    if args.cache_quota:
        from tpusim_torch.fastpath.store import as_compile_store
        from tpusim_torch.guard.store import parse_size
        from tpusim_torch.perf.cache import as_result_cache

        quota = parse_size(args.cache_quota)
        result_cache = as_result_cache(
            True if result_cache is None else result_cache
        )
        result_cache.quota_bytes = quota
        if compile_cache:
            compile_cache = as_compile_store(compile_cache, quota_bytes=quota)
    report = simulate_trace(
        args.trace, arch=args.arch, overlays=overlays, faults=faults,
        lenient=args.lenient_parse, validate=args.validate,
        result_cache=result_cache,
        workers=args.workers, pricing_backend=args.pricing_backend,
        compile_cache=compile_cache,
    )
    if args.power and report.power is not None:
        print(report.power.report_text())
    report.print_report()
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.stats.to_json() + "\n")
    return 0


def _cmd_faults(args: argparse.Namespace) -> int:
    """Single-link-failure sweep: price a collective (or replay a trace)
    once per dead link and report worst-case step-time inflation."""
    from tpusim_torch.faults.sweep import single_link_sweep, trace_step_sweep
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.timing.config import load_config

    if args.compile_cache:
        # activate before the trace loads so its parse defers
        from tpusim_torch.fastpath.store import as_compile_store

        as_compile_store(args.compile_cache)
    cfg = load_config(arch=args.arch)
    arch_name = cfg.arch.name
    topo = torus_for(args.chips, arch_name)
    if args.trace:
        result = trace_step_sweep(
            args.trace, topo, arch=args.arch,
            max_scenarios=args.max_scenarios,
            workers=args.workers, result_cache=args.result_cache,
        )
        what = f"step time ({result.unit})"
    else:
        result = single_link_sweep(
            topo, cfg.arch.ici,
            payload_bytes=args.payload_mb * 1024 * 1024,
            kind=args.kind,
            workers=args.workers,
        )
        what = f"{args.kind} ({result.unit})"
    dims = "x".join(str(d) for d in topo.dims)
    print(f"tpusim faults: single-link-failure sweep on {arch_name} "
          f"{dims} torus ({topo.num_chips} chips, "
          f"{len(result.rows)} scenarios)")
    print(f"  healthy {what}: {result.healthy:.6g}")
    worst = result.worst
    if worst is not None:
        print(f"  worst-case inflation: {worst.inflation:.3f}x at link "
              f"{worst.label()}")
    top = sorted(result.rows, key=lambda r: -r.inflation)[: args.top]
    for r in top:
        print(f"    {r.label():24s} {r.value:.6g} "
              f"({r.inflation:.3f}x)")
    degraded = sum(1 for r in result.rows if r.inflation > 1.0 + 1e-12)
    print(f"  {degraded}/{len(result.rows)} scenarios inflate the "
          f"healthy baseline")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result.to_doc(), f, indent=2)
        print(f"  sweep report written to {args.json}")
    return 0


def _cmd_cache(args: argparse.Namespace) -> int:
    """Governance of a disk store (result and compiled records): inspect
    it, verify it (quarantining damaged records), collect it down to a
    quota, or clear it."""
    from tpusim_torch.guard.store import (
        clear_store, format_size, gc_store, parse_size, scan_store,
        verify_store,
    )
    from tpusim_torch.perf.cache import DEFAULT_CACHE_DIR

    d = Path(args.dir or DEFAULT_CACHE_DIR)
    if args.action != "stats" and not d.is_dir():
        print(f"tpusim_torch cache: no store at {d}", file=sys.stderr)
        return 1
    if args.action == "stats":
        for line in scan_store(d).lines():
            print(line)
        return 0
    if args.action == "verify":
        res = verify_store(d)
        print(f"store: {d}")
        for line in res.lines():
            print(line)
        return 0
    if args.action == "gc":
        try:
            quota = parse_size(args.quota)
        except ValueError as e:
            print(f"tpusim_torch cache: error: {e}", file=sys.stderr)
            return 2
        if quota is None and args.max_entries is None:
            print("tpusim_torch cache: gc needs --quota and/or "
                  "--max-entries (otherwise there is nothing to collect "
                  "down to)", file=sys.stderr)
            return 2
        res = gc_store(d, quota_bytes=quota, max_entries=args.max_entries)
        print(f"store: {d}")
        print(f"  deleted: {res.deleted} record(s) "
              f"({format_size(res.freed_bytes)} freed)")
        print(f"  reaped: {res.tmp_reaped} abandoned tmp file(s)")
        print(f"  remaining: {res.remaining_entries} record(s) "
              f"({format_size(res.remaining_bytes)})")
        return 0
    removed = clear_store(d)  # clear
    print(f"store: {d}\n  removed: {removed} file(s)")
    return 0


def _cmd_campaign(args: argparse.Namespace) -> int:
    """Monte-Carlo compound-fault campaign: sample N fault scenarios
    per pod slice from a seeded spec, price each through the shared
    result cache, and report inflation distributions + the SLO
    capacity answer.  Crash-safe: re-run with --resume to continue a
    killed campaign from its last journaled scenario."""
    from tpusim_torch.analysis import ValidationError
    from tpusim_torch.campaign import JournalError, run_campaign
    from tpusim_torch.guard.cancel import CancelToken, OperationCancelled

    progress = None
    if args.verbose:
        def progress(msg: str) -> None:
            print(f"  {msg}", file=sys.stderr)
    cancel = None
    if getattr(args, "max_wall_s", None):
        cancel = CancelToken.after(args.max_wall_s)
    try:
        res = run_campaign(
            args.spec,
            trace_path=args.trace,
            out_dir=args.out,
            resume=args.resume,
            result_cache=args.result_cache,
            workers=args.workers,
            progress=progress,
            cancel=cancel,
            compile_cache=args.compile_cache,
            scenario_batch=(
                False if args.no_scenario_batch else None),
        )
    except OperationCancelled as e:
        hint = (
            f"re-run with --resume --out {args.out} to continue from "
            f"the last journaled scenario" if args.out
            else "pass --out DIR to make cancelled campaigns resumable"
        )
        print(f"tpusim_torch campaign: cancelled: {e}; {hint}",
              file=sys.stderr)
        return 3
    except ValidationError as e:
        print(f"tpusim_torch campaign: spec refused:\n{e}",
              file=sys.stderr)
        return 1
    except JournalError as e:
        # existing-journal / foreign-resume refusals are user errors
        # with a clear next step, not tracebacks
        print(f"tpusim_torch campaign: {e}", file=sys.stderr)
        return 1
    doc = res.doc
    s = res.stats
    print(f"tpusim campaign: {doc['campaign']!r} seed={doc['seed']} "
          f"spec={doc['spec_hash']} trace={doc['trace']}")
    print(f"  {s.priced} scenario(s) priced, {s.resumed} resumed from "
          f"journal, {s.partitioned} partitioned, {s.failed} failed "
          f"({res.wall_seconds:.2f}s)")
    for sl in doc["slices"]:
        infl = sl["inflation"]
        line = (f"  {sl['label']:12s} {sl['scenarios']} scenarios, "
                f"partition rate {sl['partition_rate']:.1%}")
        if infl is not None:
            line += (f"; inflation p50 {infl['p50']:.3f}x "
                     f"p95 {infl['p95']:.3f}x p99 {infl['p99']:.3f}x "
                     f"max {infl['max']:.3f}x")
        slo = sl.get("slo")
        if slo is not None:
            at = slo["step_ms_at_percentile"]
            shown = f"{at:.3f}ms" if at is not None else "unbounded"
            line += (f"; p{slo['percentile']:g} step {shown} vs SLO "
                     f"{slo['step_time_ms']:g}ms -> "
                     f"{'MEETS' if slo['meets'] else 'MISSES'}")
        print(line)
    cap = doc.get("capacity")
    if cap is not None:
        best = cap["smallest_meeting_slice"]
        print(f"  capacity: smallest slice meeting "
              f"{cap['slo_step_time_ms']:g}ms @ p{cap['percentile']:g} "
              f"under sampled degradation: {best or 'NONE'}")
    for k, v in s.stats_dict().items():
        print(f"  {k} = {v:.0f}")
    bs = getattr(res, "batch_stats", None)
    if bs is not None and (bs.states or bs.lanes_cached or bs.skipped):
        # only-when-active: batch accounting prints only when the
        # lane-axis warm pass actually engaged this run
        for k, v in bs.stats_dict().items():
            print(f"  {k} = {v:.0f}")
    if res.report_path is not None:
        print(f"  report written to {res.report_path}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"  report also written to {args.json}")
    return 0


def _cmd_fleet(args: argparse.Namespace) -> int:
    """Traffic-driven fleet digital twin: a seeded discrete-event
    simulation of N serving pods under an open-loop arrival process
    with a campaign-style fault stream, governed by the serve daemon's
    admission policies — goodput/MFU/p99-vs-load curves, a pods-needed
    capacity frontier, energy per served request, and per-policy loss
    attribution.  Crash-safe: re-run with --resume to continue with
    zero journaled pricing intervals re-priced."""
    from tpusim_torch.analysis import ValidationError
    from tpusim_torch.fleet import FleetSpecError, JournalError, run_fleet
    from tpusim_torch.guard.cancel import CancelToken, OperationCancelled

    progress = None
    if args.verbose:
        def progress(msg: str) -> None:
            print(f"  {msg}", file=sys.stderr)
    cancel = None
    if getattr(args, "max_wall_s", None):
        cancel = CancelToken.after(args.max_wall_s)
    try:
        res = run_fleet(
            args.spec,
            trace_path=args.trace,
            out_dir=args.out,
            resume=args.resume,
            result_cache=args.result_cache,
            workers=args.workers,
            progress=progress,
            cancel=cancel,
            compile_cache=args.compile_cache,
            scenario_batch=(
                False if args.no_scenario_batch else None),
        )
    except OperationCancelled as e:
        hint = (
            f"re-run with --resume --out {args.out} to continue from "
            f"the last journaled pricing interval" if args.out
            else "pass --out DIR to make cancelled fleet runs resumable"
        )
        print(f"tpusim_torch fleet: cancelled: {e}; {hint}", file=sys.stderr)
        return 3
    except FleetSpecError as e:
        print(f"tpusim_torch fleet: spec refused ({e.code}): {e}",
              file=sys.stderr)
        return 1
    except ValidationError as e:
        print(f"tpusim_torch fleet: spec refused:\n{e}", file=sys.stderr)
        return 1
    except JournalError as e:
        print(f"tpusim_torch fleet: {e}", file=sys.stderr)
        return 1
    doc = res.doc
    s = res.stats
    print(f"tpusim fleet: {doc['fleet']!r} seed={doc['seed']} "
          f"spec={doc['spec_hash']} trace={doc['trace']}")
    print(f"  {doc['pods']} pod(s) x {doc['chips']} {doc['arch']} "
          f"chips over {doc['horizon_s']:g}s; healthy step "
          f"{doc['healthy']['step_ms']:.3f}ms "
          f"({s.states_priced} state(s) priced, {s.states_resumed} "
          f"resumed, {s.pod_losses} pod loss(es); "
          f"{res.wall_seconds:.2f}s)")
    for r in doc["curve"]:
        lat = r["latency_ms"]
        line = (f"  {r['offered_rps']:8.1f} req/s -> "
                f"{r['goodput_rps']:8.1f} goodput, "
                f"mfu {r['mfu']:.3f}")
        if lat is not None:
            line += (f", p50 {lat['p50']:.1f}ms p99 {lat['p99']:.1f}ms")
        losses = r["losses"]
        line += (f"; lost: {losses['shed']} shed, "
                 f"{losses['deadline']} deadline, "
                 f"{losses['partition']} partition, "
                 f"{losses['restart']} restart")
        if r.get("slo") is not None:
            line += f" -> {'MEETS' if r['slo']['meets'] else 'MISSES'}"
        print(line)
    frontier = doc.get("frontier")
    if frontier is not None:
        for row in frontier["table"]:
            need = row["pods_needed"]
            shown = (str(need) if need is not None
                     else f"MORE THAN {frontier['max_pods']}")
            print(f"  frontier: {row['target_rps']:g} req/s at "
                  f"p{frontier['percentile']:g} <= "
                  f"{frontier['slo_latency_ms']:g}ms needs "
                  f"{shown} pod(s)")
    for r in doc["recovery"]:
        print(f"  recovery: pod {r['pod']} lost at {r['at_s']:.1f}s, "
              f"{r['survivors']} survivor(s), re-shard "
              f"{r['chosen'] or 'none'}, recover in "
              f"{r['time_to_recover_s']:.1f}s")
    for k, v in s.stats_dict().items():
        print(f"  {k} = {v:.0f}")
    bs = getattr(res, "batch_stats", None)
    if bs is not None and (bs.states or bs.lanes_cached or bs.skipped):
        # only-when-active: batch accounting prints only when the
        # lane-axis warm pass actually engaged this run
        for k, v in bs.stats_dict().items():
            print(f"  {k} = {v:.0f}")
    if res.report_path is not None:
        print(f"  report written to {res.report_path}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"  report also written to {args.json}")
    return 0


def _cmd_advise(args: argparse.Namespace) -> int:
    """Parallelism-strategy sweep & sharding advisor: price the
    slices x strategies x meshes cross-product of one traced workload
    through the shared engine-result cache and print the ranked
    step-time / ICI-bytes / HBM-residency / watts table with the
    recommended sharding."""
    from tpusim_torch.advise import AdviseSpecError, run_advise
    from tpusim_torch.analysis import ValidationError

    progress = None
    if args.verbose:
        def progress(msg: str) -> None:
            print(f"  {msg}", file=sys.stderr)
    try:
        res = run_advise(
            args.spec,
            trace_path=args.trace,
            result_cache=args.result_cache,
            workers=args.workers,
            progress=progress,
            compile_cache=args.compile_cache,
        )
    except AdviseSpecError as e:
        print(f"tpusim_torch advise: spec refused ({e.code}): {e}",
              file=sys.stderr)
        return 1
    except ValidationError as e:
        print(f"tpusim_torch advise: spec refused:\n{e}", file=sys.stderr)
        return 1
    doc = res.doc
    cap = doc["capture"]
    print(f"tpusim advise: {doc['advise']!r} spec={doc['spec_hash']} "
          f"trace={doc['trace']}")
    print(f"  capture: {cap['chips']} chips (dp={cap['dp']} "
          f"tp={cap['tp']}), {cap['collective_sites']['tp']} tp / "
          f"{cap['collective_sites']['dp']} dp / "
          f"{cap['collective_sites']['ep']} ep collective sites")
    header = (f"  {'#':>3s} {'cell':26s} {'strategy':8s} "
              f"{'step_ms':>9s} {'ici_mb':>8s} {'coll':>5s} "
              f"{'hbm_gib':>8s} {'exp%':>6s} {'watts':>7s} "
              f"{'pf/W':>7s} flags")
    print(header)
    shown = doc["cells"][: args.top] if args.top else doc["cells"]
    for r in shown:
        flags = []
        if not r["fits_hbm"]:
            flags.append("OOM")
        if r["slo_ok"] is False:
            flags.append("SLO-MISS")
        elif r["slo_ok"] is True:
            flags.append("slo-ok")
        w = f"{r['watts']:.1f}" if r["watts"] is not None else "-"
        pw = (f"{r['perf_per_watt']:.4f}"
              if r["perf_per_watt"] is not None else "-")
        ef = r.get("exposed_comm_frac")
        ef = f"{100.0 * ef:.1f}" if ef is not None else "-"
        print(f"  {r['rank']:3d} {r['cell']:26s} {r['strategy']:8s} "
              f"{r['step_ms']:9.4f} {r['ici_bytes'] / 1e6:8.2f} "
              f"{r['collectives_per_chip']:5d} "
              f"{r['hbm_resident_gib']:8.4f} {ef:>6s} {w:>7s} {pw:>7s} "
              f"{','.join(flags) or 'ok'}")
    for s in doc["skipped"]:
        print(f"      {s['cell']:26s} skipped: {s['reason']}")
    rec = doc["recommendation"]
    if rec is not None:
        print(f"  recommendation: {rec['cell']} "
              f"({rec['strategy']}, mesh {rec['mesh']}) at "
              f"{rec['step_ms']:.4f}ms/step")
    else:
        print("  recommendation: NONE (no feasible cell)")
    for k, v in res.stats.stats_dict().items():
        print(f"  {k} = {v:.0f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"  report written to {args.json}")
    return 0


def _parse_sets(items: list[str] | None) -> dict:
    """``--set k=v`` overrides (ints/floats/json parsed, else string)."""
    out = {}
    for item in items or []:
        k, _, v = item.partition("=")
        try:
            out[k] = json.loads(v)
        except (json.JSONDecodeError, ValueError):
            out[k] = v
    return out


def _cmd_capture(args: argparse.Namespace) -> int:
    from tpusim_torch.models import get_workload
    from tpusim_torch.tracer.capture import capture_to_dir, snapshot_buffers

    wl = get_workload(args.workload)
    # no --device: the builder's own default (cuda; meta for an abstract
    # workload, the reference's ShapeDtypeStruct arguments)
    module, wl_args = wl.build(device=args.device, **_parse_sets(args.set))
    capture_to_dir(
        args.out, module, *wl_args, name=wl.name, launches=args.launches
    )
    if args.snapshot:
        paths = snapshot_buffers(
            module, *wl_args,
            out_dir=Path(args.out) / "checkpoint_files",
            launches=args.launches,
        )
        print(f"{len(paths)} buffer snapshots in {args.out}/checkpoint_files")
    print(f"trace written to {args.out}")
    return 0


def _cmd_lint(args: argparse.Namespace) -> int:
    """Static trace/config/schedule analyzer — the ``lint`` front end
    over :mod:`tpusim_torch.analysis` (stable TLxxx codes, file:line
    anchors, text or JSON output, nonzero exit on errors)."""
    from tpusim_torch.analysis import (
        Severity, analyze_stats_keys, analyze_trace_dir, list_code_lines,
    )
    from tpusim_torch.analysis.diagnostics import Diagnostics

    if args.list_codes:
        for line in list_code_lines():
            print(line)
        return 0
    if args.trace is None and not args.stats_keys \
            and not args.self_audit and not args.campaign \
            and not args.advise:
        print("tpusim_torch lint: nothing to analyze — pass a trace dir, "
              "--campaign, --advise, --stats-keys, --self-audit, or "
              "--list-codes",
              file=sys.stderr)
        return 2
    if args.trace is None and (args.faults or args.config or args.arch
                               or args.perf):
        print("tpusim_torch lint: --faults/--config/--arch/--perf need a trace "
              "dir (the declared topology and capture meta come from it)",
              file=sys.stderr)
        return 2

    diags = Diagnostics()
    perf_docs: list | None = [] if args.perf else None
    if args.trace is not None:
        analyze_trace_dir(
            args.trace, arch=args.arch, overlays=list(args.config or []),
            faults=args.faults, diags=diags, perf=args.perf,
            perf_report=perf_docs,
        )
    if args.campaign or args.advise:
        default_chips = 1
        if args.trace is not None:
            # size the primary slice the way the runners would
            from tpusim_torch.analysis.trace_passes import load_parsed_trace

            default_chips = max(
                load_parsed_trace(args.trace).replay_devices, 1
            )
        if args.campaign:
            from tpusim_torch.analysis import analyze_campaign_spec

            analyze_campaign_spec(
                args.campaign, diags=diags, default_chips=default_chips,
            )
        if args.advise:
            from tpusim_torch.analysis import analyze_advise_spec

            analyze_advise_spec(
                args.advise, diags=diags, default_chips=default_chips,
            )
    if args.stats_keys:
        analyze_stats_keys(diags=diags)
    if args.self_audit:
        from tpusim_torch.analysis import analyze_self_audit

        analyze_self_audit(diags=diags)

    if args.format == "json":
        if perf_docs is not None:
            # perf opt-in: the same document plus the per-module
            # critical-path docs (byte-identical without --perf)
            print(json.dumps(
                {**diags.to_doc(), "perf": perf_docs}, indent=2,
            ))
        else:
            print(diags.to_json())
    else:
        for line in diags.text_lines():
            print(line)
        print(f"tpusim lint: {diags.summary()}")
    gate = diags.has_errors or (
        args.strict and diags.count(Severity.WARNING) > 0
    )
    return 1 if gate else 0


def _cmd_perf_report(args: argparse.Namespace) -> int:
    """``perf-report TRACE`` — the critical-path analyzer's ranked
    exposed-collective and slack tables, one section per module, plus
    any TL5xx findings (text or the raw perf document as JSON)."""
    from tpusim_torch.analysis import analyze_trace_dir
    from tpusim_torch.analysis.diagnostics import Diagnostics

    diags = Diagnostics()
    perf_docs: list = []
    analyze_trace_dir(
        args.trace, arch=args.arch, overlays=list(args.config or []),
        diags=diags, perf=True, perf_report=perf_docs,
    )
    if args.module is not None:
        perf_docs = [d for d in perf_docs if d["module"] == args.module]
        if not perf_docs:
            print(f"tpusim_torch perf-report: no module {args.module!r} in "
                  f"{args.trace}", file=sys.stderr)
            return 2

    if args.format == "json":
        print(json.dumps(
            {**diags.to_doc(), "perf": perf_docs}, indent=2,
        ))
        return 1 if diags.has_errors else 0

    top = max(args.top, 1)
    for doc in perf_docs:
        print(f"== module {doc['module']} (entry {doc['entry']}) ==")
        print(f"  critical path : {doc['critical_path_cycles']:>14.1f} cycles")
        print(f"  serial bound  : {doc['serial_cycles']:>14.1f} cycles")
        print(f"  exposed coll  : {doc['exposed_collective_cycles']:>14.1f}"
              f" of {doc['collective_cycles']:.1f} priced cycles")
        exposures = [
            {**e, "comp": cname}
            for cname, cdoc in doc["computations"].items()
            for e in cdoc["exposures"]
        ]
        exposures.sort(key=lambda e: -e["exposed_cycles"])
        if exposures:
            print(f"  {'collective':28s} {'computation':20s} "
                  f"{'exposed':>10s} {'priced':>10s} {'movable':>10s} mode")
            for e in exposures[:top]:
                mode = "sync" if e["sync"] else "async"
                print(f"  {e['op'][:28]:28s} {e['comp'][:20]:20s} "
                      f"{e['exposed_cycles']:>10.1f} "
                      f"{e['priced_cycles']:>10.1f} "
                      f"{e['movable_cycles']:>10.1f} {mode}")
        rows = [
            {**o, "comp": cname}
            for cname, cdoc in doc["computations"].items()
            for o in cdoc["ops"]
        ]
        rows.sort(key=lambda o: -o["cycles"])
        if rows:
            print(f"  {'op':28s} {'computation':20s} {'cycles':>10s} "
                  f"{'slack':>10s} {'bound':>5s} crit")
            for o in rows[:top]:
                crit = "*" if o["critical"] else ""
                print(f"  {o['op'][:28]:28s} {o['comp'][:20]:20s} "
                      f"{o['cycles']:>10.1f} {o['slack']:>10.1f} "
                      f"{o['bound']:>5s} {crit}")
        print()
    perf_lines = [
        line for d, line in zip(diags.sorted_items(), diags.text_lines())
        if d.code.startswith("TL5")
    ]
    if perf_lines:
        print("findings:")
        for line in perf_lines:
            print(f"  {line}")
    return 1 if diags.has_errors else 0


def _cmd_info(args: argparse.Namespace) -> int:
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    info = {
        "meta": pod.meta,
        "modules": {
            name: {
                "computations": len(m.computations),
                "entry_ops": len(m.entry.ops) if m.entry_name else 0,
                "collectives": len(m.collectives()),
                "num_devices": m.num_devices,
            }
            for name, m in pod.modules.items()
        },
        "devices": {
            d: len(t.commands) for d, t in pod.devices.items()
        },
    }
    print(json.dumps(info, indent=2, default=str))
    return 0


def _cmd_workloads(args: argparse.Namespace) -> int:
    from tpusim_torch.models import list_workloads

    for wl in sorted(list_workloads(), key=lambda w: (w.suite, w.name)):
        print(f"{wl.suite:10s} {wl.name:26s} devices={wl.num_devices:<3d} "
              f"{wl.description}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpusim_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="replay a stored trace")
    ps.add_argument("trace")
    ps.add_argument("--arch", default=None, help="arch preset (v4/v5e/v5p/v6e)")
    ps.add_argument("--config", action="append",
                    help="overlay flag file(s), applied in order")
    ps.add_argument("--json", default=None, help="also write stats JSON here")
    ps.add_argument("--power", action="store_true",
                    help="enable the TPUWattch power model")
    ps.add_argument("--resume-kernel", type=int, default=0,
                    help="fast-forward the first N kernel launches")
    ps.add_argument("--checkpoint-kernel", type=int, default=0,
                    help="stop the replay after N kernel launches")
    ps.add_argument("--resume-op", type=int, default=0,
                    help="fast-forward the first N entry ops inside each "
                         "module replay (sub-kernel resume)")
    ps.add_argument("--checkpoint-op", type=int, default=0,
                    help="stop each module replay after N entry ops "
                         "(sub-kernel checkpoint; drains in-flight async)")
    ps.add_argument("--network-mode", default=None,
                    choices=["analytic", "detailed"],
                    help="ICI model: closed-form schedules or per-packet "
                         "torus network sim (the -network_mode equivalent)")
    ps.add_argument("--lenient-parse", action="store_true",
                    help="skip malformed HLO lines with a counted "
                         "warning instead of raising mid-file (salvage "
                         "mode for damaged captures)")
    ps.add_argument("--pricing-backend", default=None,
                    choices=["auto", "serial", "vectorized", "native"],
                    help="pin the tpusim_torch.fastpath pricing backend "
                         "(byte-identical; default auto = vectorized; also "
                         "via $TPUSIM_PRICING_BACKEND; native is not "
                         "ported yet and raises) and stamp fastpath_* "
                         "stats on the report")
    ps.add_argument("--faults", default=None, metavar="SCHEDULE.json",
                    help="fault schedule (dead/degraded ICI links, chip "
                         "stragglers, HBM throttles, DCN faults — see "
                         "ci/faults_schema.json); stamps faults_* stats")
    ps.add_argument("--workers", type=int, default=None, metavar="N",
                    help="fan module pricing over N processes "
                         "(default: $TPUSIM_WORKERS, else serial); "
                         "bit-identical to the serial replay")
    ps.add_argument("--result-cache", nargs="?", const=True, default=None,
                    metavar="DIR",
                    help="memoize engine results on disk (default dir "
                         ".tpusim_cache/): a warm re-run prices nothing "
                         "and reproduces the same stats byte for byte; "
                         "stamps cache_* stats")
    ps.add_argument("--cache-quota", default=None, metavar="SIZE",
                    help="bound the disk store (e.g. 512M, 2G); implies "
                         "--result-cache and garbage-collects least-"
                         "recently-used records past the quota; stamps "
                         "guard_* stats")
    ps.add_argument("--compile-cache", nargs="?", const=True, default=None,
                    metavar="DIR",
                    help="durable compiled-module tier (default dir "
                         ".tpusim_cache/, beside the result records): "
                         "compiled pricing columns persist across "
                         "processes, so a warm store prices from mapped "
                         "columns with zero IR built; stamps fastpath_* "
                         "stats")
    ps.add_argument("--validate", nargs="?", const="on", default=None,
                    choices=["on", "strict"], metavar="on|strict",
                    help="pre-flight the trace/config/schedule through "
                         "the static analyzer (lint) and refuse "
                         "to replay on error-level diagnostics; "
                         "--validate=strict also refuses on warnings. "
                         "NOTE: bare --validate greedily binds a "
                         "following positional, so place it AFTER the "
                         "trace path or use the = form")
    ps.set_defaults(fn=_cmd_simulate)

    pfa = sub.add_parser(
        "faults",
        help="single-link-failure sweep: worst-case step-time inflation "
             "over every dead-link scenario (degraded-pod what-ifs)",
    )
    pfa.add_argument("--arch", default="v5p")
    pfa.add_argument("--chips", type=int, default=64,
                     help="pod size to sweep (default 64 = v5p 4x4x4)")
    pfa.add_argument("--kind", default="all-reduce",
                     help="collective to price per scenario "
                          "(analytic sweep)")
    pfa.add_argument("--payload-mb", type=float, default=64.0,
                     help="per-chip payload for the analytic sweep")
    pfa.add_argument("--trace", default=None,
                     help="replay this trace per scenario instead "
                          "(end-to-end step-time inflation; slower)")
    pfa.add_argument("--max-scenarios", type=int, default=16,
                     help="scenario cap for --trace sweeps")
    pfa.add_argument("--top", type=int, default=5,
                     help="how many worst links to print")
    pfa.add_argument("--json", default=None,
                     help="write the full sweep report here")
    pfa.add_argument("--workers", type=int, default=None, metavar="N",
                     help="fan per-link scenarios over N processes "
                          "(default: $TPUSIM_WORKERS, else serial); "
                          "rows merge in link order — byte-identical "
                          "to the serial sweep")
    pfa.add_argument("--result-cache", nargs="?", const=True, default=None,
                     metavar="DIR",
                     help="share one engine-result cache across the "
                          "sweep's replays (--trace sweeps; in-memory "
                          "sharing is always on, this adds the disk "
                          "tier)")
    pfa.add_argument("--compile-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="durable compiled-module tier: every sweep "
                          "scenario shares one compile, persisted "
                          "across runs")
    pfa.set_defaults(fn=_cmd_faults)

    pca = sub.add_parser(
        "cache",
        help="govern a disk store (result and compiled records): stats / "
             "verify (quarantine damaged records) / gc (LRU-collect to a "
             "quota) / clear",
    )
    pca.add_argument("action", choices=["stats", "verify", "gc", "clear"],
                     help="stats: one scan summary; verify: integrity "
                          "sweep quarantining corrupt/stale-format "
                          "records; gc: delete least-recently-used "
                          "records down to --quota/--max-entries; "
                          "clear: remove everything incl. quarantine")
    pca.add_argument("--dir", default=None, metavar="DIR",
                     help="store directory (default: the --result-cache "
                          "default, .tpusim_cache/)")
    pca.add_argument("--quota", default=None, metavar="SIZE",
                     help="gc: byte quota to collect down to "
                          "(e.g. 512M, 2G)")
    pca.add_argument("--max-entries", type=int, default=None, metavar="N",
                     help="gc: record-count quota to collect down to")
    pca.set_defaults(fn=_cmd_cache)

    pcm = sub.add_parser(
        "campaign",
        help="seeded Monte-Carlo compound-fault campaign: N sampled "
             "degradation scenarios per pod slice -> inflation "
             "distributions (p50/p95/p99/max), partition rate, energy "
             "deltas, and the smallest slice meeting a step-time SLO",
    )
    pcm.add_argument("spec", help="campaign spec JSON")
    pcm.add_argument("--trace", required=True,
                     help="trace directory the campaign replays")
    pcm.add_argument("--out", default=None, metavar="DIR",
                     help="campaign state dir: crash-safe journal.jsonl "
                          "+ report.json (required for --resume)")
    pcm.add_argument("--resume", action="store_true",
                     help="continue a killed campaign from the last "
                          "journaled scenario in --out (completed "
                          "scenarios are never re-priced)")
    pcm.add_argument("--workers", type=int, default=None, metavar="N",
                     help="fan each replay's module pricing over N "
                          "processes (scenarios run serially so the "
                          "journal stays a true prefix)")
    pcm.add_argument("--result-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="share the engine-result cache on disk "
                          "(in-memory sharing across scenarios is "
                          "always on; this persists it across runs)")
    pcm.add_argument("--compile-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="durable compiled-module tier: a fresh "
                          "campaign over an already-compiled trace "
                          "parses and compiles nothing "
                          "(tpusim_torch.fastpath.store)")
    pcm.add_argument("--max-wall-s", type=float, default=None, metavar="S",
                     help="cooperative wall-clock budget: the campaign "
                          "cancels at the next scenario boundary with "
                          "everything completed journaled — --resume "
                          "re-prices nothing (exit 3)")
    pcm.add_argument("--no-scenario-batch", action="store_true",
                     help="disable scenario-batched pricing (the "
                          "lane-axis batch pass that warms the result "
                          "cache per slice; report bytes are identical "
                          "either way — this only trades speed for a "
                          "pure per-state walk)")
    pcm.add_argument("--json", default=None,
                     help="also write the report document here")
    pcm.add_argument("--verbose", action="store_true",
                     help="per-scenario progress on stderr")
    pcm.set_defaults(fn=_cmd_campaign)

    pfl = sub.add_parser(
        "fleet",
        help="traffic-driven fleet digital twin: N simulated serving "
             "pods under an open-loop arrival process with a seeded "
             "fault stream and the serve daemon's admission policies "
             "-> goodput/MFU/p99-vs-load curves, a pods-needed "
             "capacity frontier, energy per request, and per-policy "
             "loss attribution",
    )
    pfl.add_argument("spec", help="fleet spec JSON")
    pfl.add_argument("--trace", required=True,
                     help="trace directory the fleet serves")
    pfl.add_argument("--out", default=None, metavar="DIR",
                     help="fleet state dir: crash-safe journal.jsonl "
                          "+ report.json (required for --resume)")
    pfl.add_argument("--resume", action="store_true",
                     help="continue a killed fleet run from its "
                          "journal in --out (journaled pricing "
                          "intervals are never re-priced)")
    pfl.add_argument("--workers", type=int, default=None, metavar="N",
                     help="fan each replay's module pricing over N "
                          "processes (states price serially so the "
                          "journal stays a true prefix)")
    pfl.add_argument("--result-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="share the engine-result cache on disk "
                          "(in-memory sharing across states is "
                          "always on; this persists it across runs)")
    pfl.add_argument("--compile-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="durable compiled-module tier: a fresh "
                          "fleet run over an already-compiled trace "
                          "parses and compiles nothing "
                          "(tpusim_torch.fastpath.store)")
    pfl.add_argument("--max-wall-s", type=float, default=None, metavar="S",
                     help="cooperative wall-clock budget: the run "
                          "cancels at the next pricing/cell boundary "
                          "with everything priced so far journaled — "
                          "--resume re-prices nothing (exit 3)")
    pfl.add_argument("--no-scenario-batch", action="store_true",
                     help="disable scenario-batched pricing (the "
                          "lane-axis batch pass that warms the result "
                          "cache per pod; report bytes are identical "
                          "either way — this only trades speed for a "
                          "pure per-state walk)")
    pfl.add_argument("--json", default=None,
                     help="also write the report document here")
    pfl.add_argument("--verbose", action="store_true",
                     help="per-state/per-cell progress on stderr")
    pfl.set_defaults(fn=_cmd_fleet)

    pad = sub.add_parser(
        "advise",
        help="parallelism-strategy sweep & sharding advisor: price the "
             "slices x strategies x meshes cross-product of one traced "
             "workload on modeled tori -> ranked step-time/ICI-bytes/"
             "HBM/watts table + recommended sharding",
    )
    pad.add_argument("spec", help="advise spec JSON (see "
                                  "docs/ARCHITECTURE.md)")
    pad.add_argument("--trace", required=True,
                     help="trace directory of the workload to advise on")
    pad.add_argument("--top", type=int, default=0,
                     help="print only the best N cells (0 = all)")
    pad.add_argument("--workers", type=int, default=None, metavar="N",
                     help="fan each cell's module pricing over N "
                          "processes (cells run serially so the report "
                          "is byte-identical)")
    pad.add_argument("--result-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="share the engine-result cache on disk "
                          "(in-memory sharing across cells is always "
                          "on; this persists it — a warm re-run prices "
                          "zero engine walks)")
    pad.add_argument("--compile-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="durable compiled-module tier: cell clones "
                          "compile once ever per (content, config) "
                          "(tpusim_torch.fastpath.store)")
    pad.add_argument("--json", default=None,
                     help="also write the ranked report document here")
    pad.add_argument("--verbose", action="store_true",
                     help="per-cell progress on stderr")
    pad.set_defaults(fn=_cmd_advise)


    pc = sub.add_parser("capture", help="capture a registered workload")
    pc.add_argument("workload")
    pc.add_argument("out")
    pc.add_argument("--launches", type=int, default=1)
    pc.add_argument("--snapshot", action="store_true",
                    help="also run the workload and dump every output "
                         "buffer per launch to <out>/checkpoint_files/ "
                         "(a multi-device workload runs all its devices' "
                         "programs on the one device)")
    pc.add_argument("--set", action="append", metavar="K=V",
                    help="workload builder parameter override(s)")
    pc.add_argument("--device", default=None,
                    help="device the workload's tensors live on "
                         "(default cuda, or meta for an abstract workload, "
                         "which then refuses --snapshot; cpu runs the "
                         "plain versions)")
    pc.set_defaults(fn=_cmd_capture)

    pli = sub.add_parser(
        "lint",
        help="static trace/config/schedule analyzer: TLxxx diagnostics "
             "with file:line anchors, before anything is priced",
    )
    pli.add_argument("trace", nargs="?", default=None,
                     help="trace directory to analyze")
    pli.add_argument("--arch", default=None,
                     help="config preset to cross-check (default: the "
                          "arch the trace was captured on)")
    pli.add_argument("--config", action="append",
                     help="overlay flag file(s), applied like simulate's")
    pli.add_argument("--faults", default=None, metavar="SCHEDULE.json",
                     help="fault schedule to validate against the "
                          "trace's declared topology")
    pli.add_argument("--campaign", default=None, metavar="SPEC.json",
                     help="campaign spec to validate (TL21x codes: "
                          "format, candidate slices, SLO percentile, "
                          "correlated-group links); works with or "
                          "without a trace dir")
    pli.add_argument("--advise", default=None, metavar="SPEC.json",
                     help="advise spec to validate (TL22x codes: "
                          "format, unknown strategy, mesh "
                          "factorization, arch presets, SLO without "
                          "candidates); works with or without a "
                          "trace dir")
    pli.add_argument("--format", choices=["text", "json"],
                     default="text",
                     help="diagnostic output format (json is the "
                          "machine-readable document)")
    pli.add_argument("--strict", action="store_true",
                     help="exit nonzero on warnings too, not just "
                          "errors")
    pli.add_argument("--stats-keys", action="store_true",
                     help="also audit the repo's obs_/faults_/ici_ "
                          "stats-key namespaces (ownership, collisions, "
                          "schema agreement); exit 0 when the audit is "
                          "clean, 1 on any error-level finding (the "
                          "same gate as trace diagnostics)")
    pli.add_argument("--self-audit", action="store_true",
                     help="run the TL35x determinism/durability "
                          "self-audit over the repo's own sources "
                          "(unseeded RNG / wall-clock in seeded "
                          "subsystems, os.replace without "
                          "fsync-before-replace staging); exit 1 on "
                          "findings")
    pli.add_argument("--perf", action="store_true",
                     help="also run the TL50x performance passes "
                          "(critical path, slack, exposed-communication "
                          "accounting) priced with the composed config; "
                          "--format json carries the per-module "
                          "critical-path document under a 'perf' key")
    pli.add_argument("--list-codes", action="store_true",
                     help="print the diagnostic registry grouped by "
                          "family with the owning pass module, and "
                          "exit")
    pli.set_defaults(fn=_cmd_lint)

    ppr = sub.add_parser(
        "perf-report",
        help="static perf verdict for a trace: ranked exposed-collective "
             "and slack tables from the critical-path analyzer, plus the "
             "TL5xx diagnostics",
    )
    ppr.add_argument("trace", help="trace directory to analyze")
    ppr.add_argument("--arch", default=None,
                     help="config preset to price with (default: the "
                          "arch the trace was captured on)")
    ppr.add_argument("--config", action="append",
                     help="overlay flag file(s), applied like simulate's")
    ppr.add_argument("--module", default=None,
                     help="report only this module (default: all)")
    ppr.add_argument("--top", type=int, default=10,
                     help="rows per ranked table (default 10)")
    ppr.add_argument("--format", choices=["text", "json"],
                     default="text",
                     help="text tables or the raw perf document")
    ppr.set_defaults(fn=_cmd_perf_report)

    pi = sub.add_parser("info", help="describe a stored trace")
    pi.add_argument("trace")
    pi.set_defaults(fn=_cmd_info)

    pw = sub.add_parser("workloads", help="list registered workloads")
    pw.set_defaults(fn=_cmd_workloads)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError, RuntimeError) as e:
        # RuntimeError covers a missing card and a capture graph node the
        # port cannot lower yet (NotImplementedError)
        print(f"tpusim_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

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
                                    [--max-wall-s S] [--max-rss SIZE]
                                    [--validate[=on|strict]]
                                    [--obs-out DIR [--obs-window-cycles N]]
    python -m tpusim_torch profile  <trace-dir> [--arch A] [--top N]
                                    [--result-cache[=DIR]]
    python -m tpusim_torch timeline <trace-dir> <out.json> [--module M]
                                    [--arch A] [--counters]
                                    [--obs-window-cycles N]
    python -m tpusim_torch aerial   <trace-dir> [--module M] [--arch A]
                                    [--sample N] [--gz F] [--power]
    python -m tpusim_torch debug    <trace-dir> [--module M] [--arch A]
    python -m tpusim_torch bbv      <trace-dir> [--module M] [--interval N]
                                    [--out F]
    python -m tpusim_torch occupancy <trace-dir> [--module M] [--arch A]
                                    [--limit N]
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
                                    [--resume] [--workers N] [--nodes N]
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
    python -m tpusim_torch serve    [--host H] [--port P] [--trace-root DIR]
                                    [--max-inflight N] [--queue-depth N]
                                    [--deadline-s S] [--serve-workers N]
                                    [--result-cache[=DIR]] [--state-dir DIR]
                                    [--compile-cache[=DIR]] [--hot-cache[=DIR]]
                                    [--cache-quota SIZE] [--max-rss SIZE]
                                    [--max-worker-rss SIZE] [--join HOST:PORT]
                                    [--acceptors N] [--strict-lint]
                                    [--trace-requests]
                                    [--access-log[=PATH]] [...]
    python -m tpusim_torch serve-bench [--url U] [--trace-root DIR]
                                    [--concurrency N] [--requests N]
                                    [--trace T]... [--arch A]
                                    [--no-cli-baseline] [--serve-workers N]
                                    [--worker-sweep N,..]
                                    [--acceptor-sweep N,..] [--no-hot-cache]
                                    [--loadgen-procs N] [--reps N] [--json F]
    python -m tpusim_torch tune     [--arch A] [--out PATH|auto|''] [--device D]
    python -m tpusim_torch tune     --power [--arch A] [--out DIR]
    python -m tpusim_torch run      -B SUITE -C ARCH[+NAMED],... [-o DIR]
                                    [--traces DIR] [--yaml F] [--capture]
                                    [--parallel N] [--power] [--obs]
                                    [--monitor-interval S]
                                    [--result-cache DIR]
    python -m tpusim_torch correlate-ops <workload> [--arch A] [--iters N]
                                    [--top N] [--json F] [--set K=V]
                                    [--device cuda|cpu]
    python -m tpusim_torch stats-diff <old-run-dir> <new-run-dir>
                                    [--rel-tol R] [--check]
    python -m tpusim_torch derive-arch [--src v5e] [--dst v5p] [--out F]
    python -m tpusim_torch correl-regen [--artifact F] [--fixtures DIR]
                                    [--arch v5e] [--out F] [--workers N]
    python -m tpusim_torch refine   [--fixtures DIR] [--arch A] [--seed F]
                                    [--sweeps N] [--out F]
                                    [--per-op-artifact F] [--no-per-op]
                                    [--anchor W]
    python -m tpusim_torch loo      [--fixtures DIR] [--arch A]
                                    [--per-op-artifact F] [--sweeps N]
                                    [--anchor W] [--out F]
    python -m tpusim_torch info     <trace-dir>
    python -m tpusim_torch workloads

The output format is the reference's (errors and refusals on stderr
under the ``tpusim_torch`` prefix; a cancelled simulate, campaign or
fleet run exits 3 — ``simulate --max-wall-s`` and ``--max-rss`` cancel
cooperatively — a bad size 2, a refused spec 1; ``lint`` exits 1 on
errors, and on warnings under ``--strict``).  ``lint --self-audit`` and
``--stats-keys`` audit the port's own sources.  ``simulate``, ``serve``,
``profile`` and the trace tools (``timeline``, ``aerial``, ``debug``,
``bbv``, ``occupancy``) are host commands: they take no ``--device`` and
make no CUDA tensor; neither do ``serve --acceptors``, the forked nodes
of ``campaign --nodes`` (which refuses ``cuda`` scenario batching) and
``serve-bench``, whose processes are all ``python -m tpusim_torch``.
``run`` captures missing traces (``--capture``) through ``python -m
tpusim_torch capture``, on the card.  Deviations from the reference's
defaults: ``correl-regen`` and ``loo`` write under :data:`PORT_REPORTS`
(``build/tpusim_torch_reports/``), not over the JAX package's committed
``reports/correl_ops.json`` and ``reports/loo.json``, which they still
read as input; ``tune --power`` writes under
``build/tpusim_torch_reports/power_fitted/``, not over the committed
fitted coefficients; ``tune`` without ``--power`` times its
microbenchmarks on the card (``--device``) and ``--out auto`` (the
default) writes ``build/tpusim_torch_reports/tuned/<arch>.tuned.flags``,
not ``configs/`` — ``TPUSIM_TUNED_DIR=build/tpusim_torch_reports/tuned``
applies it.  ``correlate-ops`` profiles its workload on the card
(``--device``; ``--set`` resizes it as ``capture``'s does).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: where ``correl-regen`` and ``loo`` write by default: the JAX package's
#: committed ``reports/`` artifacts carry its model version and stay its own
PORT_REPORTS = Path("build") / "tpusim_torch_reports"


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
    obs = None
    if args.obs_window_cycles and not args.obs_out:
        print("tpusim_torch: error: --obs-window-cycles requires --obs-out "
              "(nothing would be sampled or written)", file=sys.stderr)
        return 2
    if args.obs_out:
        from tpusim_torch.obs import Instrumentation

        obs = Instrumentation(window_cycles=args.obs_window_cycles)
    faults = None
    if args.faults:
        from tpusim_torch.faults import load_fault_schedule

        faults = load_fault_schedule(args.faults)
    # --cache-quota bounds the disk store: it implies --result-cache and
    # governs the compile tier's publishes too (one quota, one directory);
    # --max-wall-s arms a cooperative deadline token; --max-rss mounts the
    # memory watchdog whose terminal shed step cancels the run cleanly
    result_cache = args.result_cache
    compile_cache = args.compile_cache
    cancel = None
    watchdog = None
    try:
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
                compile_cache = as_compile_store(compile_cache,
                                                 quota_bytes=quota)
        if args.max_wall_s:
            from tpusim_torch.guard.cancel import CancelToken

            cancel = CancelToken.after(args.max_wall_s)
        if args.max_rss:
            from tpusim_torch.guard.cancel import CancelToken
            from tpusim_torch.guard.store import parse_size
            from tpusim_torch.guard.watchdog import (
                MemoryWatchdog,
                default_ladder,
            )
            from tpusim_torch.perf.cache import as_result_cache

            if cancel is None:
                cancel = CancelToken()
            # the ladder's shrink step needs the live ResultCache, not the
            # raw flag value (True / a dir path): coerce here and hand the
            # same instance to simulate_trace below
            result_cache = as_result_cache(result_cache)
            watchdog = default_ladder(
                MemoryWatchdog(
                    soft_bytes=None,
                    hard_bytes=parse_size(args.max_rss),
                    on_shed=lambda: cancel.cancel(
                        "RSS passed --max-rss with every droppable "
                        "store already shed"
                    ),
                ),
                result_cache=result_cache,
            ).start()
    except ValueError as e:
        print(f"tpusim_torch: error: {e}", file=sys.stderr)
        return 2
    from tpusim_torch.guard.cancel import OperationCancelled

    try:
        report = simulate_trace(
            args.trace, arch=args.arch, overlays=overlays, obs=obs,
            faults=faults, lenient=args.lenient_parse,
            validate=args.validate, result_cache=result_cache,
            workers=args.workers, pricing_backend=args.pricing_backend,
            cancel=cancel, compile_cache=compile_cache,
        )
    except OperationCancelled as e:
        # the clean refusal: nothing half-written, caches warm on disk
        print(f"tpusim_torch simulate: cancelled: {e}", file=sys.stderr)
        return 3
    finally:
        if watchdog is not None:
            watchdog.stop()
    if args.power and report.power is not None:
        print(report.power.report_text())
    if obs is not None:
        from tpusim_torch.obs import write_obs_dir

        with obs.span("export"):
            paths = write_obs_dir(args.obs_out, report, obs=obs)
        n_win = report.samples.num_windows if report.samples else 0
        w_cyc = report.samples.window_cycles if report.samples else 0
        print(f"obs: {n_win} windows x {w_cyc:.0f} cycles -> "
              + ", ".join(str(p) for p in paths.values()))
        s = report.samples
        if s is not None and s.pinned and s.coarsenings:
            print(f"obs: warning: requested window "
                  f"{args.obs_window_cycles:.0f} cycles exceeded the "
                  f"{s.max_windows}-window memory cap; coarsened "
                  f"{2 ** s.coarsenings}x to {s.window_cycles:.0f} cycles",
                  file=sys.stderr)
        # refresh the obs stats snapshot now that the simulate/export
        # spans have closed (the driver snapshotted mid-span)
        report.stats.update(obs.stats_dict(), prefix="obs_")
    report.print_report()
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.stats.to_json() + "\n")
    return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    """Pipeline self-profiling — where does the SIMULATOR spend host
    time: a per-phase wall-clock/peak-RSS table from the obs span tree,
    plus the top-N costliest simulated ops."""
    import time

    from tpusim_torch.obs import Instrumentation

    t_enter = time.perf_counter()
    # sample=False: the point is the breakdown of a NORMAL simulation's
    # host time — per-op sampler feeds would skew the very table printed
    obs = Instrumentation(sample=False)
    with obs.span("init"):
        # the package imports the replay needs, torch included (the engine
        # reaches it through the pricing module), count under `init`
        from tpusim_torch.fastpath import price  # noqa: F401
        from tpusim_torch.sim.driver import simulate_trace

    report = simulate_trace(
        args.trace, arch=args.arch, obs=obs,
        result_cache=args.result_cache,
    )

    with obs.span("report"):
        totals = report.totals
        op_rows = sorted(
            totals.per_op_cycles.items(), key=lambda kv: -kv[1]
        )[:args.top]
    total_wall = time.perf_counter() - t_enter

    arch = report.arch_config
    print(f"tpusim profile: {args.trace}")
    print(f"  arch={report.config_name} devices={report.num_devices} "
          f"kernels={len(report.kernels)} sim_cycles={report.cycles:.4g}")
    print(f"  wall={total_wall:.3f}s sim_rate={report.sim_rate_kops:.1f} "
          f"kops/s silicon_slowdown="
          f"{report.silicon_slowdown(arch.clock_hz):.3g}")
    print()
    for line in obs.profile_lines(total_wall):
        print(line)
    if args.result_cache is not None:
        # cache effectiveness: hits mean skipped engine walks
        s = report.stats
        print(f"  result cache: {s.get('cache_hits', 0):.0f} hits, "
              f"{s.get('cache_misses', 0):.0f} misses "
              f"({s.get('cache_disk_hits', 0):.0f} from disk, "
              f"{s.get('cache_disk_errors', 0):.0f} corrupt)")
    print()
    print(f"top {len(op_rows)} costliest ops "
          f"(of {totals.op_count} simulated):")
    print(f"  {'op':40s} {'opcode':18s} {'cycles':>12s} "
          f"{'count':>8s} {'% cycles':>9s}")
    # per_op_cycles accumulates across every launch on every replayed
    # device, so normalize by total device-time, not the pod makespan
    device_time = sum(report.device_cycles.values()) or report.cycles
    for name, cyc in op_rows:
        opcode = totals.per_op_opcode.get(name, "?")
        count = totals.per_op_count.get(name, 0.0)
        pct = 100.0 * cyc / device_time if device_time else 0.0
        print(f"  {name[:40]:40s} {opcode[:18]:18s} {cyc:12.4g} "
              f"{count:8.0f} {pct:8.2f}%")
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
    from tpusim_torch.campaign import (
        JournalError, run_campaign, run_sharded_campaign,
    )
    from tpusim_torch.guard.cancel import CancelToken, OperationCancelled

    progress = None
    if args.verbose:
        def progress(msg: str) -> None:
            print(f"  {msg}", file=sys.stderr)
    cancel = None
    if getattr(args, "max_wall_s", None):
        cancel = CancelToken.after(args.max_wall_s)
    nodes = getattr(args, "nodes", None)
    if nodes is not None and nodes > 1 and not args.out:
        print("tpusim_torch campaign: --nodes needs --out DIR (the "
              "per-node journal shards and merged report live there)",
              file=sys.stderr)
        return 2
    try:
        if nodes is not None and nodes > 1:
            res = run_sharded_campaign(
                args.spec,
                trace_path=args.trace,
                out_dir=args.out,
                nodes=nodes,
                resume=args.resume,
                result_cache=args.result_cache,
                workers=args.workers,
                progress=progress,
                compile_cache=args.compile_cache,
                scenario_batch=(
                    False if args.no_scenario_batch else None),
            )
        else:
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


def _cmd_serve_front(args: argparse.Namespace) -> int:
    """The multi-acceptor front tier — N acceptor processes sharing the
    listen port via SO_REUSEPORT (fd-passing fallback), each with its own
    HTTP parse + admission, against shared hot-cache / disk-cache /
    quarantine state."""
    import tempfile

    from tpusim_torch.serve.front import FrontSupervisor, reuse_port_available

    ephemeral_quarantine = None
    if args.state_dir:
        quarantine_dir = str(Path(args.state_dir) / "quarantine")
    else:
        # no state dir: the shared quarantine is run-scoped — reclaim
        # it after the drain or restarts would litter the temp dir
        ephemeral_quarantine = tempfile.mkdtemp(
            prefix="tpusim-serve-quar-"
        )
        quarantine_dir = ephemeral_quarantine
    settings = {
        "trace_root": args.trace_root,
        "max_inflight": args.max_inflight,
        "queue_depth": args.queue_depth,
        "deadline_s": args.deadline_s,
        "max_request_bytes": args.max_request_bytes,
        "result_cache": args.result_cache,
        "workers": args.workers or 1,
        "workers_per_acceptor": args.serve_workers,
        "min_workers": args.serve_min_workers,
        "job_workers": max(args.job_workers, 1),
        "drain_grace_s": args.drain_grace_s,
        "state_dir": args.state_dir,
        "verbose": args.verbose,
        "disk_quota": args.cache_quota,
        "max_rss": args.max_rss,
        "max_worker_rss": args.max_worker_rss,
        "compile_cache": args.compile_cache,
        "hot_cache": args.hot_cache,
        "strict_lint": args.strict_lint,
        "trace_requests": args.trace_requests,
        "access_log": args.access_log,
        "quarantine_dir": quarantine_dir,
        "join_addr": args.join,
        "join_min_nodes": args.cluster_min_nodes,
    }
    front = FrontSupervisor(
        settings, num_acceptors=args.acceptors,
        host=args.host, port=args.port,
    )
    try:
        front.start()
    except (OSError, RuntimeError, ValueError) as e:
        print(f"tpusim_torch serve: error: {e}", file=sys.stderr)
        return 2
    front.install_signal_handlers()
    mode = "SO_REUSEPORT" if reuse_port_available() else "fd-passing"
    hot_note = ", hot-cache on" if args.hot_cache else ""
    join_note = f", join {args.join}" if args.join else ""
    print(f"tpusim_torch serve: listening on "
          f"http://{front.host}:{front.port} "
          f"(traces: {args.trace_root or 'inline only'}; "
          f"acceptors {args.acceptors} via {mode}"
          f"{hot_note}{join_note})",
          flush=True)
    front.wait_stopped()
    if ephemeral_quarantine is not None:
        import shutil

        shutil.rmtree(ephemeral_quarantine, ignore_errors=True)
    print("tpusim_torch serve: drained, exiting", flush=True)
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    """Long-running simulation service (:mod:`tpusim_torch.serve`): JSON
    API over HTTP with hot traces, admission control, a process-wide
    shared engine-result cache, and SIGTERM drain; ``--acceptors N``
    serves through the front tier.  A host command: it makes no CUDA
    tensor."""
    from tpusim_torch.serve.daemon import ServeDaemon

    if args.acceptors and args.acceptors > 0:
        return _cmd_serve_front(args)
    try:
        daemon = ServeDaemon(
            trace_root=args.trace_root,
            host=args.host,
            port=args.port,
            max_inflight=args.max_inflight,
            queue_depth=args.queue_depth,
            deadline_s=args.deadline_s,
            max_request_bytes=args.max_request_bytes,
            result_cache=args.result_cache,
            workers=args.workers or 1,
            serve_workers=args.serve_workers,
            min_workers=args.serve_min_workers,
            # clamp at 1: job_workers=0 is the in-process test hook
            # (accept + persist jobs without draining them); a served
            # daemon must always drain its queue
            job_workers=max(args.job_workers, 1),
            drain_grace_s=args.drain_grace_s,
            state_dir=args.state_dir,
            verbose=args.verbose,
            cache_quota=args.cache_quota,
            max_rss=args.max_rss,
            max_worker_rss=args.max_worker_rss,
            compile_cache=args.compile_cache,
            hot_cache=args.hot_cache,
            strict_lint=args.strict_lint,
            trace_requests=args.trace_requests,
            access_log=args.access_log,
            cluster_join=args.join,
            cluster_min_nodes=args.cluster_min_nodes,
        )
    except ValueError as e:
        # a quota/size typo must refuse loudly, not bound nothing
        print(f"tpusim_torch serve: error: {e}", file=sys.stderr)
        return 2
    daemon.install_signal_handlers()
    daemon.start()
    # the bound port line is the startup contract: --port 0 asks the
    # kernel for a free port, and wrappers (tests, chip_smoke.py, shell
    # scripts) parse this line to find it
    workers_note = (
        f", serve-workers {args.serve_workers}" if args.serve_workers
        else ""
    )
    join_note = f", join {args.join}" if args.join else ""
    print(f"tpusim_torch serve: listening on "
          f"http://{daemon.host}:{daemon.port} "
          f"(traces: {args.trace_root or 'inline only'}; "
          f"max-inflight {args.max_inflight}, queue {args.queue_depth}"
          f"{workers_note}{join_note})",
          flush=True)
    daemon.wait_stopped()
    print("tpusim_torch serve: drained, exiting", flush=True)
    return 0


def _cmd_serve_bench(args: argparse.Namespace) -> int:
    """Loadgen for the serving daemon: replay a fixture request mix at a
    target concurrency, report p50/p95/p99 + throughput, and compare the
    warm served path against the cold one-shot CLI (every process it
    starts is ``python -m tpusim_torch``)."""
    from tpusim_torch.serve.bench import (
        format_acceptor_sweep, format_report, format_sweep,
        run_acceptor_sweep, run_serve_bench, run_worker_sweep,
    )

    mix = None
    if args.trace:
        mix = [
            {"trace": t, "arch": args.arch}
            for t in args.trace
        ]
    if args.acceptor_sweep:
        try:
            counts = [int(c) for c in args.acceptor_sweep.split(",") if c]
        except ValueError:
            print(f"tpusim_torch serve-bench: --acceptor-sweep wants a "
                  f"comma-separated int list, got {args.acceptor_sweep!r}")
            return 2
        doc = run_acceptor_sweep(
            acceptor_counts=counts,
            trace_root=args.trace_root,
            concurrency=args.concurrency,
            requests=args.requests,
            mix=mix,
            hot_cache=not args.no_hot_cache,
            serve_workers=args.serve_workers,
            reps=args.reps,
            loadgen_procs=args.loadgen_procs,
        )
        print(format_acceptor_sweep(doc))
        failed = any(
            leg["error_count"] for leg in doc["acceptor_sweep"]
        )
    elif args.worker_sweep:
        try:
            counts = [int(c) for c in args.worker_sweep.split(",") if c]
        except ValueError:
            print(f"tpusim_torch serve-bench: --worker-sweep wants a "
                  f"comma-separated int list, got {args.worker_sweep!r}")
            return 2
        doc = run_worker_sweep(
            worker_counts=counts,
            trace_root=args.trace_root,
            concurrency=args.concurrency,
            requests=args.requests,
            mix=mix,
            cli_baseline=not args.no_cli_baseline,
            reps=args.reps,
        )
        print(format_sweep(doc))
        failed = any(
            leg["error_count"] for leg in doc["worker_sweep"]
        )
    else:
        doc = run_serve_bench(
            url=args.url,
            trace_root=args.trace_root,
            concurrency=args.concurrency,
            requests=args.requests,
            mix=mix,
            cli_baseline=not args.no_cli_baseline,
            serve_workers=args.serve_workers,
            reps=args.reps,
        )
        print(format_report(doc))
        failed = bool(doc.get("error_count") or doc.get("errors"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"report written to {args.json}")
    return 1 if failed else 0


def _cmd_tune(args: argparse.Namespace) -> int:
    """``tune --power``: fit power coefficients (telemetry when a source
    answers, anchor fixtures otherwise) into ``--out`` (default
    :data:`tpusim_torch.harness.tuner.POWER_OUT`).  ``tune``: fit the
    arch knobs from microbenchmarks timed on ``--device`` (default the
    card), print the result and write the overlay to ``--out`` (default
    ``auto`` = :data:`~tpusim_torch.harness.tuner.TUNED_OUT`
    ``/<arch>.tuned.flags``; ``''`` writes nothing)."""
    import dataclasses

    from tpusim_torch.harness.tuner import (
        TUNED_OUT, tune, tune_power, write_overlay,
    )

    if args.power:
        path = tune_power(args.arch or "v5e", out_dir=args.out)
        print(f"fitted power coefficients written to {path}")
        return 0
    result = tune(args.arch, device=args.device)
    print(json.dumps(dataclasses.asdict(result), indent=2))
    out = "auto" if args.out is None else args.out
    if out == "auto":
        out = TUNED_OUT / f"{result.base_arch}.tuned.flags"
        out.parent.mkdir(parents=True, exist_ok=True)
    if out:
        write_overlay(result, out)
        print(f"overlay written to {out} (TPUSIM_TUNED_DIR={Path(out).parent} "
              f"applies <arch>.tuned.flags)")
    return 0


def _cmd_correlate_ops(args: argparse.Namespace) -> int:
    """Per-op sim-vs-silicon correlation for one workload on its device
    (plot-correlation.py at HLO-instruction grain)."""
    from tpusim_torch.harness.correl_ops import (
        correlate_workload_ops, write_correl_ops,
    )
    from tpusim_torch.models import get_workload

    wl = get_workload(args.workload)
    fn, wl_args = wl.build(device=args.device, **_parse_sets(args.set))
    corr = correlate_workload_ops(
        fn, wl_args, name=wl.name, arch=args.arch, iters=args.iters,
    )
    print(f"matched {len(corr.rows)} ops "
          f"({corr.matched_time_fraction:.0%} of device time); "
          f"sync-op weighted |error| = "
          f"{corr.sync_weighted_abs_error_pct:.1f}% "
          f"(all rows {corr.weighted_abs_error_pct:.1f}%)")
    for r in corr.worst(args.top):
        print(f"  {r.name:40s} {r.opcode:16s} "
              f"sim={r.sim_ns:10.0f}ns real={r.real_ns:10.0f}ns "
              f"err={r.error_pct:+7.1f}%")
    if args.json:
        p = write_correl_ops([corr], args.json)
        print(f"report written to {p}")
    return 0


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


def _pick_module(pod, name):
    if name:
        return pod.modules[name]
    if not pod.modules:
        raise KeyError("trace has no modules")
    return pod.modules[sorted(pod.modules)[0]]


def _cmd_debug(args: argparse.Namespace) -> int:
    from tpusim_torch.sim.debugger import Debugger
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    mod = _pick_module(pod, args.module)
    Debugger(mod, load_config(arch=args.arch)).repl()
    return 0


def _cmd_timeline(args: argparse.Namespace) -> int:
    from tpusim_torch.sim.traceviz import write_chrome_trace
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.trace.format import load_trace

    if args.obs_window_cycles and not args.counters:
        print("tpusim_torch: error: --obs-window-cycles requires --counters",
              file=sys.stderr)
        return 2
    pod = load_trace(args.trace)
    mod = _pick_module(pod, args.module)
    cfg = load_config(arch=args.arch)
    obs = None
    if args.counters:
        from tpusim_torch.obs import Instrumentation

        obs = Instrumentation(window_cycles=args.obs_window_cycles)
    res = Engine(cfg, record_timeline=True, obs=obs).run(mod)
    extra = None
    if obs is not None and res.samples is not None:
        from tpusim_torch.obs import counter_track_events, window_rows

        rows = window_rows(res.samples, cfg.arch)
        extra = counter_track_events(rows, cfg.arch.clock_hz)
    write_chrome_trace(
        res, cfg.arch, args.out, process_name=mod.name, extra_events=extra
    )
    n_extra = f" + {len(extra)} counter samples" if extra else ""
    print(f"chrome trace ({len(res.timeline)} events{n_extra}) written to "
          f"{args.out}; open in chrome://tracing or ui.perfetto.dev")
    return 0


def _cmd_aerial(args: argparse.Namespace) -> int:
    from tpusim_torch.sim.interval import (
        render_text_lanes, sample_intervals, write_interval_log,
    )
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.timing.engine import Engine
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    mod = _pick_module(pod, args.module)
    cfg = load_config(arch=args.arch)
    cap = 2_000_000
    res = Engine(cfg, record_timeline=True, max_timeline_events=cap).run(mod)
    if len(res.timeline) >= cap:
        print(f"warning: timeline capped at {cap} events; "
              "the view covers only the first part of the run",
              file=sys.stderr)
    sample = args.sample or cfg.stat_sample_cycles
    samples = sample_intervals(res, sample)
    power = None
    if args.power:
        from tpusim_torch.power.model import power_timeline

        power = power_timeline(
            samples, cfg.arch, cfg.arch.name, dvfs_scale=cfg.dvfs_scale
        )
    if args.gz:
        meta = {"module": mod.name, "arch": cfg.arch.name,
                "sample_cycles": sample}
        if power is not None:
            meta["power_watts"] = [round(w["watts"], 2) for w in power]
        write_interval_log(samples, args.gz, meta=meta)
        print(f"interval log written to {args.gz}")
    print(render_text_lanes(samples), end="")
    if power:
        from tpusim_torch.sim.interval import render_scalar_lane

        watts = [w["watts"] for w in power]
        avg = sum(watts) / len(watts)
        print(render_scalar_lane(
            watts, "power",
            suffix=f" avg {avg:.0f} W peak {max(watts):.0f} W",
        ), end="")
    return 0


def _cmd_bbv(args: argparse.Namespace) -> int:
    from tpusim_torch.tools.bbv import compute_bbv, write_simpoint_bb
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    mod = _pick_module(pod, args.module)
    res = compute_bbv(mod, interval_ops=args.interval)
    print(f"{res.num_intervals} intervals x {args.interval} ops, "
          f"{len(res.dims)} opcode dims")
    if args.out:
        write_simpoint_bb(res, args.out)
        print(f"SimPoint frequency vectors written to {args.out}")
    return 0


def _cmd_occupancy(args: argparse.Namespace) -> int:
    from tpusim_torch.timing.config import load_config
    from tpusim_torch.tools.occupancy import occupancy_report
    from tpusim_torch.trace.format import load_trace

    pod = load_trace(args.trace)
    mod = _pick_module(pod, args.module)
    cfg = load_config(arch=args.arch)
    report = occupancy_report(mod, cfg.arch)
    for line in report.summary_lines(limit=args.limit):
        print(line)
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    from tpusim_torch.harness.runner import run_suite

    rows = run_suite(
        args.suite,
        [c for c in args.configs.split(",") if c],
        args.out,
        trace_root=args.traces,
        yaml_path=args.yaml,
        capture_missing=args.capture,
        parallel=args.parallel,
        power=args.power,
        obs=args.obs,
        monitor_interval_s=args.monitor_interval,
        result_cache=args.result_cache,
    )
    failed = rows.get("__failed__", {}).get("runs", [])
    ok = {k: v for k, v in rows.items() if k != "__failed__"}
    print(f"tpusim run: {len(ok)} runs scraped to {args.out}/stats.csv"
          + (f"; FAILED: {failed}" if failed else ""))
    return 1 if failed else 0


def _cmd_stats_diff(args: argparse.Namespace) -> int:
    """Compare two scraped run trees — the merge-stats compare role
    (two builds / two configs over the same app list)."""
    from tpusim_torch.harness.scrape import diff_stats, scrape_run_dirs

    old = scrape_run_dirs(args.old)
    new = scrape_run_dirs(args.new)
    diffs = diff_stats(old, new, rel_tol=args.rel_tol)
    if not diffs:
        print("no differences")
        return 0
    for run in sorted(diffs):
        if run in ("__only_old__", "__only_new__"):
            side = "only in OLD" if run == "__only_old__" else "only in NEW"
            for r in sorted(diffs[run]):
                print(f"{r}: {side}")
            continue
        for stat, (a, b) in sorted(diffs[run].items()):
            print(f"{run}: {stat} {a} -> {b}")
    return 1 if args.check else 0


def _cmd_derive_arch(args: argparse.Namespace) -> int:
    """Cross-generation overlay derivation (docs/V5P.md)."""
    import os

    from tpusim_torch.timing.derive import derive_overlay

    # default to the directory load_config resolves overlays from
    # ($TPUSIM_TUNED_DIR or <repo>/configs) — a cwd-relative write from
    # elsewhere would never be applied
    base = os.environ.get("TPUSIM_TUNED_DIR") or str(
        Path(__file__).resolve().parents[1] / "configs"
    )
    out = args.out or str(
        Path(base) / f"{args.dst.lower()}.derived.flags"
    )
    lines = derive_overlay(args.src, args.dst, out_path=out)
    print(f"derive-arch: {len([l for l in lines if l.startswith('-')])} "
          f"knobs {args.src} -> {args.dst}, written to {out}")
    return 0


def _cmd_correl_regen(args: argparse.Namespace) -> int:
    """Regenerate the per-op correlation artifact offline: the current
    model replayed against the device durations stored in an existing
    artifact (default: the JAX package's ``reports/correl_ops.json``,
    read only; the output goes under :data:`PORT_REPORTS`)."""
    from tpusim_torch.harness.correl_ops import regenerate_offline

    out = args.out or str(PORT_REPORTS / "correl_ops.json")
    doc = regenerate_offline(
        args.artifact, fixture_dir=args.fixtures, arch=args.arch,
        out_path=out, workers=args.workers,
    )
    print(
        f"correl-regen: {len(doc['workloads'])} workloads, "
        f"mean sync-op weighted |error| = "
        f"{doc['mean_sync_weighted_abs_error_pct']}% "
        f"(all rows {doc['mean_weighted_abs_error_pct']}%), "
        f"model_version {doc['model_version']} "
        f"-> {out}"
    )
    # the async-observable demonstration derives purely from the per-op
    # artifact + manifest; keep it in lockstep with the regen
    try:
        from tpusim_torch.harness.async_observable import (
            analyze_async_observable,
        )

        demo = analyze_async_observable(
            out, Path(args.fixtures) / "manifest.json",
            fixture_dir=args.fixtures, arch=args.arch,
        )
        demo_path = Path(out).parent / "async_observable.json"
        demo_path.write_text(json.dumps(demo, indent=2))
        print(
            f"correl-regen: async-observable evidence refreshed "
            f"({demo['evidence']['occupancy_impossible_rows']} "
            f"occupancy-impossible rows) -> {demo_path}"
        )
    except Exception as e:
        print(f"correl-regen: async evidence FAILED: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
    return 0


def _cmd_refine(args: argparse.Namespace) -> int:
    """Offline replay refinement against the committed silicon fixtures
    — no device needed (the joint fit on the objective the fixtures
    measure)."""
    import math

    from tpusim_torch.harness.refine import (
        load_per_op_rows, refine_arch_on_fixtures, split_held_out,
    )

    fixture_dir = Path(args.fixtures)
    manifest_path = fixture_dir / "manifest.json"
    if not manifest_path.exists():
        print(f"no fixture manifest at {manifest_path}", file=sys.stderr)
        return 1
    manifest = json.loads(manifest_path.read_text())
    arch = args.arch or manifest.get("arch", "v5e")
    seed = [args.seed] if args.seed else []
    # held-out full-model fixtures are validation, never training
    train_entries, per_op_rows, _ = split_held_out(
        manifest.get("workloads", []),
        {} if args.no_per_op else load_per_op_rows(args.per_op_artifact),
    )
    result = refine_arch_on_fixtures(
        arch, train_entries, fixture_dir,
        base_overlays=seed, max_sweeps=args.sweeps,
        per_op_rows=per_op_rows, anchor_weight=args.anchor,
    )
    if not math.isfinite(result.start_err_pct):
        # no fixture replayed: an "overlay" of untouched preset values
        # must not masquerade as a fit
        print(
            f"no fixture workload replayed from {fixture_dir}; "
            f"nothing to refine", file=sys.stderr,
        )
        return 1
    print(f"fixture replay objective: {result.start_err_pct:.2f} -> "
          f"{result.final_err_pct:.2f} "
          f"({result.evals} evals, {result.sweeps} sweeps; "
          f"{result.replayed}/{result.total} fixtures)")
    if result.parts:
        print("  parts: " + ", ".join(
            f"{k}={v:.2f}" for k, v in sorted(result.parts.items())
        ))
    for k, v in sorted(result.changed.items()):
        print(f"  {k} -> {v:.6g}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        lines = result.overlay_lines(manifest.get("device_kind", ""))
        if args.seed:
            # the search ran WITH the seed's non-knob fits applied
            # (host_bandwidth, ici.link_bandwidth ...); the emitted
            # overlay must carry them or it won't reproduce the
            # reported error
            lines += [
                ln for ln in Path(args.seed).read_text().splitlines()
                if ln.startswith("-") and not any(
                    ln.startswith(f"-arch.{k} ") for k in result.values
                )
            ]
        out.write_text("\n".join(lines) + "\n")
        print(f"overlay written to {out}")
    return 0


def _cmd_loo(args: argparse.Namespace) -> int:
    """Leave-one-out validation: the out-of-sample counterpart of the
    in-sample fit.  Writes :data:`PORT_REPORTS`/``loo.json`` by
    default."""
    from tpusim_torch.harness.refine import (
        leave_one_out, load_per_op_rows, split_held_out,
    )

    fixture_dir = Path(args.fixtures)
    manifest_path = fixture_dir / "manifest.json"
    if not manifest_path.exists():
        print(f"no fixture manifest at {manifest_path}", file=sys.stderr)
        return 1
    manifest = json.loads(manifest_path.read_text())
    arch = args.arch or manifest.get("arch", "v5e")
    # held-out full-model fixtures are already out-of-sample by
    # construction; LOO folds cover the training workloads only
    entries, per_op_rows, _ = split_held_out(
        manifest.get("workloads", []),
        load_per_op_rows(args.per_op_artifact),
    )
    doc = leave_one_out(
        arch, entries, fixture_dir,
        per_op_rows=per_op_rows,
        max_sweeps=args.sweeps, anchor_weight=args.anchor,
    )
    for f in doc["folds"]:
        print(f"  held-out {f['workload']:24s} "
              f"err={f['held_out_err_pct']:+8.2f}%  "
              f"(train objective {f['train_objective']:.2f})")
    print(f"loo: mean |held-out error| = {doc['mean_loo_abs_err_pct']}% "
          f"(worst {doc['worst_loo_abs_err_pct']}%) over "
          f"{len(doc['folds'])} folds")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2))
        print(f"written to {out}")
    return 0


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
    ps.add_argument("--max-wall-s", type=float, default=None, metavar="S",
                    help="cooperative wall-clock budget: the replay "
                         "cancels cleanly at the next command/op "
                         "boundary once S seconds elapse (exit 3)")
    ps.add_argument("--max-rss", default=None, metavar="SIZE",
                    help="memory watchdog hard threshold (e.g. 4G): "
                         "past it the degradation ladder sheds caches "
                         "and finally cancels the run cleanly instead "
                         "of meeting the OOM-killer (exit 3)")
    ps.add_argument("--validate", nargs="?", const="on", default=None,
                    choices=["on", "strict"], metavar="on|strict",
                    help="pre-flight the trace/config/schedule through "
                         "the static analyzer (lint) and refuse "
                         "to replay on error-level diagnostics; "
                         "--validate=strict also refuses on warnings. "
                         "NOTE: bare --validate greedily binds a "
                         "following positional, so place it AFTER the "
                         "trace path or use the = form")
    ps.add_argument("--obs-out", default=None, metavar="DIR",
                    help="enable the observability layer and write "
                         "samples.jsonl + trace.json (Perfetto counter "
                         "tracks) + metrics.prom here")
    ps.add_argument("--obs-window-cycles", type=float, default=0.0,
                    help="cycle-window size for the sampler "
                         "(0 = auto: self-coarsening to a bounded "
                         "window count)")
    ps.set_defaults(fn=_cmd_simulate)

    pp = sub.add_parser(
        "profile",
        help="self-profile one replay: per-phase wall-clock/peak-RSS "
             "table (parse/cost/engine/ici/power) + top costliest ops",
    )
    pp.add_argument("trace")
    pp.add_argument("--arch", default=None)
    pp.add_argument("--top", type=int, default=10,
                    help="how many costliest ops to print")
    pp.add_argument("--result-cache", nargs="?", const=True, default=None,
                    metavar="DIR",
                    help="profile a cached replay and report cache "
                         "effectiveness")
    pp.set_defaults(fn=_cmd_profile)

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
    pcm.add_argument("--nodes", type=int, default=None, metavar="N",
                     help="shard scenario batches across N node "
                          "processes by journal signature (requires "
                          "--out): each shard appends to its own "
                          "fsync'd journal, the coordinator merges by "
                          "(slice, index) into a report byte-identical "
                          "to a single-node run; a killed shard "
                          "resumes ELSEWHERE with --resume, re-pricing "
                          "nothing")
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

    psv = sub.add_parser(
        "serve",
        help="simulation-as-a-service daemon: JSON API (simulate/lint/"
             "sweep/campaign/advise/fleet/jobs/healthz/metrics) with "
             "hot traces, admission control, shared result cache, "
             "SIGTERM drain",
    )
    psv.add_argument("--host", default="127.0.0.1")
    psv.add_argument("--port", type=int, default=8642,
                     help="listen port (0 = ask the kernel; the bound "
                          "port is printed on startup)")
    psv.add_argument("--trace-root", default=None, metavar="DIR",
                     help="directory whose subdirectories are servable "
                          "traces (requests name them; no other "
                          "filesystem paths are reachable)")
    psv.add_argument("--max-inflight", type=int, default=4,
                     help="concurrent requests actually executing")
    psv.add_argument("--queue-depth", type=int, default=16,
                     help="requests allowed to wait for a slot before "
                          "new arrivals get 429 + Retry-After")
    psv.add_argument("--deadline-s", type=float, default=30.0,
                     help="default per-request deadline (a queued "
                          "request past it gets 504; requests may "
                          "lower/raise it via deadline_ms, capped)")
    psv.add_argument("--max-request-bytes", type=int,
                     default=8 * 1024 * 1024,
                     help="request-body cap; larger bodies get 413 "
                          "before being read")
    psv.add_argument("--result-cache", nargs="?", const=True, default=None,
                     metavar="DIR",
                     help="add the disk tier to the shared engine-result "
                          "cache (default dir .tpusim_cache/); the "
                          "in-memory tier is always on")
    psv.add_argument("--workers", type=int, default=None, metavar="N",
                     help="per-request pricing workers (default 1)")
    psv.add_argument("--serve-workers", type=int, default=0, metavar="N",
                     help="pre-forked supervised worker processes for "
                          "sync pricing: crash isolation (one bad "
                          "request costs one worker), deadline kills, "
                          "poison-request quarantine, content-hash-"
                          "affinity dispatch (default 0: the single-"
                          "process path)")
    psv.add_argument("--serve-min-workers", type=int, default=1,
                     metavar="N",
                     help="live-worker floor: below it the daemon sheds "
                          "load (503 + Retry-After) instead of queueing "
                          "into a dead pool")
    psv.add_argument("--job-workers", type=int, default=1,
                     help="threads draining the async job queue")
    psv.add_argument("--drain-grace-s", type=float, default=60.0,
                     help="SIGTERM drain budget before giving up on "
                          "in-flight work")
    psv.add_argument("--state-dir", default=None, metavar="DIR",
                     help="persist accepted async job specs (and "
                          "campaign/fleet journals) here: a restarted "
                          "daemon re-enqueues queued/running jobs and "
                          "resumes them from their journals")
    psv.add_argument("--cache-quota", default=None, metavar="SIZE",
                     help="bound the shared disk result cache (e.g. 2G); "
                          "the daemon and every serve-worker garbage-"
                          "collect least-recently-used records past it")
    psv.add_argument("--compile-cache", nargs="?", const=True,
                     default=None, metavar="DIR",
                     help="durable compiled-module tier shared by the "
                          "daemon and every serve-worker: a cold first "
                          "request against a warm store prices from "
                          "mapped columns with zero IR built")
    psv.add_argument("--max-rss", default=None, metavar="SIZE",
                     help="daemon memory watchdog hard threshold: past "
                          "it the degradation ladder shrinks caches, "
                          "drops the compiled tier, forces lean "
                          "streaming, then sheds load (503 + "
                          "Retry-After)")
    psv.add_argument("--max-worker-rss", default=None, metavar="SIZE",
                     help="per-worker RSS cap (serve-workers mode): an "
                          "over-budget idle worker is restarted "
                          "deliberately between requests")
    psv.add_argument("--acceptors", type=int, default=0, metavar="N",
                     help="N acceptor processes sharing the listen "
                          "port via SO_REUSEPORT (fd-passing fallback; "
                          "TPUSIM_NO_REUSEPORT=1 forces it) — each runs "
                          "its own HTTP parse + admission, so no single "
                          "GIL touches every request (default 0: one "
                          "daemon process)")
    psv.add_argument("--join", default=None, metavar="HOST:PORT",
                     help="join the multi-node cluster whose primary "
                          "listens at HOST:PORT: this node registers, "
                          "heartbeats, serves its consistent-hash share "
                          "of trace affinity, and forwards misses one "
                          "hop to the owner; omit on the primary")
    psv.add_argument("--cluster-min-nodes", type=int, default=1,
                     metavar="N",
                     help="shed compute requests (503 + Retry-After) "
                          "while fewer than N cluster members are alive "
                          "(default 1: never shed)")
    psv.add_argument("--hot-cache", nargs="?", const=True, default=None,
                     metavar="DIR",
                     help="shared mmap hot-response cache (default dir "
                          ".tpusim_hot/): warm repeat simulate requests "
                          "are answered straight from the map; "
                          "invalidated by model/format/tuned-overlay "
                          "changes")
    psv.add_argument("--strict-lint", action="store_true",
                     help="refuse (422 + the diagnostics doc) any "
                          "simulate request whose trace-family lint "
                          "passes report errors OR warnings (TL5xx "
                          "advisory); the verdict is cached by content "
                          "hash")
    psv.add_argument("--trace-requests", action="store_true",
                     help="request-scoped tracing: X-Tpusim-Trace on "
                          "every response, phase spans in a bounded "
                          "flight recorder (GET /v1/debug/traces), "
                          "per-route/per-phase latency histograms on "
                          "/metrics")
    psv.add_argument("--access-log", nargs="?", const=True, default=None,
                     metavar="PATH",
                     help="structured JSONL access log (default path "
                          "<state-dir>/access.jsonl, size-rotated)")
    psv.add_argument("--verbose", action="store_true",
                     help="per-request access log on stderr")
    psv.set_defaults(fn=_cmd_serve)

    psb = sub.add_parser(
        "serve-bench",
        help="loadgen for the serve daemon: fixture request mix at a "
             "target concurrency -> p50/p95/p99 + throughput vs the "
             "cold one-shot CLI",
    )
    psb.add_argument("--url", default=None,
                     help="target an already-running daemon (default: "
                          "boot one in-process on a free port)")
    psb.add_argument("--trace-root", default=None, metavar="DIR",
                     help="trace root for the self-booted daemon "
                          "(default: the committed test fixtures)")
    psb.add_argument("--concurrency", type=int, default=8)
    psb.add_argument("--requests", type=int, default=64)
    psb.add_argument("--trace", action="append", default=None,
                     help="fixture trace name(s) for the mix (default: "
                          "llama_tiny_tp2dp2 + matmul_512)")
    psb.add_argument("--arch", default="v5p",
                     help="arch for --trace mix entries")
    psb.add_argument("--no-cli-baseline", action="store_true",
                     help="skip the cold-CLI comparison run")
    psb.add_argument("--serve-workers", type=int, default=0, metavar="N",
                     help="boot the self-hosted daemon with N supervised "
                          "worker processes (default 0 = single-process)")
    psb.add_argument("--worker-sweep", default=None, metavar="N,N,...",
                     help="scaling curve: one warm bench leg per worker "
                          "count (0 = single-process baseline), e.g. "
                          "'0,1,2,4'; overrides --url/--serve-workers")
    psb.add_argument("--acceptor-sweep", default=None, metavar="N,N,...",
                     help="front-tier scaling curve: one warm leg per "
                          "acceptor count against an out-of-process "
                          "front fleet (0 = single-process baseline "
                          "added automatically), e.g. '1,2,4'; the "
                          "loadgen fans over processes so its GIL "
                          "never caps the measurement")
    psb.add_argument("--no-hot-cache", action="store_true",
                     help="acceptor-sweep legs WITHOUT the shared mmap "
                          "hot-response cache (default: on)")
    psb.add_argument("--loadgen-procs", type=int, default=None,
                     metavar="N",
                     help="loadgen processes for --acceptor-sweep "
                          "(default: min(cores, 4), at least 2)")
    psb.add_argument("--reps", type=int, default=3, metavar="N",
                     help="measured storms per leg; each leg reports its "
                          "best-throughput pass (noisy-neighbor armor; "
                          "errors from every pass still count)")
    psb.add_argument("--json", default=None,
                     help="also write the report document here")
    psb.set_defaults(fn=_cmd_serve_bench)

    ptu = sub.add_parser(
        "tune", help="fit arch parameters on the local device (tuner)",
    )
    ptu.add_argument("--arch", default=None)
    ptu.add_argument("--out", default=None,
                     help="overlay destination; 'auto' (the default) = "
                          "build/tpusim_torch_reports/tuned/<arch>.tuned."
                          "flags (TPUSIM_TUNED_DIR applies it; never "
                          "configs/); '' disables writing.  With --power: "
                          "the directory for <arch>.json (default "
                          "build/tpusim_torch_reports/power_fitted/, never "
                          "the committed power/fitted/)")
    ptu.add_argument("--power", action="store_true",
                     help="fit power coefficients instead (telemetry when "
                          "available, anchor fixtures otherwise)")
    ptu.add_argument("--device", default=None,
                     help="where the microbenchmarks run (default cuda; "
                          "cpu times the host, through wall time)")
    ptu.set_defaults(fn=_cmd_tune)


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

    pr = sub.add_parser(
        "run",
        help="run a benchmark suite across configs (run_simulations.py): "
             "fabricate run dirs, execute, monitor, scrape to stats.csv",
    )
    pr.add_argument("-B", "--suite", required=True,
                    help="suite name (built-in registry group or YAML)")
    pr.add_argument("-C", "--configs", required=True,
                    help="comma-separated arch[+named] list, e.g. "
                         "v5p,v5e,v5p+dcn")
    pr.add_argument("-o", "--out", default="runs",
                    help="output root (run dirs, jobs.json, stats.csv)")
    pr.add_argument("--traces", default=None,
                    help="trace root (default <out>/traces)")
    pr.add_argument("--yaml", default=None,
                    help="suite/config YAML (define-all-apps equivalent)")
    pr.add_argument("--capture", action="store_true",
                    help="capture missing traces first (on the card)")
    pr.add_argument("--parallel", type=int, default=None)
    pr.add_argument("--power", action="store_true")
    pr.add_argument("--obs", action="store_true",
                    help="write per-run obs exports (samples.jsonl, "
                         "trace.json, metrics.prom) under each run dir")
    pr.add_argument("--monitor-interval", type=float, default=10.0)
    pr.add_argument("--result-cache", default=None, metavar="DIR",
                    help="shared on-disk engine-result cache every "
                         "simulate cell mounts (repeat cells price "
                         "nothing)")
    pr.set_defaults(fn=_cmd_run)

    pco = sub.add_parser(
        "correlate-ops",
        help="per-op sim-vs-silicon correlation for a workload (live)",
    )
    pco.add_argument("workload")
    pco.add_argument("--arch", default=None)
    pco.add_argument("--iters", type=int, default=3)
    pco.add_argument("--top", type=int, default=10)
    pco.add_argument("--json", default=None, help="write correl_ops.json")
    pco.add_argument("--set", action="append", metavar="K=V",
                     help="override a workload parameter (repeatable)")
    pco.add_argument("--device", default=None,
                     help="where the workload runs (default cuda; cpu "
                          "profiles the host's op events)")
    pco.set_defaults(fn=_cmd_correlate_ops)

    pda = sub.add_parser(
        "derive-arch",
        help="derive a generation's overlay from another's calibration "
             "(transferable TensorCore knobs over published absolutes)",
    )
    pda.add_argument("--src", default="v5e")
    pda.add_argument("--dst", default="v5p")
    pda.add_argument("--out", default=None,
                     help="default: configs/<dst>.derived.flags")
    pda.set_defaults(fn=_cmd_derive_arch)

    plo = sub.add_parser(
        "loo",
        help="leave-one-out validation of the refinement procedure "
             "(offline; one preset-seeded refit per held-out workload)",
    )
    plo.add_argument("--fixtures", default="reports/silicon")
    plo.add_argument("--arch", default=None)
    plo.add_argument(
        "--per-op-artifact", default="reports/correl_ops.json",
        help="per-op artifact whose device rows join each fold's "
             "objective (held-out workload excluded)",
    )
    plo.add_argument("--sweeps", type=int, default=6)
    plo.add_argument(
        "--anchor", type=float, default=1.0,
        help="quadratic penalty on relative knob drift from the preset "
             "(physical-prior regularization; 0 disables)",
    )
    plo.add_argument("--out", default=str(PORT_REPORTS / "loo.json"))
    plo.set_defaults(fn=_cmd_loo)

    pcr = sub.add_parser(
        "correl-regen",
        help="regenerate the per-op correlation artifact offline "
             "(current model vs the artifact's stored device durations)",
    )
    pcr.add_argument("--artifact", default="reports/correl_ops.json")
    pcr.add_argument("--fixtures", default="reports/silicon")
    pcr.add_argument("--arch", default="v5e")
    pcr.add_argument("--out", default=None,
                     help="output path (default: "
                          f"{PORT_REPORTS / 'correl_ops.json'})")
    pcr.add_argument("--workers", type=int, default=None, metavar="N",
                     help="fan per-workload replays over N processes "
                          "(byte-identical artifact)")
    pcr.set_defaults(fn=_cmd_correl_regen)

    pf = sub.add_parser(
        "refine",
        help="joint-fit arch knobs against committed silicon fixtures "
             "(offline; coordinate descent on the replay objective)",
    )
    pf.add_argument(
        "--fixtures", default="reports/silicon",
        help="fixture dir with manifest.json (default: reports/silicon)",
    )
    pf.add_argument("--arch", default=None)
    pf.add_argument("--seed", default=None,
                    help="overlay flag file to seed the search from")
    pf.add_argument("--sweeps", type=int, default=6)
    pf.add_argument("--out", default=None,
                    help="write the refined overlay here")
    pf.add_argument(
        "--per-op-artifact", default="reports/correl_ops.json",
        help="per-op artifact whose device rows join the objective",
    )
    pf.add_argument(
        "--no-per-op", action="store_true",
        help="fit on end-to-end totals only",
    )
    pf.add_argument(
        "--anchor", type=float, default=1.0,
        help="quadratic penalty on relative knob drift from the seed "
             "(physical-prior regularization; 0 disables)",
    )
    pf.set_defaults(fn=_cmd_refine)

    psd = sub.add_parser(
        "stats-diff",
        help="diff two scraped run trees (merge-stats compare role)",
    )
    psd.add_argument("old", help="run dir of the baseline")
    psd.add_argument("new", help="run dir of the candidate")
    psd.add_argument("--rel-tol", type=float, default=0.0,
                     help="relative tolerance for numeric stats")
    psd.add_argument("--check", action="store_true",
                     help="exit 1 when any difference is found (CI gate)")
    psd.set_defaults(fn=_cmd_stats_diff)

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

    pd = sub.add_parser(
        "debug", help="single-step a trace module (gdb-style)"
    )
    pd.add_argument("trace")
    pd.add_argument("--module", default=None)
    pd.add_argument("--arch", default=None)
    pd.set_defaults(fn=_cmd_debug)

    pv = sub.add_parser(
        "timeline", help="export a module's op timeline as Chrome trace JSON"
    )
    pv.add_argument("trace")
    pv.add_argument("out")
    pv.add_argument("--module", default=None)
    pv.add_argument("--arch", default=None)
    pv.add_argument("--counters", action="store_true",
                    help="merge sampled counter tracks (mxu_util, "
                         "hbm_gbps, ...) into the trace")
    pv.add_argument("--obs-window-cycles", type=float, default=0.0)
    pv.set_defaults(fn=_cmd_timeline)

    pa = sub.add_parser(
        "aerial",
        help="interval-sampled unit-utilization time series "
             "(the AerialVision-style time-lapse view)",
    )
    pa.add_argument("trace")
    pa.add_argument("--module", default=None)
    pa.add_argument("--arch", default=None)
    pa.add_argument("--sample", type=float, default=0,
                    help="window size in cycles (default: stat_sample_cycles)")
    pa.add_argument("--gz", default=None,
                    help="also write the gzip'd JSONL interval log here")
    pa.add_argument("--power", action="store_true",
                    help="add a TPUWattch power-over-time lane")
    pa.set_defaults(fn=_cmd_aerial)

    pb = sub.add_parser(
        "bbv",
        help="per-interval opcode vectors for SimPoint phase sampling "
             "(the bbv_tool equivalent)",
    )
    pb.add_argument("trace")
    pb.add_argument("--module", default=None)
    pb.add_argument("--interval", type=int, default=1000)
    pb.add_argument("--out", default=None,
                    help="write SimPoint .bb frequency vectors here")
    pb.set_defaults(fn=_cmd_bbv)

    po = sub.add_parser(
        "occupancy",
        help="MXU tile / vmem occupancy per matmul-shaped op "
             "(the occupancy_calc_tool equivalent)",
    )
    po.add_argument("trace")
    po.add_argument("--module", default=None)
    po.add_argument("--arch", default=None)
    po.add_argument("--limit", type=int, default=10)
    po.set_defaults(fn=_cmd_occupancy)

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

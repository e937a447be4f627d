"""``tpusim_torch serve-bench`` — the serving layer's measured headline
(port of ``tpusim/serve/bench.py``).

Replays a fixture request mix against a daemon at a target concurrency
and reports p50/p95/p99 latency + throughput, next to the cost of the
same work as a one-shot CLI invocation (full process start + config
compose + trace load + pricing).  The subsystem's acceptance number:
a **warm cached** ``POST /v1/simulate`` must be orders of magnitude
faster than the cold CLI path, because the daemon pays parse/compose
once and every repeat request is an engine-cache lookup.

By default the bench boots its own daemon in-process on an ephemeral
loopback port (the same composition ``python -m tpusim_torch serve``
runs); ``--url`` points it at an external one instead, in which case the
CLI baseline is skipped (the fixture may not exist locally).  Every
process it starts — the cold CLI baseline, the out-of-process daemons
of the sweeps — is ``python -m tpusim_torch``.  The loadgen processes of
the acceptor sweep are forked and touch no torch.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

__all__ = ["format_acceptor_sweep", "format_report", "format_sweep",
           "run_acceptor_sweep", "run_serve_bench", "run_worker_sweep"]

#: the default fixture mix: the multi-device llama fixture is the
#: headline, the matmul rides along as a second launch class so the
#: cache serves more than one shape
DEFAULT_MIX = (
    {"trace": "llama_tiny_tp2dp2", "arch": "v5p"},
    {"trace": "matmul_512", "arch": "v5e"},
)


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    idx = min(
        int(round(q / 100.0 * len(sorted_vals) + 0.5)) - 1,
        len(sorted_vals) - 1,
    )
    return sorted_vals[max(idx, 0)]


def _cli_seconds(trace_path: Path, arch: str, runs: int = 2) -> float:
    """Wall seconds of one cold ``python -m tpusim_torch simulate``
    process — the best (minimum) of ``runs``, so the reported speedup is
    the conservative one."""
    best = float("inf")
    for _ in range(max(runs, 1)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpusim_torch", "simulate",
             str(trace_path), "--arch", arch],
            capture_output=True, text=True,
        )
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"CLI baseline failed rc={proc.returncode}: "
                f"{proc.stderr.strip()[:500]}"
            )
        best = min(best, dt)
    return best


def _run_storm(
    url: str, mix: list[dict], n_total: int, n_threads: int,
    deadline_s: float,
) -> tuple[list[float], int, list[str], float]:
    """One concurrent request storm: ``n_total`` requests round-robined
    over the mix from ``n_threads`` client threads.  Returns
    ``(latencies, cache_hits, errors, wall_s)``."""
    from tpusim_torch.serve.client import ServeClient

    latencies: list[float] = []
    hits = [0]
    errors: list[str] = []
    lock = threading.Lock()
    next_idx = [0]

    def loop():
        local_client = ServeClient(url, timeout_s=deadline_s)
        while True:
            with lock:
                i = next_idx[0]
                if i >= n_total:
                    return
                next_idx[0] += 1
            req = mix[i % len(mix)]
            t0 = time.perf_counter()
            try:
                r = local_client.simulate(**req)
            except Exception as e:  # noqa: BLE001 - report, don't die
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if r.cache_hit:
                    hits[0] += 1

    threads = [
        threading.Thread(target=loop, name=f"serve-bench-{i}")
        for i in range(max(n_threads, 1))
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return latencies, hits[0], errors, wall


def _boot_daemon_proc(
    trace_root, concurrency, deadline_s, serve_workers,
    acceptors: int = 0, hot_cache_dir=None,
):
    """Boot ``python -m tpusim_torch serve`` as its own process; returns
    ``(proc, url)``.  The sweep measures the daemon as deployed — in its
    own process — because an in-process daemon shares the loadgen's GIL,
    and the pool legs then measure loadgen contention, not the pool."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "tpusim_torch", "serve",
        "--host", "127.0.0.1", "--port", "0",
        "--trace-root", str(trace_root),
        "--max-inflight", str(max(int(concurrency), 1)),
        "--queue-depth", str(max(int(concurrency) * 4, 16)),
        "--deadline-s", str(float(deadline_s)),
    ]
    if serve_workers > 0:
        cmd += ["--serve-workers", str(int(serve_workers))]
    if acceptors > 0:
        cmd += ["--acceptors", str(int(acceptors))]
    if hot_cache_dir is not None:
        cmd += ["--hot-cache", str(hot_cache_dir)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()  # the bound-port startup contract
    m = re.search(r"http://[\d.:]+", line or "")
    if m is None:
        proc.kill()
        proc.wait()
        raise RuntimeError(
            f"serve daemon never printed its URL (got {line!r})"
        )
    return proc, m.group(0)


def run_serve_bench(
    url: str | None = None,
    trace_root: str | Path | None = None,
    concurrency: int = 8,
    requests: int = 64,
    mix: list[dict] | None = None,
    cli_baseline: bool = True,
    cli_runs: int = 2,
    deadline_s: float = 120.0,
    serve_workers: int = 0,
    reps: int = 1,
    out_of_process: bool = False,
) -> dict:
    """Run the loadgen; returns the report document.

    The measured pass is **warm**: one untimed priming request per mix
    entry runs first, so the reported latencies are the steady-state
    service the daemon exists to provide (the cold numbers are the CLI
    baseline's whole story)."""
    from tpusim_torch.serve.client import ServeClient

    mix = [dict(m) for m in (mix or DEFAULT_MIX)]
    daemon = None
    daemon_proc = None
    if url is None:
        if trace_root is None:
            trace_root = (
                Path(__file__).resolve().parents[2]
                / "tests" / "fixtures" / "traces"
            )
        if out_of_process:
            daemon_proc, url = _boot_daemon_proc(
                trace_root, concurrency, deadline_s,
                max(int(serve_workers), 0),
            )
        else:
            from tpusim_torch.serve.daemon import ServeDaemon

            daemon = ServeDaemon(
                trace_root=trace_root,
                max_inflight=max(int(concurrency), 1),
                queue_depth=max(int(concurrency) * 4, 16),
                deadline_s=deadline_s,
                serve_workers=max(int(serve_workers), 0),
            ).start()
            url = daemon.url
    client = ServeClient(url, timeout_s=deadline_s)

    try:
        # prime: first contact pays trace load + config compose + the
        # cold pricing walk; everything measured after this is warm
        warm_info = []
        for m in mix:
            t0 = time.perf_counter()
            r = client.simulate(**m)
            warm_info.append({
                "request": m,
                "cold_s": time.perf_counter() - t0,
                "cache_hit": r.cache_hit,
            })

        n_total = max(int(requests), 1)
        n_threads = max(int(concurrency), 1)

        # steady-state warmup: with a worker pool each WORKER owns its own
        # registry + L1, and work-conserving dispatch spills a busy
        # home's requests to its neighbors — an untimed concurrent
        # storm pushes every worker through its cold parse so the
        # measured pass is the steady-state service, not a parse bench
        n_warm = max(n_threads * 2, len(mix) * 2, serve_workers * 2)
        _run_storm(url, mix, n_warm, n_threads, deadline_s)

        # reps > 1: repeat the measured storm and keep the
        # best-throughput pass — shared CI containers are noisy
        # neighbors, and the steady-state capability (not the worst
        # co-tenant interference window) is the number the scaling
        # claim is about; errors from EVERY pass are kept
        best = None
        errors: list[str] = []
        for _ in range(max(int(reps), 1)):
            latencies, hits, errs, wall = _run_storm(
                url, mix, n_total, n_threads, deadline_s,
            )
            errors.extend(errs)
            if best is None or (
                wall > 0 and len(latencies) / wall > best[3]
            ):
                rps = len(latencies) / wall if wall else 0.0
                best = (latencies, hits, wall, rps)
        latencies, hits, wall, _rps = best
        latencies.sort()
        doc: dict = {
            "url": url,
            "concurrency": n_threads,
            "serve_workers": max(int(serve_workers), 0),
            "requests": len(latencies),
            "error_count": len(errors),
            "errors": errors[:10],   # sample only — error_count is the truth
            "wall_s": round(wall, 4),
            "throughput_rps": round(len(latencies) / wall, 2) if wall else 0,
            "cache_hit_fraction": (
                round(hits / len(latencies), 4) if latencies else 0.0
            ),
            "latency_ms": {
                "p50": round(_percentile(latencies, 50) * 1e3, 3),
                "p95": round(_percentile(latencies, 95) * 1e3, 3),
                "p99": round(_percentile(latencies, 99) * 1e3, 3),
                "max": round(latencies[-1] * 1e3, 3) if latencies else 0.0,
            },
            "warmup": warm_info,
        }

        if cli_baseline and trace_root is not None:
            head = mix[0]
            trace_path = Path(trace_root) / str(head.get("trace", ""))
            if trace_path.is_dir():
                cli_s = _cli_seconds(
                    trace_path, str(head.get("arch", "v5p")), runs=cli_runs,
                )
                p50_s = _percentile(latencies, 50)
                doc["cli_baseline"] = {
                    "trace": head.get("trace"),
                    "cold_cli_s": round(cli_s, 4),
                    "warm_p50_ms": doc["latency_ms"]["p50"],
                    "speedup_p50": (
                        round(cli_s / p50_s, 1) if p50_s > 0 else None
                    ),
                }
        if daemon is not None and daemon.supervisor is not None:
            sup = daemon.supervisor.stats_dict()
            doc["workers"] = {
                "alive": sup["workers_alive"],
                "restarts": sup["worker_restarts_total"],
                "kills": sup["worker_kills_total"],
                "retries": sup["worker_retries_total"],
                "dispatched": sup["worker_dispatched_total"],
            }
        elif daemon_proc is not None and serve_workers > 0:
            # out-of-process: the fleet state rides /healthz + /metrics
            health = client.healthz()
            worker_docs = health.get("workers") or []
            retries = 0
            try:
                for line in client.metrics_text().splitlines():
                    if line.startswith("tpusim_serve_worker_retries_total"):
                        retries = int(float(line.split()[1]))
            except Exception:  # noqa: BLE001 - stats garnish, not the bench
                pass
            doc["workers"] = {
                "alive": health.get("workers_alive", 0),
                "restarts": sum(
                    w.get("restarts", 0) for w in worker_docs
                ),
                "kills": sum(w.get("kills", 0) for w in worker_docs),
                "retries": retries,
                "dispatched": sum(
                    w.get("requests_done", 0) for w in worker_docs
                ),
            }
        return doc
    finally:
        if daemon is not None:
            daemon.drain_and_stop()
        if daemon_proc is not None:
            import signal as _signal
            import subprocess as _subprocess

            daemon_proc.send_signal(_signal.SIGTERM)  # the drain path
            try:
                daemon_proc.wait(timeout=30)
            except _subprocess.TimeoutExpired:
                daemon_proc.kill()
                daemon_proc.wait()


def run_worker_sweep(
    worker_counts: list[int] | tuple[int, ...] = (0, 1, 2, 4),
    trace_root: str | Path | None = None,
    concurrency: int = 8,
    requests: int = 64,
    mix: list[dict] | None = None,
    cli_baseline: bool = True,
    cli_runs: int = 2,
    reps: int = 3,
) -> dict:
    """The worker-pool scaling curve: one warm bench pass per worker count
    (``0`` = the single-process path) against a freshly-booted daemon,
    reporting req/s + p50/p95/p99 + error/retry/restart counts per leg
    and each leg's speedup over the single-process baseline.  Every leg
    boots its daemon **out of process** (the deployed topology): an
    in-process daemon shares the loadgen's GIL and the pool legs would
    measure loadgen contention instead of the pool.  (The JAX
    package's committed curve, on its own hosts, is
    ``reports/serve_bench.json``.)"""
    counts = sorted({max(int(c), 0) for c in worker_counts})
    if 0 not in counts:
        counts.insert(0, 0)  # the scaling claim needs its baseline
    legs: list[dict] = []
    base_rps = None
    for i, c in enumerate(counts):
        doc = run_serve_bench(
            trace_root=trace_root,
            concurrency=concurrency,
            requests=requests,
            mix=mix,
            cli_baseline=cli_baseline and i == 0,
            cli_runs=cli_runs,
            serve_workers=c,
            reps=reps,
            out_of_process=True,
        )
        leg = {
            "serve_workers": c,
            "throughput_rps": doc["throughput_rps"],
            "latency_ms": doc["latency_ms"],
            "requests": doc["requests"],
            "error_count": doc.get(
                "error_count", len(doc.get("errors", []))
            ),
            "cache_hit_fraction": doc["cache_hit_fraction"],
        }
        if doc.get("workers"):
            leg["worker_restarts"] = doc["workers"]["restarts"]
            leg["worker_retries"] = doc["workers"]["retries"]
        if c == 0:
            base_rps = doc["throughput_rps"]
            if doc.get("cli_baseline"):
                leg["cli_baseline"] = doc["cli_baseline"]
        if base_rps:
            leg["speedup_vs_single_process"] = round(
                doc["throughput_rps"] / base_rps, 2
            )
        legs.append(leg)
    return {
        "concurrency": int(concurrency),
        "requests_per_leg": int(requests),
        # each leg's number is the best of `reps` measured storms
        # against its own freshly-booted out-of-process daemon — the
        # steady-state capability, not the worst co-tenant window of a
        # shared CI box (errors from every rep are still counted)
        "reps_per_leg": max(int(reps), 1),
        "worker_sweep": legs,
        "single_process_rps": base_rps,
        "best_rps": max(leg["throughput_rps"] for leg in legs),
        "best_speedup": max(
            leg.get("speedup_vs_single_process", 1.0) for leg in legs
        ),
    }


def _run_storm_raw(
    url: str, mix: list[dict], n_total: int, n_threads: int,
    deadline_s: float,
) -> tuple[list[float], int, list[str], float]:
    """A storm over pre-serialized keep-alive HTTP — the acceptor-sweep
    loadgen.  The threaded :class:`ServeClient` storm spends more CPU
    (json round trips, dataclass assembly) than a hot-tier server does
    per request; on a small CI box that measures the LOADGEN, not the
    fleet.  Here each thread writes prebuilt request bytes and reads
    Content-Length-delimited responses — the server still parses full
    HTTP and serves real bodies; only the client-side waste is gone.
    Same return contract as :func:`_run_storm`."""
    import json as _json
    import socket
    import urllib.parse

    parsed = urllib.parse.urlsplit(url)
    host, port = parsed.hostname, parsed.port or 80
    reqs = []
    for m in mix:
        body = _json.dumps(
            {"tuned": True, "validate": True, **m}
        ).encode()
        reqs.append(
            b"POST /v1/simulate HTTP/1.1\r\nHost: " + host.encode()
            + b"\r\nContent-Type: application/json\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body
        )
    latencies: list[float] = []
    hits = [0]
    errors: list[str] = []
    lock = threading.Lock()
    next_idx = [0]

    def loop():
        sock = None
        buf = b""
        while True:
            with lock:
                i = next_idx[0]
                if i >= n_total:
                    break
                next_idx[0] += 1
            req = reqs[i % len(reqs)]
            t0 = time.perf_counter()
            try:
                if sock is None:
                    sock = socket.create_connection(
                        (host, port), timeout=deadline_s,
                    )
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1,
                    )
                    buf = b""
                sock.sendall(req)
                while b"\r\n\r\n" not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise ConnectionError("server closed")
                    buf += chunk
                head, _, rest = buf.partition(b"\r\n\r\n")
                status = int(head.split(b" ", 2)[1])
                clen = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length"):
                        clen = int(line.split(b":", 1)[1])
                        break
                while len(rest) < clen:
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise ConnectionError("server closed mid-body")
                    rest += chunk
                payload, buf = rest[:clen], rest[clen:]
            except OSError as e:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                if status != 200:
                    errors.append(f"HTTP {status}: {payload[:120]!r}")
                    continue
                latencies.append(dt)
                if b'"cache_hit": true' in payload:
                    hits[0] += 1
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    threads = [
        threading.Thread(target=loop, name=f"serve-bench-raw-{i}")
        for i in range(max(n_threads, 1))
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return latencies, hits[0], errors, wall


def _storm_proc_main(q, url, mix, n_total, n_threads, deadline_s, raw):
    """One loadgen process of the multi-process storm (acceptor sweep
    legs): runs its share and ships the raw sample back over a queue.
    ALWAYS posts a result — a child that died without posting would
    leave the parent blocked on the queue for the full timeout."""
    try:
        fn = _run_storm_raw if raw else _run_storm
        latencies, hits, errors, wall = fn(
            url, mix, n_total, n_threads, deadline_s,
        )
        q.put((latencies, hits, errors[:20], wall))
    except Exception as e:  # noqa: BLE001 - the child's report boundary
        q.put(([], 0, [f"loadgen child died: {type(e).__name__}: {e}"],
               0.0))


def _run_storm_procs(
    url: str, mix: list[dict], n_total: int, n_threads: int,
    deadline_s: float, procs: int, raw: bool = True,
) -> tuple[list[float], int, list[str], float]:
    """A storm fanned over ``procs`` loadgen PROCESSES.  A threaded
    loadgen caps at its own GIL somewhere past ~1k req/s — measuring a
    multi-acceptor fleet through it would report the loadgen's ceiling,
    not the fleet's.  Throughput uses the storm's outer wall (the
    processes run concurrently)."""
    import multiprocessing

    procs = max(int(procs), 1)
    if procs == 1:
        fn = _run_storm_raw if raw else _run_storm
        return fn(url, mix, n_total, n_threads, deadline_s)
    ctx = multiprocessing.get_context(
        "fork" if "fork" in multiprocessing.get_all_start_methods()
        else "spawn"
    )
    import queue as _queue

    q = ctx.Queue()
    threads_each = max(n_threads // procs, 1)
    # distribute the remainder so the measured sample matches the
    # requested count exactly (a silent floor-division drop would make
    # the report's requests_per_leg a lie)
    shares = [
        n_total // procs + (1 if i < n_total % procs else 0)
        for i in range(procs)
    ]
    children = [
        ctx.Process(
            target=_storm_proc_main,
            args=(q, url, list(mix), share, threads_each, deadline_s,
                  raw),
            daemon=True,
        )
        for share in shares if share > 0
    ]
    t0 = time.perf_counter()
    for p in children:
        p.start()
    latencies: list[float] = []
    hits = 0
    errors: list[str] = []
    for _ in children:
        try:
            lat, h, errs, _w = q.get(timeout=deadline_s + 60)
        except _queue.Empty:
            # a child was killed hard (OOM) before it could post even
            # its failure report — record it and keep the sweep alive
            errors.append("loadgen child never reported (killed?)")
            continue
        latencies.extend(lat)
        hits += h
        errors.extend(errs)
    for p in children:
        p.join(timeout=10)
    wall = time.perf_counter() - t0
    return latencies, hits, errors, wall


def run_acceptor_sweep(
    acceptor_counts: list[int] | tuple[int, ...] = (1, 2, 4),
    trace_root: str | Path | None = None,
    concurrency: int = 8,
    requests: int = 256,
    mix: list[dict] | None = None,
    hot_cache: bool = True,
    serve_workers: int = 0,
    reps: int = 3,
    loadgen_procs: int | None = None,
    deadline_s: float = 120.0,
) -> dict:
    """The front tier's scaling curve: one warm bench pass per acceptor
    count against a freshly-booted **out-of-process** front fleet
    (``--acceptors N [--hot-cache]``), with the single-process daemon
    (``0``) as the baseline leg.  The loadgen itself fans over
    processes (``loadgen_procs``, default ~half the cores, min 2) so
    its GIL never caps the measurement.  Every leg gets its own hot
    dir: legs must not warm each other."""
    import tempfile

    from tpusim_torch.serve.client import ServeClient

    mix = [dict(m) for m in (mix or DEFAULT_MIX)]
    if trace_root is None:
        trace_root = (
            Path(__file__).resolve().parents[2]
            / "tests" / "fixtures" / "traces"
        )
    if loadgen_procs is None:
        import os as _os

        loadgen_procs = max(min((_os.cpu_count() or 2), 4), 2)
    counts = sorted({max(int(c), 0) for c in acceptor_counts})
    if 0 not in counts:
        counts.insert(0, 0)
    legs: list[dict] = []
    base_rps = None
    for c in counts:
        hot_dir = (
            tempfile.mkdtemp(prefix="tpusim-bench-hot-")
            if hot_cache and c > 0 else None
        )
        proc, url = _boot_daemon_proc(
            trace_root, concurrency, deadline_s,
            serve_workers if c > 0 else 0,
            acceptors=c, hot_cache_dir=hot_dir,
        )
        try:
            client = ServeClient(url, timeout_s=deadline_s, retries=3)
            for m in mix:  # prime every entry (publishes the hot tier)
                client.simulate(**m)
            # untimed steady-state warmup across every acceptor: the
            # kernel distributes connections, so a concurrent storm is
            # what pushes each acceptor through its cold path
            _run_storm_procs(
                url, mix, max(concurrency * 4, (c or 1) * 8),
                concurrency, deadline_s, loadgen_procs,
            )
            best = None
            errors: list[str] = []
            for _ in range(max(int(reps), 1)):
                lat, hits, errs, wall = _run_storm_procs(
                    url, mix, max(int(requests), 1),
                    max(int(concurrency), 1), deadline_s, loadgen_procs,
                )
                errors.extend(errs)
                rps = len(lat) / wall if wall else 0.0
                if best is None or rps > best[3]:
                    best = (lat, hits, wall, rps)
            lat, hits, wall, rps = best
            lat.sort()
            hot_hits = 0
            try:
                for line in client.metrics_text().splitlines():
                    if line.startswith("tpusim_serve_hot_hits_total"):
                        hot_hits = int(float(line.split()[1]))
            except Exception:  # noqa: BLE001 - garnish, not the bench
                pass
            leg = {
                "acceptors": c,
                "hot_cache": bool(hot_dir),
                "serve_workers": serve_workers if c > 0 else 0,
                "throughput_rps": round(rps, 2),
                "requests": len(lat),
                "error_count": len(errors),
                "cache_hit_fraction": (
                    round(hits / len(lat), 4) if lat else 0.0
                ),
                "hot_hits": hot_hits,
                "latency_ms": {
                    "p50": round(_percentile(lat, 50) * 1e3, 3),
                    "p95": round(_percentile(lat, 95) * 1e3, 3),
                    "p99": round(_percentile(lat, 99) * 1e3, 3),
                },
            }
            if c == 0:
                base_rps = leg["throughput_rps"]
            if base_rps:
                leg["speedup_vs_single_process"] = round(
                    leg["throughput_rps"] / base_rps, 2
                )
            legs.append(leg)
        finally:
            import shutil
            import signal as _signal
            import subprocess as _subprocess

            proc.send_signal(_signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except _subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if hot_dir is not None:
                # per-leg tempdir holds up to a whole segment; leaking
                # one per leg per run would fill /tmp over time
                shutil.rmtree(hot_dir, ignore_errors=True)
    return {
        "concurrency": int(concurrency),
        "requests_per_leg": int(requests),
        "reps_per_leg": max(int(reps), 1),
        "loadgen_procs": int(loadgen_procs),
        "hot_cache": bool(hot_cache),
        "acceptor_sweep": legs,
        "single_process_rps": base_rps,
        "best_rps": max(leg["throughput_rps"] for leg in legs),
        "best_speedup": max(
            leg.get("speedup_vs_single_process", 1.0) for leg in legs
        ),
    }


def format_acceptor_sweep(doc: dict) -> str:
    lines = [
        f"tpusim_torch serve-bench acceptor sweep @ concurrency "
        f"{doc['concurrency']} ({doc['requests_per_leg']} requests/leg, "
        f"{doc['loadgen_procs']} loadgen procs, "
        f"hot-cache {'on' if doc['hot_cache'] else 'off'})",
        "  acceptors  req/s     p50ms   p95ms   p99ms  errors  speedup",
    ]
    for leg in doc["acceptor_sweep"]:
        lines.append(
            f"  {leg['acceptors']:>9}  {leg['throughput_rps']:>8}  "
            f"{leg['latency_ms']['p50']:>6}  {leg['latency_ms']['p95']:>6}  "
            f"{leg['latency_ms']['p99']:>6}  {leg['error_count']:>6}  "
            f"{leg.get('speedup_vs_single_process', 1.0):>6}x"
        )
    lines.append(
        f"  best: {doc['best_rps']} req/s "
        f"({doc['best_speedup']}x the single-process daemon)"
    )
    return "\n".join(lines)


def format_sweep(doc: dict) -> str:
    lines = [
        f"tpusim_torch serve-bench worker sweep @ concurrency "
        f"{doc['concurrency']} ({doc['requests_per_leg']} requests/leg)",
        "  workers  req/s     p50ms   p95ms   p99ms  errors  speedup",
    ]
    for leg in doc["worker_sweep"]:
        lines.append(
            f"  {leg['serve_workers']:>7}  {leg['throughput_rps']:>8}  "
            f"{leg['latency_ms']['p50']:>6}  {leg['latency_ms']['p95']:>6}  "
            f"{leg['latency_ms']['p99']:>6}  {leg['error_count']:>6}  "
            f"{leg.get('speedup_vs_single_process', 1.0):>6}x"
        )
    lines.append(
        f"  best: {doc['best_rps']} req/s "
        f"({doc['best_speedup']}x the single-process daemon)"
    )
    return "\n".join(lines)


def format_report(doc: dict) -> str:
    lines = [
        f"tpusim_torch serve-bench: {doc['requests']} requests @ "
        f"concurrency {doc['concurrency']} against {doc['url']}",
        f"  throughput: {doc['throughput_rps']} req/s "
        f"(wall {doc['wall_s']}s; cache-hit fraction "
        f"{doc['cache_hit_fraction']:.0%})",
        f"  latency: p50 {doc['latency_ms']['p50']}ms  "
        f"p95 {doc['latency_ms']['p95']}ms  "
        f"p99 {doc['latency_ms']['p99']}ms  "
        f"max {doc['latency_ms']['max']}ms",
    ]
    for w in doc.get("warmup", []):
        lines.append(
            f"  cold first request {w['request'].get('trace')}: "
            f"{w['cold_s'] * 1e3:.1f}ms"
        )
    cb = doc.get("cli_baseline")
    if cb:
        lines.append(
            f"  cold CLI simulate ({cb['trace']}): "
            f"{cb['cold_cli_s'] * 1e3:.0f}ms -> warm served p50 "
            f"{cb['warm_p50_ms']}ms = {cb['speedup_p50']}x"
        )
    if doc.get("errors"):
        lines.append(f"  ERRORS ({len(doc['errors'])}): {doc['errors']}")
    return "\n".join(lines)

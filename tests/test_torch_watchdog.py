"""The port's memory watchdog (``tpusim_torch.guard.watchdog``), the
result cache's shrink step, served cancellation, and ``simulate
--max-wall-s`` / ``--max-rss``.

Mirrors the watchdog and served-cancellation tests of
``tests/test_guard.py`` against the port, and holds the ladder to the JAX
package's: the same pressure trace walks both ladders through the same
steps, flips and counters.  The CLI legs run both packages' ``simulate``
in fresh processes: a bad size exits 2, a cancelled run exits 3 with the
same refusal, and under a threshold that never trips the port's stats
equal its own plain run's and the JAX CLI's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.guard.watchdog import MemoryWatchdog as RefWatchdog  # noqa: E402
from tpusim.guard.watchdog import default_ladder as ref_ladder  # noqa: E402
from tpusim.perf.cache import ResultCache as RefCache  # noqa: E402
from tpusim.timing.engine import EngineResult as RefResult  # noqa: E402
from tpusim_torch.guard import (  # noqa: E402
    CancelToken,
    MemoryWatchdog,
    OperationCancelled,
    default_ladder,
    rss_bytes,
)
from tpusim_torch.perf.cache import (  # noqa: E402
    ResultCache,
    clear_compiled_cache,
    set_compiled_cache_max,
)
from tpusim_torch.timing.config import load_config  # noqa: E402
from tpusim_torch.timing.engine import EngineResult  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures" / "traces"
#: a module whose serial walk prices for ~2 s on a CPU, far past the
#: watchdog's 0.25 s sample interval
LONG_TRACE = REPO / "reports" / "silicon" / "decode_step"
VOLATILE = ("simulation_rate_kops", "silicon_slowdown", "wall_seconds")


# -- the shrink step ----------------------------------------------------------

def test_shrink_and_compiled_tier_bounds():
    cache = ResultCache(max_entries=64)
    for i in range(64):
        cache.put(f"k{i}", EngineResult(cycles=float(i)))
    dropped = cache.shrink()
    assert dropped == 32 and cache.max_entries == 32
    assert len(cache._mem) == 32
    assert cache.lru_shrinks == 1
    assert cache.guard_stats_dict()["lru_shrinks_total"] == 1
    # the floor holds
    for _ in range(10):
        cache.shrink()
    assert cache.max_entries == 16
    cache.restore_entry_budget(64)
    assert cache.max_entries == 64
    # compiled tier: clearing and re-bounding never raises, returns
    # counts (contents depend on what this process priced before)
    n = clear_compiled_cache()
    assert n >= 0
    set_compiled_cache_max(8)
    set_compiled_cache_max(256)  # restore the default for later tests


# -- the ladder ---------------------------------------------------------------

def _ladder_walk(watchdog_cls, ladder, cache_cls, result_cls) -> list:
    """Drive one ladder through a fixed RSS trace; every observation the
    reference test makes, in order."""
    cache = cache_cls(max_entries=64)
    for i in range(64):
        cache.put(f"k{i}", result_cls(cycles=float(i)))
    rss = {"v": 100}
    flips: list[str] = []
    dog = ladder(
        watchdog_cls(
            soft_bytes=200, hard_bytes=400, rss_fn=lambda: rss["v"],
            on_shed=lambda: flips.append("shed"),
            on_recover=lambda: flips.append("recover"),
        ),
        result_cache=cache,
    )
    seen = []
    for v in (100, 250, 250, 500, 100, 250):
        rss["v"] = v
        dog.poll_once()
        seen.append((v, list(dog.steps_taken), dog.shedding, list(flips),
                     cache.max_entries,
                     os.environ.get("TPUSIM_STREAM_THRESHOLD")))
    seen.append(dog.stats_dict())
    return seen


def test_watchdog_ladder_order_and_recovery():
    prev = os.environ.get("TPUSIM_STREAM_THRESHOLD")
    try:
        seen = _ladder_walk(MemoryWatchdog, default_ladder, ResultCache,
                            EngineResult)
        steps = [s[1] for s in seen[:-1]]
        # below the soft line nothing; soft: one step per sample, in
        # ladder order; hard: every remaining step, then shed
        assert steps[0] == []
        assert steps[1] == ["shrink_lru"] and seen[1][4] == 32
        assert steps[2] == ["shrink_lru", "drop_compiled"]
        assert steps[3][-1] == "force_lean" and seen[3][5] == "0"
        assert seen[3][2] and seen[3][3] == ["shed"]
        # back under the soft line: recover, re-arm, undo force_lean and
        # restore the L1 budget (a transient spike pins nothing)
        assert not seen[4][2] and seen[4][3] == ["shed", "recover"]
        assert seen[4][5] == prev and seen[4][4] == 64
        # the ladder re-armed from the top, halving the restored budget
        assert steps[5][-1] == "shrink_lru" and seen[5][4] == 32
        stats = seen[-1]
        assert stats["rss_peak_bytes"] == 500
        assert stats["shed_entries_total"] == 1
        assert stats["recoveries_total"] == 1
        # the JAX package's ladder walks the same trace the same way
        assert _ladder_walk(RefWatchdog, ref_ladder, RefCache,
                            RefResult) == seen
    finally:
        if prev is None:
            os.environ.pop("TPUSIM_STREAM_THRESHOLD", None)
        else:
            os.environ["TPUSIM_STREAM_THRESHOLD"] = prev
        set_compiled_cache_max(256)


def test_stop_reverts_no_step():
    """A shed process keeps ``TPUSIM_STREAM_THRESHOLD=0`` after
    :meth:`MemoryWatchdog.stop` (as the reference does); only a recovery
    below the soft line undoes it."""
    prev = os.environ.get("TPUSIM_STREAM_THRESHOLD")
    try:
        dog = default_ladder(MemoryWatchdog(
            soft_bytes=None, hard_bytes=10, rss_fn=lambda: 100,
        )).start()
        dog.poll_once()
        dog.stop()
        assert dog.shedding
        assert os.environ.get("TPUSIM_STREAM_THRESHOLD") == "0"
        assert dog.steps_taken == ["drop_compiled", "force_lean"]
    finally:
        if prev is None:
            os.environ.pop("TPUSIM_STREAM_THRESHOLD", None)
        else:
            os.environ["TPUSIM_STREAM_THRESHOLD"] = prev


def test_rss_bytes_reads_this_process():
    rss = rss_bytes()
    assert rss > 10 * 1024 * 1024  # a live CPython is tens of MB


def test_watchdog_samples_current_rss_never_the_peak_fallback():
    """The watchdog's default sampler must be the current-RSS reader:
    rss_bytes' ru_maxrss fallback is monotone, and a governor sampling
    a peak would turn one transient spike into permanent load-shedding
    with no possible recovery."""
    from tpusim_torch.guard.watchdog import _rss_current

    dog = MemoryWatchdog(soft_bytes=None, hard_bytes=None)
    assert dog._rss_fn is _rss_current
    # the /proc-only reader: live value for us, 0 ("no signal", never
    # "no memory") for a pid that cannot exist
    assert _rss_current() > 10 * 1024 * 1024
    assert _rss_current(1 << 30) == 0


# -- served cancellation ------------------------------------------------------

def test_serve_worker_simulate_cancels_in_process():
    from tpusim_torch.serve.registry import TraceRegistry
    from tpusim_torch.serve.worker import ServeWorker

    worker = ServeWorker(
        TraceRegistry(FIXTURES), result_cache=ResultCache(),
    )
    tok = CancelToken()
    tok.cancel("deadline")
    with pytest.raises(OperationCancelled):
        worker.simulate(
            {"trace": "matmul_512", "arch": "v5e", "tuned": False},
            cancel=tok,
        )


def test_sweep_jobs_are_cancellable_at_link_grain():
    """Both sweep flavors and the serve worker honor the job's token, and
    an armed-but-untripped token changes nothing."""
    from tpusim_torch.faults.sweep import single_link_sweep, trace_step_sweep
    from tpusim_torch.ici.topology import torus_for
    from tpusim_torch.serve.registry import TraceRegistry
    from tpusim_torch.serve.worker import ServeWorker

    tok = CancelToken()
    tok.cancel("client DELETE")
    cfg = load_config(arch="v5p", tuned=False)
    topo = torus_for(8, cfg.arch.name)
    with pytest.raises(OperationCancelled):
        single_link_sweep(topo, cfg.arch.ici, cancel=tok)
    with pytest.raises(OperationCancelled):
        trace_step_sweep(
            str(FIXTURES / "llama_tiny_tp2dp2"), topo, config=cfg,
            cancel=tok,
        )
    worker = ServeWorker(
        TraceRegistry(FIXTURES), result_cache=ResultCache(),
    )
    with pytest.raises(OperationCancelled):
        worker.sweep({"arch": "v5p", "chips": 8}, cancel=tok)
    live = single_link_sweep(
        torus_for(8, cfg.arch.name), cfg.arch.ici,
        cancel=CancelToken(),
    )
    bare = single_link_sweep(torus_for(8, cfg.arch.name), cfg.arch.ici)
    assert live.to_doc() == bare.to_doc()
    live = trace_step_sweep(
        str(FIXTURES / "llama_tiny_tp2dp2"), topo, config=cfg,
        max_scenarios=2, cancel=CancelToken(),
    )
    bare = trace_step_sweep(
        str(FIXTURES / "llama_tiny_tp2dp2"), topo, config=cfg,
        max_scenarios=2,
    )
    assert live.to_doc() == bare.to_doc()


def test_inprocess_daemon_coop_cancel_504():
    """Single-process daemon: a cold pricing run that outlives its
    deadline must 504 through the in-process CancelToken (detail names
    the cooperative cancel), and the daemon keeps serving."""
    import http.client

    from tpusim_torch.serve.daemon import ServeDaemon

    with ServeDaemon(trace_root=FIXTURES) as d:
        conn = http.client.HTTPConnection(d.host, d.port, timeout=30)
        try:
            # cold llama pricing takes hundreds of ms; 50ms of budget
            # comfortably clears admission and trips mid-walk
            conn.request(
                "POST", "/v1/simulate",
                json.dumps({
                    "trace": "llama_tiny_tp2dp2", "arch": "v5p",
                    "tuned": False, "deadline_ms": 50,
                }),
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 504
            assert "cooperative" in doc["detail"]
            # the daemon survives and prices the same request fine
            conn.request(
                "POST", "/v1/simulate",
                json.dumps({
                    "trace": "matmul_512", "arch": "v5e", "tuned": False,
                }),
                {"Content-Type": "application/json"},
            )
            resp2 = conn.getresponse()
            assert resp2.status == 200
            resp2.read()
        finally:
            conn.close()


def test_jobtable_cancel_queued_and_running(tmp_path):
    from tpusim_torch.serve.admission import JobTable

    table = JobTable(queue_depth=4, persist_dir=tmp_path / "jobs")
    queued = table.submit("sweep", {"arch": "v5p"})
    running = table.submit("campaign", {"spec": {}})
    assert table.cancel("job-999999") is None
    # cancel while queued: terminal immediately
    assert table.cancel(queued.job_id) == "cancelled"
    assert table.get(queued.job_id).status == "cancelled"
    # a worker picks up the other job (the queued-cancelled one is gone
    # from the line)
    job = table.next_job(timeout_s=0.1)
    assert job is running and job.status == "running"
    # cancel while running: the token trips, the loop lands it terminal
    assert table.cancel(running.job_id) == "cancelling"
    assert running.cancel_token.cancelled
    table.finish(job, None, "cancelled: client asked",
                 status="cancelled")
    assert table.get(running.job_id).status == "cancelled"
    # cancelled is terminal for drain purposes
    assert table.wait_idle(timeout_s=1.0)
    # and persisted terminally: a recovering table retains, not re-runs
    table2 = JobTable(queue_depth=4, persist_dir=tmp_path / "jobs")
    assert table2.get(queued.job_id).status == "cancelled"
    assert table2.get(running.job_id).status == "cancelled"
    assert table2.recovered == 0


# -- simulate --max-wall-s / --max-rss ----------------------------------------

def _cli(package: str, *argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", package, "simulate", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )


@pytest.mark.parametrize("flags", [
    ("--max-rss", "12Q"), ("--max-rss", "G"), ("--cache-quota", "x"),
])
def test_simulate_bad_size_exits_2(flags):
    trace = str(FIXTURES / "matmul_512")
    ours = _cli("tpusim_torch", trace, "--arch", "v5e", *flags)
    ref = _cli("tpusim", trace, "--arch", "v5e", *flags)
    assert ours.returncode == ref.returncode == 2, (ours.stderr, ref.stderr)
    assert ours.stdout == ref.stdout == ""
    assert ours.stderr.replace("tpusim_torch:", "tpusim:") == ref.stderr


def test_simulate_max_wall_s_cancels_exit_3():
    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    ours = _cli("tpusim_torch", trace, "--arch", "v5p", "--max-wall-s", "1e-6")
    ref = _cli("tpusim", trace, "--arch", "v5p", "--max-wall-s", "1e-6")
    assert ours.returncode == ref.returncode == 3
    assert ours.stdout == ref.stdout == ""
    assert ours.stderr == ref.stderr.replace(
        "tpusim simulate:", "tpusim_torch simulate:")
    assert ours.stderr.startswith("tpusim_torch simulate: cancelled: ")


def test_simulate_max_rss_below_rss_sheds_and_exits_3():
    """A threshold below any live interpreter's RSS: the first sample
    (0.25 s in) runs the whole ladder and cancels the serial walk, which
    prices this trace for seconds."""
    proc = _cli("tpusim_torch", str(LONG_TRACE), "--arch", "v5e",
                "--pricing-backend", "serial", "--max-rss", "1M")
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout == ""
    assert proc.stderr == (
        "tpusim_torch simulate: cancelled: RSS passed --max-rss with every "
        "droppable store already shed\n")


def test_simulate_max_rss_that_never_trips_changes_no_stat(tmp_path):
    trace = str(FIXTURES / "llama_tiny_tp2dp2")
    argv = (trace, "--arch", "v5p")
    runs = {
        "plain": _cli("tpusim_torch", *argv, "--json",
                      str(tmp_path / "plain.json")),
        "ours": _cli("tpusim_torch", *argv, "--max-rss", "512G",
                     "--max-wall-s", "600", "--json",
                     str(tmp_path / "ours.json")),
        "ref": _cli("tpusim", *argv, "--max-rss", "512G", "--max-wall-s",
                    "600", "--json", str(tmp_path / "ref.json")),
    }
    for name, proc in runs.items():
        assert proc.returncode == 0, (name, proc.stderr)

    def stats(name):
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        return {k: v for k, v in doc.items() if k not in VOLATILE}

    assert stats("ours") == stats("plain") == stats("ref")

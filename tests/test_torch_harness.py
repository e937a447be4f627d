"""The port's orchestration harness (``tpusim_torch.harness``: procman,
scraper, suites, runner) and the ``stats-diff`` CLI, against the JAX
package's.

The non-slow cases of ``tests/test_harness.py`` run on the port as they
run on the reference (procman retries, backoff, drain and SIGTERM; the
scraper's sentinel; built-in and YAML suites; ``overlay_to_flag_lines``;
the missing-trace error; ``diff_stats`` and the CLI), and
``run_experiments`` over two committed traces x ``v5e,v5p`` writes the
``stats.csv`` the JAX package's ``run_experiments`` writes over the same
specs, but for the host-dependent keys ``ci/check_golden.py`` treats as
volatile.  Every output goes to ``tmp_path``.
"""

import csv
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.harness.procman import ProcMan  # noqa: E402
from tpusim_torch.harness.runner import RunSpec, run_experiments  # noqa: E402
from tpusim_torch.harness.scrape import (  # noqa: E402
    scrape_log,
    scrape_run_dirs,
    write_csv,
)
from tpusim_torch.sim.stats import EXIT_SENTINEL  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"


# -- procman ----------------------------------------------------------------

def test_procman_runs_jobs(tmp_path):
    pm = ProcMan(parallel=2)
    for i in range(4):
        pm.submit(
            [sys.executable, "-c", f"print('job {i}')"],
            log_path=tmp_path / f"j{i}.log",
        )
    assert pm.run(poll_s=0.05)
    assert pm.status_summary() == {"done": 4}
    assert "job 2" in (tmp_path / "j2.log").read_text()


def test_procman_retries_job_killed_by_signal(tmp_path):
    """A job that dies from a transient signal is no longer terminal:
    with retries budgeted it is reaped and resubmitted (exponential
    backoff), and the second attempt succeeds."""
    marker = tmp_path / "first_attempt_done"
    code = (
        "import os, signal\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "print('recovered')\n"
    )
    pm = ProcMan(parallel=1)
    job = pm.submit(
        [sys.executable, "-c", code],
        log_path=tmp_path / "flaky.log",
        retries=1, backoff_s=0.01,
    )
    assert pm.run(poll_s=0.02)
    assert job.status == "done"
    assert job.attempts == 2
    assert job.retried == 1
    s = pm.status_summary()
    assert s["done"] == 1 and s["retries"] == 1
    log = (tmp_path / "flaky.log").read_text()
    assert "retry attempt 2/2" in log and "recovered" in log
    pm.dump_state(tmp_path / "jobs.json")
    state = __import__("json").loads((tmp_path / "jobs.json").read_text())
    assert state[0]["attempts"] == 2


def test_procman_retry_budget_exhausts_to_failed(tmp_path):
    pm = ProcMan(parallel=1)
    job = pm.submit(
        [sys.executable, "-c", "raise SystemExit(7)"],
        log_path=tmp_path / "always_bad.log",
        retries=2, backoff_s=0.01,
    )
    assert not pm.run(poll_s=0.02)
    assert job.status == "failed"
    assert job.attempts == 3          # 1 original + 2 resubmissions
    assert job.returncode == 7


def test_procman_backoff_grows_and_caps():
    from tpusim_torch.harness.procman import MAX_BACKOFF_S, Job

    j = Job(job_id=3, cmd=["x"], retries=10, backoff_s=0.5)
    delays = []
    for attempt in (1, 2, 3, 4):
        j.attempts = attempt
        delays.append(j.next_backoff_s())
    # exponential (jitter <= 25%) and bounded
    assert delays[1] > delays[0] and delays[2] > delays[1]
    for base, got in zip((0.5, 1.0, 2.0, 4.0), delays):
        assert base <= got <= min(base * 1.25, MAX_BACKOFF_S)
    j.attempts = 30
    assert j.next_backoff_s() == MAX_BACKOFF_S


def test_procman_drain_finishes_running_cancels_pending(tmp_path):
    """request_drain mid-run: the running child is reaped normally (its
    work completes), never-started jobs go 'cancelled', and run()
    returns instead of hanging on the frozen pending set."""
    import threading
    import time

    pm = ProcMan(parallel=1)
    marker = tmp_path / "slow.done"
    j0 = pm.submit([
        sys.executable, "-c",
        f"import time, pathlib; time.sleep(0.4); "
        f"pathlib.Path({str(marker)!r}).write_text('done')",
    ])
    j1 = pm.submit([sys.executable, "-c", "print('never runs')"])
    results: list[bool] = []
    th = threading.Thread(
        target=lambda: results.append(pm.run(poll_s=0.02))
    )
    th.start()
    deadline = time.time() + 10.0
    while j0.status != "running":
        assert time.time() < deadline, "job 0 never started"
        time.sleep(0.01)
    pm.request_drain()
    th.join(timeout=30.0)
    assert not th.is_alive()
    assert j0.status == "done" and j0.returncode == 0
    assert marker.exists()  # the in-flight child genuinely finished
    assert j1.status == "cancelled"
    assert results == [False]  # not all jobs succeeded (one cancelled)
    summary = pm.status_summary()
    assert summary == {"done": 1, "cancelled": 1}


def test_procman_sigterm_drains_gracefully(tmp_path):
    """run(drain_signals=True) under a real SIGTERM: the slow child is
    never orphaned, the queue stops, and the parent exits cleanly (rc
    0) — unlike the default disposition, which kills the parent
    mid-reap and leaves the child running."""
    import signal
    import subprocess
    import textwrap
    import time

    marker = tmp_path / "slow.done"
    code = textwrap.dedent(f"""
        import json, sys
        from tpusim_torch.harness.procman import ProcMan

        pm = ProcMan(parallel=1)
        pm.submit([sys.executable, "-c",
                   "import time, pathlib; time.sleep(0.4); "
                   "pathlib.Path({str(marker)!r}).write_text('done')"])
        pm.submit([sys.executable, "-c", "print('never runs')"])
        printed = [False]

        def tick(p):
            if not printed[0] and any(
                j.status == "running" for j in p.jobs
            ):
                printed[0] = True
                print("RUNNING", flush=True)

        ok = pm.run(poll_s=0.02, on_tick=tick, drain_signals=True)
        print("SUMMARY " + json.dumps(pm.status_summary()), flush=True)
    """)
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent.parent,
        start_new_session=True,
    )
    try:
        assert proc.stdout.readline().strip() == "RUNNING"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30.0)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, out  # graceful: run() returned, process exited
    assert marker.exists()  # the running child finished its work
    import json as _json

    summary = _json.loads(out.split("SUMMARY ", 1)[1])
    assert summary == {"done": 1, "cancelled": 1}
    # no orphan child in the group
    import os as _os

    deadline = time.time() + 5.0
    while time.time() < deadline:
        try:
            _os.killpg(proc.pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError("orphan procman child outlived the parent")


def test_procman_reports_failure(tmp_path):
    pm = ProcMan(parallel=2)
    pm.submit([sys.executable, "-c", "raise SystemExit(3)"],
              log_path=tmp_path / "bad.log")
    pm.submit([sys.executable, "-c", "print('ok')"],
              log_path=tmp_path / "good.log")
    assert not pm.run(poll_s=0.05)
    s = pm.status_summary()
    assert s == {"done": 1, "failed": 1}
    pm.dump_state(tmp_path / "jobs.json")
    assert (tmp_path / "jobs.json").exists()


# -- scraper ----------------------------------------------------------------

def test_scrape_requires_sentinel(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("tpusim_sim_cycle = 123\n")  # no sentinel
    assert scrape_log(log) is None
    log.write_text(f"tpusim_sim_cycle = 123\ntpusim_x = 1.5\n{EXIT_SENTINEL}\n")
    stats = scrape_log(log)
    assert stats == {"sim_cycle": 123, "x": 1.5}


def test_scrape_run_dirs_and_csv(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "run.log").write_text(
        f"tpusim_sim_cycle = 10\n{EXIT_SENTINEL}\n"
    )
    (tmp_path / "b" / "run.log").write_text("crashed\n")
    rows = scrape_run_dirs(tmp_path, "**/run.log")
    assert rows["a/run.log"]["sim_cycle"] == 10
    assert rows["__failed__"]["runs"] == ["b/run.log"]
    write_csv(rows, tmp_path / "out.csv")
    text = (tmp_path / "out.csv").read_text()
    assert "sim_cycle" in text and "a/run.log" in text


# -- suites / run matrix ----------------------------------------------------

def test_builtin_suites_from_registry():
    from tpusim_torch.harness.suites import list_suites, load_suite

    suites = list_suites()
    assert suites.get("ubench", 0) >= 10
    assert "all" in suites
    entries = load_suite("ubench")
    names = {e.workload for e in entries}
    assert "matmul_chain" in names and "embedding_lookup" in names
    with pytest.raises(KeyError, match="unknown suite"):
        load_suite("nope")


def test_yaml_suites_and_configs(tmp_path):
    from tpusim_torch.harness.suites import load_named_configs, load_suite

    y = tmp_path / "apps.yml"
    y.write_text(
        "suites:\n"
        "  quick:\n"
        "    - workload: matmul_chain\n"
        "      params: {m: 256}\n"
        "      launches: 2\n"
        "    - reduction\n"
        "configs:\n"
        "  narrow: {kernel_window: 1}\n"
        "  dcn: {arch: {ici: {chips_per_slice: 4}}}\n"
    )
    entries = load_suite("quick", y)
    assert entries[0].workload == "matmul_chain"
    assert entries[0].params == {"m": 256}
    assert entries[0].launches == 2
    assert entries[1].workload == "reduction"
    assert entries[0].run_name == "matmul_chain__m256"
    cfgs = load_named_configs(y)
    assert cfgs["narrow"] == {"kernel_window": 1}
    assert cfgs["dcn"]["arch"]["ici"]["chips_per_slice"] == 4
    # yaml suites shadow nothing built-in; builtin still resolvable
    assert load_suite("ubench", y)


def test_overlay_to_flag_lines():
    from tpusim_torch.harness.runner import overlay_to_flag_lines
    from tpusim_torch.timing.config import SimConfig, overlay, parse_flag_file

    d = {"kernel_window": 1, "arch": {"ici": {"chips_per_slice": 4}}}
    lines = overlay_to_flag_lines(d)
    assert "-kernel_window 1" in lines
    assert "-arch.ici.chips_per_slice 4" in lines
    # round-trip through the flag-file parser into a real config
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".cfg", delete=False) as f:
        f.write("\n".join(lines))
        path = f.name
    cfg = overlay(SimConfig(), parse_flag_file(path))
    assert cfg.kernel_window == 1
    assert cfg.arch.ici.chips_per_slice == 4


def test_run_suite_missing_trace_errors(tmp_path):
    from tpusim_torch.harness.runner import run_suite

    with pytest.raises(FileNotFoundError, match="--capture"):
        run_suite(
            "ubench", ["v5e"], tmp_path, capture_missing=False,
        )


def test_diff_stats_compares_two_runs():
    """The merge-stats compare role (util/plotting/merge-stats.py): two
    configs over the same runs, numeric tolerance, one-sided runs."""
    from tpusim_torch.harness.scrape import diff_stats

    old = {
        "a/run.log": {"cycles": 100.0, "flops": 5.0, "note": "x"},
        "gone/run.log": {"cycles": 1.0},
        "__failed__": {"runs": ["dead"]},
    }
    new = {
        "a/run.log": {"cycles": 103.0, "flops": 5.0, "note": "y"},
        "fresh/run.log": {"cycles": 2.0},
    }
    d = diff_stats(old, new, rel_tol=0.05)
    # 3% cycle delta is inside the 5% tolerance; note differs exactly
    assert d["a/run.log"] == {"note": ("x", "y")}
    assert "gone/run.log" in d["__only_old__"]
    assert "fresh/run.log" in d["__only_new__"]
    strict = diff_stats(old, new)
    assert strict["a/run.log"]["cycles"] == (100.0, 103.0)


def test_stats_diff_cli(tmp_path):
    import subprocess
    import sys

    for side, cyc in (("old", 100), ("new", 110)):
        d = tmp_path / side / "runA"
        d.mkdir(parents=True)
        (d / "run.log").write_text(
            f"tpusim_tot_sim_cycles = {cyc}\n"
            "TPUSIM: *** exit detected ***\n"
        )
    p = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "stats-diff",
         str(tmp_path / "old"), str(tmp_path / "new"), "--check"],
        capture_output=True, text=True,
        cwd=Path(__file__).resolve().parent.parent,
    )
    assert p.returncode == 1
    assert "tot_sim_cycles 100" in p.stdout
    p2 = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "stats-diff",
         str(tmp_path / "old"), str(tmp_path / "new"),
         "--rel-tol", "0.2"],
        capture_output=True, text=True,
        cwd=Path(__file__).resolve().parent.parent,
    )
    assert p2.returncode == 0


def _stats_tree(root: Path, cycles: dict[str, int]) -> Path:
    for run, cyc in cycles.items():
        d = root / run
        d.mkdir(parents=True)
        (d / "run.log").write_text(
            f"tpusim_tot_sim_cycles = {cyc}\n"
            "tpusim_op_count = 7\n"
            f"{EXIT_SENTINEL}\n"
        )
    return root


@pytest.mark.parametrize("extra", [[], ["--check"], ["--rel-tol", "0.2"]])
def test_stats_diff_cli_prints_the_references_lines(tmp_path, extra):
    """Both packages' ``stats-diff`` print the same lines and exit with
    the same code: differing stats, one-sided runs, ``--check``,
    ``--rel-tol``, and "no differences" for a tree against itself."""
    import subprocess

    old = _stats_tree(tmp_path / "old", {"a": 100, "gone": 1})
    new = _stats_tree(tmp_path / "new", {"a": 110, "fresh": 2})
    for pair in ((old, new), (old, old)):
        outs = [
            subprocess.run(
                [sys.executable, "-m", pkg, "stats-diff", *map(str, pair),
                 *extra],
                capture_output=True, text=True, cwd=REPO,
            )
            for pkg in ("tpusim", "tpusim_torch")
        ]
        assert (outs[1].returncode, outs[1].stdout) == \
            (outs[0].returncode, outs[0].stdout)
    assert outs[1].stdout == "no differences\n"


_CSV_SPECS = [
    ("matmul_512", "v5e", [], False),
    ("matmul_512", "v5p", ["-kernel_window 4"], True),
    ("llama_tiny_tp2dp2", "v5e", [], False),
    ("llama_tiny_tp2dp2", "v5p", [], True),
]


def _masked_csv(path: Path) -> tuple[list[str], list[list[str]]]:
    """A stats CSV without the host-dependent columns that
    ``ci/check_golden.py`` treats as volatile."""
    sys.path.insert(0, str(REPO / "ci"))
    try:
        from check_golden import VOLATILE
    finally:
        sys.path.pop(0)
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    keep = [i for i, c in enumerate(header) if c not in VOLATILE]
    return [header[i] for i in keep], [[r[i] for i in keep] for r in rows]


def test_run_experiments_csv_equals_the_references(tmp_path):
    """Two committed traces x ``v5e,v5p`` (one cell with an overlay, two
    with ``--power``): each package runs its own ``simulate`` children
    and scrapes them, and the two ``stats.csv`` files agree cell for cell
    but for the volatile keys."""
    from tpusim.harness.runner import RunSpec as RefRunSpec
    from tpusim.harness.runner import run_experiments as ref_run

    def specs(cls):
        return [
            cls(trace=FIXTURES / "traces" / t, arch=a, overlays=o,
                name=t, power=p)
            for t, a, o, p in _CSV_SPECS
        ]

    ref_rows = ref_run(specs(RefRunSpec), tmp_path / "ref", parallel=4,
                       csv_path=tmp_path / "ref.csv")
    rows = run_experiments(specs(RunSpec), tmp_path / "port", parallel=4,
                           csv_path=tmp_path / "port.csv")
    assert "__failed__" not in rows and len(rows) == 4
    assert sorted(rows) == sorted(ref_rows)
    for run, stats in rows.items():
        assert stats["sim_cycle"] > 0
        assert stats["sim_cycle"] == ref_rows[run]["sim_cycle"], run
    assert _masked_csv(tmp_path / "port.csv") == \
        _masked_csv(tmp_path / "ref.csv")
    port_cfg = (tmp_path / "port" / "matmul_512__v5p" / "sim.config")
    assert port_cfg.read_text() == (
        tmp_path / "ref" / "matmul_512__v5p" / "sim.config").read_text()
    assert [j["status"] for j in __import__("json").loads(
        (tmp_path / "port" / "jobs.json").read_text())] == ["done"] * 4
    assert (tmp_path / "port" / "failures.json").read_text() == "[]"


# -- chip_smoke.py's phase 16 (a)-(c) on the CPU host -------------------------


def test_chip_smoke_streaming_and_offline_on_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """Phase 16's host parts, rehearsed on the CPU: (b) and (c) as on the
    card (the full ``loo`` included, in the background), (a) at a few
    computations streamed by ``$TPUSIM_STREAM_THRESHOLD=0`` (a file that
    small cannot hold the RSS bound: the import floor's noise is larger).
    (d) needs the card: its capture job runs the workload there."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.delenv("TPUSIM_TUNED_DIR")
    monkeypatch.setattr(smoke, "STREAM_COMPS", 3)
    monkeypatch.setattr(smoke, "MIN_STREAM_BYTES", 0)
    monkeypatch.setattr(smoke, "STREAM_ENV",
                        {"TPUSIM_STREAM_THRESHOLD": "0"})
    monkeypatch.setattr(smoke, "STREAM_RSS_FRACTION", float("inf"))
    offline = tmp_path / "offline"
    offline.mkdir()
    untuned = tmp_path / "untuned"
    untuned.mkdir()
    started = smoke.start_offline(offline)
    streaming = smoke.start_streaming(tmp_path, untuned)
    try:
        a = smoke.finish_streaming("cpu", streaming)
        bc = smoke.finish_offline("cpu", offline, started)
    finally:
        for proc, f, *_ in [*started.values(),
                            *(p for _, p in streaming["legs"].values())]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    assert max(a["parsed"].values()) <= smoke.STREAM_PARSED_CAP
    assert a["sim_cycle"] > 0 and a["rss_added_bytes"] > 0
    assert set(a["joined_s"]) == {
        "stream_serial", "memory_serial", "memory_vectorized", "rss",
        "store_cold", "store_warm"}
    assert [p for p, _ in bc["loo_gaps"]] == \
        [".folds[7].train_parts.async_exposure_err_pct"]
    text = capsys.readouterr().out
    for part in ("(a)", "(b)", "(c)"):
        assert f"  {part} " in text
    assert smoke.os.environ.get("TPUSIM_STREAM_THRESHOLD") is None

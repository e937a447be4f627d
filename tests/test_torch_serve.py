"""The port's serving daemon (:mod:`tpusim_torch.serve`) end to end,
over an ephemeral loopback port.

Mirrors ``tests/test_serve.py`` test for test against the port (the
supervised-pool chaos tests are in ``tests/test_torch_serve_pool.py``):

* simulate / lint / sweep round-trips through the real HTTP stack;
* byte-equality of a served stats doc vs the same request through the
  port's ``simulate`` CLI (the determinism contract);
* warm repeat requests served from the shared result cache
  (``cache_hit`` true, stats byte-identical to the cold pass);
* error-level TLxxx diagnostics reject a request as 400 with the list;
  ``--strict-lint`` refuses warnings as 422 from a content-hash verdict
  cache, TL5xx passing through as warnings;
* admission: 429 + Retry-After with the queue full, 504 past the
  deadline, 413 for oversized bodies (deterministic: the daemon's
  ``work_hook`` holds a request in flight on an Event);
* ``/metrics`` parses as Prometheus text;
* SIGTERM drain of a real ``python -m tpusim_torch serve`` process;
* the client's timeouts, safe retries and ``Retry-After`` handling, and
  the job table's recovery.

Then the port is held to the JAX package's daemon live: both daemons
serve the fixtures, take the same requests, and every response must carry
the same status, the same document keys and equal values with
``model_version`` masked; served ``stats`` are compared by the served-bytes
canon of ``ci/check_golden.py`` (``_serve_served_bytes``).
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.serve.client import ServeClient, ServeError  # noqa: E402
from tpusim_torch.serve.daemon import (  # noqa: E402
    SERVE_FORMAT_VERSION,
    ServeDaemon,
)


REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "traces"

#: keys excluded from byte-equality comparisons: host-dependent values
#: plus the perf layer's own accounting (present exactly when a cache /
#: pool is mounted, which differs between served and plain-CLI runs)
VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
PERF_PREFIXES = ("cache_", "pool_")


def canonical(stats: dict) -> str:
    doc = {
        k: v for k, v in stats.items()
        if k not in VOLATILE and not k.startswith(PERF_PREFIXES)
    }
    return json.dumps(doc, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# shared daemon (round-trip tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def daemon():
    d = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    yield d
    d.drain_and_stop()


@pytest.fixture(scope="module")
def client(daemon):
    return ServeClient(daemon.url)


def test_healthz_and_traces(client):
    health = client.healthz()
    assert health["status"] == "ok"
    assert health["format_version"] == SERVE_FORMAT_VERSION
    assert set(client.traces()) >= {"llama_tiny_tp2dp2", "matmul_512"}


def test_simulate_round_trip(client):
    r = client.simulate(trace="llama_tiny_tp2dp2", arch="v5p")
    assert r.arch == "v5p"
    assert r.num_devices == 4
    assert r.sim_cycles > 0
    assert r.stats["kernel_launches"] > 0
    assert r.format_version == SERVE_FORMAT_VERSION
    assert r.model_version  # stamped so clients can reason about staleness


def test_warm_repeat_is_cache_hit_and_byte_identical(client):
    cold = client.simulate(trace="matmul_512", arch="v5e")
    warm = client.simulate(trace="matmul_512", arch="v5e")
    assert warm.cache_hit
    assert canonical(warm.stats) == canonical(cold.stats)


def test_served_stats_byte_equal_cli(client, tmp_path):
    """The same request through the one-shot CLI must produce the same
    stats doc byte for byte (minus host-dependent keys and the cache
    layer's own accounting)."""
    served = client.simulate(trace="llama_tiny_tp2dp2", arch="v5p")
    out = tmp_path / "cli_stats.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "simulate",
         str(FIXTURES / "llama_tiny_tp2dp2"), "--arch", "v5p",
         "--json", str(out)],
        capture_output=True, text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    cli_stats = json.loads(out.read_text())
    assert canonical(served.stats) == canonical(cli_stats)


def test_inline_hlo_simulate(client):
    text = (FIXTURES / "matmul_512" / "modules" / "matmul_512.hlo").read_text()
    r1 = client.simulate(hlo_text=text, arch="v5e")
    assert r1.sim_cycles > 0
    assert r1.trace.startswith("inline:")
    # the inline pod is cached under its content hash: the repeat
    # request parses nothing and prices nothing
    r2 = client.simulate(hlo_text=text, arch="v5e")
    assert r2.cache_hit
    assert canonical(r2.stats) == canonical(r1.stats)


def test_simulate_with_faults_stamps_fault_stats(client):
    r = client.simulate(
        trace="llama_tiny_tp2dp2", arch="v5p",
        faults={"faults": [{"kind": "chip_straggler", "chip": 0,
                            "clock_scale": 0.5}]},
    )
    assert any(k.startswith("faults_") for k in r.stats)
    healthy = client.simulate(trace="llama_tiny_tp2dp2", arch="v5p")
    assert r.sim_cycles > healthy.sim_cycles


def test_partitioned_topology_is_422_not_500(client):
    """A fault schedule that disconnects the pod is the request's
    fault: the replay refusal (TopologyPartitionedError) must surface
    as 422, never the 500 boundary."""
    faults = {"faults": [
        {"kind": "link_down", "src": 0, "dst": 1},
        {"kind": "link_down", "src": 0, "dst": 2},
    ]}
    with pytest.raises(ServeError) as ei:
        client.simulate(
            trace="llama_tiny_tp2dp2", arch="v5p", faults=faults,
            overlays=[{"arch": {"ici": {"network_mode": "detailed"}}}],
        )
    assert ei.value.status == 422
    assert ei.value.code == "replay_failed"
    assert "partitioned" in ei.value.detail


def test_lint_round_trip(client):
    rep = client.lint(trace="llama_tiny_tp2dp2", arch="v5p")
    assert rep.errors == 0
    assert "error(s)" in rep.summary
    assert isinstance(rep.diagnostics.get("items", []), list)


def test_sweep_job_round_trip(client):
    job_id = client.sweep(arch="v5p", chips=8, payload_mb=1.0)
    assert job_id.startswith("job-")
    status = client.wait_job(job_id, timeout_s=60)
    assert status.status == "done"
    assert status.result["scenarios"] > 0
    assert status.result["worst_inflation"] >= 1.0


def test_sweep_trace_mode_honors_overlays(client):
    """A trace sweep must price under the request's composed config —
    overlays silently dropped would return wrong inflation numbers."""
    base = client.wait_job(
        client.sweep(trace="llama_tiny_tp2dp2", arch="v5p",
                     max_scenarios=2),
        timeout_s=120,
    )
    slow_ici = client.wait_job(
        client.sweep(trace="llama_tiny_tp2dp2", arch="v5p",
                     max_scenarios=2,
                     overlays=[{"arch": {"ici": {
                         "link_bandwidth": 9.0e9}}}]),
        timeout_s=120,
    )
    assert base.status == "done" and slow_ici.status == "done"
    # 10x slower links must inflate the healthy step-time baseline
    assert slow_ici.result["healthy"] > base.result["healthy"]


def test_unknown_job_404(client):
    with pytest.raises(ServeError) as ei:
        client.job("job-999999")
    assert ei.value.status == 404


def test_unknown_trace_404_and_no_path_walk(client):
    for name in ("nope", "../nope", "a/b"):
        with pytest.raises(ServeError) as ei:
            client.simulate(trace=name, arch="v5p")
        assert ei.value.status == 404, name


def test_bad_request_400(client):
    with pytest.raises(ServeError) as ei:
        client.simulate(trace="matmul_512", hlo_text="x", arch="v5e")
    assert ei.value.status == 400
    with pytest.raises(ServeError) as ei:
        client.simulate(hlo_text="definitely not hlo {", arch="v5e")
    assert ei.value.status == 400


def test_metrics_prometheus_parses(client):
    client.healthz()
    text = client.metrics_text()
    gauges = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.split()
        gauges[name] = float(value)
    assert gauges["tpusim_serve_requests_total"] > 0
    assert "tpusim_serve_admission_inflight" in gauges
    assert "tpusim_serve_cache_hits" in gauges
    assert "# TYPE tpusim_serve_requests_total counter" in text
    assert "# HELP tpusim_serve_requests_total" in text


# ---------------------------------------------------------------------------
# validation refusal (400 with the TLxxx list)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def broken_root(tmp_path_factory):
    """A trace root holding one trace whose commandlist references a
    module that does not exist — an error-level TL006."""
    root = tmp_path_factory.mktemp("serve_broken_root")
    td = root / "broken"
    (td / "modules").mkdir(parents=True)
    src = FIXTURES / "matmul_512" / "modules" / "matmul_512.hlo"
    (td / "modules" / "matmul_512.hlo").write_text(src.read_text())
    (td / "meta.json").write_text(
        json.dumps({"num_devices": 1, "format_version": 1})
    )
    (td / "commandlist.jsonl").write_text(
        json.dumps({"kind": "kernel_launch", "module": "no_such_module",
                    "device": 0}) + "\n"
    )
    return root


def test_error_diagnostics_reject_as_400(broken_root):
    with ServeDaemon(trace_root=broken_root) as d:
        c = ServeClient(d.url)
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="broken", arch="v5e")
        err = ei.value
        assert err.status == 400
        assert err.code == "validation_failed"
        assert "TL006" in err.doc.get("codes", [])
        assert any(
            item["code"] == "TL006" for item in err.diagnostics
        )
        # the lint endpoint REPORTS the same finding instead of failing
        rep = c.lint(trace="broken", arch="v5e")
        assert rep.errors >= 1
        assert "TL006" in rep.codes
        # validate=False skips the pre-flight; the replay itself then
        # refuses (422) rather than pricing garbage silently
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="broken", arch="v5e", validate=False)
        assert ei.value.status == 422


# ---------------------------------------------------------------------------
# strict lint (serve --strict-lint): 422 + diagnostics doc, verdict
# cached by content hash
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def warned_root(tmp_path_factory):
    """A trace whose lint verdict is warning-only (TL015 zero-byte
    standalone collective): the default pre-flight admits it, the
    strict-lint gate refuses it."""
    root = tmp_path_factory.mktemp("serve_warned_root")
    td = root / "warned"
    (td / "modules").mkdir(parents=True)
    src = FIXTURES / "matmul_512" / "modules" / "matmul_512.hlo"
    (td / "modules" / "matmul_512.hlo").write_text(src.read_text())
    (td / "meta.json").write_text(
        json.dumps({"num_devices": 4, "format_version": 1})
    )
    (td / "commandlist.jsonl").write_text("\n".join([
        json.dumps({"kind": "kernel_launch",
                    "module": "matmul_512", "device": 0}),
        json.dumps({"kind": "collective", "device": 0, "bytes": 0,
                    "collective": {"kind": "all-reduce",
                                   "replica_groups": [[0, 1], [2, 3]]}}),
    ]) + "\n")
    return root


def test_strict_lint_refuses_warnings_as_422(warned_root):
    with ServeDaemon(trace_root=warned_root, strict_lint=True) as d:
        c = ServeClient(d.url)
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="warned", arch="v5e")
        err = ei.value
        assert err.status == 422
        assert err.code == "strict_lint_refused"
        assert any(
            item["code"] == "TL015" for item in err.diagnostics
        )
        # the repeat is refused from the CACHED verdict: one verdict
        # entry, two refusals, zero re-lints
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="warned", arch="v5e")
        assert ei.value.status == 422
        stats = d.worker.stats_dict()
        assert stats["strict_lint_refused_total"] == 2
        assert stats["lint_verdicts_cached"] == 1
        # nothing priced
        assert d.worker.priced == 0


def test_strict_lint_verdicts_do_not_cross_serve_commandlists(
    tmp_path_factory,
):
    """Two traces sharing byte-identical modules but DIFFERENT
    commandlists must each get their own verdict: the trace passes
    judge both artifacts, so the cache key carries a commandlist
    fingerprint beside the module content hashes."""
    root = tmp_path_factory.mktemp("serve_twin_root")
    src = FIXTURES / "matmul_512" / "modules" / "matmul_512.hlo"
    for name, extra in (("clean", []), ("dirty", [
        json.dumps({"kind": "collective", "device": 0, "bytes": 0,
                    "collective": {"kind": "all-reduce",
                                   "replica_groups": [[0, 1], [2, 3]]}}),
    ])):
        td = root / name
        (td / "modules").mkdir(parents=True)
        (td / "modules" / "matmul_512.hlo").write_text(src.read_text())
        (td / "meta.json").write_text(
            json.dumps({"num_devices": 4, "format_version": 1})
        )
        (td / "commandlist.jsonl").write_text("\n".join(
            [json.dumps({"kind": "kernel_launch",
                         "module": "matmul_512", "device": 0})] + extra
        ) + "\n")
    # a third twin differing only in META (pod declaration 1 -> the
    # device-0 launch is still fine, but a dirty meta declaring fewer
    # devices than a command uses would TL007): meta must join the key
    td = root / "metatwin"
    (td / "modules").mkdir(parents=True)
    (td / "modules" / "matmul_512.hlo").write_text(src.read_text())
    (td / "meta.json").write_text(
        json.dumps({"num_devices": 1, "format_version": 1})
    )
    (td / "commandlist.jsonl").write_text(
        json.dumps({"kind": "kernel_launch",
                    "module": "matmul_512", "device": 0}) + "\n"
    )
    with ServeDaemon(trace_root=root, strict_lint=True) as d:
        c = ServeClient(d.url)
        # the clean twin admits first — its verdict must NOT admit the
        # dirty twin afterwards (nor vice versa on a fresh daemon)
        r = c.simulate(trace="clean", arch="v5e")
        assert r.stats["sim_cycle"] > 0
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="dirty", arch="v5e")
        assert ei.value.status == 422
        r = c.simulate(trace="metatwin", arch="v5e")
        assert r.stats["sim_cycle"] > 0
        # three distinct verdicts: modules alone must not key the cache
        assert d.worker.stats_dict()["lint_verdicts_cached"] == 3


def test_strict_lint_admits_clean_traces(warned_root):
    with ServeDaemon(trace_root=FIXTURES, strict_lint=True) as d:
        c = ServeClient(d.url)
        r = c.simulate(trace="matmul_512", arch="v5e")
        assert r.stats["sim_cycle"] > 0
        r2 = c.simulate(trace="matmul_512", arch="v5e")
        assert r2.cache_hit
        stats = d.worker.stats_dict()
        assert stats["strict_lint_refused_total"] == 0
        assert stats["lint_verdicts_cached"] == 1


def test_strict_lint_passes_tl5xx_findings_as_warnings(warned_root):
    """TL5xx perf-lint findings are advisory by contract: a verdict
    whose only warnings are TL5xx must ADMIT the trace (the findings
    still ride along in the cached doc), while a TL5xx finding next to
    a genuine warning changes nothing about the refusal."""
    def _with_perf_findings(registry):
        orig = registry.trace_diagnostics

        def fake(entry):
            diags = orig(entry)
            diags.emit("TL500", "critical path summary (synthetic)")
            diags.emit("TL501", "collective 90% exposed (synthetic)")
            return diags
        registry.trace_diagnostics = fake

    with ServeDaemon(trace_root=FIXTURES, strict_lint=True) as d:
        _with_perf_findings(d.worker.registry)
        c = ServeClient(d.url)
        r = c.simulate(trace="matmul_512", arch="v5e")
        assert r.stats["sim_cycle"] > 0
        stats = d.worker.stats_dict()
        assert stats["strict_lint_refused_total"] == 0
        assert stats["lint_verdicts_cached"] == 1

    with ServeDaemon(trace_root=warned_root, strict_lint=True) as d:
        _with_perf_findings(d.worker.registry)
        c = ServeClient(d.url)
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="warned", arch="v5e")
        assert ei.value.status == 422
        # the perf findings ride along in the refusal doc unchanged
        assert any(
            item["code"] == "TL501" for item in ei.value.diagnostics
        )


def test_strict_lint_off_keeps_warning_traces_servable(warned_root):
    """The default daemon admits warning-only traces — strict lint is
    an opt-in tightening, not a behavior change."""
    with ServeDaemon(trace_root=warned_root) as d:
        c = ServeClient(d.url)
        r = c.simulate(trace="warned", arch="v5e")
        assert r.stats["sim_cycle"] > 0
        assert "strict_lint_refused_total" not in d.worker.stats_dict()


def test_strict_lint_inline_hlo_verdict_cached_by_content(warned_root):
    bad_inline = (
        "HloModule bad, num_partitions=4\n\n"
        "ENTRY %main (p0: f32[8]) -> f32[8] {\n"
        "  %p0 = f32[8]{0} parameter(0)\n"
        "  ROOT %r = f32[8]{0} add(%p0, %ghost)\n"
        "}\n"
    )
    with ServeDaemon(trace_root=None, strict_lint=True) as d:
        c = ServeClient(d.url)
        for _ in range(2):
            with pytest.raises(ServeError) as ei:
                c.simulate(hlo_text=bad_inline, arch="v5e")
            assert ei.value.status == 422
            assert any(
                item["code"] == "TL001"
                for item in ei.value.diagnostics
            )
        stats = d.worker.stats_dict()
        assert stats["strict_lint_refused_total"] == 2
        assert stats["lint_verdicts_cached"] == 1


# ---------------------------------------------------------------------------
# admission: 429 / 504 / 413
# ---------------------------------------------------------------------------


def _blocked_daemon(**kw):
    """A daemon whose simulate requests block on an Event — admission
    behavior becomes deterministic (no timer races)."""
    release = threading.Event()
    entered = threading.Event()

    def hook(endpoint, body):
        if body.get("block"):
            entered.set()
            assert release.wait(30.0), "test never released the hook"

    d = ServeDaemon(trace_root=FIXTURES, work_hook=hook, **kw)
    return d, release, entered


def test_429_when_queue_full():
    d, release, entered = _blocked_daemon(max_inflight=1, queue_depth=0)
    with d:
        c = ServeClient(d.url)
        # hold one request in-flight (the body carries the block flag
        # only through the hook; it prices normally once released)
        blocker = threading.Thread(target=lambda: ServeClient(d.url)._request(
            "POST", "/v1/simulate",
            {"trace": "matmul_512", "arch": "v5e", "block": True},
        ), daemon=True)
        blocker.start()
        assert entered.wait(10.0)
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="matmul_512", arch="v5e")
        assert ei.value.status == 429
        assert ei.value.retry_after_s is not None
        assert ei.value.retry_after_s >= 1.0
        release.set()
        blocker.join(timeout=30.0)
        # with the slot free again the same request succeeds
        assert c.simulate(trace="matmul_512", arch="v5e").sim_cycles > 0


def test_504_when_deadline_expires_in_queue():
    d, release, entered = _blocked_daemon(max_inflight=1, queue_depth=4)
    with d:
        c = ServeClient(d.url)
        blocker = threading.Thread(target=lambda: ServeClient(d.url)._request(
            "POST", "/v1/simulate",
            {"trace": "matmul_512", "arch": "v5e", "block": True},
        ), daemon=True)
        blocker.start()
        assert entered.wait(10.0)
        t0 = time.monotonic()
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="matmul_512", arch="v5e", deadline_ms=300)
        waited = time.monotonic() - t0
        assert ei.value.status == 504
        assert waited >= 0.25  # it genuinely queued until the deadline
        release.set()
        blocker.join(timeout=30.0)


def test_413_for_oversized_body():
    with ServeDaemon(trace_root=FIXTURES, max_request_bytes=1024) as d:
        c = ServeClient(d.url)
        with pytest.raises(ServeError) as ei:
            c.simulate(hlo_text="x" * 4096, arch="v5e")
        assert ei.value.status == 413


def test_queued_waiter_is_not_starved_by_fresh_arrivals():
    """FIFO admission: while a request is queued, a freed slot goes to
    it, not to whichever newcomer happens to arrive next — a steady
    arrival stream must not ride a queued request to its 504."""
    from tpusim_torch.serve.admission import AdmissionController

    adm = AdmissionController(max_inflight=1, queue_depth=4)
    order: list[str] = []
    first = adm.admit()
    waiter_ready = threading.Event()

    def waiter():
        waiter_ready.set()
        with adm.admit(deadline=time.monotonic() + 10.0):
            order.append("waiter")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    waiter_ready.wait(5.0)
    deadline = time.monotonic() + 5.0
    while adm.stats_dict()["queued"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    # newcomers while the waiter queues: they must line up BEHIND it
    results: list[str] = []

    def newcomer(tag):
        with adm.admit(deadline=time.monotonic() + 10.0):
            results.append(tag)
            order.append(tag)

    n1 = threading.Thread(target=newcomer, args=("n1",), daemon=True)
    n1.start()
    time.sleep(0.05)
    first.__exit__(None, None, None)  # free the slot
    t.join(timeout=10.0)
    n1.join(timeout=10.0)
    assert order[0] == "waiter", order  # the queued request went first


def test_job_queue_overload_429():
    d = ServeDaemon(trace_root=FIXTURES, job_queue_depth=1, job_workers=1)
    # NOT started: no job worker drains the queue, so the second submit
    # must bounce off the bounded table
    d.jobs.submit("sweep", {"arch": "v5p", "chips": 8})
    from tpusim_torch.serve.admission import Overloaded

    with pytest.raises(Overloaded):
        d.jobs.submit("sweep", {"arch": "v5p", "chips": 8})


# ---------------------------------------------------------------------------
# SIGTERM drain (real process)
# ---------------------------------------------------------------------------


def test_sigterm_drains_real_daemon(tmp_path):
    """``python -m tpusim_torch serve`` under SIGTERM: the in-flight request
    completes with 200, the process exits 0, and the listener is gone
    afterwards."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpusim_torch", "serve", "--port", "0",
         "--trace-root", str(FIXTURES), "--drain-grace-s", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO,
    )
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line, line
        url = line.split("listening on ", 1)[1].split()[0]
        c = ServeClient(url, timeout_s=120.0)

        result: dict = {}

        def slow_request():
            # cold llama: trace load + pricing keeps this in flight
            # long enough for the SIGTERM to land mid-request
            result["r"] = c.simulate(trace="llama_tiny_tp2dp2", arch="v5p")

        t = threading.Thread(target=slow_request, daemon=True)
        t.start()
        time.sleep(0.15)  # let the request reach the daemon
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=120.0)
        assert not t.is_alive(), "in-flight request never completed"
        assert result["r"].sim_cycles > 0  # drained, not dropped
        assert proc.wait(timeout=60.0) == 0  # the exit-0 contract
        out = proc.stdout.read()
        assert "drained" in out
        # the listener is really gone
        with pytest.raises(Exception):
            ServeClient(url, timeout_s=2.0).healthz()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_in_process_drain_rejects_new_work():
    """From the first drain instant, new requests get 503 and /healthz
    reports draining — load balancers stop routing before the listener
    disappears."""
    d = ServeDaemon(trace_root=FIXTURES).start()
    try:
        c = ServeClient(d.url)
        assert c.simulate(trace="matmul_512", arch="v5e").sim_cycles > 0
        assert c.healthz()["status"] == "ok"
        d.admission.start_drain()
        with pytest.raises(ServeError) as ei:
            c.simulate(trace="matmul_512", arch="v5e")
        assert ei.value.status == 503
        with pytest.raises(ServeError) as ei:
            c.healthz()
        assert ei.value.status == 503
        assert ei.value.doc.get("status") == "draining"
    finally:
        d.drain_and_stop()


# ---------------------------------------------------------------------------
# client timeouts + safe retries
# ---------------------------------------------------------------------------


@pytest.fixture()
def black_hole():
    """A server that accepts connections and never answers — the
    stalled-daemon stand-in."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    accepted = []

    def acceptor():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            accepted.append(conn)

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()
    try:
        yield srv.getsockname(), accepted
    finally:
        srv.close()
        for conn in accepted:
            try:
                conn.close()
            except OSError:
                pass


def test_client_get_times_out_and_retries(black_hole):
    """A stalled daemon can no longer block the client forever: the
    call times out, the (idempotent) GET retries once with backoff,
    and the failure surfaces as a typed 'timeout' error."""
    (host, port), accepted = black_hole
    c = ServeClient(
        f"http://{host}:{port}", timeout_s=0.3, retries=1,
        backoff_base_s=0.01,
    )
    t0 = time.monotonic()
    with pytest.raises(ServeError) as ei:
        c.healthz()
    assert ei.value.status == 0
    assert ei.value.code == "timeout"
    assert time.monotonic() - t0 < 5.0
    # both the original attempt and the retry reached the server
    assert len(accepted) == 2


def test_client_never_replays_a_sent_post(black_hole):
    """A POST whose bytes finished sending is NOT retried on timeout —
    the server may have executed it (a replayed /v1/sweep would
    enqueue a duplicate job)."""
    (host, port), accepted = black_hole
    c = ServeClient(
        f"http://{host}:{port}", timeout_s=0.3, retries=3,
        backoff_base_s=0.01,
    )
    with pytest.raises(ServeError) as ei:
        c.simulate(trace="matmul_512", arch="v5e")
    assert ei.value.code == "timeout"
    assert len(accepted) == 1  # one attempt, no replay


def test_client_per_call_timeout_override(black_hole):
    """timeout_s= on a single call beats the constructor default, even
    on a warm keep-alive connection."""
    (host, port), _accepted = black_hole
    c = ServeClient(f"http://{host}:{port}", timeout_s=60.0, retries=0)
    t0 = time.monotonic()
    with pytest.raises(ServeError):
        c.healthz(timeout_s=0.25)
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# Retry-After honoring (opt-in) + the preserved never-replay rules
# ---------------------------------------------------------------------------


@pytest.fixture()
def backpressure_server():
    """A stub daemon that 503s with Retry-After N times, then 202s —
    the restarting-primary / overloaded-queue stand-in.  Yields
    ``((host, port), hits, set_refusals)``."""
    import http.server

    hits: list[str] = []
    state = {"refusals": 1, "retry_after": "0.3"}

    class _H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0") or 0)
            self.rfile.read(length)
            hits.append(self.path)
            if len(hits) <= state["refusals"]:
                body = json.dumps({"error": "overloaded",
                                   "detail": "queue full"}).encode()
                self.send_response(503)
                self.send_header("Retry-After", state["retry_after"])
            else:
                body = json.dumps({"job_id": "job-000001",
                                   "status": "queued"}).encode()
                self.send_response(202)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address, hits, state
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_honors_retry_after_on_503(backpressure_server):
    """With honor_retry_after=True the client sleeps at least the
    server's hint and re-issues — safe even for a job submission,
    because a clean 503 means the server refused (nothing to replay)."""
    (host, port), hits, _state = backpressure_server
    c = ServeClient(
        f"http://{host}:{port}", retries=2, honor_retry_after=True,
        backoff_base_s=0.01,
    )
    t0 = time.monotonic()
    job_id = c.sweep(arch="v5p", chips=8)
    elapsed = time.monotonic() - t0
    assert job_id == "job-000001"
    assert len(hits) == 2              # one refusal + one success
    assert elapsed >= 0.3              # the hint was honored
    assert elapsed < 10.0              # and capped/jittered sanely


def test_client_retry_after_is_opt_in(backpressure_server):
    """The default client surfaces the 503 immediately — honoring is
    opt-in."""
    (host, port), hits, _state = backpressure_server
    c = ServeClient(f"http://{host}:{port}", retries=2)
    with pytest.raises(ServeError) as ei:
        c.sweep(arch="v5p", chips=8)
    assert ei.value.status == 503
    assert ei.value.retry_after_s == pytest.approx(0.3)
    assert len(hits) == 1


def test_client_retry_after_budget_exhausts(backpressure_server):
    """Refusals past the retries budget surface the last 503 — the
    client never spins forever on a saturated server."""
    (host, port), hits, state = backpressure_server
    state["refusals"] = 5
    state["retry_after"] = "0.01"
    c = ServeClient(
        f"http://{host}:{port}", retries=2, honor_retry_after=True,
        backoff_base_s=0.001,
    )
    with pytest.raises(ServeError) as ei:
        c.sweep(arch="v5p", chips=8)
    assert ei.value.status == 503
    assert len(hits) == 3              # initial + retries budget of 2


def test_honoring_client_still_never_replays_sent_post(black_hole):
    """honor_retry_after must not weaken the transport-level rule: a
    POST whose bytes finished sending and then TIMED OUT is never
    replayed — the server may still be executing it."""
    (host, port), accepted = black_hole
    c = ServeClient(
        f"http://{host}:{port}", timeout_s=0.3, retries=3,
        backoff_base_s=0.01, honor_retry_after=True,
    )
    with pytest.raises(ServeError) as ei:
        c.sweep(arch="v5p", chips=8)
    assert ei.value.code == "timeout"
    assert len(accepted) == 1          # one attempt, no replay


# ---------------------------------------------------------------------------
# JobTable boot robustness: torn persist files quarantine, never abort
# ---------------------------------------------------------------------------


def test_jobtable_recovery_quarantines_torn_persist_file(tmp_path):
    """A truncated per-job JSON file (daemon killed mid-persist before
    the atomic replace, or disk damage) quarantines with ONE warning;
    the healthy jobs recover intact."""
    import warnings as _warnings

    from tpusim_torch.serve.admission import JobTable

    jobs_dir = tmp_path / "jobs"
    jobs_dir.mkdir()
    healthy = {
        "job-000001": {"job_id": "job-000001", "kind": "sweep",
                       "request": {"arch": "v5p"}, "status": "queued"},
        "job-000003": {"job_id": "job-000003", "kind": "campaign",
                       "request": {"spec": {}}, "status": "done",
                       "result": {"ok": True}},
    }
    for jid, doc in healthy.items():
        (jobs_dir / f"{jid}.json").write_text(json.dumps(doc))
    # the torn file: a prefix of valid JSON (no closing brace)
    (jobs_dir / "job-000002.json").write_text(
        '{"job_id": "job-000002", "kind": "sweep", "requ'
    )

    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        table = JobTable(persist_dir=jobs_dir)
    warned = [w for w in caught if "job-000002" in str(w.message)]
    assert len(warned) == 1
    assert "quarantined" in str(warned[0].message)

    # the healthy jobs are all present, the torn one is gone
    assert table.get("job-000001").status == "queued"
    assert table.get("job-000003").status == "done"
    assert table.get("job-000002") is None
    assert table.recovered == 1        # the queued job re-enqueued
    assert (jobs_dir / "quarantine" / "job-000002.json").is_file()
    assert not (jobs_dir / "job-000002.json").exists()
    # id allocation continues past every healthy id
    job = table.submit("sweep", {"arch": "v5p"})
    assert job.job_id == "job-000004"

    # a SECOND boot over the same dir re-warns nothing (the damage
    # was moved aside, not left to re-trip every startup)
    with _warnings.catch_warnings(record=True) as caught2:
        _warnings.simplefilter("always")
        table2 = JobTable(persist_dir=jobs_dir)
    assert not [w for w in caught2 if "unreadable" in str(w.message)]
    assert table2.get("job-000001") is not None


def test_jobtable_recovery_quarantines_wrong_shape(tmp_path):
    """A file that parses as JSON but is not a job object (a list, a
    doc missing its request) also quarantines instead of silently
    lingering forever."""
    import warnings as _warnings

    from tpusim_torch.serve.admission import JobTable

    jobs_dir = tmp_path / "jobs"
    jobs_dir.mkdir()
    (jobs_dir / "job-000001.json").write_text(json.dumps(["not", "a", "job"]))
    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        table = JobTable(persist_dir=jobs_dir)
    assert len([w for w in caught if "job-000001" in str(w.message)]) == 1
    assert table.get("job-000001") is None
    assert (jobs_dir / "quarantine" / "job-000001.json").is_file()


# ---------------------------------------------------------------------------
# the port's daemon against the JAX package's, live
# ---------------------------------------------------------------------------

sys.path.insert(0, str(REPO / "ci"))
from check_golden import (  # noqa: E402
    ADVISE_SMOKE_SPEC,
    CAMPAIGN_SMOKE_SPEC,
    FLEET_SMOKE_SPEC,
    _serve_served_bytes,
)


@pytest.fixture(scope="module")
def pair():
    """(port daemon, JAX daemon) on the fixtures, each with a fresh
    in-memory result cache and two job threads."""
    from tpusim.serve.daemon import ServeDaemon as RefDaemon

    ours = ServeDaemon(trace_root=FIXTURES, job_workers=2).start()
    ref = RefDaemon(trace_root=FIXTURES, job_workers=2).start()
    yield ours, ref
    ours.drain_and_stop()
    ref.drain_and_stop()


def _call(d, method: str, path: str, body: dict | None = None):
    conn = http.client.HTTPConnection(d.host, d.port, timeout=300)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _masked(doc):
    """``doc`` without the model stamp each package mints for itself."""
    if isinstance(doc, dict):
        return {k: _masked(v) for k, v in doc.items()
                if k != "model_version"}
    if isinstance(doc, list):
        return [_masked(v) for v in doc]
    return doc


def _same_response(pair, path: str, body: dict) -> tuple[int, dict]:
    """POST ``body`` to both daemons and hold the port to the JAX
    package: status, keys, and every value but ``model_version`` (served
    ``stats`` by the served-bytes canon, the volatile host-clock keys
    aside).  Returns the port's (status, doc)."""
    ours, ref = pair
    s1, d1 = _call(ours, "POST", path, body)
    s2, d2 = _call(ref, "POST", path, body)
    assert s1 == s2, (d1, d2)
    assert sorted(d1) == sorted(d2)
    if "stats" in d1:
        assert _serve_served_bytes(d1["stats"]) == \
            _serve_served_bytes(d2["stats"])
        assert sorted(d1["stats"]) == sorted(d2["stats"])
        d1, d2 = dict(d1), dict(d2)
        d1.pop("stats")
        d2.pop("stats")
    assert _masked(d1) == _masked(d2)
    return s1, d1


def _same_job(pair, path: str, body: dict) -> dict:
    """Submit the same async job to both daemons, wait for both, and
    hold the port's job document to the JAX package's (the report
    ``==`` with ``model_version`` dropped).  Returns the port's."""
    ours, ref = pair
    s1, sub1 = _call(ours, "POST", path, body)
    s2, sub2 = _call(ref, "POST", path, body)
    assert s1 == s2 == 202, (sub1, sub2)
    assert sorted(sub1) == sorted(sub2)
    got = ServeClient(ours.url).wait_job(sub1["job_id"], timeout_s=240)
    want = ServeClient(ref.url).wait_job(sub2["job_id"], timeout_s=240)
    assert got.status == want.status == "done", (got.raw, want.raw)
    assert sorted(got.raw) == sorted(want.raw)
    assert _masked({k: v for k, v in got.raw.items() if k != "job_id"}) == \
        _masked({k: v for k, v in want.raw.items() if k != "job_id"})
    return got.raw


@pytest.mark.parametrize("fixture,arch,overlays", [
    ("matmul_512", "v5e", []),
    ("matmul_512", "v5p", []),
    ("llama_tiny_tp2dp2", "v5p", []),
    ("llama_tiny_tp2dp2", "v5p",
     [{"arch": {"ici": {"network_mode": "detailed"}}}]),
    ("llama_tiny_tp2dp2", "v6e", [{"power_enabled": True}]),
])
def test_live_simulate_equals_jax_daemon(pair, fixture, arch, overlays):
    body = {"trace": fixture, "arch": arch, "overlays": overlays,
            "tuned": False}
    status, doc = _same_response(pair, "/v1/simulate", body)
    assert status == 200 and not doc["cache_hit"]
    # the warm repeat: a cache hit in both, the same bytes
    status, doc = _same_response(pair, "/v1/simulate", body)
    assert status == 200 and doc["cache_hit"]


def test_live_inline_hlo_equals_jax_daemon(pair):
    text = (FIXTURES / "llama_tiny_tp2dp2" / "modules").glob("*.hlo")
    hlo = sorted(text)[0].read_text()
    for num_devices in (1, 4):
        status, doc = _same_response(pair, "/v1/simulate", {
            "hlo_text": hlo, "num_devices": num_devices, "arch": "v5p",
            "tuned": False,
        })
        assert status == 200 and doc["trace"].startswith("inline:")


def test_live_faults_and_partition_equal_jax_daemon(pair):
    status, _doc = _same_response(pair, "/v1/simulate", {
        "trace": "llama_tiny_tp2dp2", "arch": "v5p", "tuned": False,
        "faults": {"faults": [
            {"kind": "chip_straggler", "chip": 0, "clock_scale": 0.5},
            {"kind": "hbm_throttle", "chip": 1, "hbm_scale": 0.5},
        ]},
    })
    assert status == 200
    status, doc = _same_response(pair, "/v1/simulate", {
        "trace": "llama_tiny_tp2dp2", "arch": "v5p", "tuned": False,
        "overlays": [{"arch": {"ici": {"network_mode": "detailed"}}}],
        "faults": {"faults": [
            {"kind": "link_down", "src": 0, "dst": 1},
            {"kind": "link_down", "src": 0, "dst": 2},
        ]},
    })
    assert status == 422 and doc["error"] == "replay_failed"


def test_live_lint_and_refusals_equal_jax_daemon(pair):
    status, doc = _same_response(pair, "/v1/lint", {
        "trace": "llama_tiny_tp2dp2", "arch": "v5p"})
    assert status == 200 and doc["errors"] == 0
    status, doc = _same_response(pair, "/v1/lint", {
        "trace": "matmul_512", "arch": "v6e",
        "overlays": [{"arch": {"mxu_rows": 0}}]})
    assert status in (200, 400)
    for body in ({"trace": "nope", "arch": "v5p"},
                 {"hlo_text": "definitely not hlo {", "arch": "v5e"},
                 {"trace": "matmul_512", "arch": "v5e",
                  "overlays": ["flags.txt"]}):
        status, _doc = _same_response(pair, "/v1/simulate", body)
        assert status in (400, 404)


def test_live_sweeps_equal_jax_daemon(pair):
    doc = _same_job(pair, "/v1/sweep",
                    {"arch": "v5p", "chips": 8, "payload_mb": 1.0})
    assert doc["result"]["scenarios"] > 0
    doc = _same_job(pair, "/v1/sweep", {
        "trace": "llama_tiny_tp2dp2", "arch": "v5p", "max_scenarios": 2,
        "tuned": False})
    assert doc["result"]["scenarios"] == 2


def test_live_campaign_fleet_advise_equal_jax_daemon(pair):
    for path, spec in (("/v1/campaign", CAMPAIGN_SMOKE_SPEC),
                       ("/v1/fleet", FLEET_SMOKE_SPEC),
                       ("/v1/advise", ADVISE_SMOKE_SPEC)):
        doc = _same_job(pair, path,
                        {"trace": "llama_tiny_tp2dp2", "spec": spec})
        assert doc["result"], path

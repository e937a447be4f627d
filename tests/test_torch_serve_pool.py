"""The port's supervised worker pool (``serve --serve-workers``), and
the serve smokes of ``ci/check_golden.py`` run against the port.

Mirrors the pool tests of ``tests/test_serve.py`` (the supervised
pre-forked fleet with its chaos hooks armed: SIGKILL mid-request,
poison-request quarantine, deadline kills, degraded-pool shedding,
affinity), then ``serve_smoke`` and ``serve_chaos_smoke``
(``ci/check_golden.py:766``, ``:908``) at ``serve_workers`` 0 and 2: the
golden matrix served cold equals the committed goldens by the
served-bytes canon, a warm pass is all ``cache_hit`` with zero engine
walks in the serving process, ``/metrics`` carries the serve counters,
and a worker SIGKILLed mid-matrix costs no request.

One cell of the matrix, ``llama_tiny_tp2dp2`` at v6e with power, misses
its golden by one ulp in ``energy_dynamic_j`` in both packages on this
interpreter (Python 3.12's compensated float ``sum``, ROADMAP A8): that
cell is held to the JAX package's daemon by bytes and to the golden under
``compare``.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.serve.client import ServeClient  # noqa: E402
from tpusim_torch.serve.daemon import ServeDaemon  # noqa: E402
from tpusim_torch.timing.engine import Engine  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "traces"

sys.path.insert(0, str(REPO / "ci"))
from check_golden import (  # noqa: E402
    MATRIX,
    _overlay_tag,
    _serve_golden_bytes,
    _serve_served_bytes,
    compare,
)

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


@pytest.fixture(scope="module")
def daemon():
    d = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    yield d
    d.drain_and_stop()


@pytest.fixture(scope="module")
def client(daemon):
    return ServeClient(daemon.url)

# ---------------------------------------------------------------------------
# supervised worker pool — chaos paths
# ---------------------------------------------------------------------------
#
# These tests exercise the supervision policies with the daemon's
# chaos hooks armed (``chaos_hooks=True``: ``_chaos_exit`` makes the
# worker ``os._exit`` the instant the request lands, ``_chaos_sleep_s``
# stalls it before pricing — a stand-in for a hung native call).  The
# invariant under test throughout: one bad request costs exactly one
# worker, never the service, and every surviving response stays
# byte-identical to the single-process path.


def _raw_post(daemon, path, body, timeout=60.0):
    """POST without the typed client: chaos bodies carry hook keys the
    client API (rightly) has no parameter for, and some assertions need
    the raw status + headers."""
    conn = http.client.HTTPConnection(daemon.host, daemon.port, timeout=timeout)
    try:
        conn.request(
            "POST", path, body=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, dict(resp.getheaders()), json.loads(payload)
    finally:
        conn.close()


@pytest.fixture(scope="module")
def pool_daemon(tmp_path_factory):
    # Workers pin their environment AT FORK TIME.  This module-scoped
    # fixture is created before the function-scoped autouse
    # ``_isolate_tuned_overlays`` patch, so without pinning here the
    # fleet would fork with the repo's tuned overlays visible while the
    # in-process daemons compose lazily under the per-test isolation —
    # and "byte-identical" would fail on a config skew, not a pool bug.
    old = os.environ.get("TPUSIM_TUNED_DIR")
    os.environ["TPUSIM_TUNED_DIR"] = str(
        tmp_path_factory.mktemp("no_tuned_pool")
    )
    d = ServeDaemon(
        trace_root=FIXTURES, max_inflight=4, serve_workers=2,
        chaos_hooks=True,
    ).start()
    try:
        yield d
    finally:
        d.drain_and_stop()
        if old is None:
            os.environ.pop("TPUSIM_TUNED_DIR", None)
        else:
            os.environ["TPUSIM_TUNED_DIR"] = old


@pytest.fixture(scope="module")
def pool_client(pool_daemon):
    return ServeClient(pool_daemon.url)


def test_multi_worker_byte_identical_to_single_process(pool_client, client):
    """The byte-identity contract across 1..N workers: the supervised
    pool's stats docs equal the single-process daemon's for the same
    requests (the CI serve smoke extends this to the full golden
    matrix)."""
    for trace, arch in (("llama_tiny_tp2dp2", "v5p"), ("matmul_512", "v5e")):
        multi = pool_client.simulate(trace=trace, arch=arch)
        single = client.simulate(trace=trace, arch=arch)
        assert canonical(multi.stats) == canonical(single.stats)


def test_healthz_and_metrics_expose_worker_fleet(pool_client):
    health = pool_client.healthz()
    assert health["workers_configured"] == 2
    assert health["workers_alive"] >= 1
    docs = health["workers"]
    assert len(docs) == 2
    assert {d["index"] for d in docs} == {0, 1}
    for key in ("alive", "pid", "restarts", "kills", "crashes"):
        assert key in docs[0]
    prom = pool_client.metrics_text()
    for gauge in (
        "serve_workers_alive", "serve_worker_restarts_total",
        "serve_worker_kills_total", "serve_quarantine_size",
        "serve_shed_503_total",
    ):
        assert f"tpusim_{gauge} " in prom


def test_sigkilled_worker_mid_request_is_retried_byte_identical(
    pool_daemon, pool_client, client,
):
    """The headline chaos path: SIGKILL the worker while it holds a
    request.  The daemon survives, the request is retried on a fresh
    worker and answers 200 with stats byte-identical to the
    single-process baseline, and the supervisor records the restart."""
    sup = pool_daemon.supervisor
    baseline = client.simulate(trace="matmul_512", arch="v5e")
    restarts0 = sum(s.restarts for s in sup.slots)
    retried0 = sup.retried
    out = {}

    def go():
        out["resp"] = _raw_post(pool_daemon, "/v1/simulate", {
            "trace": "matmul_512", "arch": "v5e",
            "_chaos_sleep_s": 1.0,  # a window to land the SIGKILL in
        })

    t = threading.Thread(target=go, daemon=True)
    t.start()
    victim = None
    deadline = time.monotonic() + 5.0
    while victim is None and time.monotonic() < deadline:
        for s in sup.slots:
            if s.busy and s.pid is not None:
                victim = s.pid
                break
        time.sleep(0.01)
    assert victim is not None, "request never reached a worker"
    os.kill(victim, signal.SIGKILL)
    t.join(timeout=60.0)
    assert not t.is_alive(), "request never completed after the kill"
    status, _headers, doc = out["resp"]
    assert status == 200, doc
    assert canonical(doc["stats"]) == canonical(baseline.stats)
    assert sup.retried == retried0 + 1
    # the dead slot is respawned (poll: restart rides the monitor loop)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if (sum(s.restarts for s in sup.slots) >= restarts0 + 1
                and sup.alive_count() == 2):
            break
        time.sleep(0.02)
    assert sum(s.restarts for s in sup.slots) >= restarts0 + 1
    assert sup.alive_count() == 2


def test_poison_request_quarantined_after_retry_budget(
    pool_daemon, pool_client,
):
    """A request that kills EVERY worker it lands on burns its retry
    budget, then 422s with a diagnostic; the identical request is
    refused immediately (no further worker deaths) and the pool keeps
    serving clean traffic."""
    sup = pool_daemon.supervisor
    body = {"trace": "llama_tiny_tp2dp2", "arch": "v5p", "_chaos_exit": True}
    status, _headers, doc = _raw_post(pool_daemon, "/v1/simulate", body)
    assert status == 422, doc
    assert doc["error"] == "poison_request"
    assert doc["poison"]["worker_deaths"] == 2  # original + one retry
    assert doc["poison"]["content_hash"]
    # identical request again: quarantine answers, nobody dies
    crashes0 = sum(s.crashes for s in sup.slots)
    status2, _h2, doc2 = _raw_post(pool_daemon, "/v1/simulate", body)
    assert status2 == 422 and doc2["error"] == "poison_request"
    assert sum(s.crashes for s in sup.slots) == crashes0
    # a different deadline is the same poison (volatile keys stripped
    # from the quarantine identity)
    status3, _h3, doc3 = _raw_post(
        pool_daemon, "/v1/simulate", {**body, "deadline_ms": 9999},
    )
    assert status3 == 422 and doc3["error"] == "poison_request"
    # the poison burned both workers; once the backed-off restarts land
    # (what Retry-After tells a real client to wait for) the pool
    # serves clean traffic again
    deadline = time.monotonic() + 10.0
    while sup.alive_count() < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sup.alive_count() == 2
    r = pool_client.simulate(trace="llama_tiny_tp2dp2", arch="v5p")
    assert r.sim_cycles > 0


def test_deadline_kill_of_stuck_worker_504_and_restart(
    pool_daemon, pool_client,
):
    """A worker stuck past the request deadline is killed (SIGTERM →
    SIGKILL escalation), the request 504s, and the slot is restarted —
    a hung native call can no longer pin the daemon."""
    sup = pool_daemon.supervisor
    kills0 = sum(s.kills for s in sup.slots)
    status, _headers, doc = _raw_post(pool_daemon, "/v1/simulate", {
        "trace": "matmul_512", "arch": "v5e",
        "_chaos_sleep_s": 30.0, "deadline_ms": 400,
    })
    assert status == 504, doc
    assert doc["error"] == "deadline_exceeded"
    assert "killed" in doc["detail"]
    assert sum(s.kills for s in sup.slots) == kills0 + 1
    # the killed slot comes back and the pool keeps serving
    deadline = time.monotonic() + 10.0
    while sup.alive_count() < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sup.alive_count() == 2
    assert pool_client.simulate(trace="matmul_512", arch="v5e").sim_cycles > 0


def test_degraded_pool_sheds_load_503_with_retry_after():
    """Once live workers fall below the floor the daemon sheds load
    (503 + Retry-After) instead of queueing into a dead pool, and
    /healthz reports the degraded state (200 — the daemon itself is
    answering; balancers read the field)."""
    d = ServeDaemon(
        trace_root=FIXTURES, serve_workers=1, min_workers=1,
        restart_backoff_s=5.0, chaos_hooks=True,
    ).start()
    try:
        c = ServeClient(d.url)
        assert c.simulate(trace="matmul_512", arch="v5e").sim_cycles > 0
        d.supervisor.kill_worker(0)
        deadline = time.monotonic() + 5.0
        while d.supervisor.alive_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert d.supervisor.alive_count() == 0
        status, headers, doc = _raw_post(
            d, "/v1/simulate", {"trace": "matmul_512", "arch": "v5e"},
        )
        assert status == 503, doc
        assert doc["error"] == "degraded"
        assert int(headers.get("Retry-After", "0")) >= 1
        assert d.supervisor.shed >= 1
        health = c.healthz()
        assert health["status"] == "degraded"
        assert health["workers_alive"] == 0
    finally:
        d.drain_and_stop()


def test_affinity_key_ignores_deadline_but_not_content():
    from tpusim_torch.serve.supervisor import Supervisor

    a = Supervisor.affinity_key("simulate", {"trace": "x", "deadline_ms": 100})
    b = Supervisor.affinity_key("simulate", {"trace": "x", "deadline_ms": 900})
    other = Supervisor.affinity_key("simulate", {"trace": "y"})
    assert a == b
    assert a != other



# ---------------------------------------------------------------------------
# ci/check_golden.py's serve smokes, against the port
# ---------------------------------------------------------------------------


def _matrix_names() -> list[tuple[str, str, list]]:
    out = []
    for fixture, arch, overlays in MATRIX:
        name = f"{fixture}__{arch}"
        tag = _overlay_tag(overlays)
        if tag:
            name += "__" + tag
        out.append((name, (fixture, arch, overlays)))
    return out


@pytest.fixture(scope="module")
def jax_served() -> dict[str, str]:
    """The JAX package's daemon's served bytes of every matrix cell."""
    from tpusim.serve.client import ServeClient as RefClient
    from tpusim.serve.daemon import ServeDaemon as RefDaemon

    with RefDaemon(trace_root=FIXTURES) as d:
        c = RefClient(d.url)
        return {
            name: _serve_served_bytes(c.simulate(
                trace=fixture, arch=arch, overlays=list(overlays),
                tuned=False,
            ).stats)
            for name, (fixture, arch, overlays) in _matrix_names()
        }


def _held_to_golden(name: str, served: str, jax_served: dict) -> None:
    """The served bytes equal the committed golden's; where the JAX
    package's daemon misses that golden too (one cell, A8), they equal
    the JAX daemon's bytes and pass ``compare`` against the golden."""
    golden = _serve_golden_bytes(name)
    if jax_served[name] == golden:
        assert served == golden, name
    else:
        assert served == jax_served[name], name
        assert compare({name: json.loads(served)}) == [], name


def _counting_walks(runs: dict):
    orig = Engine.run

    def counting(self, module):
        runs["n"] += 1
        return orig(self, module)

    return orig, counting


@pytest.mark.parametrize("serve_workers", [0, 2])
def test_serve_smoke_golden_matrix(serve_workers, jax_served):
    runs = {"n": 0}
    orig, counting = _counting_walks(runs)
    d = ServeDaemon(trace_root=FIXTURES, max_inflight=4,
                    serve_workers=serve_workers)
    if serve_workers:
        # the pool prices in child processes: the parent prices nothing
        # in either pass, so count from before the cold one
        Engine.run = counting
    d.start()
    try:
        c = ServeClient(d.url)
        health = c.healthz()
        assert health["status"] == "ok"
        if serve_workers:
            assert health["workers_alive"] == serve_workers

        def run_pass():
            return [(name, c.simulate(trace=fixture, arch=arch,
                                      overlays=list(overlays), tuned=False))
                    for name, (fixture, arch, overlays) in _matrix_names()]

        cold = run_pass()
        for name, r in cold:
            _held_to_golden(name, _serve_served_bytes(r.stats), jax_served)
        Engine.run = counting
        try:
            warm = run_pass()
        finally:
            Engine.run = orig
        assert runs["n"] == 0
        assert [name for name, r in warm if not r.cache_hit] == []
        for (name, a), (_n, b) in zip(cold, warm):
            assert _serve_served_bytes(a.stats) == \
                _serve_served_bytes(b.stats), name
        prom = c.metrics_text()
        for line in prom.splitlines():
            if line and not line.startswith("#"):
                _key, value = line.split()
                float(value)
        required = ["serve_requests_total", "serve_cache_hits"]
        if serve_workers:
            required += ["serve_workers_alive", "serve_worker_restarts_total",
                         "serve_worker_kills_total", "serve_quarantine_size",
                         "serve_shed_503_total"]
        for key in required:
            assert f"tpusim_{key} " in prom, key
    finally:
        Engine.run = orig
        assert d.drain_and_stop()


def test_serve_chaos_smoke_sigkill_mid_matrix(jax_served):
    d = ServeDaemon(trace_root=FIXTURES, max_inflight=4,
                    serve_workers=2).start()
    sup = d.supervisor
    stop = threading.Event()
    killed = {"pid": None}

    def chaos():
        # SIGKILL a worker the moment one holds a request, exactly once
        while not stop.is_set():
            for slot in sup.slots:
                if slot.busy and slot.pid is not None:
                    killed["pid"] = slot.pid
                    sup.kill_worker(slot.index)
                    return
            stop.wait(0.002)

    t = threading.Thread(target=chaos, daemon=True)
    try:
        c = ServeClient(d.url)
        t.start()
        for _ in range(2):
            for name, (fixture, arch, overlays) in _matrix_names():
                r = c.simulate(trace=fixture, arch=arch,
                               overlays=list(overlays), tuned=False)
                _held_to_golden(name, _serve_served_bytes(r.stats),
                                jax_served)
        stop.set()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert killed["pid"] is not None
        assert sum(s.restarts for s in sup.slots) >= 1
    finally:
        stop.set()
        assert d.drain_and_stop()


def test_guard_smoke_coop_cancel_keeps_the_worker():
    """``guard_smoke``'s leg 2 (``ci/check_golden.py:1811``): a request
    past its deadline answers 504 through the worker's in-process cancel;
    the worker keeps its pid, answers the next request warm with the same
    bytes, and the cooperative-cancel counter is on ``/metrics``."""
    d = ServeDaemon(trace_root=FIXTURES, serve_workers=2,
                    chaos_hooks=True).start()
    try:
        c = ServeClient(d.url)
        warmup = c.simulate(trace="matmul_512", arch="v5e", tuned=False)
        pids = [w["pid"] for w in c.healthz()["workers"]]
        resp, payload = c._raw("POST", "/v1/simulate", {
            "trace": "matmul_512", "arch": "v5e", "tuned": False,
            "_chaos_spin_s": 10, "deadline_ms": 400,
        })
        doc = json.loads(payload)
        assert resp.status == 504 and "cooperative" in doc["detail"]
        health = c.healthz()
        assert [w["pid"] for w in health["workers"]] == pids
        assert sum(w["restarts"] for w in health["workers"]) == 0
        assert sum(w["kills"] for w in health["workers"]) == 0
        assert "tpusim_serve_worker_coop_cancels_total 1" in c.metrics_text()
        repeat = c.simulate(trace="matmul_512", arch="v5e", tuned=False)
        assert repeat.cache_hit
        assert _serve_served_bytes(repeat.stats) == \
            _serve_served_bytes(warmup.stats)
    finally:
        assert d.drain_and_stop()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 on the CPU host
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_copies_the_served_bytes_canon():
    smoke = _chip_smoke()
    stats = json.loads(_serve_golden_bytes("llama_tiny_tp2dp2__v5p"))
    stats.update({"cache_hits": 1, "fastpath_backend": "vectorized",
                  "wall_seconds": 0.5, "guard_x": 1, "pool_workers": 2})
    assert smoke.served_bytes(stats) == _serve_served_bytes(stats)


def test_chip_smoke_serving_plane_on_cpu(tmp_path, capsys):
    """Phase 17, rehearsed on the CPU host: the card's captures stand in
    as the JAX package's committed traces of the same names (the silicon
    corpus, and the two fixtures for the flash and all-reduce captures)."""
    smoke = _chip_smoke()
    kept = tmp_path / "kept"
    kept.mkdir()
    for name in smoke.LOWERED:
        (kept / name).symlink_to(REPO / "reports" / "silicon" / name)
    (kept / "flash_attention_pallas").symlink_to(FIXTURES / "matmul_512")
    (kept / "ici_allreduce").symlink_to(FIXTURES / "llama_tiny_tp2dp2")
    work = tmp_path / "work"
    work.mkdir()
    prev = os.environ.get("TPUSIM_STREAM_THRESHOLD")
    out = smoke.serving_plane("cpu", work, kept)
    assert os.environ.get("TPUSIM_STREAM_THRESHOLD") == prev
    assert out["a"]["walks"] == out["b"]["pool"]["walks"] == 0
    # one ulp in one cell, in both packages (ROADMAP A8)
    assert sum(out["a"]["float_gaps"].values()) == 1
    assert out["b"]["chaos"]["restarts"] >= 1
    assert out["b"]["coop_cancel"]["restarts"] == 0
    assert out["c"]["cells"] == out["c"]["hot_hits"] == 24
    assert out["a"]["warm_p50_ms"] > 0
    assert out["launches"] == {"flash_attention": 0, "scan_rows": 0}
    text = capsys.readouterr().out
    for part in "abcd":
        assert f"  ({part}) " in text
    assert "  serving plane: matmul_512 @ v5e warm served p50" in text

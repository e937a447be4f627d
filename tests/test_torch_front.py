"""The port's multi-acceptor front tier (``serve --acceptors``) on the CPU,
mirroring the front half of ``tests/test_front.py`` and held to a live
JAX ``FrontSupervisor``.

* a two-acceptor fleet behind one SO_REUSEPORT port: fleet ``/healthz``
  (both acceptors, acceptor 0 the primary), a simulate round trip, the
  standalone daemon's bytes, a warm repeat served from the shared hot
  cache (counted on ``/metrics``), the fleet-wide ``/metrics`` merge
  (``?scope=local`` one acceptor's), async jobs on any acceptor proxied
  to the primary's one id space, and an acceptor SIGKILLed under traffic
  healed with no client-visible failure;
* the golden matrix served by the port's front equals the JAX front's
  served bytes (``_serve_served_bytes``, ``ci/check_golden.py:755``) by
  ``==``, first and repeated, and the committed goldens under the float rule
  (golden cell 5 misses its golden by one ulp in both packages on
  Python 3.12, ROADMAP A8);
* ``TPUSIM_NO_REUSEPORT=1``: the fd-passing fallback serves the same
  bytes and heals an acceptor kill too;
* a poison verdict of one acceptor's supervisor refuses the body in
  another's (the shared quarantine);
* ``python -m tpusim_torch serve --acceptors 2`` prints its startup line
  and drains on SIGTERM.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.serve.client import ServeClient  # noqa: E402
from tpusim_torch.serve.daemon import ServeDaemon  # noqa: E402
from tpusim_torch.serve.front import FrontSupervisor  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
sys.path.insert(0, str(REPO / "ci"))
from check_golden import (  # noqa: E402
    MATRIX,
    _overlay_tag,
    _serve_golden_bytes,
    _serve_served_bytes,
    compare,
)

VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}


def canonical(stats: dict) -> str:
    return json.dumps(
        {k: v for k, v in stats.items() if k not in VOLATILE},
        indent=1, sort_keys=True,
    )


def _metric(text: str, key: str) -> float:
    for line in text.splitlines():
        if line.startswith(f"tpusim_{key} "):
            return float(line.split()[1])
    return 0.0


def _settings(root: Path) -> dict:
    return {
        "trace_root": str(FIXTURES),
        "max_inflight": 4,
        "hot_cache": str(root / "hot"),
        "quarantine_dir": str(root / "quarantine"),
    }


@pytest.fixture(scope="module")
def untuned(tmp_path_factory):
    """The fleets fork before any per-test isolation: pin an empty tuned
    overlay dir in the environment they inherit."""
    old = os.environ.get("TPUSIM_TUNED_DIR")
    os.environ["TPUSIM_TUNED_DIR"] = str(tmp_path_factory.mktemp("untuned"))
    yield
    if old is None:
        os.environ.pop("TPUSIM_TUNED_DIR", None)
    else:
        os.environ["TPUSIM_TUNED_DIR"] = old


@pytest.fixture(scope="module")
def front(untuned, tmp_path_factory):
    f = FrontSupervisor(_settings(tmp_path_factory.mktemp("front")),
                        num_acceptors=2, restart_backoff_s=0.1).start()
    try:
        yield f
    finally:
        f.stop()


@pytest.fixture(scope="module")
def jax_front(untuned, tmp_path_factory):
    from tpusim.serve.front import FrontSupervisor as RefFront

    f = RefFront(_settings(tmp_path_factory.mktemp("jax_front")),
                 num_acceptors=2, restart_backoff_s=0.1).start()
    try:
        yield f
    finally:
        f.stop()


@pytest.fixture(scope="module")
def front_client(front):
    return ServeClient(front.url, retries=3)


def test_front_round_trip_and_fleet_health(front, front_client):
    assert front.reuse_port
    health = front_client.healthz()
    assert health["status"] == "ok"
    assert health["acceptors_alive"] == 2
    assert health["acceptors_configured"] == 2
    indices = {a["acceptor_index"] for a in health["acceptors"]}
    assert indices == {0, 1}
    primary = [a for a in health["acceptors"] if a.get("primary")]
    assert len(primary) == 1 and primary[0]["acceptor_index"] == 0
    r = front_client.simulate(trace="matmul_512", arch="v5e")
    assert r.sim_cycles > 0


def test_front_served_bytes_match_plain_daemon(front_client):
    """Byte-identity across topologies: the fleet's response equals the
    standalone daemon's for the same request."""
    plain = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    try:
        want = ServeClient(plain.url).simulate(
            trace="llama_tiny_tp2dp2", arch="v5p",
        )
        got = front_client.simulate(trace="llama_tiny_tp2dp2", arch="v5p")
        assert canonical(got.stats) == canonical(want.stats)
    finally:
        plain.drain_and_stop()


def _matrix():
    for fixture, arch, overlays in MATRIX:
        name = f"{fixture}__{arch}"
        tag = _overlay_tag(overlays)
        if tag:
            name += "__" + tag
        yield name, fixture, arch, overlays


def test_front_serves_the_golden_matrix_as_the_jax_front(front, jax_front):
    """Every golden cell, first and repeated (fresh connections, so both
    acceptors serve, priced or from a cache): the port's front's served
    bytes equal the JAX front's by ``==``, and the golden's where the JAX
    front meets it; the one cell both miss by an ulp passes
    ``compare``."""
    from tpusim.serve.client import ServeClient as RefClient

    for name, fixture, arch, overlays in _matrix():
        req = dict(trace=fixture, arch=arch, overlays=list(overlays),
                   tuned=False)
        for leg in ("first", "repeated"):
            got = ServeClient(front.url, retries=3).simulate(**req)
            want = RefClient(jax_front.url, retries=3).simulate(**req)
            served = _serve_served_bytes(got.stats)
            assert served == _serve_served_bytes(want.stats), (name, leg)
            golden = _serve_golden_bytes(name)
            if _serve_served_bytes(want.stats) == golden:
                assert served == golden, name
            else:
                assert compare({name: json.loads(served)}) == [], name


def test_front_warm_repeat_is_hot_hit(front, front_client):
    before = _metric(
        front_client.metrics_text(), "serve_hot_hits_total",
    )
    front_client.simulate(trace="matmul_512", arch="v5e")  # publishes
    r = front_client.simulate(trace="matmul_512", arch="v5e")
    assert r.cache_hit
    after = _metric(front_client.metrics_text(), "serve_hot_hits_total")
    assert after > before


def test_front_metrics_merge_is_fleet_wide(front, front_client, jax_front):
    """/metrics merges every acceptor; ?scope=local stays one
    acceptor's view; the fleet view names what the JAX front's does."""
    from tpusim.serve.client import ServeClient as RefClient

    fleet = front_client.metrics_text()
    assert _metric(fleet, "serve_acceptors_alive") == 2
    assert _metric(fleet, "serve_acceptors_configured") == 2
    # fleet-summed request counter >= any local view's
    resp, payload = front_client._raw("GET", "/metrics?scope=local")
    local = payload.decode()
    assert "serve_acceptors_alive" not in local
    assert _metric(fleet, "serve_requests_total") >= _metric(
        local, "serve_requests_total",
    )

    def names(text):
        return {ln.split()[0].split("{")[0] for ln in text.splitlines()
                if ln.startswith("tpusim_serve_acceptor")}

    assert names(fleet) == names(RefClient(jax_front.url).metrics_text())


def test_front_jobs_proxied_to_primary(front, front_client):
    """Async jobs work through ANY acceptor: submissions and polls on
    secondaries proxy to the primary's JobTable (single-owner ids)."""
    ids = set()
    for _ in range(4):  # fresh connections spread over acceptors
        c = ServeClient(front.url)
        jid = c.sweep(arch="v5p", chips=8, payload_mb=1)
        st = c.wait_job(jid, timeout_s=60)
        assert st.status == "done"
        ids.add(jid)
    assert len(ids) == 4  # one id space: the primary owns the table


def _kill_and_heal(f, url: str) -> None:
    """SIGKILL acceptor 1 mid-traffic: every idempotent simulate still
    answers (the client reconnects onto the survivor), the supervisor
    respawns the slot, and the fleet view recovers."""
    ServeClient(url, retries=3).simulate(trace="matmul_512", arch="v5e")
    boots_before = f.slots[1].boots
    for i in range(30):
        if i == 5:
            f.kill_acceptor(1)
        r = ServeClient(url, retries=3).simulate(
            trace="matmul_512", arch="v5e",
        )
        assert r.cache_hit
    deadline = time.monotonic() + 20
    while (
        f.slots[1].boots <= boots_before or not f.slots[1].alive
    ) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert f.slots[1].boots > boots_before
    assert f.slots[1].alive
    assert ServeClient(url, retries=3).healthz()["acceptors_alive"] == 2


def test_front_acceptor_kill_heals_under_traffic(front):
    _kill_and_heal(front, front.url)


def test_front_fd_fallback_serves_and_heals(tmp_path, monkeypatch, untuned):
    """TPUSIM_NO_REUSEPORT=1 forces the parent-accept + send_fds path:
    same API, same bytes, and an acceptor kill heals there too."""
    monkeypatch.setenv("TPUSIM_NO_REUSEPORT", "1")
    f = FrontSupervisor(_settings(tmp_path), num_acceptors=2,
                        restart_backoff_s=0.1).start()
    plain = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    try:
        assert not f.reuse_port
        c = ServeClient(f.url)
        assert c.healthz()["acceptors_alive"] == 2
        r1 = c.simulate(trace="matmul_512", arch="v5e")
        r2 = c.simulate(trace="matmul_512", arch="v5e")
        assert not r1.cache_hit and r2.cache_hit
        want = ServeClient(plain.url).simulate(trace="matmul_512",
                                               arch="v5e")
        assert _serve_served_bytes(r2.stats) == \
            _serve_served_bytes(want.stats)
        _kill_and_heal(f, f.url)
    finally:
        plain.drain_and_stop()
        assert f.stop()


def test_shared_quarantine_across_supervisors(tmp_path):
    """A poison verdict published by one acceptor's supervisor refuses
    the same body in ANOTHER acceptor's supervisor immediately — no
    worker deaths spent re-learning it."""
    from tpusim_torch.serve.supervisor import Supervisor
    from tpusim_torch.serve.worker import RequestError

    qdir = tmp_path / "quarantine"
    sup_a = Supervisor({}, num_workers=1, quarantine_dir=qdir)
    sup_b = Supervisor({}, num_workers=1, quarantine_dir=qdir)
    body = {"trace": "t", "hlo_text": None}
    key = Supervisor.affinity_key("simulate", body)
    sup_a._quarantine_add(key, "simulate", body, "killed 2 workers")
    with pytest.raises(RequestError) as ei:
        sup_b.execute("simulate", body)
    assert ei.value.status == 422
    assert ei.value.extra["poison"]["content_hash"] == key
    assert sup_b.poisoned == 1


def test_cli_serve_acceptors_starts_and_drains(untuned):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpusim_torch", "serve", "--port", "0",
         "--trace-root", str(FIXTURES), "--acceptors", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("tpusim_torch serve: listening on http://"), \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        assert "acceptors 2 via SO_REUSEPORT" in line
        url = line.split()[4]
        r = ServeClient(url, retries=3).simulate(trace="matmul_512",
                                                 arch="v5e")
        assert r.sim_cycles > 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert "tpusim_torch serve: drained, exiting" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

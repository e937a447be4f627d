"""Multi-node cluster contract of the port (``tpusim_torch.serve.cluster``).

Mirrors ``tests/test_cluster.py`` but for its three distributed-campaign
tests (``campaign/shard.py`` and ``--nodes`` are not ported yet,
ROADMAP A11 item 2).

Membership: the primary's registry is the single epoch writer — epochs
only climb, a rejoin carrying a stale epoch is refused (split-brain
safety), a node missing K heartbeats is marked dead with the death
rebroadcast to survivors through the beat-response view (pull gossip).

Affinity: the consistent-hash ring moves ONLY a dead node's keys when
membership changes, and skips members that are shedding.

Client failover: idempotent requests move to another known member on
connection-refused/reset; submissions that finished sending and ANY
timed-out request never do.

Observability: the ``cluster_`` stats namespace and the ``node_id``
field on access-log lines / trace docs exist ONLY when clustered — the
single-node path stays byte-identical, pinned here.  Two live daemons
join, forward and heal.
"""


from __future__ import annotations

import json
import signal
import socket
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.serve.cluster import (  # noqa: E402
    AffinityRing,
    ClusterRegistry,
    HeartbeatLoop,
    StaleEpoch,
    alive_members,
    parse_addr,
    ring_for,
    seeded_jitter,
)

FIXTURES = Path(__file__).parent / "fixtures" / "traces"
TRACE = FIXTURES / "llama_tiny_tp2dp2"


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def registry(**kw) -> tuple[ClusterRegistry, FakeClock]:
    clock = FakeClock()
    kw.setdefault("beat_interval_s", 1.0)
    kw.setdefault("missed_beats", 3)
    reg = ClusterRegistry(
        "prim:1", "http://prim:1", clock=clock, **kw,
    )
    return reg, clock


# -- membership / epoch -----------------------------------------------------

def test_epoch_monotonic_across_joins_beats_and_deaths():
    reg, clock = registry()
    seen = [reg.epoch]
    seen.append(reg.join("a:1", "http://a:1")["epoch"])
    seen.append(reg.join("b:2", "http://b:2")["epoch"])
    seen.append(reg.beat("a:1", epoch=seen[-1])["epoch"])
    clock.now += 10.0          # both members blow their beat deadline
    reg.reap()
    seen.append(reg.epoch)
    seen.append(reg.join("a:1", "http://a:1")["epoch"])  # heal rejoin
    assert seen == sorted(seen), seen
    assert len(set(seen)) >= 4  # joins and the death sweep each bumped


def test_stale_rejoin_refused_fresh_rejoin_accepted():
    reg, clock = registry()
    v1 = reg.join("a:1", "http://a:1")
    reg.join("b:2", "http://b:2")          # epoch moves past v1
    with pytest.raises(StaleEpoch):
        reg.join("a:1", "http://a:1", epoch=v1["epoch"] - 1)
    assert reg.stats_dict()["cluster_stale_rejoins_total"] == 1
    # epoch 0 is the declared-fresh path: always accepted (the heal)
    v = reg.join("a:1", "http://a:1", epoch=0)
    assert any(
        m["node_id"] == "a:1" and m["alive"] for m in v["members"]
    )


def test_heartbeat_timeout_death_is_rebroadcast_to_survivors():
    reg, clock = registry()
    va = reg.join("a:1", "http://a:1")
    vb = reg.join("b:2", "http://b:2")
    # a beats at the deadline minus epsilon; b goes silent
    clock.now += 2.9
    va = reg.beat("a:1", epoch=vb["epoch"])
    clock.now += 0.2                      # b is now past 3 * 1.0s
    died = reg.reap()
    assert died == ["b:2"]
    assert reg.stats_dict()["cluster_deaths_total"] == 1
    # the survivor's NEXT beat response carries the death (pull gossip)
    view = reg.beat("a:1", epoch=va["epoch"])
    dead = {
        m["node_id"] for m in view["members"] if not m["alive"]
    }
    assert dead == {"b:2"}
    assert {m["node_id"] for m in alive_members(view)} == {
        "prim:1", "a:1",
    }


def test_beat_from_dead_or_unknown_node_refused():
    reg, clock = registry()
    v = reg.join("a:1", "http://a:1")
    clock.now += 10.0
    reg.reap()
    with pytest.raises(StaleEpoch):
        reg.beat("a:1", epoch=v["epoch"])   # dead: must rejoin fresh
    with pytest.raises(StaleEpoch):
        reg.beat("ghost:9", epoch=0)        # never joined at all
    reg.join("a:1", "http://a:1", epoch=0)  # the rejoin heals it
    reg.beat("a:1", epoch=reg.epoch)


def test_heartbeat_loop_rejoins_fresh_after_reap():
    """Member-side half of the heal: a beat answered 409 (we were
    reaped while partitioned) drops the loop back to a fresh epoch-0
    join — never a quiet resurrection at the stale epoch."""
    reg, clock = registry()

    def post(path, doc):
        try:
            if path.endswith("/join"):
                return 200, reg.join(
                    doc["node_id"], doc["url"], epoch=doc["epoch"],
                )
            return 200, reg.beat(
                doc["node_id"], epoch=doc["epoch"],
                shedding=doc["shedding"],
            )
        except StaleEpoch:
            return 409, None

    hb = HeartbeatLoop("a:1", "http://a:1", "prim:1", post=post)
    assert hb.step() and hb.joined          # join
    assert hb.step()                        # beat carries the view
    assert hb.view()["epoch"] == reg.epoch
    clock.now += 10.0
    reg.reap()                              # reaped while partitioned
    assert not hb.step() and not hb.joined  # beat → 409 → fresh state
    assert hb.step() and hb.joined          # epoch-0 rejoin heals
    assert any(
        m["node_id"] == "a:1" and m["alive"]
        for m in reg.view()["members"]
    )


def test_reap_never_kills_the_primary_itself():
    reg, clock = registry()
    clock.now += 1000.0
    assert reg.reap() == []
    assert [m["node_id"] for m in alive_members(reg.view())] == [
        "prim:1",
    ]


# -- affinity ring ----------------------------------------------------------

def test_affinity_remaps_only_the_dead_nodes_keys():
    nodes = ["n0:1", "n1:2", "n2:3"]
    ring = AffinityRing(nodes)
    keys = [f"trace-{i}" for i in range(300)]
    before = {k: ring.owner(k) for k in keys}
    assert set(before.values()) == set(nodes)  # all nodes own some
    survivor_ring = AffinityRing(["n0:1", "n2:3"])
    moved = 0
    for k in keys:
        after = survivor_ring.owner(k)
        if before[k] == "n1:2":
            moved += 1
            assert after in ("n0:1", "n2:3")
        else:
            # the consistent-hash contract: survivors keep their keys
            assert after == before[k], k
    assert moved > 0


def test_ring_for_skips_shedding_members_with_floor():
    view = {
        "members": [
            {"node_id": "a:1", "alive": True, "shedding": False},
            {"node_id": "b:2", "alive": True, "shedding": True},
            {"node_id": "c:3", "alive": False, "shedding": False},
        ],
    }
    ring = ring_for(view)
    assert {ring.owner(f"k{i}") for i in range(100)} == {"a:1"}
    # everyone shedding: fall back to all alive rather than an empty
    # ring (shedding nodes answering slowly beats nobody answering)
    for m in view["members"]:
        m["shedding"] = True
    ring = ring_for(view)
    assert {ring.owner(f"k{i}") for i in range(100)} == {"a:1", "b:2"}


def test_seeded_jitter_deterministic_and_bounded():
    a = seeded_jitter("node:1", 3, 2.0)
    assert a == seeded_jitter("node:1", 3, 2.0)
    assert a != seeded_jitter("node:2", 3, 2.0)
    assert 0.0 <= a <= 0.5 * 2.0


def test_parse_addr():
    assert parse_addr("127.0.0.1:8080") == ("127.0.0.1", 8080)
    with pytest.raises(ValueError):
        parse_addr("no-port")


# -- zero new keys when unclustered (satellite pin) -------------------------

def test_unclustered_daemon_mints_zero_cluster_keys():
    from tpusim_torch.serve.daemon import ServeDaemon

    d = ServeDaemon(trace_root=FIXTURES).start()
    try:
        from tpusim_torch.serve.client import ServeClient

        c = ServeClient(d.url)
        c.simulate(trace="matmul_512", arch="v5e")
        assert not any(
            k.startswith("cluster_") or k.startswith("serve_nodes")
            for k in d.metrics_values()
        )
        text = c.metrics_text()
        assert "cluster_" not in text
        assert "serve_nodes" not in text
        assert "cluster" not in c.healthz()
    finally:
        d.abort()


# -- two live daemons: join, gossip, forward --------------------------------

def test_two_daemons_join_forward_and_heal():
    from tpusim_torch.serve.client import ServeClient
    from tpusim_torch.serve.daemon import ServeDaemon

    a = ServeDaemon(trace_root=FIXTURES).start()
    b = None
    try:
        b = ServeDaemon(
            trace_root=FIXTURES, cluster_join=f"{a.host}:{a.port}",
        ).start()
        # joined on both sides: the primary registers B before its join
        # response reaches B, whose view lands when B reads that response
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if a.cluster is not None and len(
                alive_members(a.cluster.view())
            ) == 2 and b.cluster_view_doc() is not None:
                break
            time.sleep(0.05)
        else:
            pytest.fail("node B never joined")
        assert b.cluster_view_doc()["epoch"] == a.cluster.epoch
        ra = ServeClient(a.url).simulate(trace="matmul_512", arch="v5e")
        rb = ServeClient(b.url).simulate(trace="matmul_512", arch="v5e")
        assert ra.sim_cycles == rb.sim_cycles
        ha = ServeClient(a.url).healthz()
        assert ha["cluster"]["nodes_alive"] == 2
        assert ha["cluster"]["primary"] is True
        b.abort()
        b = None
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            stats = a.cluster.stats_dict()
            if stats["cluster_deaths_total"] >= 1:
                break
            time.sleep(0.1)
        else:
            pytest.fail("node B's death never recorded")
        # the fleet keeps serving through the heal
        r2 = ServeClient(a.url).simulate(trace="matmul_512", arch="v5e")
        assert r2.sim_cycles == ra.sim_cycles
    finally:
        if b is not None:
            b.abort()
        a.abort()


# -- client failover (stub servers) -----------------------------------------

class StubServer:
    """Raw-socket stub: records request counts; per-mode behavior lets
    each failover rule be pinned without a real daemon."""

    def __init__(self, mode: str = "ok"):
        self.mode = mode
        self.hits = 0
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.hits += 1
            try:
                conn.settimeout(5.0)
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                if self.mode == "reset_after_recv":
                    # pause so the client is parked in getresponse()
                    # (bytes FINISHED sending — a send-stage reset is
                    # legitimately safe to replay, not what we pin here)
                    self._stop.wait(0.3)
                    # RST, not FIN: FIN reads as idle keep-alive close
                    conn.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00",
                    )
                    conn.close()
                    continue
                if self.mode == "stall":
                    # accept, read, never answer: the client times out
                    self._stop.wait(10.0)
                    conn.close()
                    continue
                body = b'{"ok": true}'
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\nConnection: close\r\n\r\n" + body
                )
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_client_fails_over_idempotent_post_on_refused():
    from tpusim_torch.serve.client import ServeClient

    live = StubServer()
    try:
        c = ServeClient(
            f"http://127.0.0.1:{_dead_port()}",
            retries=0, members=[live.url],
        )
        doc = c._request(
            "POST", "/v1/simulate", {"trace": "t"}, idempotent=True,
        )
        assert doc == {"ok": True}
        assert live.hits == 1
    finally:
        live.close()


def test_client_fails_over_get_on_refused():
    from tpusim_torch.serve.client import ServeClient

    live = StubServer()
    try:
        c = ServeClient(
            f"http://127.0.0.1:{_dead_port()}",
            retries=0, members=[live.url],
        )
        assert c._request("GET", "/healthz") == {"ok": True}
        assert live.hits == 1
    finally:
        live.close()


def test_client_never_fails_over_sent_submission():
    from tpusim_torch.serve.client import ServeClient, ServeError

    first = StubServer(mode="reset_after_recv")
    fallback = StubServer()
    try:
        c = ServeClient(first.url, retries=2, members=[fallback.url])
        with pytest.raises(ServeError) as ei:
            # a job submission: idempotent NOT set, bytes finish
            # sending before the RST — replaying it elsewhere could
            # enqueue a duplicate job
            c._request("POST", "/v1/sweep", {"job": 1})
        assert ei.value.code == "connection_failed"
        assert fallback.hits == 0
    finally:
        first.close()
        fallback.close()


def test_client_never_fails_over_after_timeout():
    from tpusim_torch.serve.client import ServeClient, ServeError

    first = StubServer(mode="stall")
    fallback = StubServer()
    try:
        c = ServeClient(
            first.url, timeout_s=0.3, retries=2,
            members=[fallback.url],
        )
        with pytest.raises(ServeError) as ei:
            # even idempotent bodies: the stalled node may still be
            # executing, and stacking a replay compounds the load
            c._request(
                "POST", "/v1/simulate", {"trace": "t"},
                idempotent=True,
            )
        assert ei.value.code == "timeout"
        assert fallback.hits == 0
    finally:
        first.close()
        fallback.close()


# -- node_id on observability surfaces (satellite pin) ----------------------

def test_access_log_node_id_only_when_clustered(tmp_path):
    from tpusim_torch.obs.reqtrace import AccessLog

    plain = AccessLog(tmp_path / "plain.jsonl")
    plain.write(route="simulate", status=200, latency_ms=1.0)
    plain.close()
    clustered = AccessLog(tmp_path / "clustered.jsonl")
    clustered.write(
        route="simulate", status=200, latency_ms=1.0,
        node_id="127.0.0.1:9",
    )
    clustered.close()
    doc = json.loads((tmp_path / "plain.jsonl").read_text())
    assert "node_id" not in doc
    doc = json.loads((tmp_path / "clustered.jsonl").read_text())
    assert doc["node_id"] == "127.0.0.1:9"


def test_trace_doc_node_id_only_when_clustered():
    from tpusim_torch.obs.reqtrace import RequestTracer

    plain = RequestTracer()
    tr = plain.begin("simulate")
    doc = plain.finish(tr, 200)
    assert "node_id" not in doc
    clustered = RequestTracer(node_id="127.0.0.1:9")
    tr = clustered.begin("simulate")
    doc = clustered.finish(tr, 200)
    assert doc["node_id"] == "127.0.0.1:9"


# -- the same control plane as the JAX package ------------------------------

def test_ring_owners_and_jitter_equal_jax_package():
    """Affinity must route a key to the same member whichever package a
    node runs, and restart jitter is the same seeded sequence."""
    from tpusim.serve.cluster import AffinityRing as RefRing
    from tpusim.serve.cluster import seeded_jitter as ref_jitter

    nodes = ["10.0.0.1:8642", "10.0.0.2:8642", "10.0.0.3:8642", "h:1"]
    keys = [f"trace-{i}" for i in range(500)]
    for members in (nodes, nodes[:3], nodes[1:]):
        ours, ref = AffinityRing(members), RefRing(members)
        assert [ours.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    for attempt in range(8):
        assert seeded_jitter("n:1", attempt, 2.0) == \
            ref_jitter("n:1", attempt, 2.0)

"""The port's served jobs, request tracing and hot-response cache.

Mirrors the daemon-side tests of other files against
:mod:`tpusim_torch.serve`:

* ``tests/test_advise.py:424-450`` — the served advise doc equals the
  CLI path's, a bad spec fails the job with its code;
* ``tests/test_campaign.py:388-490`` — the job table persists and
  recovers, a daemon restart resumes a queued campaign under the same id
  (journaled under ``--state-dir``), a bad spec fails the job;
* ``tests/test_fleet.py:489-516`` — the served fleet doc equals the
  direct run's, a bad spec fails the job;
* ``tests/test_reqtrace.py:411-501`` — ``--trace-requests`` off costs
  nothing and mints nothing; on, bodies stay byte-identical while the
  header, the flight recorder, the histograms and the access log appear;
* the standalone hot-cache tests of ``tests/test_front.py:59-230`` and
  ``:478`` (the front fleet itself is ROADMAP A11 item 2).

Each served report is also held to the JAX package's direct run of the
same spec (``==`` with ``model_version`` dropped).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.advise import run_advise  # noqa: E402
from tpusim_torch.campaign import run_campaign  # noqa: E402
from tpusim_torch.fleet import run_fleet  # noqa: E402
from tpusim_torch.obs.reqtrace import TRACE_HEADER, valid_trace_id  # noqa: E402,E501
from tpusim_torch.serve.client import ServeClient  # noqa: E402
from tpusim_torch.serve.daemon import ServeDaemon  # noqa: E402
from tpusim_torch.serve.hotcache import HotResponseCache  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "traces"
TRACE = FIXTURES / "llama_tiny_tp2dp2"

VOLATILE = {"simulation_rate_kops", "wall_seconds", "silicon_slowdown"}
PERF_PREFIXES = ("cache_", "pool_")

ADVISE_SPEC = {
    "name": "t",
    "strategies": ["dp", "tp", "dp_tp", "sp", "pp"],
    "slices": [{"arch": "v5p", "chips": 8}],
    "tuned": False,
}


def campaign_spec(**over) -> dict:
    doc = {
        "name": "t", "seed": 11, "scenarios": 4,
        "arch": "v5p", "chips": 8, "tuned": False,
        "faults": {
            "count": {"dist": "uniform", "min": 0, "max": 2},
            "kinds": {"link_down": 1.0, "link_degraded": 1.0,
                      "chip_straggler": 0.5, "hbm_throttle": 0.5},
            "scale": {"min": 0.4, "max": 0.9},
        },
    }
    doc.update(over)
    return doc


def fleet_spec(**over) -> dict:
    doc = {
        "name": "t-fleet", "seed": 3, "pods": 2,
        "arch": "v5p", "chips": 8, "tuned": False,
        "horizon_s": 30.0,
        "traffic": {
            "load_points": [6.0],
            "mix": [{"name": "chat", "weight": 3.0, "steps": 50},
                    {"name": "batch", "weight": 1.0, "steps": 200}],
        },
        "faults": {
            "count": {"dist": "uniform", "min": 0, "max": 2},
            "kinds": {"link_down": 1.0, "hbm_throttle": 1.0},
            "scale": {"min": 0.4, "max": 0.9},
            "window": {"min_s": 5.0, "max_s": 15.0},
            "pod_loss": {"prob": 0.9},
        },
        "policies": {"max_inflight": 1, "queue_depth": 4,
                     "deadline_s": 0.5, "restart_backoff_s": 3.0},
    }
    doc.update(over)
    return doc


def _dropped(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "model_version"}


# -- served advise ------------------------------------------------------------

def test_served_advise_doc_matches_cli():
    from tpusim.advise import run_advise as ref_advise

    cli_doc = run_advise(ADVISE_SPEC, trace_path=TRACE).doc
    with ServeDaemon(trace_root=FIXTURES) as d:
        c = ServeClient(d.url)
        job = c.advise(spec=ADVISE_SPEC, trace="llama_tiny_tp2dp2")
        st = c.wait_job(job, timeout_s=120.0)
        assert st.status == "done", st.error
        assert json.dumps(st.result, sort_keys=True) == \
            json.dumps(cli_doc, sort_keys=True)
        prom = c.metrics_text()
        assert "tpusim_serve_advise_cells_total" in prom
    assert _dropped(st.result) == \
        _dropped(ref_advise(ADVISE_SPEC, trace_path=TRACE).doc)


def test_served_advise_rejects_bad_spec():
    with ServeDaemon(trace_root=FIXTURES) as d:
        c = ServeClient(d.url)
        job = c.advise(
            spec={"strategies": ["warp"]}, trace="llama_tiny_tp2dp2",
        )
        st = c.wait_job(job, timeout_s=30.0)
        assert st.status == "failed"
        assert "bad_advise_spec" in (st.error or "")


# -- served campaigns and the job table ---------------------------------------

def test_jobtable_persists_and_recovers(tmp_path):
    from tpusim_torch.serve.admission import JobTable

    t1 = JobTable(persist_dir=tmp_path)
    job_q = t1.submit("campaign", {"spec": {"seed": 1}})
    job_r = t1.submit("sweep", {"chips": 8})
    job_d = t1.submit("sweep", {"chips": 27})
    assert t1.next_job(timeout_s=0.01) is job_q   # queued -> running
    t1.finish(job_d, {"ok": 1}, None)
    files = sorted(p.name for p in tmp_path.glob("job-*.json"))
    assert files == [
        "job-000001.json", "job-000002.json", "job-000003.json",
    ]

    # "restart": a fresh table over the same dir
    t2 = JobTable(persist_dir=tmp_path)
    assert t2.recovered == 2          # running + queued re-enqueue
    got = t2.get(job_q.job_id)
    assert got is not None and got.status == "queued"
    assert got.kind == "campaign"
    assert got.request == {"spec": {"seed": 1}}
    done = t2.get(job_d.job_id)
    assert done.status == "done" and done.result == {"ok": 1}
    # recovered jobs drain in submission order under the SAME ids
    assert t2.next_job(timeout_s=0.01).job_id == job_q.job_id
    assert t2.next_job(timeout_s=0.01).job_id == job_r.job_id
    # ids continue past the recovered ones
    assert t2.submit("sweep", {}).job_id == "job-000004"


@pytest.fixture
def serve_daemon_factory():
    daemons = []

    def make(**kw):
        d = ServeDaemon(trace_root=FIXTURES, **kw)
        d.start()
        daemons.append(d)
        return d

    yield make
    for d in daemons:
        if not d._stopped.is_set():
            d.abort()


def test_daemon_restart_resumes_queued_campaign_job(
    tmp_path, serve_daemon_factory,
):
    """A queued ``POST /v1/campaign`` job survives a daemon crash: the
    restarted daemon re-enqueues it from the persisted spec, runs it to
    completion under the same job id, and journals under --state-dir."""
    from tpusim.campaign import run_campaign as ref_campaign

    spec = campaign_spec(scenarios=3, seed=8)
    state = tmp_path / "state"

    # job workers held at 0: the job is accepted + persisted, never run
    d1 = serve_daemon_factory(state_dir=state, job_workers=0)
    c1 = ServeClient(d1.url)
    job_id = c1.campaign(spec=spec, trace="llama_tiny_tp2dp2")
    assert c1.job(job_id).status == "queued"
    d1.abort()                        # crash: no drain, no cleanup

    d2 = serve_daemon_factory(state_dir=state, job_workers=1)
    assert d2.jobs.recovered == 1
    c2 = ServeClient(d2.url)
    st = c2.wait_job(job_id, timeout_s=120)
    assert st.status == "done", st.error
    doc = st.result
    assert doc["seed"] == 8
    assert doc["slices"][0]["scenarios"] == 3
    assert (state / "campaigns" / job_id / "journal.jsonl").is_file()
    assert d2.drain_and_stop()

    # the served report matches the CLI path byte for byte
    clean = run_campaign(spec, trace_path=TRACE)
    assert json.dumps(doc, sort_keys=True) == \
        json.dumps(clean.doc, sort_keys=True)
    assert _dropped(doc) == _dropped(ref_campaign(spec, trace_path=TRACE).doc)


def test_bad_campaign_spec_fails_the_job_with_the_code(
    serve_daemon_factory,
):
    """Submission is async (202 always); a bad spec is refused when the
    job runs, landing as a failed job carrying the loader's message —
    never a daemon crash."""
    d = serve_daemon_factory()
    c = ServeClient(d.url)
    job_id = c.campaign(
        trace="llama_tiny_tp2dp2",
        spec={"seed": 1, "faults": {"kinds": ["tachyon_storm"]}},
    )
    st = c.wait_job(job_id, timeout_s=60)
    assert st.status == "failed"
    assert "tachyon_storm" in st.error
    assert d.drain_and_stop()


# -- served fleet -------------------------------------------------------------

def test_served_fleet_doc_is_byte_identical_to_direct():
    from tpusim.fleet import run_fleet as ref_fleet

    spec = fleet_spec()
    direct = run_fleet(spec, trace_path=TRACE)
    with ServeDaemon(trace_root=FIXTURES, port=0) as d:
        c = ServeClient(d.url)
        job_id = c.fleet(spec=spec, trace=TRACE.name)
        status = c.wait_job(job_id, timeout_s=300)
        assert status.status == "done", status.error
        assert json.dumps(status.result, sort_keys=True) == \
            json.dumps(direct.doc, sort_keys=True)
        # the executor totals ride /metrics under the serve_fleet_* name
        metrics = c.metrics_text()
        assert "serve_fleet_requests_total" in metrics
    assert _dropped(status.result) == \
        _dropped(ref_fleet(spec, trace_path=TRACE).doc)


def test_bad_fleet_spec_fails_job_with_code():
    with ServeDaemon(trace_root=FIXTURES, port=0) as d:
        c = ServeClient(d.url)
        job_id = c.fleet(spec={"pods": 0}, trace=TRACE.name)
        status = c.wait_job(job_id, timeout_s=60)
        assert status.status == "failed"
        assert "bad_fleet_spec" in (status.error or "")


# -- request tracing: the daemon half -----------------------------------------

SIM_BODY = {
    "trace": "matmul_512", "arch": "v5p", "tuned": True, "validate": True,
}


def canonical(payload: bytes) -> str:
    doc = json.loads(payload)
    doc["stats"] = {
        k: v for k, v in doc["stats"].items()
        if k not in VOLATILE and not k.startswith(PERF_PREFIXES)
    }
    return json.dumps(doc, sort_keys=True)


@pytest.fixture(scope="module")
def off_daemon():
    d = ServeDaemon(trace_root=str(FIXTURES), max_inflight=4).start()
    yield d
    d.drain_and_stop()


#: lazy response matrix from the tracing-off daemon, issued from INSIDE
#: a test (module-fixture setup would run before the conftest autouse
#: TPUSIM_TUNED_DIR pin, composing a differently-tuned config)
_OFF_PASS: dict = {}


@pytest.fixture
def off_pass(off_daemon):
    if not _OFF_PASS:
        c = ServeClient(off_daemon.url)
        bodies = []
        for _ in range(2):  # cold then warm
            resp, payload = c._raw("POST", "/v1/simulate", SIM_BODY)
            bodies.append((resp, payload))
        _OFF_PASS["sim"] = bodies
        _OFF_PASS["metrics"] = c.metrics_text()
        _OFF_PASS["debug_status"] = \
            c._raw("GET", "/v1/debug/traces")[0].status
        _OFF_PASS["stats_keys"] = set(off_daemon.metrics_values())
        _OFF_PASS["reqtrace_attr"] = off_daemon.reqtrace
        _OFF_PASS["access_log_attr"] = off_daemon.access_log
    return _OFF_PASS


@pytest.fixture(scope="module")
def on_daemon(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reqtrace_on")
    d = ServeDaemon(
        trace_root=str(FIXTURES), max_inflight=4,
        trace_requests=True, access_log=str(tmp / "access.jsonl"),
    ).start()
    d._access_log_path = tmp / "access.jsonl"
    yield d
    d.drain_and_stop()


def test_tracing_off_is_zero_overhead(off_pass):
    assert off_pass["reqtrace_attr"] is None
    assert off_pass["access_log_attr"] is None
    assert not any(k.startswith("reqtrace_") for k in off_pass["stats_keys"])
    assert "reqtrace" not in off_pass["metrics"]
    assert off_pass["debug_status"] == 404
    for resp, _ in off_pass["sim"]:
        assert resp.getheader(TRACE_HEADER) is None


def test_tracing_on_is_byte_identical_and_traced(off_pass, on_daemon):
    c = ServeClient(on_daemon.url)
    for resp_off, payload_off in off_pass["sim"]:
        resp_on, payload_on = c._raw("POST", "/v1/simulate", SIM_BODY)
        tid = resp_on.getheader(TRACE_HEADER)
        assert tid and valid_trace_id(tid)
        # the body never changes — only the header grows
        assert canonical(payload_on) == canonical(payload_off)
        assert set(json.loads(payload_on)["stats"]) == \
            set(json.loads(payload_off)["stats"])
    assert c.last_trace_id == tid

    # the trace is retrievable and its top-level spans fit the total
    doc = c.trace_detail(tid)
    assert doc["trace_id"] == tid
    paths = [s["path"] for s in doc["spans"]]
    assert "dispatch" in paths and "dispatch/price" in paths
    top = sum(s["dur_ms"] for s in doc["spans"] if "/" not in s["path"])
    assert top <= doc["total_ms"] + 0.05
    assert (doc.get("meta") or {}).get("tier") in ("warm", "priced")

    # recent_traces lists it; chrome export loads
    assert any(s["trace_id"] == tid for s in c.recent_traces())
    assert "traceEvents" in c.trace_detail(tid, chrome=True)


def test_tracing_on_inbound_header_is_honored(on_daemon):
    import http.client

    conn = http.client.HTTPConnection(
        on_daemon.host, on_daemon.port, timeout=30,
    )
    try:
        conn.request(
            "POST", "/v1/simulate", body=json.dumps(SIM_BODY).encode(),
            headers={"Content-Type": "application/json",
                     TRACE_HEADER: "deadbeef01234567"},
        )
        resp = conn.getresponse()
        resp.read()
        assert resp.getheader(TRACE_HEADER) == "deadbeef01234567"
    finally:
        conn.close()


def test_tracing_on_metrics_histograms_sum_to_request_counter(on_daemon):
    c = ServeClient(on_daemon.url)
    c.healthz()
    text = c.metrics_text()
    assert "# TYPE tpusim_reqtrace_route_ms histogram" in text
    assert "# TYPE tpusim_serve_requests_total counter" in text
    inf = [ln for ln in text.splitlines()
           if ln.startswith("tpusim_reqtrace_route_ms_bucket")
           and 'le="+Inf"' in ln]
    bucket_total = sum(float(ln.split()[1]) for ln in inf)
    counter = next(
        float(ln.split()[1]) for ln in text.splitlines()
        if ln.startswith("tpusim_serve_requests_total ")
    )
    # the /metrics request observes itself before rendering, so the
    # equality is exact, not off-by-one
    assert bucket_total == counter
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        parts = ln.split()
        assert len(parts) == 2, ln
        float(parts[1])


def test_tracing_on_writes_access_log(on_daemon):
    # run after the traffic-generating tests: flush happens on close,
    # so read through the daemon's still-open handle state via a sync
    on_daemon.access_log._fh.flush()
    lines = on_daemon._access_log_path.read_text().splitlines()
    assert lines
    recs = [json.loads(ln) for ln in lines]
    assert any(r["route"] == "simulate" and r["trace_id"] for r in recs)
    assert all(
        {"ts_s", "route", "status", "latency_ms"} <= set(r) for r in recs
    )


# -- the hot-response cache (standalone daemon) -------------------------------

def _hot_canonical(stats: dict) -> str:
    return json.dumps(
        {k: v for k, v in stats.items() if k not in VOLATILE},
        indent=1, sort_keys=True,
    )


def _metric(text: str, key: str) -> float:
    for line in text.splitlines():
        if line.startswith(f"tpusim_{key} "):
            return float(line.split()[1])
    return 0.0


def test_hotcache_round_trip_across_instances(tmp_path):
    """A publish by one instance is readable by a second instance on
    the same dir (the cross-process shape, minus the fork)."""
    a = HotResponseCache(tmp_path, generation="g1")
    assert a.get("k") is None
    assert a.publish("k", b'{"x": 1}\n')
    got = a.get("k")
    assert bytes(got) == b'{"x": 1}\n'
    b = HotResponseCache(tmp_path, generation="g1")
    assert bytes(b.get("k")) == b'{"x": 1}\n'
    # first writer wins; a duplicate publish is a no-op
    assert not b.publish("k", b"other")
    assert bytes(a.get("k")) == b'{"x": 1}\n'
    assert "k" in a and "missing" not in a


def test_hotcache_generation_invalidation(tmp_path):
    """A generation bump (model_version / format / tuned state moved)
    orphans the old entries AND reaps the old files."""
    old = HotResponseCache(tmp_path, generation="old1")
    old.publish("k", b"stale")
    new = HotResponseCache(tmp_path, generation="new2")
    assert new.get("k") is None
    names = {p.name for p in tmp_path.iterdir()}
    assert not any("old1" in n for n in names), names


def test_hotcache_generation_is_the_jax_rule():
    """The generation fingerprint is the reference's function of its
    inputs; each package feeds it its own ``model_version``, so the two
    packages never read each other's hot entries in one directory."""
    from tpusim.serve.hotcache import hot_generation as ref_generation
    from tpusim.timing.model_version import model_version as ref_version
    from tpusim_torch.serve.hotcache import hot_generation
    from tpusim_torch.timing.model_version import model_version

    assert hot_generation("m", 1) == ref_generation("m", 1)
    assert hot_generation(model_version(), 1) != \
        ref_generation(ref_version(), 1)


def test_hotcache_quota_rotation(tmp_path):
    """Past the quota the writer rotates to a fresh epoch segment; old
    keys become misses (repopulated in one request each), the new key
    serves, and the store never exceeds the quota."""
    c = HotResponseCache(tmp_path, generation="g", quota_bytes=1 << 16)
    body = b"x" * 4096
    for i in range(20):  # 80 KB through a 64 KB quota
        assert c.publish(f"k{i}", body)
    assert c.rotations >= 1
    seg = tmp_path / c._read_index_doc()["segment"]
    assert seg.stat().st_size <= 1 << 16
    assert bytes(c.get("k19")) == body   # newest entry survives
    assert c.get("k0") is None           # rotated away


def test_hotcache_oversized_body_never_publishes(tmp_path):
    c = HotResponseCache(tmp_path, generation="g", quota_bytes=1 << 16)
    assert not c.publish("big", b"x" * (1 << 15))  # > quota/8
    assert c.get("big") is None


def test_hotcache_concurrent_publishers(tmp_path):
    """Two instances racing distinct keys (the two-acceptor shape):
    every key lands, every body reads back exactly."""
    a = HotResponseCache(tmp_path, generation="g")
    b = HotResponseCache(tmp_path, generation="g")
    errors = []

    def pump(cache, prefix):
        try:
            for i in range(25):
                cache.publish(f"{prefix}{i}", f"{prefix}{i}".encode())
        except Exception as e:  # noqa: BLE001 - the assertion below
            errors.append(e)

    ts = [
        threading.Thread(target=pump, args=(a, "a")),
        threading.Thread(target=pump, args=(b, "b")),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    reader = HotResponseCache(tmp_path, generation="g")
    for prefix in ("a", "b"):
        for i in range(25):
            assert bytes(reader.get(f"{prefix}{i}")) == \
                f"{prefix}{i}".encode()


def test_hot_served_bytes_match_real_warm_response(tmp_path):
    """The hot tier stores synthesized warm-form bytes on first pricing;
    they must equal what a real (result-cache-hit) warm response
    produces — cache accounting included, wall-clock keys excepted."""
    hot = ServeDaemon(
        trace_root=FIXTURES, max_inflight=4, hot_cache=tmp_path / "hot",
    ).start()
    plain = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    try:
        ch = ServeClient(hot.url)
        cp = ServeClient(plain.url)
        first = ch.simulate(trace="matmul_512", arch="v5e")
        assert not first.cache_hit
        served = ch.simulate(trace="matmul_512", arch="v5e")
        assert served.cache_hit  # from the mmap, warm form
        assert _metric(ch.metrics_text(), "serve_hot_hits_total") == 1
        cp.simulate(trace="matmul_512", arch="v5e")
        real_warm = cp.simulate(trace="matmul_512", arch="v5e")
        assert real_warm.cache_hit
        assert _hot_canonical(served.stats) == \
            _hot_canonical(real_warm.stats)
        # the accounting keys too: synthesis must fold misses exactly
        assert served.stats.get("cache_hits") == \
            real_warm.stats.get("cache_hits")
        assert served.stats.get("cache_misses") == \
            real_warm.stats.get("cache_misses")
    finally:
        hot.drain_and_stop()
        plain.drain_and_stop()


def test_hot_entries_keyed_by_trace_content(tmp_path):
    """A hot dir surviving a restart must not serve bytes priced from
    different on-disk trace content: the key carries a stat fingerprint
    of the trace dir."""
    d = ServeDaemon(
        trace_root=FIXTURES, max_inflight=4, hot_cache=tmp_path / "hot",
    )
    body = {"trace": "matmul_512", "arch": "v5e", "tuned": True}
    k1 = d.hot_key_for("simulate", body)
    assert k1 is not None
    # unknown traces are not hot-servable (the 404 path answers)
    assert d.hot_key_for("simulate", {"trace": "nope"}) is None
    # a different fingerprint yields a different key
    d2 = ServeDaemon(
        trace_root=FIXTURES, max_inflight=4, hot_cache=tmp_path / "hot",
    )
    d2._trace_fp_cache["matmul_512"] = "different"
    assert d2.hot_key_for("simulate", body) != k1
    # volatile keys never fragment the hot tier
    assert d.hot_key_for(
        "simulate", {**body, "deadline_ms": 123}
    ) == k1


def test_hotcache_enospc_disables_publishes_with_one_warning(
    tmp_path, monkeypatch,
):
    """ENOSPC/EIO graceful degradation on the hot tier: a failed
    segment append warns once, disables further publishes for the
    instance, and requests keep flowing through the ordinary path."""
    import errno
    import warnings as _warnings

    import tpusim_torch.serve.hotcache as H

    c = HotResponseCache(tmp_path, generation="g")
    assert c.publish("k0", b"before")   # the healthy path works

    def boom(seg_path, body):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(H, "_append_segment", boom)
    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        assert c.publish("k1", b"body1") is False
        assert c.publish("k2", b"body2") is False   # no re-warn
    disabled = [
        w for w in caught
        if "disabling further hot publishes" in str(w.message)
    ]
    assert len(disabled) == 1
    assert c._publish_disabled
    # reads keep serving what the index already names
    assert bytes(c.get("k0")) == b"before"
    assert c.get("k1") is None
    # a fresh instance (healthy medium again) publishes normally
    monkeypatch.undo()
    fresh = HotResponseCache(tmp_path, generation="g")
    assert fresh.publish("k1", b"body1")
    assert bytes(fresh.get("k1")) == b"body1"

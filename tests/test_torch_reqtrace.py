"""Request-scoped tracing in the port (``tpusim_torch.obs.reqtrace``).

The unit half of ``tests/test_reqtrace.py``, run on the port: trace ids,
span-tree math, the latency histogram and its exposition, the flight
recorder's tail-sampling, the prometheus TYPE contract, the Chrome export
and the access log; and the ``reqtrace_`` namespace in the port's
stats-key registry.  The reference's daemon half waits for the port's
serving plane (ROADMAP A11).  The same calls give the JAX package's
documents: ids, paths and counters beside wall-clock durations.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim.obs import reqtrace as ref_reqtrace  # noqa: E402
from tpusim_torch.obs import reqtrace as port_reqtrace  # noqa: E402
from tpusim_torch.obs.export import (  # noqa: E402
    prometheus_text,
    request_chrome_trace,
)
from tpusim_torch.obs.reqtrace import (  # noqa: E402
    BUCKET_BOUNDS_MS,
    AccessLog,
    FlightRecorder,
    LatencyHistogram,
    RequestTracer,
    histogram_exposition,
    mint_trace_id,
    valid_trace_id,
)


REPO = Path(__file__).resolve().parent.parent


def test_mint_trace_id_random_and_wellformed():
    a, b = mint_trace_id(), mint_trace_id()
    assert a != b
    assert valid_trace_id(a) and valid_trace_id(b)
    assert len(a) == 16


def test_mint_trace_id_honors_wellformed_inbound():
    assert mint_trace_id("deadbeef01234567") == "deadbeef01234567"
    # normalized, not rejected
    assert mint_trace_id("  DEADBEEF01234567 ") == "deadbeef01234567"


@pytest.mark.parametrize("bad", [
    "", "xyz", "short", "deadbeef0123456g", "a" * 33,
    "../../etc/passwd", "deadbeef 0123",
])
def test_mint_trace_id_rejects_malformed_inbound(bad):
    tok = mint_trace_id(bad)
    assert tok != bad.strip().lower()
    assert valid_trace_id(tok)
    assert not valid_trace_id(bad)


# ---------------------------------------------------------------------------
# span tree
# ---------------------------------------------------------------------------


def test_span_nesting_builds_slash_paths():
    rt = RequestTracer(acceptor_index=3)
    tr = rt.begin("simulate", None)
    with tr.span("dispatch"):
        with tr.span("price"):
            pass
        with tr.span("serialize"):
            pass
    doc = rt.finish(tr, 200)
    paths = [s["path"] for s in doc["spans"]]
    assert paths == ["dispatch", "dispatch/price", "dispatch/serialize"]
    assert doc["acceptor"] == 3
    # children start no earlier than the parent and fit inside it
    parent = next(s for s in doc["spans"] if s["path"] == "dispatch")
    for s in doc["spans"]:
        if s["path"].startswith("dispatch/"):
            assert s["start_ms"] >= parent["start_ms"]
            assert s["start_ms"] + s["dur_ms"] <= (
                parent["start_ms"] + parent["dur_ms"] + 1e-3
            )


def test_worker_spans_merge_under_dispatch_and_tolerate_garbage():
    rt = RequestTracer()
    tr = rt.begin("simulate", None)
    t0 = time.monotonic()
    tr.add_worker_spans(
        [("price", t0, 0.001), ("serialize", t0, 0.0005),
         "garbage", ("short",), None],
    )
    doc = rt.finish(tr, 200)
    assert [s["path"] for s in doc["spans"]] == [
        "dispatch/price", "dispatch/serialize",
    ]


def test_fd_dispatch_pulls_start_back_to_accept_instant():
    rt = RequestTracer()
    t_accept = time.monotonic()
    time.sleep(0.002)
    tr = rt.begin("simulate", None, start_s=time.monotonic())
    tr.note_fd_dispatch(t_accept, time.monotonic())
    doc = rt.finish(tr, 200)
    fdd = next(s for s in doc["spans"] if s["path"] == "fd_dispatch")
    assert fdd["start_ms"] == 0.0
    assert fdd["dur_ms"] >= 1.0  # the slept handoff leg is visible


def test_finish_is_idempotent():
    rt = RequestTracer()
    tr = rt.begin("metrics", None)
    doc1 = rt.finish(tr, 200)
    time.sleep(0.001)
    doc2 = rt.finish(tr, 500)  # late second call changes nothing
    assert doc2 is doc1
    assert doc1["status"] == 200
    # and the completion was observed exactly once
    assert rt.metrics_values()["reqtrace_route_ms__metrics__cnt"] == 1.0


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


def test_histogram_bucketing_boundaries_and_overflow():
    h = LatencyHistogram()
    h.observe(0.25)      # on the first bound -> bucket 0 (le is <=)
    h.observe(0.26)      # just past -> bucket 1
    h.observe(1e9)       # overflow slot
    h.observe(-5.0)      # clamped to 0 -> bucket 0
    assert h.counts[0] == 2
    assert h.counts[1] == 1
    assert h.counts[-1] == 1
    assert h.count == 4
    assert h.sum_ms == pytest.approx(0.25 + 0.26 + 1e9)


def test_histogram_exposition_renders_cumulative_series():
    rt = RequestTracer()
    for _ in range(3):
        tr = rt.begin("simulate", None)
        rt.finish(tr, 200)
    values = rt.metrics_values()
    rest, lines = histogram_exposition(values)
    # histogram keys split out; counters flow through untouched
    assert not any(k.startswith("reqtrace_route_ms") for k in rest)
    assert "reqtrace_recorded_total" in rest
    assert "# TYPE tpusim_reqtrace_route_ms histogram" in lines
    bucket = [ln for ln in lines if ln.startswith(
        'tpusim_reqtrace_route_ms_bucket{route="simulate"')]
    assert len(bucket) == len(BUCKET_BOUNDS_MS) + 1  # + the +Inf line
    counts = [float(ln.split()[1]) for ln in bucket]
    assert counts == sorted(counts)  # cumulative is monotone
    assert counts[-1] == 3.0         # +Inf == observation count
    # every sample line splits into exactly two whitespace parts (the
    # scrape validators' invariant): labels contain no spaces
    for ln in lines:
        if ln.startswith("#"):
            continue
        parts = ln.split()
        assert len(parts) == 2, ln
        float(parts[1])


def test_histogram_exposition_accepts_fleet_merged_floats():
    # the fleet merge sums peer values into floats; exposition must
    # render them without complaint
    values = {
        "reqtrace_route_ms__simulate__b0": 3.0,
        "reqtrace_route_ms__simulate__b2": 1.0,
        "reqtrace_route_ms__simulate__sum": 12.5,
        "reqtrace_route_ms__simulate__cnt": 4.0,
        "serve_requests_total": 4.0,
    }
    rest, lines = histogram_exposition(values)
    assert rest == {"serve_requests_total": 4.0}
    inf = next(ln for ln in lines if 'le="+Inf"' in ln)
    assert float(inf.split()[1]) == 4.0
    le1 = next(ln for ln in lines if 'le="4"' in ln)
    assert float(le1.split()[1]) == 4.0  # 3 + 1 cumulative


# ---------------------------------------------------------------------------
# flight recorder tail-sampling
# ---------------------------------------------------------------------------


def _doc(tid, route="simulate", status=200, total_ms=1.0):
    return {"trace_id": tid, "route": route, "status": status,
            "total_ms": total_ms, "acceptor": None, "spans": []}


def test_recorder_keeps_n_slowest_per_route():
    rec = FlightRecorder(keep_slowest=3)
    for i in range(10):
        rec.record(_doc(f"{i:016x}", total_ms=float(i)))
    kept = rec.snapshot()
    assert [d["total_ms"] for d in kept] == [9.0, 8.0, 7.0]
    # a faster trace never evicts a slower one
    assert rec.record(_doc("f" * 16, total_ms=0.5)) is False
    assert rec.sampled_out_total == 7 + 1
    assert rec.live == 3


def test_recorder_keeps_every_error_in_its_own_ring():
    rec = FlightRecorder(keep_slowest=1, keep_errors=4)
    rec.record(_doc("a" * 16, total_ms=99.0))
    for i in range(6):
        rec.record(_doc(f"e{i:015x}", status=504, total_ms=0.01))
    kept = rec.snapshot()
    # the slow success survives a flood of fast errors, and the error
    # ring holds the most recent keep_errors of them
    assert kept[0]["total_ms"] == 99.0
    assert sum(1 for d in kept if d["status"] == 504) == 4
    assert rec.get("e5" + "0" * 13 + "5") is None  # malformed id
    assert rec.get("a" * 16)["total_ms"] == 99.0


def test_recorder_bounds_route_cardinality():
    rec = FlightRecorder(keep_slowest=2, max_routes=2)
    assert rec.record(_doc("1" * 16, route="a"))
    assert rec.record(_doc("2" * 16, route="b"))
    assert rec.record(_doc("3" * 16, route="c")) is False
    assert rec.sampled_out_total == 1


# ---------------------------------------------------------------------------
# prometheus TYPE contract
# ---------------------------------------------------------------------------


def test_prometheus_total_keys_are_counters():
    text = prometheus_text({
        "serve_requests_total": 5, "serve_uptime_s": 1.5, "ok": 1,
    })
    assert "# TYPE tpusim_serve_requests_total counter" in text
    assert "# TYPE tpusim_serve_uptime_s gauge" in text
    assert "# TYPE tpusim_ok gauge" in text


def test_prometheus_one_type_line_per_name():
    rt = RequestTracer()
    tr = rt.begin("simulate", None)
    rt.finish(tr, 200)
    rest, lines = histogram_exposition(rt.metrics_values())
    text = prometheus_text(rest) + "\n".join(lines) + "\n"
    seen: dict[str, str] = {}
    for ln in text.splitlines():
        if not ln.startswith("# TYPE "):
            continue
        _, _, name, mtype = ln.split()
        assert name not in seen, f"duplicate TYPE for {name}"
        seen[name] = mtype
    assert seen["tpusim_reqtrace_recorded_total"] == "counter"
    assert seen["tpusim_reqtrace_traces_live"] == "gauge"
    assert seen["tpusim_reqtrace_route_ms"] == "histogram"


# ---------------------------------------------------------------------------
# chrome export
# ---------------------------------------------------------------------------


def test_request_chrome_trace_shape():
    rt = RequestTracer(acceptor_index=1)
    tr = rt.begin("simulate", "deadbeefcafef00d")
    with tr.span("dispatch"):
        with tr.span("price"):
            pass
    doc = rt.finish(tr, 200)
    ct = request_chrome_trace(doc)
    assert ct["displayTimeUnit"] == "ms"
    events = ct["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    # the request envelope plus one slice per span
    assert len(xs) == 1 + len(doc["spans"])
    assert all(e["dur"] > 0 for e in xs)
    names = {e["name"] for e in events if e.get("ph") == "M"}
    assert "process_name" in names and "thread_name" in names
    json.dumps(ct)  # serializable as-is for Perfetto


# ---------------------------------------------------------------------------
# access log
# ---------------------------------------------------------------------------


def test_access_log_jsonl_fields_and_rotation(tmp_path):
    path = tmp_path / "access.jsonl"
    log = AccessLog(path, max_bytes=256)
    for i in range(16):
        log.write(route="simulate", status=200, latency_ms=1.25,
                  trace_id="ab" * 8, tier="warm", acceptor=0)
    log.close()
    log.close()  # idempotent
    assert path.exists()
    rotated = path.with_name(path.name + ".1")
    assert rotated.exists()  # 16 lines of ~100B crossed 256B repeatedly
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    recs += [json.loads(ln) for ln in rotated.read_text().splitlines()]
    assert recs
    r = recs[0]
    assert set(r) == {
        "ts_s", "trace_id", "route", "status", "latency_ms", "tier",
        "acceptor",
    }
    assert r["status"] == 200 and r["tier"] == "warm"
    assert log.lines_total == 16


# ---------------------------------------------------------------------------
# statskeys namespace
# ---------------------------------------------------------------------------


def test_statskeys_reqtrace_namespace_registered():
    from tpusim_torch.analysis.statskeys import AUDIT_GLOBS, STATS_NAMESPACES

    assert "reqtrace_" in STATS_NAMESPACES
    owners = STATS_NAMESPACES["reqtrace_"]
    assert "tpusim_torch/obs/" in owners
    assert "tpusim_torch/serve/" in owners
    # the minting module is inside an audited glob, so the namespace is
    # actually enforced, not merely declared
    assert "tpusim_torch/obs/*.py" in AUDIT_GLOBS
    assert (REPO / "tpusim_torch" / "obs" / "reqtrace.py").is_file()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_constants_and_exports_equal_the_reference():
    from tpusim import obs as ref_obs
    from tpusim_torch import obs as port_obs

    assert port_reqtrace.BUCKET_BOUNDS_MS == ref_reqtrace.BUCKET_BOUNDS_MS
    assert port_reqtrace.TRACE_HEADER == ref_reqtrace.TRACE_HEADER
    assert port_reqtrace.TRACE_CTX_KEY == ref_reqtrace.TRACE_CTX_KEY
    assert port_obs.__all__ == ref_obs.__all__


def _session(mod):
    """One scripted tracer session: three routes, nested spans, worker
    spans, an error, and the recorder's and histograms' state after it."""
    rt = mod.RequestTracer(acceptor_index=2)
    docs = []
    for i, (route, status) in enumerate((("simulate", 200), ("metrics", 200),
                                         ("simulate", 504))):
        tr = rt.begin(route, f"{i:016x}")
        with tr.span("dispatch"):
            with tr.span("price"):
                pass
        tr.add_worker_spans([("serialize", time.monotonic(), 0.0001)])
        docs.append(rt.finish(tr, status))
    return rt, docs


def test_tracer_session_matches_the_reference():
    """The same calls give the same documents in both packages: ids,
    routes, statuses, span paths and every counter; the durations are
    the host clock's and are compared by key only."""
    port_rt, port_docs = _session(port_reqtrace)
    ref_rt, ref_docs = _session(ref_reqtrace)

    def shape(doc):
        return ({k: v for k, v in doc.items() if not k.endswith("_ms")
                 and k != "spans"},
                [s["path"] for s in doc["spans"]])

    assert [shape(d) for d in port_docs] == [shape(d) for d in ref_docs]
    port_m, ref_m = port_rt.metrics_values(), ref_rt.metrics_values()
    assert set(port_m) == set(ref_m)
    for key in ref_m:
        if key.endswith("__sum") or "__b" in key:
            continue  # bucketed / summed wall-clock milliseconds
        assert port_m[key] == ref_m[key], key
    values = {"reqtrace_route_ms__simulate__b0": 3.0,
              "reqtrace_route_ms__simulate__b2": 1.0,
              "reqtrace_route_ms__simulate__sum": 12.5,
              "reqtrace_route_ms__simulate__cnt": 4.0,
              "serve_requests_total": 4.0}
    assert port_reqtrace.histogram_exposition(values) == \
        ref_reqtrace.histogram_exposition(values)

"""``serve-bench`` in the port, held to the JAX package's bench on the CPU.

The bench's numbers are timings, so its documents are held to the
reference's by schema (every key, every leg's keys), request counts and
``error_count`` 0, never by latency; what the benched daemons serve is
held by bytes (the served-bytes canon of ``ci/check_golden.py:755``).

* a small ``run_serve_bench`` against a port daemon and the same against
  a JAX daemon, each with its cold CLI baseline (``python -m
  tpusim_torch simulate`` for the port);
* a worker sweep (0 and 2 supervised workers) and an acceptor sweep (1
  and 2 acceptors with the hot cache, and the single-process baseline
  leg), each leg a freshly booted ``python -m tpusim_torch serve``;
* the CLI: a bad sweep list exits 2, ``--json`` writes the document.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.serve import bench  # noqa: E402
from tpusim_torch.serve.client import ServeClient  # noqa: E402
from tpusim_torch.serve.daemon import ServeDaemon  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "traces"
sys.path.insert(0, str(REPO / "ci"))
from check_golden import _serve_served_bytes  # noqa: E402


def _schema(doc):
    """The key structure of a document: dicts by key, lists by their
    first element (the legs share one shape)."""
    if isinstance(doc, dict):
        return {k: _schema(v) for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], dict):
        return [_schema(doc[0])]
    return None


def _served(url: str, client_cls) -> list[str]:
    c = client_cls(url)
    return [_serve_served_bytes(c.simulate(**m).stats)
            for m in bench.DEFAULT_MIX]


def test_serve_bench_matches_the_reference():
    from tpusim.serve import bench as ref_bench
    from tpusim.serve.client import ServeClient as RefClient
    from tpusim.serve.daemon import ServeDaemon as RefDaemon

    kw = dict(trace_root=FIXTURES, concurrency=4, requests=16, reps=1,
              cli_runs=1)
    ours = ServeDaemon(trace_root=FIXTURES, max_inflight=4).start()
    ref = RefDaemon(trace_root=FIXTURES, max_inflight=4).start()
    try:
        got = bench.run_serve_bench(url=ours.url, **kw)
        want = ref_bench.run_serve_bench(url=ref.url, **kw)
        assert _served(ours.url, ServeClient) == _served(ref.url, RefClient)
    finally:
        ours.drain_and_stop()
        ref.drain_and_stop()
    assert _schema(got) == _schema(want)
    assert got["requests"] == want["requests"] == 16
    assert got["error_count"] == want["error_count"] == 0
    assert got["cache_hit_fraction"] == want["cache_hit_fraction"] == 1.0
    assert [w["request"] for w in got["warmup"]] == \
        [w["request"] for w in want["warmup"]]
    cb = got["cli_baseline"]
    assert cb["trace"] == "llama_tiny_tp2dp2" and cb["cold_cli_s"] > 0
    text = bench.format_report(got)
    assert text.startswith("tpusim_torch serve-bench: 16 requests")
    assert "cold CLI simulate (llama_tiny_tp2dp2)" in text


def test_worker_sweep_matches_the_reference():
    from tpusim.serve import bench as ref_bench

    kw = dict(worker_counts=(2,), trace_root=FIXTURES, concurrency=4,
              requests=16, cli_baseline=False, reps=1)
    got = bench.run_worker_sweep(**kw)
    want = ref_bench.run_worker_sweep(**kw)
    assert _schema(got) == _schema(want)
    assert [leg["serve_workers"] for leg in got["worker_sweep"]] == \
        [leg["serve_workers"] for leg in want["worker_sweep"]] == [0, 2]
    for g, w in zip(got["worker_sweep"], want["worker_sweep"]):
        assert sorted(g) == sorted(w)
        assert g["requests"] == w["requests"] == 16
        assert g["error_count"] == w["error_count"] == 0
        assert g["cache_hit_fraction"] == 1.0
    assert "tpusim_torch serve-bench worker sweep" in \
        bench.format_sweep(got)


def test_acceptor_sweep_matches_the_reference():
    from tpusim.serve import bench as ref_bench

    kw = dict(acceptor_counts=(1, 2), trace_root=FIXTURES, concurrency=4,
              requests=32, reps=1, loadgen_procs=2)
    got = bench.run_acceptor_sweep(**kw)
    want = ref_bench.run_acceptor_sweep(**kw)
    assert _schema(got) == _schema(want)
    assert [leg["acceptors"] for leg in got["acceptor_sweep"]] == \
        [leg["acceptors"] for leg in want["acceptor_sweep"]] == [0, 1, 2]
    for g, w in zip(got["acceptor_sweep"], want["acceptor_sweep"]):
        assert sorted(g) == sorted(w)
        assert g["requests"] == w["requests"] == 32
        assert g["error_count"] == w["error_count"] == 0
        assert g["hot_cache"] == w["hot_cache"] == (g["acceptors"] > 0)
        assert g["cache_hit_fraction"] == 1.0
    assert got["acceptor_sweep"][2]["hot_hits"] > 0
    assert "tpusim_torch serve-bench acceptor sweep" in \
        bench.format_acceptor_sweep(got)


def test_cli_refuses_a_bad_sweep_and_writes_json(tmp_path, capsys):
    assert port_main(["serve-bench", "--worker-sweep", "0,x"]) == 2
    assert "--worker-sweep wants a comma-separated int list" in \
        capsys.readouterr().out
    assert port_main(["serve-bench", "--acceptor-sweep", "a"]) == 2
    out = tmp_path / "bench.json"
    assert port_main(["serve-bench", "--requests", "8", "--concurrency",
                      "2", "--reps", "1", "--no-cli-baseline",
                      "--trace", "matmul_512", "--arch", "v5e",
                      "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["requests"] == 8 and doc["error_count"] == 0
    assert doc["warmup"][0]["request"] == {"trace": "matmul_512",
                                           "arch": "v5e"}
    assert f"report written to {out}" in capsys.readouterr().out

"""The sharded campaign (``campaign --nodes``) in the port, mirroring the
three shard tests of ``tests/test_cluster.py`` on the CPU, and held to
the JAX package.

* the hash-ring assignment moves only a dead node's signatures, and
  equals the JAX package's assignment;
* a sharded run needs an ``--out`` dir, and refuses ``scenario_batch=
  "cuda"`` (its nodes fork and could not use the card);
* one shard SIGKILLed as it spawns: the survivors price its scenarios in
  the next wave, nothing prices twice, and the merged report equals the
  single-node run's by bytes (and the JAX package's single-node report,
  ``model_version`` aside, by ``==``);
* through the CLI: a shard journal left by a dead node is refused
  without ``--resume`` and finished elsewhere with it, on three nodes,
  to the single-node report's bytes.
"""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpusim.campaign import run_campaign as ref_run_campaign  # noqa: E402
from tpusim.campaign import shard_assignment as ref_assignment  # noqa: E402
from tpusim_torch.__main__ import main as port_main  # noqa: E402
from tpusim_torch.campaign import (  # noqa: E402
    run_campaign,
    run_sharded_campaign,
    shard_assignment,
)
from tpusim_torch.campaign.journal import Journal  # noqa: E402
from tpusim_torch.campaign.spec import load_campaign_spec, spec_hash  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRACE = REPO / "tests" / "fixtures" / "traces" / "llama_tiny_tp2dp2"


def shard_spec(**over) -> dict:
    doc = {
        "name": "t-shard", "seed": 11, "scenarios": 4,
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


def all_shard_sigs(out_dir) -> tuple[set, int]:
    seen: set = set()
    dup = 0
    shards = Path(out_dir) / "shards"
    for d in sorted(shards.iterdir()) if shards.is_dir() else []:
        if not (d / "journal.jsonl").is_file():
            continue
        for rec in Journal(d).iter_records():
            if rec.get("kind") != "scenario":
                continue
            sig = (rec["slice"], rec["index"])
            if sig in seen:
                dup += 1
            seen.add(sig)
    return seen, dup


def _masked(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "model_version"}


def test_shard_assignment_stable_when_a_node_dies():
    work = [("v5p-8", i) for i in range(64)]
    before = shard_assignment(work, [0, 1, 2], "deadbeef")
    assert all(before[n] for n in (0, 1, 2))  # every node owns some
    after = shard_assignment(work, [0, 2], "deadbeef")
    # survivors keep EXACTLY their keys; only node 1's work moved
    assert before[0] <= after[0]
    assert before[2] <= after[2]
    assert (after[0] | after[2]) == set(work)
    assert (after[0] - before[0]) | (after[2] - before[2]) == before[1]
    # the JAX package places every signature on the same node
    assert before == ref_assignment(work, [0, 1, 2], "deadbeef")
    assert after == ref_assignment(work, [0, 2], "deadbeef")


def test_sharded_campaign_requires_out_dir(tmp_path, capsys):
    with pytest.raises(ValueError, match="--out"):
        run_sharded_campaign(shard_spec(), trace_path=TRACE, nodes=2)
    with pytest.raises(ValueError, match="cannot use the card"):
        run_sharded_campaign(shard_spec(), trace_path=TRACE, nodes=2,
                             out_dir=tmp_path, scenario_batch="cuda")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(shard_spec()))
    assert port_main(["campaign", str(spec), "--trace", str(TRACE),
                      "--nodes", "2"]) == 2
    assert "--nodes needs --out DIR" in capsys.readouterr().err


def test_shard_kill_resumes_elsewhere_report_byte_identical(tmp_path):
    """One shard child SIGKILLed as soon as it spawns; the survivor
    prices the dead shard's scenarios in the next wave, nothing prices
    twice, and the merged report is byte-identical to the single-node
    run."""
    spec = shard_spec()
    single = run_campaign(spec, trace_path=TRACE, out_dir=tmp_path / "single")
    single_bytes = (tmp_path / "single" / "report.json").read_text()

    killed = {"n": 0}

    def kill_first(procs):
        if killed["n"] == 0 and procs:
            victim = procs[sorted(procs)[0]]
            os.kill(victim.pid, signal.SIGKILL)
            killed["n"] += 1

    msgs: list[str] = []
    res = run_sharded_campaign(
        spec, trace_path=TRACE, out_dir=tmp_path / "sharded",
        nodes=2, progress=msgs.append, on_spawn=kill_first,
    )
    assert killed["n"] == 1
    assert any("died" in m for m in msgs), msgs
    merged = (tmp_path / "sharded" / "report.json").read_text()
    assert merged == single_bytes
    sigs, dup = all_shard_sigs(tmp_path / "sharded")
    assert dup == 0
    assert len(sigs) == res.stats.scenarios == single.stats.scenarios
    ref = ref_run_campaign(spec, trace_path=TRACE)
    assert _masked(json.loads(merged)) == _masked(ref.doc)


def test_cli_nodes_resume_a_dead_shard_elsewhere(tmp_path, capsys):
    """A shard journal left half done by a dead node: ``--nodes 3``
    refuses to start over it, ``--nodes 3 --resume`` prices only what is
    missing and merges a report equal by bytes to the single-node CLI
    run's."""
    spec_doc = shard_spec(candidate_slices=[
        {"arch": "v5p", "chips": 8}, {"arch": "v5p", "chips": 16}])
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(spec_doc))
    single, sharded = tmp_path / "single", tmp_path / "sharded"
    assert port_main(["campaign", str(spec), "--trace", str(TRACE),
                      "--out", str(single)]) == 0
    # node 1 of a two-node run died after pricing half of its share
    parsed = load_campaign_spec(spec_doc)
    work = [(sl.label, i) for sl in parsed.slices(4)
            for i in range(parsed.scenarios)]
    share = sorted(shard_assignment(work, [0, 1], spec_hash(parsed))[1])
    done = set(share[:len(share) // 2])
    run_campaign(spec_doc, trace_path=TRACE,
                 out_dir=sharded / "shards" / "n1", only=done)
    capsys.readouterr()
    assert port_main(["campaign", str(spec), "--trace", str(TRACE),
                      "--out", str(sharded), "--nodes", "3"]) == 1
    assert "already holds journaled scenarios" in capsys.readouterr().err
    assert port_main(["campaign", str(spec), "--trace", str(TRACE),
                      "--out", str(sharded), "--nodes", "3",
                      "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"{len(work) - len(done)} scenario(s) priced, {len(done)} " \
        f"resumed from journal" in out
    assert (sharded / "report.json").read_bytes() == \
        (single / "report.json").read_bytes()
    sigs, dup = all_shard_sigs(sharded)
    assert dup == 0 and sigs == set(work)


# -- chip_smoke.py's phase 18 on the CPU host --------------------------------


def test_chip_smoke_phase_18_on_cpu(tmp_path, monkeypatch, capsys):
    """Phase 18 rehearsed on the CPU host at a reduced size: three CPU
    captures stand in for the card's (the parse check over them), and
    phase 9 (c)'s campaign at 64 scenarios; every part's checks run as on
    the card, and the kernels' counters stay 0."""
    import importlib.util

    from tpusim_torch.__main__ import main as cli

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kept = tmp_path / "kept"
    caps = {"flash_attention_pallas": ["--set", "seq=256", "--set",
                                       "batch=1", "--set", "heads=2"],
            "matmul_chain": [],
            "ici_allreduce": ["--set", "world=8", "--set", "elems=1024"]}
    for name, sets in caps.items():
        assert cli(["capture", name, str(kept / name), "--device", "cpu",
                    *sets]) == 0
    monkeypatch.setattr(smoke, "PARSED_CAPTURES", tuple(caps))
    monkeypatch.setattr(smoke, "BIG_CAMPAIGN_SCENARIOS", 64)
    work = tmp_path / "work"
    work.mkdir()
    out = smoke.front_shards_bench("cpu", work, kept)
    assert out["launches"] == {"flash_attention": 0, "scan_rows": 0}
    for leg in ("reuseport", "fd"):
        assert out["a"][leg]["kill"]["restarts"] >= 1
        assert sum(out["a"][leg]["float_gaps"].values()) <= 1
    assert "died" in out["b"]["waves"][1]
    assert out["d"]["price_scan"]["calls"] > 0 and out["d"]["ici_net"]["runs"]
    assert out["e"] == {"v5e": "anchors", "v5p": "anchors"}
    assert [leg["acceptors"] for leg in out["c"]["acceptor"]["legs"]] == \
        [0, 1, 2]
    assert "serve-bench worker sweep" in capsys.readouterr().out

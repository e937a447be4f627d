"""On the card, at the cells' own sizes: a short run of each cell is
correct, and a run with the fp8 control in the program's place is not,
on three seeds.
These skip without an NVIDIA card; run them on one with
``python -m pytest benchmark/tests/test_portbench_card.py -q``."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults, harness, spec
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_the_fp8_control_fails_at_the_cells_size(card, cell, seed):
    c = spec.find_cell(cell)
    fam = spec.family(c.config["family"])
    r = harness.run_cell(c, seed, 1.0, False, card, time.perf_counter(),
                         wrap=faults.control(fam, c.config))
    print(json.dumps({"cell": cell, "seed": seed, "control": r["checks"],
                      "correct": r["correct"], "steps": r["attempted"]}))
    assert r["correct"] is False and r["failed"] >= 1
    torch.cuda.empty_cache()

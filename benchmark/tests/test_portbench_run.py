"""Whole runs of the harness at a size the CPU holds: the result's keys,
faults and the fp8 control planted under the timed path, a metric that
reads nothing, and the modules a run may not load.  The harness's look for a card is skipped: the tests
call :func:`benchmark.harness.run_cell` on the CPU."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import compare, faults, harness, spec, traffic
from benchmark.tests.conftest import ROOT, tiny_cell

fam = spec.family("llama_decoder")
SEED = 2 ** 31 + 12345


def _run(cell, trace=False, wrap=None, seed=SEED):
    return harness.run_cell(cell, seed, 0.3, trace, "cpu",
                            time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    cell = tiny_cell("mistral7b")
    r = _run(cell, trace)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == trace
    assert r["correct"] is True and r["failed"] == 0
    # the window runs at least past the early step it compares
    assert r["attempted"] > traffic.compared_step(cell.traffic, SEED)
    names = {m["name"] for m in (cell.per_layer if trace else
                                 cell.end_to_end)}
    assert set(r["metrics"]) <= names
    if not trace:
        # no card: no peak memory, and so no peak_mem_gib
        assert set(r["metrics"]) == names - {"peak_mem_gib"}
    else:
        assert "host_ms_per_step" in r["metrics"]
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    check = r["checks"]["logit_row_err"]
    assert 0 < check["value"] < check["limit"]
    json.dumps(r)


@pytest.mark.parametrize("config", ["mistral7b", "deepseek7b"])
@pytest.mark.parametrize("fault", ["half_batch", "altered_answer",
                                   "altered_token", "stale"])
def test_a_planted_fault_makes_the_run_incorrect(config, fault):
    cell = tiny_cell(config)
    wrap = faults.all_faults(cell.traffic["batch"],
                             cell.config["vocab_size"])[fault]
    r = _run(cell, wrap=wrap)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["logit_row_err"]["value"] > 0.3


def test_a_batch_of_one_has_no_half_batch_fault():
    assert "half_batch" not in faults.all_faults(1, 512)


#: the limit of ``logit_row_err`` at the tests' tiny sizes (2 layers, dim
#: 128, seq 48), set from its readings on the CPU: the bf16 program
#: 0.006-0.009, the fp8 control 0.09-0.14 (the cells' own limits are set
#: from readings at their sizes on the card, where both read far higher)
TINY_LIMIT = 0.04


@pytest.mark.parametrize("config", ["mistral7b", "deepseek7b"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_and_the_program_passes(config, seed):
    """The reference in fp8 (the precision below bfloat16) put in the
    program's place reads over the limit; the program under it."""
    c = tiny_cell(config)
    params = fam.make_params(c.config, seed, "cpu")
    tokens = traffic.make_tokens(c.traffic, c.config["vocab_size"], seed,
                                 "cpu")[0]
    ref = fam.reference(params, tokens, c.config)
    ctl = fam.reference(params, tokens, c.config,
                        matmul_dtype=torch.float8_e4m3fn)
    wit = fam.reference(params, tokens, c.config,
                        store_dtype=torch.bfloat16)
    got = fam.step(fam.build(c.config, "cpu"), params, tokens)
    program = compare.row_error(got, ref)
    assert compare.row_error(ctl, ref) > TINY_LIMIT > program
    assert compare.row_error(ctl, ref) > 3 * program
    # the plain witness with bfloat16 storage reads as the program does
    assert 0.5 < compare.row_error(wit, ref) / program < 2


def _tiny_limit(cell):
    cell.limits["logit_row_err"]["limit"] = TINY_LIMIT
    return cell


@pytest.mark.parametrize("config", ["mistral7b", "deepseek7b"])
def test_the_control_in_the_programs_place_makes_the_run_incorrect(config):
    """The control driven through the whole run, as a fault is: the
    program's run passes the limit, the control's fails it."""
    cell = _tiny_limit(tiny_cell(config))
    assert _run(cell)["correct"] is True
    r = _run(cell, wrap=faults.control(fam, cell.config))
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["logit_row_err"]["value"] > TINY_LIMIT


class _NaNRow(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *args):
        out = self.inner(*args).clone()
        out[-1, -1, 0] = float("nan")
        return out


def test_a_nan_in_one_row_makes_the_run_incorrect():
    r = _run(tiny_cell("mistral7b"), wrap=_NaNRow)
    value = r["checks"]["logit_row_err"]["value"]
    assert value != value and r["correct"] is False and r["failed"] >= 1
    assert compare.worst([0.1, float("nan"), 0.2]) != compare.worst(
        [0.1, float("nan"), 0.2])


def test_a_metric_that_reads_nothing_ends_a_run_on_a_card():
    cell = tiny_cell("mistral7b")
    ctx = harness.Context(trace=None, host_ns=[], model_flops=1.0, gemms=[],
                          element_size=2, dtype="bfloat16", peaks=None)
    assert harness.read_per_layer(cell, ctx, "cpu", strict=False) == {}
    with pytest.raises(harness.MissingMetric) as e:
        harness.read_per_layer(cell, ctx, "Another Card", strict=True)
    assert "mfu_pct" in str(e.value) and "Another Card" in str(e.value)
    assert "missing from" in str(e.value)


def test_harness_and_reference_load_no_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, calibrate, faults, run\n"
        "from benchmark.reference import llama_plain\n"
        "from benchmark.families import llama_decoder\n"
        "import benchmark.metrics.gemm_roofline\n"
        "llama_decoder.build(__import__('json').load(open(%r)), 'cpu')\n"
        "print(run.foreign_modules())\n"
        "print(sorted(m for m in sys.modules if m.startswith('tpusim_torch'))"
        "[:1])\n" % (str(ROOT), str(ROOT / "benchmark/configs/mistral7b.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    found, program = out.stdout.strip().splitlines()
    assert found == "[]"
    assert program == "['tpusim_torch']"   # the program itself is loaded


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "tpusim_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert "tpusim_torch_fake" not in run.foreign_modules()
    assert "jaxlike" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "tpusim.fake", object())
    assert "tpusim.fake" in run.foreign_modules()


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral7b.prefill_2k", "--seed", str(2 ** 31 + 1), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_compared_step_and_streams_follow_the_seed():
    mix = spec.find_cell("mistral7b.prefill_2k").traffic
    picks = {traffic.compared_step(mix, s) for s in range(64)}
    assert picks <= set(range(mix["compare_from"])) and len(picks) > 4
    assert traffic.compared_step(mix, 2 ** 40) == traffic.compared_step(
        mix, 2 ** 40)

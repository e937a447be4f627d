"""BENCHMARK.json's names and units, and cells, mixes, metric readers and
op classes found by name from files alone."""

import json
import re
import shutil

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def _names():
    out = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        out += c["reduced"]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_names_use_only_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_have_allowed_units_and_keys(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_whys_sources_and_paths():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(entry["why"])
    for c in BENCH["configs"]:
        assert LINE.match(c["source"])
        assert c["file"].startswith("benchmark/")
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(NAME.match(p) for p in rel.split("/")), rel


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_and_its_readers_are_found_by_name(cell):
    c = spec.find_cell(cell)
    assert c.chips == 1
    fam = spec.family(c.config["family"])
    for hook in ("check_traffic", "make_params", "make_inputs", "build",
                 "step_input", "step", "reference", "readings",
                 "model_flops", "gemms", "element_size"):
        assert callable(getattr(fam, hook)), hook
    assert {m["name"] for m in c.end_to_end} == {
        "step_ms", "step_ms_p90", "peak_mem_gib", "setup_s"}
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert "logit_row_err" in c.limits


def test_gemm_class_lists_the_weight_product_ops():
    assert spec.op_class("gemm") >= {"aten::mm", "aten::addmm"}


def test_a_new_cell_mix_reader_and_op_name_need_only_new_files(tmp_path):
    """A cell, a traffic mix, a per-layer reader and a GEMM op name added
    as files and entries, with no file of the harness edited."""
    data = tmp_path / "benchmark"
    for sub in ("traffic", "limits", "metrics", "kernel_ops/gemm"):
        (data / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "benchmark/configs", data / "configs")
    shutil.copytree(ROOT / "benchmark/families", data / "families")
    shutil.copy(ROOT / "benchmark/kernel_ops/gemm/aten.txt",
                data / "kernel_ops/gemm/aten.txt")
    (data / "kernel_ops/gemm/later.txt").write_text("aten::_scaled_mm\n")
    (data / "traffic/prefill_1k.json").write_text(json.dumps(
        {"loop": "closed", "batch": 4, "seq": 1024, "tokens": "uniform",
         "pool": 8, "warmup": 3, "compare_from": 8}))
    (data / "limits/deepseek7b.prefill_1k.json").write_text(json.dumps(
        {"logit_row_err": {"limit": 0.5}}))
    (data / "metrics/later_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "deepseek7b.prefill_1k", "config": "deepseek7b",
        "traffic": "prefill_1k", "chips": 1, "why": "a later cell"}]
    bench["per_layer"] = BENCH["per_layer"] + [{
        "name": "later_metric", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "runner", "moves": "step_ms",
        "workloads": ["deepseek7b.prefill_1k"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("deepseek7b.prefill_1k", tmp_path / "BENCHMARK.json",
                          data)
    assert cell.traffic["seq"] == 1024
    assert cell.config["vocab_size"] == 102400
    assert cell.limits["logit_row_err"]["limit"] == 0.5
    assert "later_metric" in {m["name"] for m in cell.per_layer}
    assert spec.metric_reader("later_metric", data).read(None) == 42.0
    assert spec.op_class("gemm", data) == {"aten::mm", "aten::addmm",
                                           "aten::_scaled_mm"}
    # a metric scoped to the new cell stays out of the others
    other = spec.find_cell("mistral7b.prefill_2k", tmp_path / "BENCHMARK.json")
    assert "later_metric" not in {m["name"] for m in other.per_layer}
    with pytest.raises(KeyError):
        spec.find_cell("nope", tmp_path / "BENCHMARK.json", data)

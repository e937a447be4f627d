"""What a cell is, found by name from ``BENCHMARK.json`` and data files.

A workload names a configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<mix>.json``); its limits are
``benchmark/limits/<workload>.json``.  A configuration names its family,
a module ``benchmark/families/<family>.py``; a per-layer metric is read
by ``benchmark/metrics/<metric>.py``; a class of kernels is the union of
the op names listed in ``benchmark/kernel_ops/<class>/*.txt``.  A new
cell, mix, metric or op name is a new file and a new entry: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def find_cell(name: str, bench_file: Path = BENCHMARK_JSON,
              data: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench_file``, its files read from ``data``
    (the configuration's from the checkout's root)."""
    from benchmark import traffic

    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(bench_file).parent / configs[w["config"]]["file"])
    mix = traffic.validate(
        load_json(data / "traffic" / f"{check_name(w['traffic'])}.json"))
    limits = load_json(data / "limits" / f"{check_name(name)}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=mix,
                limits=limits,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def _load(kind: str, name: str, data: Path) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = data / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} at {path}")
    modname = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def family(name: str, data: Path = HERE) -> ModuleType:
    return _load("families", name, data)


def metric_reader(name: str, data: Path = HERE) -> ModuleType:
    return _load("metrics", name, data)


def op_class(name: str, data: Path = HERE) -> frozenset[str]:
    """The ATen op names of a class of kernels: the union of the lines of
    ``kernel_ops/<name>/*.txt`` (``#`` starts a comment)."""
    ops = set()
    for path in sorted((data / "kernel_ops" / check_name(name)).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                ops.add(line)
    return frozenset(ops)

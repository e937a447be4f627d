"""Benchmark-suite and config database — the rebuild of the reference's
YAML app/config registries (``util/job_launching/apps/define-all-apps.yml``
and ``configs/define-standard-cfgs.yml``).

Port of ``tpusim/harness/suites.py``.

Two sources compose:

* **built-in**: every registered workload
  (:mod:`tpusim_torch.models.registry`) grouped by its ``suite`` tag —
  the in-code ``define-all-apps`` rows;
* **YAML**: a user file adding suites (workload + param overrides +
  launches) and named config overlays, the way the reference lets a lab
  define local app lists without editing the tool (PyYAML is imported
  only when a YAML file is given).

YAML schema::

    suites:
      quick:
        - workload: matmul_chain
          params: {m: 512, k: 512, depth: 2}
          launches: 2
    configs:
      narrow: {kernel_window: 1}
      dcn:    {arch: {ici: {chips_per_slice: 4}}}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["SuiteEntry", "load_suite", "load_named_configs", "list_suites"]


@dataclass
class SuiteEntry:
    workload: str
    params: dict[str, Any] = field(default_factory=dict)
    launches: int = 1

    @property
    def run_name(self) -> str:
        if not self.params:
            return self.workload
        tag = "_".join(f"{k}{v}" for k, v in sorted(self.params.items()))
        return f"{self.workload}__{tag}"[:96]


def _builtin_suites() -> dict[str, list[SuiteEntry]]:
    from tpusim_torch.models import list_workloads

    suites: dict[str, list[SuiteEntry]] = {}
    for wl in list_workloads():
        suites.setdefault(wl.suite, []).append(SuiteEntry(wl.name))
    # "all" = every single-chip workload (multi-device ones need a mesh)
    suites["all"] = [
        SuiteEntry(wl.name) for wl in list_workloads()
        if wl.num_devices <= 1
    ]
    return suites


def _yaml_suites(path: Path) -> dict[str, list[SuiteEntry]]:
    import yaml

    doc = yaml.safe_load(path.read_text()) or {}
    out: dict[str, list[SuiteEntry]] = {}
    for name, rows in (doc.get("suites") or {}).items():
        entries = []
        for row in rows:
            if isinstance(row, str):
                entries.append(SuiteEntry(row))
            else:
                entries.append(SuiteEntry(
                    workload=row["workload"],
                    params=dict(row.get("params") or {}),
                    launches=int(row.get("launches", 1)),
                ))
        out[name] = entries
    return out


def list_suites(yaml_path: str | Path | None = None) -> dict[str, int]:
    suites = _builtin_suites()
    if yaml_path:
        suites.update(_yaml_suites(Path(yaml_path)))
    return {name: len(entries) for name, entries in sorted(suites.items())}


def load_suite(
    name: str, yaml_path: str | Path | None = None
) -> list[SuiteEntry]:
    """Resolve a suite name against the YAML file (if given) then the
    built-in registry groups."""
    if yaml_path:
        from_yaml = _yaml_suites(Path(yaml_path))
        if name in from_yaml:
            return from_yaml[name]
    suites = _builtin_suites()
    if name not in suites:
        known = sorted(suites)
        raise KeyError(f"unknown suite {name!r}; available: {known}")
    return suites[name]


def load_named_configs(
    yaml_path: str | Path | None,
) -> dict[str, dict[str, Any]]:
    """Named overlay dicts from the YAML ``configs:`` section (the
    define-standard-cfgs rows)."""
    if not yaml_path:
        return {}
    import yaml

    doc = yaml.safe_load(Path(yaml_path).read_text()) or {}
    return {k: dict(v or {}) for k, v in (doc.get("configs") or {}).items()}

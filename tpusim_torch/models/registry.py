"""Workload registry — the ``define-all-apps.yml`` equivalent
(``util/job_launching/apps/define-all-apps.yml``): a named database of
traceable benchmarks with their argument sets.

Port of ``tpusim/models/registry.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["Workload", "register", "get_workload", "list_workloads"]


@dataclass
class Workload:
    name: str
    builder: Callable[..., tuple[Callable, tuple]]
    description: str = ""
    suite: str = "default"
    params: dict[str, Any] = field(default_factory=dict)
    #: devices the workload wants (1 = single-chip)
    num_devices: int = 1

    def build(self, **overrides: Any) -> tuple[Callable, tuple]:
        """Returns (module, example_args); ``device=`` picks where the
        inputs live (default cuda)."""
        kw = dict(self.params)
        kw.update(overrides)
        return self.builder(**kw)


_REGISTRY: dict[str, Workload] = {}


def register(
    name: str,
    *,
    description: str = "",
    suite: str = "default",
    num_devices: int = 1,
    **params: Any,
) -> Callable:
    def deco(builder: Callable) -> Callable:
        _REGISTRY[name] = Workload(
            name=name, builder=builder, description=description,
            suite=suite, params=params, num_devices=num_devices,
        )
        return builder

    return deco


def get_workload(name: str) -> Workload:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown workload {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_workloads(suite: str | None = None) -> list[Workload]:
    return [
        w for w in _REGISTRY.values() if suite is None or w.suite == suite
    ]

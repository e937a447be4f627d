"""Workload registry — the ``define-all-apps.yml`` equivalent
(``util/job_launching/apps/define-all-apps.yml``): a named database of
traceable benchmarks with their argument sets.

Port of ``tpusim/models/registry.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Workload", "register", "get_workload", "list_workloads",
           "resolve_device", "torch_dtype", "tensor_from_numpy"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless the caller asks for something else; raises when
    CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available "
            "(pass --device cpu / device='cpu' to run on the CPU)"
        )
    return dev


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a workload's ``dtype`` parameter."""
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[dtype]


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` holding a numpy array's values (or a numpy
    scalar's); bfloat16 arrays (``ml_dtypes``, what ``np.asarray`` gives
    for a JAX bfloat16 array) arrive exactly as torch bfloat16."""
    a = np.array(a, order="C")      # a writable copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


@dataclass
class Workload:
    name: str
    builder: Callable[..., tuple[Callable, tuple]]
    description: str = ""
    suite: str = "default"
    params: dict[str, Any] = field(default_factory=dict)
    #: devices the workload wants (1 = single-chip)
    num_devices: int = 1
    #: captured over abstract (``meta``) tensors unless a device is asked
    #: for: the port's counterpart of the reference's ``ShapeDtypeStruct``
    #: arguments
    abstract: bool = False

    def build(self, **overrides: Any) -> tuple[Callable, tuple]:
        """Returns (module, example_args); ``device=`` picks where the
        inputs live (default cuda; ``meta`` for an abstract workload)."""
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
    abstract: bool = False,
    **params: Any,
) -> Callable:
    def deco(builder: Callable) -> Callable:
        _REGISTRY[name] = Workload(
            name=name, builder=builder, description=description,
            suite=suite, params=params, num_devices=num_devices,
            abstract=abstract,
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

"""Workloads: the registry and the registered workloads.

Importing this package registers every ported workload (it imports
torch)."""

from tpusim_torch.models.registry import Workload, get_workload, list_workloads, register

from tpusim_torch.models import flash_attention as _flash_attention  # noqa: F401

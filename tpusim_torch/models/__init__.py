"""Workloads: the registry and the registered workloads.

Importing this package registers every ported workload (it imports
torch)."""

from tpusim_torch.models.registry import Workload, get_workload, list_workloads, register

# import for registration side effects
from tpusim_torch.models import microbench as _microbench  # noqa: F401
from tpusim_torch.models import attention as _attention  # noqa: F401
from tpusim_torch.models import decode as _decode  # noqa: F401
from tpusim_torch.models import deepseek_v2 as _deepseek_v2  # noqa: F401
from tpusim_torch.models import flash_attention as _flash_attention  # noqa: F401
from tpusim_torch.models import llama as _llama  # noqa: F401
from tpusim_torch.models import llama_aot as _llama_aot  # noqa: F401
from tpusim_torch.models import moe as _moe  # noqa: F401
from tpusim_torch.models import pipeline as _pipeline  # noqa: F401
from tpusim_torch.models import resnet as _resnet  # noqa: F401

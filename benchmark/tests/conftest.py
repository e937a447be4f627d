"""Fixtures of the benchmark's tests.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root;
tests marked ``card`` need an NVIDIA card and skip without one (the
fixture decides, never the import)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402

#: sizes that a CPU test holds, every other key as published
TINY = {
    "mistral7b": {"vocab_size": 512, "hidden_size": 128,
                  "intermediate_size": 448, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "num_key_value_heads": 1},
    "deepseek7b": {"vocab_size": 1024, "hidden_size": 128,
                   "intermediate_size": 352, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 4},
}
TINY_MIX = {"loop": "closed", "batch": 2, "seq": 48, "tokens": "uniform",
            "pool": 8, "warmup": 2, "compare_from": 8}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false on this host")
    return torch.device("cuda")


def tiny_cell(config: str, cell: str = "mistral7b.prefill_2k",
              **mix) -> spec.Cell:
    """A cell of the benchmark at a size the CPU holds: the
    configuration's file with :data:`TINY`'s sizes, :data:`TINY_MIX`, and
    the limits and metrics of ``cell``."""
    real = spec.find_cell(cell)
    cfg = dict(spec.load_json(ROOT / f"benchmark/configs/{config}.json"),
               **TINY[config])
    return spec.Cell(name=f"tiny.{config}", chips=1, config=cfg,
                     traffic=dict(TINY_MIX, **mix),
                     limits=copy.deepcopy(real.limits),
                     end_to_end=real.end_to_end, per_layer=real.per_layer)

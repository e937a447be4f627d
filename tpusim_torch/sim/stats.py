"""Stats registry + report formatting.

Port of ``tpusim/sim/stats.py``.

The reference prints ~300 ``name = value`` lines per kernel
(``gpgpu_sim::print_stats``, ``gpu-sim.h:550-579``) and downstream tooling
scrapes them with YAML-configured regexes
(``util/job_launching/stats/example_stats.yml``), keyed on the success
sentinel ``GPGPU-Sim: *** exit detected ***``
(``util/job_launching/get_stats.py:224-246``).

We keep both contracts — stable greppable text lines *and* a structured JSON
dump (SURVEY.md §7: "structured stats (JSON) plus stable text lines") — and
keep a single success sentinel so monitoring works the same way.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, TextIO

__all__ = ["StatsRegistry", "EXIT_SENTINEL"]

#: the run-succeeded marker; the scraper requires it, like the reference's
#: "GPGPU-Sim: *** exit detected ***".
EXIT_SENTINEL = "TPUSIM: *** exit detected ***"

STAT_PREFIX = "tpusim_"


@dataclass
class StatsRegistry:
    """Flat name→value counter store with grouped formatting."""

    values: dict[str, Any] = field(default_factory=dict)

    def set(self, name: str, value: Any) -> None:
        self.values[name] = value

    def get(self, name: str, default: Any = None) -> Any:
        return self.values.get(name, default)

    def update(self, other: dict[str, Any], prefix: str = "") -> None:
        for k, v in other.items():
            self.values[prefix + k] = v

    # -- output ------------------------------------------------------------

    def text_lines(self) -> list[str]:
        lines = []
        for name in sorted(self.values):
            v = self.values[name]
            if isinstance(v, float):
                v = f"{v:.6g}"
            lines.append(f"{STAT_PREFIX}{name} = {v}")
        return lines

    def print_text(self, out: TextIO = sys.stdout) -> None:
        for line in self.text_lines():
            print(line, file=out)

    def to_json(self) -> str:
        return json.dumps(self.values, indent=2, sort_keys=True, default=str)


"""The card's SM clock and power, sampled beside a traced window.

H100 cards of one kind differ by 1-2% in step time; a reading of the
clocks over the window tells a slow card from a slow change.  A
:class:`Sampler` polls its meters on a daemon thread every
:data:`PERIOD_S` from ``__enter__`` to ``__exit__``, and gives the median
of each.  On a card the meters are the program's NVML readers
(:func:`card_sampler`).
"""

from __future__ import annotations

import statistics
import threading
from typing import Callable

PERIOD_S = 0.5


class Sampler:
    """``with Sampler(clock, watts):`` polls ``clock()`` (MHz) and
    ``watts()`` until the block ends; a meter that answers None adds no
    sample."""

    def __init__(self, clock: Callable[[], float | None],
                 watts: Callable[[], float | None],
                 period_s: float = PERIOD_S):
        self._meters = {"sm_clock_mhz": clock, "power_w": watts}
        self.period_s = period_s
        self.samples: dict[str, list[float]] = {k: [] for k in self._meters}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True,
                                        name="clock-sampler")

    def _poll(self) -> None:
        while True:
            for name, meter in self._meters.items():
                value = meter()
                if value is not None:
                    self.samples[name].append(value)
            if self._stop.wait(self.period_s):
                return

    def __enter__(self) -> "Sampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10 * self.period_s + 10)

    def median(self, name: str) -> float | None:
        """The median of ``name``'s samples (``sm_clock_mhz`` or
        ``power_w``), or None without one."""
        values = self.samples[name]
        return statistics.median(values) if values else None


def card_sampler(device) -> Sampler:
    """A sampler of ``device``'s SM clock and power through NVML."""
    from tpusim_torch.power.telemetry import read_card_clocks, read_card_watts

    return Sampler(lambda: read_card_clocks(device),
                   lambda: read_card_watts(device))

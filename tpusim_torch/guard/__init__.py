"""Governance of the port (port of :mod:`tpusim.guard`): the durable
stores' quota, garbage collection, integrity sweep and clearing
(:mod:`tpusim_torch.guard.store`), cooperative cancellation
(:mod:`tpusim_torch.guard.cancel`), and the memory watchdog with its
degradation ladder (:mod:`tpusim_torch.guard.watchdog`, the
``--max-rss`` flags)."""

from tpusim_torch.guard.cancel import (
    CHECK_EVERY_OPS,
    CancelToken,
    OperationCancelled,
)
from tpusim_torch.guard.watchdog import (
    MemoryWatchdog,
    default_ladder,
    rss_bytes,
)

__all__ = [
    "CHECK_EVERY_OPS",
    "CancelToken",
    "MemoryWatchdog",
    "OperationCancelled",
    "default_ladder",
    "rss_bytes",
]

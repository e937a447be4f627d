"""Governance of the port (port of :mod:`tpusim.guard`): the durable
stores' quota, garbage collection, integrity sweep and clearing
(:mod:`tpusim_torch.guard.store`), and cooperative cancellation
(:mod:`tpusim_torch.guard.cancel`).

Not ported yet: the memory watchdog (ROADMAP A11)."""

from tpusim_torch.guard.cancel import (
    CHECK_EVERY_OPS,
    CancelToken,
    OperationCancelled,
)

__all__ = ["CHECK_EVERY_OPS", "CancelToken", "OperationCancelled"]

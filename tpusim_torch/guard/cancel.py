"""Cooperative cancellation — the deadline/cancel token.

Port of ``tpusim/guard/cancel.py``.  A :class:`CancelToken` makes
interruption an in-process operation: the holder arms it with a deadline
(or cancels it explicitly), the pricing stack checks it at natural grain
boundaries — the driver's command walk, the serial engine walk every
:data:`CHECK_EVERY_OPS` ops, the fastpath between compiled blocks, the
batched pricer between steps and ``warm_states`` between states and
modules, the campaign executor between scenarios, the fleet executor
between states, recoveries and cells — and a tripped token raises
:class:`OperationCancelled` out of the stack with every cache warm and
every journal record already durable.

Checks are cheap by design: one ``Event.is_set()`` plus (when a deadline
is armed) one ``time.monotonic()`` call, and every call site guards with
``if cancel is not None`` so the ungoverned path pays one pointer
compare.  Cancellation changes whether a result is produced, never its
value.
"""

from __future__ import annotations

import threading
import time

__all__ = ["CHECK_EVERY_OPS", "CancelToken", "OperationCancelled"]

#: the serial engine walk's check stride (op grain would tax the hot
#: loop; a 256-op stride bounds the overshoot to microseconds of walk)
CHECK_EVERY_OPS = 256


class OperationCancelled(RuntimeError):
    """The operation's cancel token tripped (deadline or explicit
    cancel).  Each surface maps it itself (the CLI: a clean refusal,
    exit 3)."""


class CancelToken:
    """One cancellable operation's shared flag + optional deadline.

    Thread-safe and process-local: the holder calls :meth:`cancel`
    (or arms a ``time.monotonic()`` deadline at construction), workers
    call :meth:`check` at their grain boundaries.  Tokens never travel
    across process pipes: a forked pool worker prices its segment to
    completion and the parent checks again after it.
    """

    __slots__ = ("deadline", "_event", "reason")

    def __init__(self, deadline: float | None = None):
        #: absolute ``time.monotonic()`` instant, or None for
        #: explicit-cancel-only tokens
        self.deadline = float(deadline) if deadline is not None else None
        self._event = threading.Event()
        self.reason: str | None = None

    @classmethod
    def after(cls, seconds: float) -> "CancelToken":
        """A token that trips ``seconds`` from now (``--max-wall-s``)."""
        return cls(deadline=time.monotonic() + max(float(seconds), 0.0))

    def cancel(self, reason: str = "cancelled") -> None:
        """Trip the token explicitly (idempotent; the first reason
        wins — it is what the refusal message reports)."""
        if not self._event.is_set():
            self.reason = self.reason or reason
        self._event.set()

    @property
    def cancelled(self) -> bool:
        if self._event.is_set():
            return True
        if self.deadline is not None and time.monotonic() >= self.deadline:
            return True
        return False

    def remaining(self) -> float | None:
        """Seconds until the deadline (None when no deadline armed;
        never negative)."""
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    def check(self) -> None:
        """Raise :class:`OperationCancelled` if the token tripped."""
        if self._event.is_set():
            raise OperationCancelled(self.reason or "operation cancelled")
        if self.deadline is not None and time.monotonic() >= self.deadline:
            raise OperationCancelled(
                self.reason or "deadline exceeded (cooperative cancel)"
            )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "cancelled" if self.cancelled else "live"
        return f"CancelToken({state}, deadline={self.deadline})"

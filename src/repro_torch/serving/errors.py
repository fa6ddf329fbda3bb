"""Failure taxonomy for the serving stack (the vision-serving part of
``repro.serving.errors``, with its own :class:`NumericalError`)."""
from __future__ import annotations

__all__ = ["QueueFullError", "CancelledError", "RequestTimedOut",
           "NumericalError"]


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is full (or the
    request was shed to make room)."""


class CancelledError(RuntimeError):
    """The request's handle was cancelled before it produced a result."""


class RequestTimedOut(TimeoutError):
    """The request's per-request deadline expired in the queue."""


class NumericalError(RuntimeError):
    """A forward produced non-finite (NaN/Inf) outputs for a request."""

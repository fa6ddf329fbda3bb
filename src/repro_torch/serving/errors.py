"""Failure taxonomy for the serving stack (twin of
``repro.serving.errors``, with its own :class:`NumericalError`: the port
has no ``FallbackGuard`` below the serving layer to define it).

Every way a request can end other than DONE has one exception class, so
callers can catch precisely what they can handle:

* :class:`QueueFullError` — admission control: the bounded queue rejected
  the submit (``OverloadPolicy(shed_oldest=False)``), or the request was
  admitted and later shed to make room (``shed_oldest=True``; the shed
  handle ends ``FAILED`` with this exception and counts in
  ``ServeStats.shed``).
* :class:`CancelledError` — the caller cancelled the handle
  (``Handle.cancel()``); ``result()`` re-raises this.
* :class:`RequestTimedOut` — the request's per-request deadline
  (``deadline_ms=`` at submit) expired while it was queued or in flight;
  a ``TimeoutError`` subclass so generic timeout handling applies.
* :class:`NumericalError` — the computation produced non-finite outputs
  (a NaN-poisoned forward or KV cache); raised by the engines' per-row
  and per-slot finite checks.
* :class:`InjectedFault` — raised by the :mod:`.faults` harness on a
  provoked executor failure (defined there, re-exported here).

Process-level failures (raised by the supervision layer,
:mod:`.supervisor`):

* :class:`HungStepError` — the engine's serve thread was inside one step
  longer than the supervisor's watchdog threshold.
* :class:`EngineCrashError` — the serve thread died on an uncontained
  exception (e.g. :class:`~.faults.UncontainedCrash`).
* :class:`CircuitOpenError` — the supervisor's circuit breaker tripped
  (too many restarts inside the window).

Executor/engine failures that are none of the above propagate the original
exception through ``Handle.result()`` with the handle in state ``FAILED``.
"""
from __future__ import annotations

__all__ = ["QueueFullError", "CancelledError", "RequestTimedOut",
           "NumericalError", "InjectedFault", "UncontainedCrash",
           "HungStepError", "EngineCrashError", "CircuitOpenError"]


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is full (or the
    request was shed to make room)."""


class CancelledError(RuntimeError):
    """The request's handle was cancelled before it produced a result."""


class RequestTimedOut(TimeoutError):
    """The request's per-request deadline expired (queued or in flight)."""


class NumericalError(RuntimeError):
    """A forward produced non-finite (NaN/Inf) outputs for a request."""


class HungStepError(RuntimeError):
    """The serve thread sat inside one engine step past the watchdog
    threshold (supervisor teardown; in-flight attempts fail with this)."""


class EngineCrashError(RuntimeError):
    """The serve thread died on an uncontained exception; the supervisor
    restarts the daemon (in-flight attempts fail with this)."""


class CircuitOpenError(RuntimeError):
    """The supervisor's restart circuit breaker is open (NOT_READY):
    too many restarts within the window — requests are rejected."""


def __getattr__(name):
    # late imports: faults.py may import this module for the re-export
    if name in ("InjectedFault", "UncontainedCrash"):
        from . import faults
        return getattr(faults, name)
    raise AttributeError(name)

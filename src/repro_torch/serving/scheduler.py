"""The scheduler core behind both serving engines (twin of
``repro.serving.scheduler`` without priorities, ``requeue`` and token
streaming).

``submit()`` returns a :class:`Handle` immediately; a batch executes when
the :class:`FlushPolicy` says so -- ``max_batch`` requests are waiting
(**full**), the oldest waiting request is older than ``max_delay_ms``
(**deadline**), or on an explicit :meth:`Scheduler.drain` (**drain**).
The clock is injectable and read through a monotonic guard, so a clock
that stalls or steps back can neither make an age negative nor un-fire a
deadline.

Handles are a terminal-state machine: ``PENDING``, then exactly one of
``DONE`` / ``FAILED`` / ``CANCELLED`` / ``TIMED_OUT``.  An executor
exception fails only its batch's handles and never leaves the scheduler;
every outcome is counted in :class:`~.batching.ServeStats`, so
``submitted == completed + failed + cancelled + timed_out + shed``.

Two usage modes share the core:

* **executor mode** (VisionEngine): the scheduler owns execution -- give
  it an ``executor(handles, reason)`` and call :meth:`Scheduler.poll`;
* **admission mode** (token Engine): the engine owns execution (slots,
  prefill groups, the decode loop) and uses :meth:`Scheduler.due`,
  :meth:`Scheduler.peek` and :meth:`Scheduler.pop` to decide when and
  which waiting requests to admit.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence

from .batching import ServeStats
from .errors import CancelledError, QueueFullError, RequestTimedOut

FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_DRAIN = "drain"

PENDING = "PENDING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TIMED_OUT = "TIMED_OUT"

_STATE_OUTCOME = {DONE: "completed", FAILED: "failed",
                  CANCELLED: "cancelled", TIMED_OUT: "timed_out"}


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """``max_delay_ms=None`` disables the deadline (only full batches and
    drains flush).  Raises ``ValueError`` for a non-positive ``max_batch``
    or a negative ``max_delay_ms``."""

    max_batch: int = 64
    max_delay_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_ms is not None and self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0 or None, got {self.max_delay_ms}")

    def admission_deadline(self, queue: Sequence["Handle"]) -> Optional[float]:
        """Clock time at which the queue becomes due for a deadline flush."""
        if not queue or self.max_delay_ms is None:
            return None
        return (min(h.submitted_at for h in queue)
                + self.max_delay_ms / 1000.0)


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """``max_queue=None``: unbounded.  With a bound, a submit that finds the
    queue full raises :class:`QueueFullError` (counted in ``rejected``) or,
    with ``shed_oldest=True``, fails the oldest waiting request with it
    (counted in ``shed``) to make room."""

    max_queue: Optional[int] = None
    shed_oldest: bool = False

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {self.max_queue}")


class Handle:
    """A submitted request: a future with a terminal-state machine.
    ``result()`` raises ``RuntimeError`` while PENDING (unless ``timeout=``
    seconds are given to wait on the real clock) and re-raises the
    recorded exception for a failed/cancelled/timed-out request."""

    __slots__ = ("uid", "payload", "submitted_at", "deadline", "state",
                 "_result", "_exception", "_stats", "_cond")

    def __init__(self, uid: int, payload, submitted_at: float,
                 deadline: Optional[float] = None,
                 stats: Optional[ServeStats] = None):
        self.uid = uid
        self.payload = payload
        self.submitted_at = submitted_at
        self.deadline = deadline  # absolute clock seconds, or None
        self.state = PENDING
        self._result = None
        self._exception: Optional[BaseException] = None
        self._stats = stats
        self._cond = threading.Condition()

    def _finish(self, state: str, result=None,
                exc: Optional[BaseException] = None,
                count_as: Optional[str] = None) -> bool:
        with self._cond:
            if self.state != PENDING:
                return False
            self.state = state
            self._result = result
            self._exception = exc
            if self._stats is not None:
                self._stats.record_outcome(count_as or _STATE_OUTCOME[state])
            self._cond.notify_all()
        return True

    def set_result(self, result) -> bool:
        return self._finish(DONE, result=result)

    def set_exception(self, exc: BaseException, state: str = FAILED,
                      count_as: Optional[str] = None) -> bool:
        return self._finish(state, exc=exc, count_as=count_as)

    def cancel(self) -> bool:
        """PENDING -> CANCELLED; False if already terminal."""
        return self._finish(
            CANCELLED, exc=CancelledError(f"request {self.uid} cancelled"))

    def done(self) -> bool:
        return self.state != PENDING

    def result(self, timeout: Optional[float] = None):
        if self.state == PENDING and timeout is not None:
            with self._cond:
                self._cond.wait_for(lambda: self.state != PENDING,
                                    timeout=timeout)
            if self.state == PENDING:
                raise TimeoutError(f"request {self.uid} still PENDING after "
                                   f"{timeout}s")
        if self.state == PENDING:
            raise RuntimeError(
                f"request {self.uid} has no result yet: poll() until its "
                "deadline passes, or drain()")
        if self.state == DONE:
            return self._result
        raise self._exception

    def __repr__(self):
        return f"Handle(uid={self.uid}, {self.state})"


class Scheduler:
    """Deadline-driven FIFO request queue that owns execution: give it an
    ``executor(handles, reason)`` and call :meth:`poll`.  Queue state is
    guarded by one lock; the executor runs outside it."""

    def __init__(self, policy: FlushPolicy = FlushPolicy(),
                 executor: Optional[Callable] = None,
                 stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 overload: Optional[OverloadPolicy] = None):
        self.policy = policy
        self.executor = executor
        self.stats = stats if stats is not None else ServeStats()
        self.clock = clock
        self.overload = overload if overload is not None else OverloadPolicy()
        self._q: List[Handle] = []
        self._uids = itertools.count()
        self._last_now = float("-inf")
        self._lock = threading.RLock()

    def now(self, now: Optional[float] = None) -> float:
        """Monotonic-guarded clock read."""
        with self._lock:
            t = self.clock() if now is None else now
            if t > self._last_now:
                self._last_now = t
            return self._last_now

    # -- queue state ---------------------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def pending_payloads(self) -> list:
        """Payloads still queued, in admission order."""
        with self._lock:
            return [h.payload for h in self._q]

    def oldest_age_ms(self, now: Optional[float] = None) -> float:
        with self._lock:
            if not self._q:
                return 0.0
            oldest = min(h.submitted_at for h in self._q)
            return max(0.0, (self.now(now) - oldest) * 1000.0)

    def next_deadline(self) -> Optional[float]:
        """Clock time of the next event -- a waiting request becoming due
        for admission, or the earliest per-request deadline (None if
        neither applies): serving loops sleep until it."""
        with self._lock:
            cands = []
            adm = self.policy.admission_deadline(self._q)
            if adm is not None:
                cands.append(adm)
            cands.extend(h.deadline for h in self._q
                         if h.deadline is not None)
            return min(cands) if cands else None

    def expire(self, now: Optional[float] = None) -> int:
        """Drop cancelled handles; time out requests past their deadline."""
        with self._lock:
            now = self.now(now)
            keep: List[Handle] = []
            expired: List[Handle] = []
            for h in self._q:
                if h.state != PENDING:
                    continue
                if h.deadline is not None and now >= h.deadline:
                    expired.append(h)
                else:
                    keep.append(h)
            self._q = keep
        for h in expired:
            h.set_exception(
                RequestTimedOut(
                    f"request {h.uid} expired in queue: deadline passed "
                    f"{(now - h.deadline) * 1000.0:.1f}ms ago"),
                state=TIMED_OUT)
        return len(expired)

    def due(self, now: Optional[float] = None) -> Optional[str]:
        """The flush reason if a batch should execute now, else None."""
        with self._lock:
            now = self.now(now)
            self.expire(now)
            if not self._q:
                return None
            if len(self._q) >= self.policy.max_batch:
                return FLUSH_FULL
            deadline = self.policy.admission_deadline(self._q)
            if deadline is not None and now >= deadline:
                return FLUSH_DEADLINE
            return None

    def submit(self, payload, deadline_ms: Optional[float] = None) -> Handle:
        """Enqueue one request; a now-full batch executes inline.  Raises
        ``QueueFullError`` when a bounded queue rejects, ``ValueError`` for
        a non-positive ``deadline_ms``."""
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        shed: List[Handle] = []
        with self._lock:
            now = self.now()
            self.expire(now)
            cap = self.overload.max_queue
            if cap is not None and len(self._q) >= cap:
                if not self.overload.shed_oldest:
                    self.stats.record_outcome("rejected")
                    raise QueueFullError(
                        f"queue full: {len(self._q)} waiting >= "
                        f"max_queue={cap}")
                shed = self._q[:len(self._q) - cap + 1]
                self._q = self._q[len(shed):]
            h = Handle(uid=next(self._uids), payload=payload,
                       submitted_at=now,
                       deadline=(None if deadline_ms is None
                                 else now + deadline_ms / 1000.0),
                       stats=self.stats)
            self._q.append(h)
            self.stats.submitted += 1
        for old in shed:
            old.set_exception(
                QueueFullError(f"request {old.uid} shed: queue hit "
                               f"max_queue={self.overload.max_queue}"),
                count_as="shed")
        if self.executor is not None:
            self.poll(now)
        return h

    # -- admission mode (the engine owns execution) --------------------------
    def peek(self, n: int) -> List[Handle]:
        """Up to ``n`` next PENDING handles in admission order, not
        removed."""
        with self._lock:
            return [h for h in self._q if h.state == PENDING][: max(0, n)]

    def pop(self, handles: Sequence[Handle], reason: str) -> List[Handle]:
        """Remove ``handles`` from the queue, stamping each one's queue
        latency and the batch's flush reason into the stats; returns only
        those still PENDING (cancelled/expired ones are never executed)."""
        with self._lock:
            now = self.now()
            taken = {id(h) for h in handles}
            self._q = [h for h in self._q if id(h) not in taken]
            live = [h for h in handles if h.state == PENDING]
            for h in live:
                self.stats.record_latency((now - h.submitted_at) * 1000.0)
            if live:
                self.stats.record_flush(reason)
            return live

    def _run_executor(self, handles: List[Handle], reason: str) -> None:
        """One executor call; an exception fails only this batch."""
        try:
            self.executor(handles, reason)
        except Exception as e:  # noqa: BLE001 -- containment is the point
            for h in handles:
                h.set_exception(e)

    def poll(self, now: Optional[float] = None) -> int:
        """Execute every due batch; returns the requests resolved."""
        if self.executor is None:
            return 0
        delivered = 0
        while True:
            with self._lock:
                reason = self.due(now)
                if reason is None:
                    return delivered
                handles = self.pop(self._q[: self.policy.max_batch], reason)
            if not handles:
                continue
            self._run_executor(handles, reason)
            delivered += len(handles)

    def drain(self) -> List[Handle]:
        """Flush everything pending regardless of policy; returns the
        flushed handles in admission order."""
        if self.executor is None:
            raise RuntimeError("drain() needs an executor")
        flushed: List[Handle] = []
        while True:
            with self._lock:
                if not self._q:
                    return flushed
                handles = self.pop(self._q[: self.policy.max_batch],
                                    FLUSH_DRAIN)
            if not handles:
                continue
            self._run_executor(handles, FLUSH_DRAIN)
            flushed.extend(handles)

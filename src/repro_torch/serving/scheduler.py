"""The scheduler core behind both serving engines (twin of
``repro.serving.scheduler``).

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

Queue order is descending priority, FIFO within a class; ``requeue``
puts a preempted request back at the end of its class.  Handles stream
tokens (``push_token`` / ``tokens()`` / ``on_token``) and run
done-callbacks, all on one condition variable, so a serving daemon's
thread wakes a blocked consumer at once.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

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
        """Clock time at which the queue becomes due for a deadline flush
        (:class:`~.slo.ClassFlushPolicy` overrides it per SLO class)."""
        if not queue or self.max_delay_ms is None:
            return None
        return (min(h.submitted_at for h in queue)
                + self.max_delay_ms / 1000.0)


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """``max_queue=None``: unbounded.  With a bound, a submit that finds the
    queue full raises :class:`QueueFullError` (counted in ``rejected``) or,
    with ``shed_oldest=True``, fails the oldest waiting request of the
    lowest priority class with it (counted in ``shed``) to make room."""

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
    recorded exception for a failed/cancelled/timed-out request.

    Streaming: producers push tokens with :meth:`push_token`; consumers
    iterate :meth:`tokens` or pass an ``on_token`` callback.  Done- and
    token-callbacks run outside the handle's lock, on the resolving
    thread, and exceptions they raise are swallowed."""

    __slots__ = ("uid", "payload", "submitted_at", "deadline", "state",
                 "priority", "_result", "_exception", "_stats", "_cond",
                 "_stream", "_on_token", "_callbacks")

    def __init__(self, uid: int, payload, submitted_at: float,
                 deadline: Optional[float] = None,
                 stats: Optional[ServeStats] = None,
                 priority: int = 0,
                 on_token: Optional[Callable[[int], None]] = None):
        self.uid = uid
        self.payload = payload
        self.submitted_at = submitted_at
        self.deadline = deadline  # absolute clock seconds, or None
        self.priority = priority  # higher admits first (SLO classes)
        self.state = PENDING
        self._result = None
        self._exception: Optional[BaseException] = None
        self._stats = stats
        self._cond = threading.Condition()
        self._stream: List[int] = []   # incrementally delivered tokens
        self._on_token = on_token
        self._callbacks: List[Callable[["Handle"], None]] = []

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
            callbacks, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for cb in callbacks:  # outside the lock: a callback may inspect us
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — callbacks must not break
                pass           # the resolving engine's containment
        return True

    def add_done_callback(self, fn: Callable[["Handle"], None]) -> None:
        """Run ``fn(handle)`` once the handle reaches ANY terminal state
        (immediately if it already has).  Runs on the resolving thread,
        outside the handle's lock; exceptions are swallowed."""
        with self._cond:
            if self.state == PENDING:
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001 — see add-time contract
            pass

    # -- streaming -----------------------------------------------------------
    def push_token(self, token: int) -> bool:
        """Deliver one incremental token (producer side: the engine's
        decode loop).  Dropped once the handle is terminal.  Wakes
        :meth:`tokens` iterators; invokes the ``on_token`` callback (set
        via ``Engine.submit(on_token=)``) outside the lock, on the
        producing thread — exceptions it raises are swallowed."""
        with self._cond:
            if self.state != PENDING:
                return False
            self._stream.append(int(token))
            cb = self._on_token
            self._cond.notify_all()
        if cb is not None:
            try:
                cb(int(token))
            except Exception:  # noqa: BLE001 — user callback cannot break
                pass           # the engine loop
        return True

    @property
    def streamed(self) -> int:
        """Tokens pushed so far (monotonic; final result may hold more —
        tokens decoded and completed in the same step arrive together)."""
        with self._cond:
            return len(self._stream)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Blocking iterator over streamed tokens, in decode order.

        Yields each token as the engine produces it (requires a streaming
        submit — ``Engine.submit(stream=True)`` or ``on_token=`` — and
        something concurrently driving the engine, e.g. the serving
        daemon).  Ends when the handle resolves: normally on ``DONE``
        (after draining every pushed token), re-raising the recorded
        exception on FAILED / CANCELLED / TIMED_OUT — tokens already
        yielded stand, the failure tells the consumer the stream is
        truncated.  ``timeout``: max seconds to wait for EACH next token
        (real clock); raises ``TimeoutError`` when it expires.
        """
        pos = 0
        while True:
            with self._cond:
                while pos >= len(self._stream) and self.state == PENDING:
                    if not self._cond.wait(timeout=timeout):
                        raise TimeoutError(
                            f"request {self.uid}: no token within "
                            f"{timeout}s (is anything driving the "
                            "engine?)")
                if pos < len(self._stream):
                    tok = self._stream[pos]
                    pos += 1
                else:  # terminal and fully drained
                    if self.state == DONE:
                        return
                    exc = self._exception
                    break
            yield tok
        raise exc

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

    def cancelled(self) -> bool:
        return self.state == CANCELLED

    def exception(self) -> Optional[BaseException]:
        """The recorded failure (None while PENDING or when DONE)."""
        return self._exception

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


def end_like(h: Handle, state: str, msg: str) -> None:
    """End ``h`` as its twin on another rank ended: cancelled, timed out
    or failed, with that rank's message (a no-op once ``h`` is done)."""
    if h.done():
        return
    if state == CANCELLED:
        h.cancel()
    elif state == TIMED_OUT:
        h.set_exception(RequestTimedOut(msg), state=TIMED_OUT)
    else:
        h.set_exception(RuntimeError(msg))


class Scheduler:
    """Deadline-driven priority/FIFO request queue (see module docstring).
    Queue state is guarded by one lock; the executor runs outside it, and
    so does every handle transition the scheduler makes, so a done-callback
    may take other locks (the serving daemon's) without risking a
    lock-order inversion against a thread that submits.

    ``execute_on_submit`` (True, as in JAX): in executor mode ``submit()``
    runs a batch it makes due inline, on the submitting thread.  The
    serving daemon clears it, so only the daemon's thread touches the
    card: a foreign thread's CUDA call during a graph capture on the
    daemon's thread would invalidate the capture."""

    def __init__(self, policy: FlushPolicy = FlushPolicy(),
                 executor: Optional[Callable] = None,
                 stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 overload: Optional[OverloadPolicy] = None,
                 faults=None):
        self.policy = policy
        self.executor = executor
        self.stats = stats if stats is not None else ServeStats()
        self.clock = clock
        self.overload = overload if overload is not None else OverloadPolicy()
        self.faults = faults  # serving.faults.FaultInjector (site "executor")
        self._q: List[Handle] = []
        self._uids = itertools.count()
        self._last_now = float("-inf")
        self._lock = threading.RLock()
        self.execute_on_submit = True

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

    def _sweep(self, now: float) -> List[Handle]:
        """Under the lock: drop terminal handles from the queue, and take
        out (and return) those past their deadline.  The caller times them
        out with :meth:`_time_out` once it has released the lock."""
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
        return expired

    @staticmethod
    def _time_out(expired: List[Handle], now: float) -> None:
        for h in expired:
            h.set_exception(
                RequestTimedOut(
                    f"request {h.uid} expired in queue: deadline passed "
                    f"{(now - h.deadline) * 1000.0:.1f}ms ago"),
                state=TIMED_OUT)

    def _reason(self, now: float) -> Optional[str]:
        """Under the lock: the flush reason if a batch is due at ``now``."""
        if not self._q:
            return None
        if len(self._q) >= self.policy.max_batch:
            return FLUSH_FULL
        deadline = self.policy.admission_deadline(self._q)
        if deadline is not None and now >= deadline:
            return FLUSH_DEADLINE
        return None

    def expire(self, now: Optional[float] = None) -> int:
        """Drop cancelled handles; time out requests past their deadline."""
        with self._lock:
            now = self.now(now)
            expired = self._sweep(now)
        self._time_out(expired, now)
        return len(expired)

    def due(self, now: Optional[float] = None) -> Optional[str]:
        """The flush reason if a batch should execute now, else None."""
        with self._lock:
            now = self.now(now)
            expired = self._sweep(now)
            reason = self._reason(now)
        self._time_out(expired, now)
        return reason

    def _insert(self, h: Handle) -> None:
        """Insert keeping descending priority, FIFO within a class."""
        i = len(self._q)
        while i > 0 and self._q[i - 1].priority < h.priority:
            i -= 1
        self._q.insert(i, h)

    def submit(self, payload, deadline_ms: Optional[float] = None,
               priority: int = 0,
               on_token: Optional[Callable[[int], None]] = None) -> Handle:
        """Enqueue one request; a now-full batch executes inline (unless
        ``execute_on_submit`` is off).  Higher ``priority`` admits first;
        ``on_token`` is installed on the handle.  Raises ``QueueFullError``
        when a bounded queue rejects, ``ValueError`` for a non-positive
        ``deadline_ms``."""
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        shed: List[Handle] = []
        rejected = False
        with self._lock:
            now = self.now()
            expired = self._sweep(now)
            cap = self.overload.max_queue
            if cap is not None and len(self._q) >= cap:
                rejected = not self.overload.shed_oldest
                while not rejected and len(self._q) >= cap:
                    # the oldest of the lowest class: the queue's order
                    # puts that class at the tail, oldest first
                    minp = self._q[-1].priority
                    victim = next(h for h in self._q if h.priority == minp)
                    self._q.remove(victim)
                    shed.append(victim)
            if rejected:
                self.stats.record_outcome("rejected")
                n_waiting = len(self._q)
            else:
                h = Handle(uid=next(self._uids), payload=payload,
                           submitted_at=now,
                           deadline=(None if deadline_ms is None
                                     else now + deadline_ms / 1000.0),
                           stats=self.stats, priority=priority,
                           on_token=on_token)
                self._insert(h)
                self.stats.submitted += 1
        self._time_out(expired, now)
        if rejected:
            raise QueueFullError(
                f"queue full: {n_waiting} waiting >= max_queue={cap}")
        for old in shed:
            old.set_exception(
                QueueFullError(f"request {old.uid} shed: queue hit "
                               f"max_queue={self.overload.max_queue}"),
                count_as="shed")
        if self.executor is not None and self.execute_on_submit:
            self.poll(now)
        return h

    def requeue(self, handle: Handle) -> bool:
        """Put a still-PENDING handle back at the end of its priority class
        (a preempted request's continuation).  Resets ``submitted_at``,
        counts no new submit and bypasses the overload bound; False if the
        handle is already terminal."""
        with self._lock:
            if handle.state != PENDING:
                return False
            handle.submitted_at = self.now()
            self._insert(handle)
            return True

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
        """One executor call; an exception (an injected ``executor`` fault
        too) fails only this batch."""
        act = self.faults.on_call("executor") if self.faults else None
        try:
            if act is not None:
                act.fire()
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
                t = self.now(now)
                expired = self._sweep(t)
                reason = self._reason(t)
                handles = ([] if reason is None else
                           self.pop(self._q[: self.policy.max_batch], reason))
            self._time_out(expired, t)
            if reason is None:
                return delivered
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

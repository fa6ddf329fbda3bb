"""The wall-clock serving daemon: a thread that actually drives an engine
(a copy of ``repro.serving.daemon`` with the port's threading rules).

Everything below the daemon is poll-driven — `Engine.step()` /
`VisionEngine.poll()` advance exactly when called, which is perfect for
tests and virtual-clock benchmarks and useless for a client that just
wants to connect and submit.  :class:`ServingDaemon` closes that gap: one
background thread owns the engine and runs the serve loop; foreign
threads call :meth:`submit` (thread-safe all the way down — the scheduler
queue, the handle state machine, and ``ServeStats`` all lock internally)
and consume results through the streaming ``Handle`` API
(``handle.tokens()``, ``on_token=``, ``result(timeout=)``).

The loop does NOT poll: while decode slots are live it steps flat-out,
and when the engine goes idle it sleeps on a condition variable with a
timeout of ``scheduler.next_deadline() - now`` — a submit notifies the
condition, a deadline (admission coalescing or per-request expiry) wakes
it by timeout, and nothing else spins.  Because ``Scheduler.due`` and
``next_deadline`` share one ``FlushPolicy.admission_deadline``
arithmetic, sleeping exactly until the returned instant IS due — the
loop never wakes a float-ulp early and spins.

SLO classes (:mod:`.slo`) are resolved here, at submit
time, into plain engine arguments: the class's priority rides the
scheduler's priority queue, its ``max_delay_ms`` rides the installed
:class:`~.slo.ClassFlushPolicy`, its ``deadline_ms``
becomes the request deadline (unless the submit carries its own), its
``max_queued`` bounds the class's OUTSTANDING requests (rejecting
beyond it with ``QueueFullError``), and ``preemptible`` marks decodes
the engine may evict (restart-from-prefix) for higher tiers.  Per-class
:class:`~.batching.ServeStats` record COMPLETION latency
(submit -> terminal, not just queue wait) via done-callbacks, so
``daemon.class_stats["interactive"].p99_ms < ...["batch"].p99_ms`` is a
measurable SLO, not a hope.

Shutdown: ``shutdown(drain=True)`` stops intake and serves everything
outstanding to a terminal state; ``drain=False`` (or a drain that hits
``timeout``) cancels what remains instead — either way every submitted
handle resolves and the reconciliation invariant
``submitted == completed+failed+cancelled+timed_out+shed`` holds
exactly.  The daemon is also a context manager (clean drain on exit).

PyTorch keeps grad mode, the current CUDA device and the current stream
per thread.  The serve thread enters ``torch.cuda.device(engine.device)``
before it serves, and the engines enter ``no_grad`` / ``inference_mode``
themselves, so nothing depends on the starting thread's state.  Only the
serve thread touches the card: token submits are host-only, and the
daemon turns off the vision scheduler's inline execution at submit
(``Scheduler.execute_on_submit``), because a CUDA call from another
thread during a CUDA-graph capture on the serve thread would invalidate
the capture.  For the same reason a supervisor that tears a daemon down
waits (:meth:`ServingDaemon.join`, bounded) for the abandoned serve
thread to leave before it builds and captures the next engine.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

from .batching import ServeStats
from .errors import QueueFullError
from .scheduler import DONE, FAILED, Handle
from .slo import DEFAULT_CLASSES, ClassFlushPolicy, classes_by_name

# daemon lifecycle states
_NEW, _RUNNING, _STOPPING, _STOPPED = "new", "running", "stopping", "stopped"
_CRASHED = "crashed"  # the serve thread died on an uncontained exception


class ServingDaemon:
    """Background serve loop over one engine (see module docstring).

    ``engine``: a token ``Engine`` (driven via ``step()``) or a
    ``VisionEngine`` (driven via ``poll()``) — detected by which method
    it has; its scheduler stops executing batches inline at submit.  ``classes``: the SLO tiers submits may name (default
    interactive + batch); installs a
    :class:`~.slo.ClassFlushPolicy` built from them onto
    the engine's scheduler, preserving its ``max_batch``.  The engine's
    clock must be the real clock (a virtual clock cannot wake a sleeping
    thread — virtual-time tests drive the engine directly instead).
    """

    def __init__(self, engine, classes=DEFAULT_CLASSES):
        self.engine = engine
        sched = engine.scheduler
        if sched.clock is not time.monotonic:
            raise ValueError(
                "ServingDaemon needs the engine on the real clock "
                "(time.monotonic): sleeping until next_deadline() cannot "
                "advance an injected virtual clock — virtual-time tests "
                "drive the engine directly")
        self._is_token = hasattr(engine, "step")
        if not self._is_token:
            sched.execute_on_submit = False  # only the serve thread runs
        self.classes = classes_by_name(classes)
        sched.policy = ClassFlushPolicy.from_classes(
            classes, max_batch=sched.policy.max_batch)
        self.class_stats: Dict[str, ServeStats] = {
            name: ServeStats() for name in self.classes}
        # RLock: a done-callback may run on a thread that holds _wake
        # (a submit whose overload policy sheds a queued request)
        self._wake = threading.Condition(threading.RLock())
        self._state = _NEW
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # supervision surface (serving.supervisor): ``crashed`` records an
        # uncontained exception that killed the serve thread; ``heartbeat``
        # is the real-clock time the loop last COMPLETED a pass; and
        # ``step_started`` is non-None exactly while the loop is inside
        # one engine advance — a hung step is step_started staying set
        # while the clock runs on (an idle, sleeping loop never looks
        # hung because step_started is None between passes)
        self.crashed: Optional[BaseException] = None
        self.heartbeat: Optional[float] = None
        self.step_started: Optional[float] = None
        # outstanding (unresolved) handles, per class and as a set — the
        # per-class budget reads the count; non-drain shutdown cancels
        # the set.  Guarded by _wake's lock.
        self._outstanding: Dict[int, str] = {}  # handle uid -> class name
        self._handles: Dict[int, Handle] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingDaemon":
        """Start the serve thread; idempotent error on reuse (a daemon
        serves one lifecycle — make a new one after shutdown)."""
        with self._wake:
            if self._state != _NEW:
                raise RuntimeError(
                    f"daemon already {self._state}: a ServingDaemon runs "
                    "one start/shutdown lifecycle")
            self._state = _RUNNING
        self._thread = threading.Thread(
            target=self._run, name="repro-serve", daemon=True)
        self._thread.start()
        return self

    def __enter__(self) -> "ServingDaemon":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    @property
    def running(self) -> bool:
        return self._state == _RUNNING

    @property
    def outstanding(self) -> int:
        """Unresolved handles registered through :meth:`submit` (queued
        plus in flight) — a health-probe input."""
        with self._wake:
            return len(self._handles)

    def abort(self):
        """Supervisor teardown of a crashed/hung daemon: mark it STOPPING
        (non-drain) WITHOUT joining the serve thread — a hung thread
        cannot be joined, and a crashed one is already gone.  Returns the
        outstanding handles so the caller can fail them with the teardown
        reason (``HungStepError`` / ``EngineCrashError``); if the stuck
        thread ever wakes it sees STOPPING+non-drain and exits.  Regular
        clients should use :meth:`shutdown`."""
        with self._wake:
            if self._state in (_RUNNING, _CRASHED):
                self._state = _STOPPING
            self._drain = False
            self._wake.notify_all()
            return list(self._handles.values())

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` seconds for the serve thread to exit;
        True once it has (or never started).  A supervisor calls this
        after :meth:`abort` and before it builds the next engine, so that
        an abandoned thread's last CUDA work cannot overlap the new
        engine's graph captures."""
        th = self._thread
        if th is None:
            return True
        th.join(timeout)
        return not th.is_alive()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the daemon.  ``drain=True`` stops intake and keeps
        serving until everything outstanding reached a terminal state;
        ``drain=False`` — or a drain still busy after ``timeout``
        seconds — CANCELS the remainder instead.  Either way every
        submitted handle resolves, so the stats reconcile exactly.
        Idempotent; returns once the serve thread has exited."""
        with self._wake:
            if self._state in (_NEW, _STOPPED):
                self._state = _STOPPED
                return
            self._state = _STOPPING
            self._drain = drain
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():  # drain exceeded its budget
                with self._wake:
                    self._drain = False
                    self._wake.notify_all()
                self._thread.join()
        # cancel anything the loop did not serve (drain=False, or handles
        # still queued when a timed-out drain was demoted); in-flight
        # slots are dead with the loop, so cancel resolves them too
        with self._wake:
            leftovers = list(self._handles.values())
        for h in leftovers:
            h.cancel()
        with self._wake:
            self._state = _STOPPED

    # -- submit --------------------------------------------------------------
    def submit(self, payload, slo: str = "interactive", **kw):
        """Submit ``payload`` under an SLO class, from any thread.

        Token engine: ``payload`` is the prompt; ``kw`` forwards to
        ``Engine.submit`` (``max_new_tokens=``, ``stream=``,
        ``on_token=``, ``temperature=``, ``deadline_ms=``...).  Vision
        engine: ``payload`` is the image.  The class supplies priority,
        preemptibility, and — unless ``kw`` carries ``deadline_ms`` —
        its default deadline.  Returns what the engine's submit returns
        (a ``Request`` with ``.handle``, or a bare ``Handle``).

        Raises ``QueueFullError`` when the class's ``max_queued``
        outstanding-budget is exhausted (counted ``rejected`` in that
        class's stats; nothing was submitted), ``KeyError`` for an
        unknown class name, ``RuntimeError`` when the daemon is not
        running.
        """
        if slo not in self.classes:
            raise KeyError(
                f"unknown SLO class {slo!r}; one of "
                f"{sorted(self.classes)}")
        cls = self.classes[slo]
        cstats = self.class_stats[cls.name]
        # submit + registration happen under _wake so a concurrent
        # shutdown cannot slip between them (it would miss the handle in
        # its leftover sweep and leave it PENDING forever); lock order is
        # always _wake -> scheduler lock, never the reverse
        with self._wake:
            if self._state != _RUNNING:
                raise RuntimeError(
                    f"daemon is {self._state}: submit() needs a running "
                    "daemon (start() it, or it was shut down)")
            if cls.max_queued is not None:
                n_out = sum(1 for c in self._outstanding.values()
                            if c == cls.name)
                if n_out >= cls.max_queued:
                    cstats.record_outcome("rejected")
                    raise QueueFullError(
                        f"SLO class {cls.name!r} budget exhausted: "
                        f"{n_out} outstanding >= max_queued="
                        f"{cls.max_queued}")
            kw.setdefault("deadline_ms", cls.deadline_ms)
            if self._is_token:
                out = self.engine.submit(payload, priority=cls.priority,
                                         preemptible=cls.preemptible, **kw)
                handle = out.handle
            else:
                out = self.engine.submit(payload, **kw)
                handle = out
            t0 = self.engine.scheduler.now()
            cstats.submitted += 1
            self._outstanding[handle.uid] = cls.name
            self._handles[handle.uid] = handle
            self._wake.notify_all()  # new work: wake a sleeping loop

        def _on_done(h: Handle, _cstats=cstats, _t0=t0) -> None:
            # completion latency (submit -> terminal) on the scheduler's
            # monotonic-guarded clock; the per-class outcome mirrors the
            # engine's (shed keeps its distinct counter)
            _cstats.record_latency(
                (self.engine.scheduler.now() - _t0) * 1000.0)
            state = h.state
            if state == FAILED and isinstance(h.exception(),
                                              QueueFullError):
                _cstats.record_outcome("shed")
            elif state == DONE:
                _cstats.record_outcome("completed")
            else:
                _cstats.record_outcome(
                    {"FAILED": "failed", "CANCELLED": "cancelled",
                     "TIMED_OUT": "timed_out"}[state])
            with self._wake:
                self._outstanding.pop(h.uid, None)
                self._handles.pop(h.uid, None)
                self._wake.notify_all()  # budget freed / drain progress

        handle.add_done_callback(_on_done)
        return out

    # -- the serve loop ------------------------------------------------------
    def _tick(self) -> int:
        """One engine advance; returns >0 while there is work in hand."""
        if self._is_token:
            live = self.engine.step()
            # count due queue work too: step() returns 0 when everything
            # just retired but more requests already wait
            return live or (1 if self.engine.scheduler.due() else 0)
        resolved = self.engine.poll()
        return resolved or (1 if self.engine.scheduler.due() else 0)

    def _idle(self) -> bool:
        """Nothing queued and nothing in flight (drain-complete test)."""
        if self.engine.scheduler.pending:
            return False
        if self._is_token and any(s is not None for s in self.engine.slots):
            return False
        return True

    def _run(self) -> None:
        """Thread target: the serve loop under an UNCONTAINED-crash
        recorder.  Per-request failures never reach here (the engines
        contain them with ``except Exception``); what does — a
        ``BaseException`` like ``faults.UncontainedCrash``, or a genuine
        engine-loop bug escaping containment — kills the loop.  Record
        it and flip to CRASHED so ``submit()`` fails fast and a
        supervisor can detect, tear down, and restart.  Deliberately NOT
        re-contained: outstanding handles stay PENDING for the
        supervisor to fail/replay (plain ``shutdown()`` still cancels
        them for unsupervised users)."""
        dev = self.engine.device
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._loop()
        except BaseException as e:  # noqa: BLE001 — crash recorder
            with self._wake:
                self.crashed = e
                self.step_started = None
                if self._state == _RUNNING:
                    self._state = _CRASHED
                self._wake.notify_all()

    def _loop(self) -> None:
        sched = self.engine.scheduler
        while True:
            self.step_started = time.monotonic()
            busy = self._tick() > 0
            self.step_started = None
            self.heartbeat = time.monotonic()
            with self._wake:
                if self._state == _STOPPING:
                    if not self._drain or self._idle():
                        return
                    if not busy:  # e.g. coalescing deadline not yet due
                        self._wake.wait(timeout=0.005)
                    continue  # draining: keep serving
                if busy:
                    continue  # hot: decode slots live or queue due
                # idle: sleep until the next deadline or a submit.  The
                # re-check under the lock closes the submit race (a
                # submit between _tick and here already notified while
                # holding this lock, so pending>0 is visible now).
                if sched.pending and sched.due() is not None:
                    continue
                nd = sched.next_deadline()
                timeout = (None if nd is None
                           else max(0.0, nd - sched.clock()))
                if timeout is None or timeout > 0:
                    self._wake.wait(timeout=timeout)

    # -- reporting -----------------------------------------------------------
    def stats_summary(self) -> Dict[str, object]:
        """JSON-ready snapshot: the engine's unified stats plus the
        per-SLO-class completion-latency stats."""
        return {
            "engine": self.engine.stats.summary(),
            "classes": {name: st.summary()
                        for name, st in self.class_stats.items()},
        }

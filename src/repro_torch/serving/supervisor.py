"""Process-level supervision above the serving daemon: detect, restart,
replay (twin of ``repro.serving.supervisor``).

The layers below contain per-request failures and run a wall-clock serve
loop, but an UNCONTAINED failure (the serve thread dying on an
engine-loop bug, a step that never returns) still loses every in-flight
request.  :class:`Supervisor` is that recovery layer: it OWNS the daemon
lifecycle instead of handing the daemon to the client.

* **Two-level handles.**  ``Supervisor.submit`` returns a CLIENT handle
  (a plain :class:`~.scheduler.Handle`, uid = the client-supplied request
  id) that is distinct from the per-ATTEMPT engine handle created by each
  ``daemon.submit``.  Contained outcomes (DONE, a ``NumericalError``, a
  deadline expiry) forward from the attempt to the client handle; an
  attempt killed by supervisor teardown (``HungStepError`` /
  ``EngineCrashError``) does NOT resolve the client handle -- the request
  is REPLAYED on the restarted daemon.  Streaming replays dedup: tokens
  the client handle already received are skipped, so the client stream
  stays exactly-once and in order.

* **Detection.**  A watchdog thread polls the daemon's supervision
  surface: ``daemon.crashed`` (the serve thread died) triggers an
  ``EngineCrashError`` teardown; ``daemon.step_started`` older than
  ``RestartPolicy.hang_threshold_s`` triggers a ``HungStepError``
  teardown.

* **Teardown on the card.**  ``daemon.abort()`` marks the daemon
  stopping, the live attempt handles fail with the teardown reason, and
  the injector's hangs are released.  Then, unlike the JAX package, the
  supervisor WAITS, at most ``RestartPolicy.hang_threshold_s``, for the
  abandoned serve thread to leave (:meth:`ServingDaemon.join`).  A
  released thread finishes the step it was in -- on the card a decode
  graph replay and a device-to-host read -- and a step longer than the
  hang threshold is itself a hang.  The next engine's factory warms up
  and captures CUDA graphs in torch's global capture mode, which any
  CUDA call from another thread invalidates.  Joining orders the two.
  Once the thread has left, the supervisor drops the torn-down daemon
  and collects it (``gc.collect()``) on the watchdog thread, so its KV
  cache, graph pool and ``CUDAGraph`` objects are freed before the
  factory runs and never on another thread during a capture; the card
  holds one engine at a time.  A thread still alive after the bound
  means the card may still run its work, so no engine is built beside
  it: the circuit opens (NOT_READY), and the request journal carries
  the requests to a new process.

* **Restart discipline.**  Exponential backoff with deterministic jitter
  (``random.Random(f"{seed}:{k}")``, the JAX package's schedule
  exactly), and a circuit breaker: more than ``max_restarts`` teardowns
  inside ``restart_window_s`` trips the supervisor NOT_READY
  (:class:`~.errors.CircuitOpenError` fails everything outstanding;
  ``ready()`` turns false for the load balancer to see).  The engine
  factory runs on the watchdog thread inside ``torch.cuda.device`` of the
  first engine's device (as the serve thread does), so a rebuilt engine
  lands on the card the first one used.  A factory that raises -- a
  failed graph capture among others -- opens the circuit with that error
  as the reason; nothing is rebuilt on the CPU or on the plain path.

* **Durability.**  With a :class:`~.journal.RequestJournal` every
  submit/terminal is journaled (write-ahead: the submit record lands
  BEFORE the engine sees the request), and ``start()`` replays the
  journal's non-terminal entries -- idempotently, deadline-aware
  (``deadline_unix`` is wall-clock; an entry already past its deadline
  resolves TIMED_OUT without re-running) -- so the reconciliation
  invariant extends across PROCESS restarts, not just daemon restarts.

* **Probes.**  ``health()`` is the JSON snapshot (queue depth, heartbeat
  age, restart count, journal lag); ``ready()`` is the load-balancer
  bit.  ``launch/daemon.py --health-file`` writes these to disk.

"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels import ops
from .batching import ServeStats
from .daemon import ServingDaemon
from .errors import (CancelledError, CircuitOpenError, EngineCrashError,
                     HungStepError, QueueFullError, RequestTimedOut)
from .journal import RequestJournal
from .scheduler import CANCELLED, DONE, Handle, TIMED_OUT
from .slo import DEFAULT_CLASSES

# supervisor states
_RUNNING, _NOT_READY, _STOPPED = "running", "not_ready", "stopped"


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Watchdog + restart knobs (the JAX package's).

    ``hang_threshold_s``: one engine step taking longer than this is a
    hang.  Must comfortably exceed the slowest legitimate step (a step
    that captures a CUDA graph included).  ``poll_interval_s``: watchdog
    cadence (None: hang_threshold/5, clamped to [10ms, 250ms]).  Backoff
    before restart k (0-based) is ``min(backoff_max_s, backoff_base_s *
    2**k)`` scaled by a DETERMINISTIC jitter in [1-jitter, 1+jitter]
    seeded by ``(seed, k)``.  More than ``max_restarts`` teardowns within
    ``restart_window_s`` trips the circuit breaker (NOT_READY).  A
    teardown also waits up to ``hang_threshold_s`` for the abandoned
    serve thread to exit (see the module docstring): a released thread
    finishes at most one step.
    """

    hang_threshold_s: float = 10.0
    poll_interval_s: Optional[float] = None
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    max_restarts: int = 5
    restart_window_s: float = 60.0
    seed: int = 0

    def __post_init__(self):
        if self.hang_threshold_s <= 0:
            raise ValueError("hang_threshold_s must be > 0")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.max_restarts < 1:
            raise ValueError("max_restarts must be >= 1")

    @property
    def interval(self) -> float:
        if self.poll_interval_s is not None:
            return self.poll_interval_s
        return min(0.25, max(0.01, self.hang_threshold_s / 5.0))

    def backoff(self, k: int) -> float:
        """Delay before restart ``k`` (0-based), jittered deterministically."""
        base = min(self.backoff_max_s, self.backoff_base_s * (2.0 ** k))
        u = random.Random(f"{self.seed}:{k}").uniform(-1.0, 1.0)
        return base * (1.0 + self.jitter * u)


@dataclasses.dataclass
class _Tracked:
    """One supervised request across its attempts."""

    rid: str
    payload: object
    slo: str
    kw: dict                      # engine submit kwargs (no deadline/on_token)
    handle: Handle                # the CLIENT handle (uid = rid)
    deadline_unix: Optional[float] = None
    stream: bool = False
    attempt: Optional[Handle] = None   # live engine-side handle
    attempt_tokens: int = 0            # tokens seen from the CURRENT attempt
    pushed: int = 0                    # tokens forwarded to the client
    attempts: int = 0
    from_journal: bool = False         # recovered by cold-start replay


class Supervisor:
    """Owns daemon lifecycle: watchdog, restart w/ backoff, journal replay
    (see module docstring).

    ``engine_factory``: zero-arg callable building a FRESH engine -- called
    once at :meth:`start` (on the caller's thread) and once per restart
    (on the watchdog thread, inside the first engine's CUDA device).  It
    should build from the parameters the first engine serves, not copy
    them: each build is a new KV cache and graph pool beside them.
    ``journal``: optional :class:`~.journal.RequestJournal`; the
    supervisor takes ownership (closed at :meth:`shutdown`).  Journaling
    requires JSON-serializable payloads -- token prompts; vision image
    payloads are served but not journaled.
    """

    def __init__(self, engine_factory: Callable[[], object],
                 classes=DEFAULT_CLASSES,
                 journal: Optional[RequestJournal] = None,
                 policy: RestartPolicy = RestartPolicy()):
        self._factory = engine_factory
        self._classes = classes
        self.journal = journal
        self.policy = policy
        self.stats = ServeStats()  # CLIENT-handle outcomes (one per request)
        self._lock = threading.RLock()
        self._state = _STOPPED
        self._daemon: Optional[ServingDaemon] = None
        self._device: Optional[torch.device] = None  # the first engine's
        self._restarting = False
        self._stop_evt = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self._tracked: Dict[str, _Tracked] = {}  # insertion-ordered
        self._auto_rid = 0
        self.restarts = 0
        self.replayed = 0                 # attempts resubmitted after teardown
        self.restart_log: List[dict] = []
        self.last_recovery_s: Optional[float] = None
        self._restart_times: List[float] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Supervisor":
        with self._lock:
            if self._state != _STOPPED:
                raise RuntimeError(f"supervisor already {self._state}")
            self._state = _RUNNING
        self._daemon = self._build_daemon()
        if self.journal is not None:
            self._recover_from_journal()
        self._watchdog = threading.Thread(
            target=self._watch, name="repro-supervisor", daemon=True)
        self._watchdog.start()
        return self

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    def _build_daemon(self) -> ServingDaemon:
        dev = self._device
        with (torch.cuda.device(dev) if dev is not None
              and dev.type == "cuda" else contextlib.nullcontext()):
            engine = self._factory()
        if self._device is None:
            self._device = engine.device
        return ServingDaemon(engine, classes=self._classes).start()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the watchdog, shut the daemon down (``drain`` as in
        ``ServingDaemon.shutdown``), cancel whatever never re-attached,
        and close the journal.  Every client handle resolves."""
        self._stop_evt.set()
        if self._watchdog is not None:
            self._watchdog.join()
            self._watchdog = None
        with self._lock:
            daemon = self._daemon
            self._state = _STOPPED
        if daemon is not None:
            started = daemon.step_started
            hung = (started is not None
                    and time.monotonic() - started
                    > self.policy.hang_threshold_s)
            if daemon.crashed is not None or hung:
                # crashed/hung between the last watchdog pass and now:
                # abort and fail the attempts
                self._teardown_daemon(daemon, EngineCrashError(
                    "daemon dead at supervisor shutdown")
                    if daemon.crashed is not None else HungStepError(
                        "daemon hung at supervisor shutdown"))
            else:
                daemon.shutdown(drain=drain, timeout=timeout)
        # anything still PENDING (parked during a restart, or teardown-
        # marked for a replay that will never come) cancels now
        for t in self._snapshot():
            if not t.handle.done():
                t.handle.set_exception(
                    CancelledError(
                        f"request {t.rid} cancelled: supervisor shutdown"),
                    state=CANCELLED)
        if self.journal is not None:
            self.journal.close()

    # -- submit --------------------------------------------------------------
    def submit(self, payload, slo: str = "interactive",
               request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               stream: bool = False,
               on_token: Optional[Callable[[int], None]] = None,
               **kw) -> Handle:
        """Submit under supervision; returns the CLIENT :class:`Handle`
        (uid = ``request_id``).  ``request_id`` keys the journal and makes
        resubmission idempotent: a duplicate id while the original is
        outstanding returns the SAME handle (auto-generated when omitted --
        but only client-supplied ids survive a process restart
        meaningfully).  ``kw`` forwards to the engine submit
        (``max_new_tokens=``, ``temperature=``...).  Host-only: a submit
        never touches the card.

        Never raises ``QueueFullError``: an attempt rejected by the SLO
        budget fails the returned handle instead (outcome ``shed``) so
        the supervised surface is uniform -- every submitted id reaches
        exactly one terminal state.  Raises ``CircuitOpenError`` when the
        breaker is open and ``RuntimeError`` when not started.
        """
        with self._lock:
            if self._state == _NOT_READY:
                self.stats.record_outcome("rejected")
                raise CircuitOpenError(
                    "supervisor NOT_READY: restart circuit breaker is open "
                    f"({self.restarts} restarts)")
            if self._state != _RUNNING:
                raise RuntimeError(
                    f"supervisor is {self._state}: submit() needs start()")
            if request_id is None:
                self._auto_rid += 1
                request_id = f"auto-{self._auto_rid:08d}"
            prior = self._tracked.get(request_id)
            if prior is not None and not prior.handle.done():
                return prior.handle  # idempotent resubmit
            deadline_unix = (None if deadline_ms is None
                             else time.time() + deadline_ms / 1000.0)
            t = _Tracked(
                rid=request_id, payload=payload, slo=slo, kw=dict(kw),
                deadline_unix=deadline_unix,
                stream=bool(stream) or on_token is not None,
                handle=Handle(uid=request_id, payload=payload,
                              submitted_at=time.monotonic(),
                              stats=self.stats, on_token=on_token))
            self._tracked[request_id] = t
            self.stats.submitted += 1
        t.handle.add_done_callback(
            lambda h, _t=t: self._on_client_done(_t, h))
        if self.journal is not None:
            self.journal.record_submit(
                t.rid, self._journal_payload(payload), slo=slo, kw=dict(kw),
                deadline_unix=deadline_unix)
        self._attach(t)
        return t.handle

    @staticmethod
    def _journal_payload(payload):
        arr = np.asarray(payload)
        if np.issubdtype(arr.dtype, np.integer) and arr.ndim == 1:
            return arr.tolist()
        return None  # non-journalable payload (vision images)

    def handles(self) -> Dict[str, Handle]:
        """rid -> client handle snapshot (all tracked, any state)."""
        with self._lock:
            return {t.rid: t.handle for t in self._tracked.values()}

    def _snapshot(self) -> List[_Tracked]:
        with self._lock:
            return list(self._tracked.values())

    # -- attempt wiring ------------------------------------------------------
    def _attach(self, t: _Tracked) -> None:
        """Submit one engine ATTEMPT for ``t`` on the current daemon (or
        leave it parked when the daemon is mid-restart -- the replay pass
        picks it up).  Never raises."""
        with self._lock:
            daemon = self._daemon
            if (self._state != _RUNNING or self._restarting
                    or daemon is None or not daemon.running):
                return  # parked: _replay_pending re-attaches after restart
        if t.handle.done():
            return
        kw = dict(t.kw)
        if t.deadline_unix is not None:
            remaining_ms = (t.deadline_unix - time.time()) * 1000.0
            if remaining_ms <= 0:
                t.handle.set_exception(
                    RequestTimedOut(
                        f"request {t.rid} expired before (re)submission: "
                        "deadline passed while the daemon was down"),
                    state=TIMED_OUT)
                return
            kw["deadline_ms"] = remaining_ms
        t.attempt_tokens = 0
        if t.stream and daemon._is_token:
            kw["on_token"] = lambda tok, _t=t: self._forward_token(_t, tok)
        try:
            out = daemon.submit(np.asarray(t.payload)
                                if daemon._is_token else t.payload,
                                slo=t.slo, **kw)
        except QueueFullError as e:
            t.handle.set_exception(e, count_as="shed")
            return
        except RuntimeError:
            return  # daemon stopped under us: parked, replayed after restart
        attempt = out.handle if hasattr(out, "handle") else out
        with self._lock:
            t.attempt = attempt
            t.attempts += 1
        attempt.add_done_callback(
            lambda h, _t=t: self._on_attempt_done(_t, h))

    def _forward_token(self, t: _Tracked, tok: int) -> None:
        """Streaming bridge with replay dedup: a restarted attempt
        re-decodes from the prompt, so its first ``pushed`` tokens are
        ones the client already has and are skipped.  They are the same
        tokens only where the replay decodes as the first attempt did --
        on the card a replay's prefill group can differ from the first
        attempt's, so ``streamed == result`` is a claim the chip run
        checks, not a given."""
        t.attempt_tokens += 1
        if t.attempt_tokens > t.pushed:
            if t.handle.push_token(tok):
                t.pushed += 1

    def _on_attempt_done(self, t: _Tracked, attempt: Handle) -> None:
        with self._lock:
            if t.attempt is attempt:
                t.attempt = None
        if t.handle.done():
            return  # client already resolved (cancelled / expired here)
        if attempt.state == DONE:
            t.handle.set_result(attempt.result())
            return
        exc = attempt.exception()
        if isinstance(exc, (HungStepError, EngineCrashError)):
            # teardown killed this attempt, not the request: leave the
            # client handle PENDING -- _replay_pending resubmits it on the
            # restarted daemon
            return
        t.handle.set_exception(exc, state=attempt.state)

    def _on_client_done(self, t: _Tracked, h: Handle) -> None:
        """Terminal bookkeeping for the CLIENT handle, whichever path
        resolved it: journal the terminal (idempotent -- exactly one per
        rid) and propagate a client-side cancel to the live attempt."""
        if self.journal is not None:
            exc = h.exception()
            self.journal.record_terminal(
                t.rid, h.state, error=None if exc is None else repr(exc))
        if h.state == CANCELLED:
            with self._lock:
                attempt = t.attempt
            if attempt is not None:
                attempt.cancel()

    # -- restart machinery ---------------------------------------------------
    def _watch(self) -> None:
        while not self._stop_evt.wait(self.policy.interval):
            with self._lock:
                if self._state != _RUNNING or self._restarting:
                    continue
                daemon = self._daemon
            if daemon is None:
                continue
            reason: Optional[Exception] = None
            if daemon.crashed is not None:
                reason = EngineCrashError(
                    "serve thread died on an uncontained exception: "
                    f"{daemon.crashed!r}")
            else:
                started = daemon.step_started
                if started is not None:
                    age = time.monotonic() - started
                    if age > self.policy.hang_threshold_s:
                        reason = HungStepError(
                            f"engine step in flight for {age:.2f}s > "
                            f"hang_threshold_s="
                            f"{self.policy.hang_threshold_s}")
            if reason is not None:
                daemon = None  # _restart frees it: hold no reference here
                self._restart(reason)

    def _teardown_daemon(self, daemon: ServingDaemon,
                         reason: Exception) -> bool:
        """Abort, fail the live ATTEMPT handles with the teardown reason
        (their bridges mark the client requests for replay), release
        injected hangs, then wait up to ``hang_threshold_s`` for the
        abandoned serve thread to exit.  Returns whether it did."""
        leftovers = daemon.abort()
        for h in leftovers:
            h.set_exception(type(reason)(str(reason)))
        injector = getattr(daemon.engine, "faults", None)
        if injector is not None and hasattr(injector, "release_hangs"):
            injector.release_hangs()
        return daemon.join(self.policy.hang_threshold_s)

    def _restart(self, reason: Exception) -> None:
        """One teardown -> backoff -> rebuild -> replay cycle (runs on the
        watchdog thread; submits arriving meanwhile park and are replayed
        with everything else)."""
        detected, detected_unix = time.monotonic(), time.time()
        with self._lock:
            self._restarting = True
            old = self._daemon
        exited = self._teardown_daemon(old, reason)
        teardown_s = time.monotonic() - detected
        if exited:
            # free the old engine here, before any capture: nothing else
            # may release its graphs and caches while the next one captures
            with self._lock:
                self._daemon = None
            del old
            gc.collect()
        kind = type(reason).__name__
        with self._lock:
            self.restarts += 1
            k = self.restarts - 1
            self._restart_times = [
                ts for ts in self._restart_times
                if detected - ts <= self.policy.restart_window_s]
            self._restart_times.append(detected)
            tripped = len(self._restart_times) > self.policy.max_restarts
            entry = {"reason": kind, "detail": str(reason),
                     "detected_unix": detected_unix, "restart": self.restarts,
                     "teardown_s": round(teardown_s, 4),
                     "serve_thread_exited": exited}
            self.restart_log.append(entry)
        if tripped:
            self._open_circuit(reason)
            return
        if not exited:
            self._open_circuit(RuntimeError(
                f"the torn-down serve thread did not exit within "
                f"hang_threshold_s={self.policy.hang_threshold_s}; no engine "
                f"is built beside it (after: {reason})"))
            return
        delay = self.policy.backoff(k)
        if self._stop_evt.wait(delay):
            with self._lock:
                self._restarting = False
            return  # shutting down: shutdown() resolves what remains
        t_build = time.monotonic()
        try:
            daemon = self._build_daemon()
        except Exception as e:  # noqa: BLE001 -- recorded, fails everything
            entry["factory_error"] = repr(e)
            self._open_circuit(e)
            return
        done = time.monotonic()
        recovery_s = done - detected
        with self._lock:
            self._daemon = daemon
            self._restarting = False
            self.last_recovery_s = recovery_s
            entry["backoff_s"] = round(delay, 4)
            entry["factory_s"] = round(done - t_build, 4)
            entry["recovery_s"] = round(recovery_s, 4)
        self._replay_pending()

    def _replay_pending(self) -> None:
        """Re-attach every tracked request whose client handle is still
        PENDING with no live attempt (teardown-failed or parked), in
        submit order.  Idempotent: attached requests are skipped."""
        for t in self._snapshot():
            with self._lock:
                live = t.attempt is not None
            if t.handle.done() or live:
                continue
            self.replayed += 1
            self._attach(t)

    def _open_circuit(self, reason: Exception) -> None:
        with self._lock:
            self._state = _NOT_READY
            self._restarting = False
        exc = CircuitOpenError(
            f"circuit breaker open after {self.restarts} restarts within "
            f"{self.policy.restart_window_s}s (last: {reason})")
        for t in self._snapshot():
            if not t.handle.done():
                t.handle.set_exception(CircuitOpenError(str(exc)))

    # -- cold-start replay ---------------------------------------------------
    def _recover_from_journal(self) -> None:
        """Adopt the journal's non-terminal entries from the PREVIOUS
        process: expired deadlines resolve TIMED_OUT without re-running;
        the rest resubmit through ``daemon.submit`` in original order."""
        for rec in self.journal.pending():
            rid = rec["rid"]
            with self._lock:
                if rid in self._tracked:
                    continue
                if rec.get("payload") is None:
                    continue  # non-journalable payload (vision): unrecoverable
                t = _Tracked(
                    rid=rid, payload=rec["payload"],
                    slo=rec.get("slo", "interactive"),
                    kw=dict(rec.get("kw") or {}),
                    deadline_unix=rec.get("deadline_unix"),
                    stream=bool((rec.get("kw") or {}).pop("stream", False)),
                    from_journal=True,
                    handle=Handle(uid=rid, payload=rec["payload"],
                                  submitted_at=time.monotonic(),
                                  stats=self.stats))
                t.kw.pop("stream", None)
                self._tracked[rid] = t
                self.stats.submitted += 1
            t.handle.add_done_callback(
                lambda h, _t=t: self._on_client_done(_t, h))
            self.replayed += 1
            self._attach(t)

    # -- probes --------------------------------------------------------------
    def ready(self) -> dict:
        """The load-balancer bit: serving and able to accept work."""
        with self._lock:
            if self._state == _NOT_READY:
                return {"ready": False, "reason": "circuit_open"}
            if self._state != _RUNNING:
                return {"ready": False, "reason": self._state}
            if self._restarting:
                return {"ready": False, "reason": "restarting"}
            daemon = self._daemon
        if daemon is None or not daemon.running:
            return {"ready": False, "reason": "daemon_down"}
        return {"ready": True, "reason": "serving"}

    def health(self) -> dict:
        """JSON-ready probe snapshot (written by ``launch/daemon.py
        --health-file``): the JAX package's keys, host reads only.

        ``trip_latches["axes"]`` is ``kernels.ops.trip_counts()``, as in
        the JAX package; in the port only an explicit caller trips an
        axis.  ``trip_latches["guard"]`` is absent, as it is in the JAX
        package for an engine without a ``fallback_guard``: the port has
        no ``FallbackGuard`` (ROADMAP A5, decided: a kernel that raises
        or goes non-finite fails its batch instead of retrying silently
        off the kernel)."""
        now = time.monotonic()
        with self._lock:
            daemon = self._daemon
            state = self._state
            outstanding = sum(1 for t in self._tracked.values()
                              if not t.handle.done())
        snap = {
            "state": state,
            "ready": self.ready(),
            "restarts": self.restarts,
            "last_recovery_s": self.last_recovery_s,
            "replayed": self.replayed,
            "supervised_outstanding": outstanding,
            "unix_time": time.time(),
            "trip_latches": {"axes": ops.trip_counts()},
            "stats": self.stats.summary(),
        }
        if daemon is not None:
            engine = daemon.engine
            hb = daemon.heartbeat
            started = daemon.step_started
            snap.update({
                "daemon_state": daemon._state,
                "queue_depth": engine.scheduler.pending,
                "daemon_outstanding": daemon.outstanding,
                "heartbeat_age_s": (None if hb is None
                                    else round(now - hb, 4)),
                "step_in_flight_s": (0.0 if started is None
                                     else round(now - started, 4)),
                "crashed": (None if daemon.crashed is None
                            else repr(daemon.crashed)),
            })
        if self.journal is not None:
            snap["journal"] = {"path": str(self.journal.path),
                               "fsync": self.journal.fsync,
                               "lag": self.journal.lag(),
                               **self.journal.reconcile()}
        return snap

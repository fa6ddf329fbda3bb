"""Deterministic fault injection for the serving stack (a copy of
``repro.serving.faults``: the same grammar, sites, kinds and env var).

Every fault-tolerance behavior in this package is tested by PROVOKED
faults, not by hoping for real ones: a :class:`FaultInjector` is handed to
the scheduler/engines (``faults=``) and fires on exactly the executor
calls a :class:`FaultSpec` names — raising, delaying, or NaN-poisoning
the Nth call at a site.

Spec grammar (one spec; join several with commas)::

    KIND@SITE:WHEN[:DELAY_MS]

    KIND   raise | delay | nan | hang | crash
    SITE   an executor call site, or * for any.  The built-in sites:
             prefill        token Engine prefill batches
             decode         token Engine decode steps
             vision         VisionEngine executed batches
             executor       Scheduler-level executor calls (vision path)
             vision.kernel  inside the JAX VisionEngine's FallbackGuard.
                            The port has no such guard (no silent retry
                            on the card, ROADMAP A5), so its VisionEngine
                            refuses an injector naming this site
    WHEN   N      fire on the Nth call at that site (1-based), or
           */K    fire on every Kth call (a fault *rate*)
    DELAY  milliseconds, for KIND=delay (default 25) and KIND=hang
           (max stall; default 30000 — the watchdog should fire first)

Examples::

    raise@prefill:2        second prefill batch raises InjectedFault
    nan@decode:3           3rd decode step NaN-poisons one live slot
    raise@decode:*/10      every 10th decode step raises (10% fault rate)
    delay@vision:1:50      first vision batch stalls 50ms (wall clock)

The ``REPRO_FAULT_SPEC`` env var (read by :func:`from_env`, which every
engine consults when no ``faults=`` is passed) injects the same specs into
an unmodified binary — the repro hook for chasing production failures.
With the env var unset and no injector passed, nothing in this module
runs on the hot path.

What each KIND means at engine level:

* ``raise`` — the executor call raises :class:`InjectedFault`; the
  engines' containment fails ONLY the requests that call was serving
  (the prefill group / the live decode slots / the vision batch) and the
  serving loop keeps running.
* ``delay`` — the call stalls (real ``time.sleep``); deadline and
  timeout machinery sees genuinely late work.
* ``nan`` — the call's outputs are NaN-poisoned.  At ``decode`` the
  engine poisons ONE live slot's cache rows (that single request fails
  with ``NumericalError``; its batchmates decode on).  At ``vision`` the
  first request's logits row is poisoned (same per-request containment).
  (The JAX package's ``*.kernel`` sites fire inside its FallbackGuard,
  which the port does not have.)

* ``hang`` — the call BLOCKS (the engine thread stalls inside its step)
  until the injector's :meth:`FaultInjector.release_hangs` fires or the
  spec's DELAY_MS elapses, whichever is first.  Nothing raises: from the
  outside the step is simply not finishing — exactly what the
  supervisor's hung-step watchdog (``serving.supervisor``) must detect
  by heartbeat age.
* ``crash`` — the call raises :class:`UncontainedCrash`, a
  ``BaseException`` subclass that sails THROUGH the engines'
  per-batch ``except Exception`` containment and kills the serving
  thread: the provoked analogue of an engine-loop bug or a dying
  runtime.  Only the process-level supervisor can recover from it.

  Detection boundary: the default numerics check watches the LOGITS.
  On a fully-quantized decode path, activation quantization can launder
  a cache NaN into finite garbage before it reaches the logits (the
  port's int8 quantizers send NaN to code 0), so ``nan@decode`` against a
  quantized engine delivers corrupt-but-finite tokens undetected BY
  DEFAULT.  Opting in to the pre-quantization check
  (``debug_numerics=True`` or ``REPRO_DEBUG_NUMERICS=1``) closes the
  gap: every decode step also scans the inexact cache leaves — the
  per-row f32 KV scales carry the NaN even when the int8 payload does
  not — at the cost of a full cache read per step.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

ENV_VAR = "REPRO_FAULT_SPEC"

_KINDS = ("raise", "delay", "nan", "hang", "crash")

# a hang with no explicit DELAY_MS stalls this long before giving up on
# its own — long enough that any sanely-configured watchdog fires first
_HANG_DEFAULT_MS = 30_000.0


class InjectedFault(RuntimeError):
    """A provoked executor failure (FaultSpec kind ``raise``)."""


class UncontainedCrash(BaseException):
    """A provoked UNCONTAINED failure (FaultSpec kind ``crash``).

    Deliberately a ``BaseException`` subclass: the engines contain
    per-batch failures with ``except Exception``, so this raises straight
    through ``Engine.step()`` / ``VisionEngine.poll()`` and kills the
    daemon's serve thread — the repro for an engine-loop bug, not a
    per-request failure.  Recovery is the supervisor's job.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: KIND at SITE on the Nth (or every Kth)
    call.  Build from the string grammar with :meth:`parse`."""

    kind: str             # "raise" | "delay" | "nan"
    site: str = "*"       # executor call site, "*" matches any
    nth: int = 1          # 1-based call index (ignored when every_k set)
    every_k: Optional[int] = None  # fire on every Kth call instead
    delay_ms: float = 25.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of "
                             f"{_KINDS}")
        if self.nth < 1 or (self.every_k is not None and self.every_k < 1):
            raise ValueError(f"fault call index must be >= 1: {self}")
        if self.delay_ms < 0:
            raise ValueError(f"delay_ms must be >= 0: {self}")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse one ``KIND@SITE:WHEN[:DELAY_MS]`` spec string.  Raises
        ``ValueError`` (naming the offending text) on any malformed spec —
        a typo in ``REPRO_FAULT_SPEC`` must fail loudly at startup, not
        silently inject nothing."""
        try:
            kind, rest = text.strip().split("@", 1)
            parts = rest.split(":")
            site = parts[0].strip()
            when = parts[1].strip() if len(parts) > 1 else "1"
            kw = {}
            if len(parts) > 2:
                kw["delay_ms"] = float(parts[2])
            elif kind.strip().lower() == "hang":
                kw["delay_ms"] = _HANG_DEFAULT_MS
            if when.startswith("*/"):
                kw["every_k"] = int(when[2:])
            else:
                kw["nth"] = int(when)
            if not site:
                raise ValueError("empty site")
            return cls(kind=kind.strip().lower(), site=site, **kw)
        except ValueError as e:
            raise ValueError(
                f"malformed fault spec {text!r} (grammar: "
                f"KIND@SITE:WHEN[:DELAY_MS], e.g. 'raise@decode:3' or "
                f"'nan@vision:*/5'): {e}") from None

    def matches(self, call_index: int) -> bool:
        if self.every_k is not None:
            return call_index % self.every_k == 0
        return call_index == self.nth


@dataclasses.dataclass
class FaultAction:
    """What the matched specs of ONE call ask for (see ``fire``)."""

    site: str
    call_index: int
    do_raise: bool = False
    do_crash: bool = False
    delay_ms: float = 0.0
    hang_ms: float = 0.0
    poison: bool = False  # caller applies the NaN-poisoning (site-shaped)
    # set by the injector: release_hangs() unblocks a hanging fire()
    _hang_release: Optional[threading.Event] = None

    def fire(self) -> None:
        """Hang (until released or ``hang_ms`` elapses), then delay, then
        raise :class:`UncontainedCrash` / :class:`InjectedFault` if the
        call is spec'd to fail.  Callers check ``.poison`` themselves
        (where the NaN lands is site-specific)."""
        if self.hang_ms > 0:
            if self._hang_release is not None:
                self._hang_release.wait(timeout=self.hang_ms / 1000.0)
            else:
                time.sleep(self.hang_ms / 1000.0)
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1000.0)
        if self.do_crash:
            raise UncontainedCrash(
                f"injected uncontained crash: call {self.call_index} at "
                f"site {self.site!r}")
        if self.do_raise:
            raise InjectedFault(
                f"injected fault: call {self.call_index} at site "
                f"{self.site!r}")


class FaultInjector:
    """Counts executor calls per site and fires the matching specs.

    Deterministic by construction: the Nth call at a site always faults,
    regardless of timing — so every containment test reproduces exactly.
    """

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs: List[FaultSpec] = list(specs)
        self.calls: Dict[str, int] = {}
        self.fired: List[tuple] = []  # (site, call_index, kind)
        # one shared release latch for every hang this injector fires: a
        # supervisor tearing down a hung engine sets it so the stuck
        # thread unblocks promptly instead of sleeping out its DELAY_MS
        self._hang_release = threading.Event()

    def release_hangs(self) -> None:
        """Unblock every in-flight (and future) ``hang`` fault from this
        injector — called by the supervisor after it has torn the hung
        daemon down, so the abandoned thread exits instead of squatting
        a core until the hang's DELAY_MS elapses."""
        self._hang_release.set()

    @classmethod
    def parse(cls, text: str) -> "FaultInjector":
        """Injector from a comma-joined spec string (see module doc)."""
        return cls([FaultSpec.parse(s) for s in text.split(",") if s.strip()])

    def on_call(self, site: str) -> Optional[FaultAction]:
        """Register one executor call at ``site``; returns the merged
        :class:`FaultAction` if any spec matches, else None."""
        n = self.calls.get(site, 0) + 1
        self.calls[site] = n
        act = None
        for spec in self.specs:
            if spec.site not in ("*", site) or not spec.matches(n):
                continue
            if act is None:
                act = FaultAction(site=site, call_index=n)
            if spec.kind == "raise":
                act.do_raise = True
            elif spec.kind == "delay":
                act.delay_ms = max(act.delay_ms, spec.delay_ms)
            elif spec.kind == "nan":
                act.poison = True
            elif spec.kind == "hang":
                act.hang_ms = max(act.hang_ms, spec.delay_ms)
                act._hang_release = self._hang_release
            elif spec.kind == "crash":
                act.do_crash = True
            self.fired.append((site, n, spec.kind))
        return act

    def summary(self) -> dict:
        """Injection accounting for bench rows / postmortems."""
        return {"specs": [dataclasses.asdict(s) for s in self.specs],
                "calls": dict(self.calls),
                "fired": [list(f) for f in self.fired]}


def from_env() -> Optional[FaultInjector]:
    """The process-default injector from ``REPRO_FAULT_SPEC`` (None when
    unset/empty).  Engines consult this when constructed without an
    explicit ``faults=`` — the zero-code-change repro hook."""
    text = os.environ.get(ENV_VAR, "").strip()
    if not text:
        return None
    return FaultInjector.parse(text)

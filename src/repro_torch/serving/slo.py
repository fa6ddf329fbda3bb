"""SLO classes: named service tiers mapped onto the scheduler's knobs
(a copy of ``repro.serving.slo``).

An :class:`SLOClass` bundles the per-tier serving contract — admission
priority, how long requests may coalesce before admission
(``max_delay_ms``), an optional default per-request completion deadline,
a per-class outstanding-request budget, and whether the tier's decodes
may be PREEMPTED for higher tiers.  The daemon
(:class:`~.daemon.ServingDaemon`) resolves a class name at
submit time into plain ``Engine.submit`` arguments, so the engines stay
SLO-agnostic: priority rides the scheduler's priority queue, deadlines
ride the existing per-request deadline machinery, and preemption rides
``Engine`` slot eviction + ``Scheduler.requeue``.

:class:`ClassFlushPolicy` is the admission half: a
:class:`~.scheduler.FlushPolicy` whose
``admission_deadline`` is per-PRIORITY instead of queue-global, so an
interactive request (delay 0) makes the queue due immediately while
batch traffic keeps coalescing toward bigger prefill groups.  Because
``Scheduler.due`` and ``Scheduler.next_deadline`` share this one method,
the daemon's sleep-until-deadline loop stays exact under mixed tiers.

The two default tiers:

* ``interactive`` — priority 10, zero admission delay, preemption
  EXEMPT: latency-bound traffic that jumps the queue and keeps its slot.
* ``batch`` — priority 0, 25 ms admission coalescing, PREEMPTIBLE:
  throughput-bound traffic that yields slots to interactive arrivals
  (restart-from-prefix; see ``Engine._preempt_slot``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from .scheduler import FlushPolicy


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service tier's contract (see module docstring).

    ``priority``: higher admits first (the scheduler's priority queue).
    ``max_delay_ms``: admission coalescing budget for this tier (0.0 =
    admit as soon as a slot frees).  ``deadline_ms``: default per-request
    completion deadline applied by the daemon when the submit does not
    carry its own (None: no deadline).  ``max_queued``: daemon-level
    budget on OUTSTANDING (unresolved) requests of this class — submits
    beyond it are rejected with ``QueueFullError`` (None: unbounded).
    ``preemptible``: this tier's in-flight decodes may be evicted
    (restart-from-prefix) when a strictly-higher-priority request is due
    and no slot is free.
    """

    name: str
    priority: int = 0
    max_delay_ms: float = 0.0
    deadline_ms: Optional[float] = None
    max_queued: Optional[int] = None
    preemptible: bool = False

    def __post_init__(self):
        if self.max_delay_ms < 0:
            raise ValueError(
                f"SLO class {self.name!r}: max_delay_ms must be >= 0, got "
                f"{self.max_delay_ms}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"SLO class {self.name!r}: deadline_ms must be > 0 or "
                f"None, got {self.deadline_ms}")
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError(
                f"SLO class {self.name!r}: max_queued must be >= 1 or "
                f"None, got {self.max_queued}")


INTERACTIVE = SLOClass(name="interactive", priority=10, max_delay_ms=0.0)
BATCH = SLOClass(name="batch", priority=0, max_delay_ms=25.0,
                 preemptible=True)
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (INTERACTIVE, BATCH)


def classes_by_name(
        classes: Sequence[SLOClass]) -> Dict[str, SLOClass]:
    """Name -> class map; raises ``ValueError`` on duplicate names (two
    tiers silently shadowing each other is a config bug)."""
    out: Dict[str, SLOClass] = {}
    for c in classes:
        if c.name in out:
            raise ValueError(f"duplicate SLO class name {c.name!r}")
        out[c.name] = c
    return out


@dataclasses.dataclass(frozen=True)
class ClassFlushPolicy(FlushPolicy):
    """Per-priority admission delays over the shared scheduler queue.

    ``delay_ms_by_priority`` maps priority -> that tier's coalescing
    delay; priorities not listed fall back to the base
    ``max_delay_ms``.  ``admission_deadline`` is the min over EVERY
    waiting request's own per-tier deadline, so one zero-delay
    interactive arrival makes the queue due now without collapsing the
    batch tier's coalescing window when it is alone.
    """

    delay_ms_by_priority: Tuple[Tuple[int, float], ...] = ()

    def __post_init__(self):
        super().__post_init__()
        for p, d in self.delay_ms_by_priority:
            if d < 0:
                raise ValueError(
                    f"delay for priority {p} must be >= 0, got {d}")

    @classmethod
    def from_classes(cls, classes: Sequence[SLOClass],
                     max_batch: int = 64) -> "ClassFlushPolicy":
        """Build the policy from SLO classes: each class's priority gets
        its ``max_delay_ms``; unknown priorities admit immediately
        (delay 0 — fail toward latency, not starvation)."""
        return cls(
            max_batch=max_batch, max_delay_ms=0.0,
            delay_ms_by_priority=tuple(
                (c.priority, c.max_delay_ms) for c in classes))

    def delay_ms_for(self, priority: int) -> Optional[float]:
        for p, d in self.delay_ms_by_priority:
            if p == priority:
                return d
        return self.max_delay_ms

    def admission_deadline(self, queue) -> Optional[float]:
        cands = []
        for h in queue:
            d = self.delay_ms_for(h.priority)
            if d is None:
                continue
            cands.append(h.submitted_at + d / 1000.0)
        return min(cands) if cands else None

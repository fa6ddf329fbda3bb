"""Shared batching math + unified serving statistics (twin of
``repro.serving.batching``).

Executed batch shapes are rounded up to a power of two, so the number of
distinct shapes the kernels see is O(log2 max_batch) whatever the
traffic.  :class:`ServeStats` defines queue-latency percentiles, batch
occupancy, the padded-work fraction and the outcome counters once.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set


def pow2_bucket(n: int, min_bucket: int = 1,
                cap: Optional[int] = None) -> int:
    """Smallest power-of-two multiple of ``min_bucket`` >= ``n`` (the
    floor should itself be a power of two), bounded by ``cap`` (the
    largest shape the engine executes: ``max_batch``, or ``max_len`` for
    prefill lengths).  Raises ``ValueError`` for a negative count."""
    if n < 0:
        raise ValueError(f"bucket size for negative count {n}")
    b = max(1, min_bucket)
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _percentile(sorted_vals: List[float], pct: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(pct / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


@dataclasses.dataclass
class ServeStats:
    """Unified serving counters (one definition for both engines).

    * ``queue_ms`` — per-request time from ``submit()`` to the flush that
      started executing it (recorded by the scheduler, measured on the
      scheduler's clock so tests/benchmarks can drive virtual time).
    * occupancy — real items per executed batch relative to the policy's
      ``max_batch`` (``capacity_items`` accumulates per-batch capacity).
    * padded-work fraction — pad rows (pow2 bucketing) or pad tokens
      (ragged prefill) as a share of everything actually executed.
    * outcome counters — every submitted handle resolves into exactly one
      of ``completed`` / ``failed`` / ``cancelled`` / ``timed_out`` /
      ``shed`` (recorded by the Handle state machine), so
      ``submitted == resolved`` reconciles once traffic drains.
      ``rejected`` counts submits the OverloadPolicy refused — those
      never created a handle and are NOT part of ``submitted``.

    Thread-safety: the ``record_*`` mutators serialize on an internal
    lock, because a submitter thread and the engine thread may resolve
    outcomes concurrently and the read-add-set increments would otherwise
    lose counts.  Reads (properties, ``summary()``) are lock-free
    snapshots.
    """

    submitted: int = 0
    items: int = 0            # real items executed through batches
    batches: int = 0
    padded_items: int = 0     # pad rows/tokens added (wasted compute)
    capacity_items: int = 0   # sum of per-batch capacity (policy max_batch)
    # terminal-outcome counters (see Handle state machine)
    completed: int = 0        # handles resolved DONE
    failed: int = 0           # executor/numerical failures -> FAILED
    cancelled: int = 0        # caller cancel() -> CANCELLED
    timed_out: int = 0        # per-request deadline expiry -> TIMED_OUT
    shed: int = 0             # load shedding (FAILED w/ QueueFullError)
    rejected: int = 0         # submits refused up front (no handle made)
    queue_ms: List[float] = dataclasses.field(default_factory=list)
    flush_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    buckets_used: Set[int] = dataclasses.field(default_factory=set)

    _OUTCOMES = ("completed", "failed", "cancelled", "timed_out", "shed",
                 "rejected")

    def __post_init__(self):
        self._lock = threading.Lock()  # not a field: asdict() skips it

    # -- recording -----------------------------------------------------------
    def record_batch(self, items: int, padded: int = 0,
                     capacity: Optional[int] = None,
                     bucket: Optional[int] = None) -> None:
        with self._lock:
            self.items += items
            self.batches += 1
            self.padded_items += padded
            self.capacity_items += capacity if capacity else items + padded
            if bucket:
                self.buckets_used.add(bucket)

    def record_flush(self, reason: str) -> None:
        with self._lock:
            self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1

    def record_outcome(self, kind: str) -> None:
        """Count one terminal request outcome (called by the Handle state
        machine exactly once per handle).  Raises ``ValueError`` for a
        kind outside the outcome-counter set."""
        if kind not in self._OUTCOMES:
            raise ValueError(f"unknown outcome {kind!r}; one of "
                             f"{self._OUTCOMES}")
        with self._lock:
            setattr(self, kind, getattr(self, kind) + 1)

    # long-lived engines must not leak: latency samples keep a sliding
    # window (percentiles reflect recent traffic, memory stays bounded)
    _MAX_LATENCY_SAMPLES = 16384

    def record_latency(self, ms: float) -> None:
        with self._lock:
            self.queue_ms.append(ms)
            if len(self.queue_ms) > self._MAX_LATENCY_SAMPLES:
                del self.queue_ms[: self._MAX_LATENCY_SAMPLES // 2]

    def reset(self) -> None:
        """Zero every counter in place, under the lock (between a warm-up
        and timed traffic: the scheduler keeps its reference, so the stats
        reset without rebinding; the lock is not a field and stays)."""
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name,
                        f.default_factory()
                        if f.default is dataclasses.MISSING
                        else f.default)

    # -- derived metrics -----------------------------------------------------
    def latency_ms(self, pct: float) -> float:
        return _percentile(sorted(self.queue_ms), pct)

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50.0)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99.0)

    @property
    def batch_occupancy(self) -> float:
        return self.items / self.capacity_items if self.capacity_items else 0.0

    @property
    def padded_fraction(self) -> float:
        total = self.items + self.padded_items
        return self.padded_items / total if total else 0.0

    @property
    def resolved(self) -> int:
        """Handles that reached a terminal state; equals ``submitted``
        once all traffic has drained (the reconciliation invariant)."""
        return (self.completed + self.failed + self.cancelled
                + self.timed_out + self.shed)

    def summary(self) -> Dict[str, object]:
        """JSON-ready snapshot (serving_bench rows, CLI reporting)."""
        return {
            "submitted": self.submitted,
            "items": self.items,
            "batches": self.batches,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "timed_out": self.timed_out,
            "shed": self.shed,
            "rejected": self.rejected,
            "p50_ms": round(self.p50_ms, 4),
            "p99_ms": round(self.p99_ms, 4),
            "batch_occupancy": round(self.batch_occupancy, 4),
            "padded_fraction": round(self.padded_fraction, 4),
            "flush_reasons": dict(self.flush_reasons),
            "buckets_used": sorted(self.buckets_used),
        }

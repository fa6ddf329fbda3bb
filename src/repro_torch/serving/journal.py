"""Append-only write-ahead request journal: replay-on-restart durability
(a copy of ``repro.serving.journal``: the same records, policies and
on-disk bytes, so a journal either package writes replays in the other).

The daemon/engine layer guarantees every submitted handle resolves *while
the process lives*; this module is the durability layer above it.  Each
supervised request is journaled as two JSONL events keyed by its
CLIENT-SUPPLIED request id:

    {"e": "submit",   "rid": ..., "t": <unix>, "slo": ..., "payload": [...],
     "kw": {...}, "deadline_unix": <unix>|null}
    {"e": "terminal", "rid": ..., "t": <unix>, "state": "DONE"|...,
     "error": null|"..."}

A restart scans the journal: rids with a ``submit`` but no ``terminal``
are the requests the dead process lost mid-flight, and the supervisor
REPLAYS them idempotently through ``daemon.submit`` — deadline-aware
(``deadline_unix`` is absolute WALL-clock time, because a monotonic clock
does not survive a process restart): an entry whose deadline already
passed resolves ``TIMED_OUT`` without re-running.  The
reconciliation invariant thereby extends across restarts — journaled
submits == journaled terminals, exactly, once replay drains.

Durability knobs:

* ``fsync=`` policy — ``"always"`` (fsync every append: a crash loses at
  most the event being written), ``"batch"`` (flush to the OS on every
  append, fsync only at :meth:`rotate`/:meth:`close`; :meth:`lag` counts
  the events a power loss could lose), or ``"never"`` (benchmarks).
* Torn tails are expected, not fatal: a crash mid-append leaves a
  partial last line; on open it is truncated away (counted in
  ``torn_records``) so appends never concatenate onto garbage.
* :meth:`rotate` compacts atomically: live (non-terminal) submits are
  rewritten to a tmp file, fsync'd, then ``os.replace``d over the
  journal — a crash mid-rotate leaves either the old file or the new
  one, never a half-written hybrid.

Payloads must be JSON-serializable (the supervisor journals token
prompts as plain int lists); callbacks (``on_token``) are deliberately
NOT journaled — a callback cannot survive a process restart, but the
replayed handle still accumulates the streamed tokens.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional

_FSYNC_POLICIES = ("always", "batch", "never")


class RequestJournal:
    """One append-only JSONL journal (see module docstring).

    Opening an existing path RESUMES it: prior records are scanned (torn
    tail truncated), so :meth:`pending` immediately reflects what the
    previous process left unfinished.  All methods are thread-safe; the
    daemon's submit path and its done-callbacks append concurrently.
    """

    def __init__(self, path, fsync: str = "always"):
        if fsync not in _FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r}; one of {_FSYNC_POLICIES}")
        self.path = Path(path)
        self.fsync = fsync
        self.torn_records = 0
        self._lock = threading.Lock()
        # rid -> submit record, insertion-ordered (dict preserves order):
        # replay happens in original submit order
        self._submits: Dict[str, dict] = {}
        self._terminal: Dict[str, dict] = {}
        self._since_sync = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._recover_tail()
        self._scan()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- recovery ------------------------------------------------------------
    def _recover_tail(self) -> None:
        """Truncate a torn (crash-mid-append) final line so the next
        append starts on a record boundary."""
        if not self.path.exists():
            return
        with open(self.path, "r+b") as f:
            data = f.read()
            if not data or data.endswith(b"\n"):
                return
            keep = data.rfind(b"\n") + 1  # 0 when no complete line at all
            f.truncate(keep)
            self.torn_records += 1
            warnings.warn(
                f"journal {self.path}: truncated a torn tail record "
                f"({len(data) - keep} bytes) — crash mid-append",
                RuntimeWarning, stacklevel=3)

    def _scan(self) -> None:
        if not self.path.exists():
            return
        for i, line in enumerate(
                self.path.read_text(encoding="utf-8").splitlines(), 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                ev, rid = rec["e"], rec["rid"]
            except (json.JSONDecodeError, KeyError, TypeError):
                self.torn_records += 1
                warnings.warn(
                    f"journal {self.path}: skipping corrupt record at "
                    f"line {i}", RuntimeWarning, stacklevel=3)
                continue
            if ev == "submit":
                self._submits[rid] = rec
                # a resubmitted rid after a prior terminal is a NEW
                # lifecycle for that id (rotation would have dropped the
                # old pair anyway)
                self._terminal.pop(rid, None)
            elif ev == "terminal":
                self._terminal[rid] = rec

    # -- appends -------------------------------------------------------------
    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        if self.fsync == "always":
            os.fsync(self._f.fileno())
            self._since_sync = 0
        else:
            self._since_sync += 1

    def record_submit(self, rid: str, payload, slo: str = "interactive",
                      kw: Optional[dict] = None,
                      deadline_unix: Optional[float] = None) -> bool:
        """Journal one submit.  Returns False (no duplicate record) when
        ``rid`` is already journaled and still non-terminal — the
        idempotency that makes replay-then-resubmit safe."""
        with self._lock:
            if rid in self._submits and rid not in self._terminal:
                return False
            rec = {"e": "submit", "rid": rid, "t": time.time(), "slo": slo,
                   "payload": payload, "kw": dict(kw or {}),
                   "deadline_unix": deadline_unix}
            self._append(rec)
            self._submits[rid] = rec
            self._terminal.pop(rid, None)
            return True

    def record_terminal(self, rid: str, state: str,
                        error: Optional[str] = None) -> bool:
        """Journal one terminal transition.  Returns False when ``rid``
        is already terminal (exactly-one-terminal idempotency) or was
        never submitted here."""
        with self._lock:
            if rid not in self._submits or rid in self._terminal:
                return False
            rec = {"e": "terminal", "rid": rid, "t": time.time(),
                   "state": state, "error": error}
            self._append(rec)
            self._terminal[rid] = rec
            return True

    # -- queries -------------------------------------------------------------
    def pending(self) -> List[dict]:
        """Submit records with no terminal yet, in submit order — the
        replay worklist after a restart."""
        with self._lock:
            return [dict(rec) for rid, rec in self._submits.items()
                    if rid not in self._terminal]

    def terminal_state(self, rid: str) -> Optional[str]:
        with self._lock:
            rec = self._terminal.get(rid)
            return None if rec is None else rec["state"]

    def lag(self) -> int:
        """Events appended since the last fsync — what a power loss could
        lose under the ``batch``/``never`` policies (always 0 under
        ``always``).  A health-probe field."""
        with self._lock:
            return self._since_sync

    def reconcile(self) -> dict:
        """The cross-restart invariant snapshot: ``submitted ==
        terminals + pending`` by construction; recovery is proven when
        ``pending == 0`` (every journaled submit has exactly one
        journaled terminal — terminal dedup is enforced at append)."""
        with self._lock:
            n_sub = len(self._submits)
            n_term = sum(1 for r in self._submits if r in self._terminal)
            return {"submitted": n_sub, "terminal": n_term,
                    "pending": n_sub - n_term, "exact": n_sub == n_term,
                    "torn_records": self.torn_records}

    # -- maintenance ---------------------------------------------------------
    def rotate(self) -> int:
        """Atomic compaction: rewrite the journal keeping only the
        non-terminal submit records (terminated pairs are history, not
        recovery state).  Returns the number of records dropped."""
        with self._lock:
            live = [rec for rid, rec in self._submits.items()
                    if rid not in self._terminal]
            dropped = (len(self._submits) - len(live)
                       + len(self._terminal))
            tmp = self.path.with_suffix(self.path.suffix + ".rotate-tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in live:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            self._submits = {rec["rid"]: rec for rec in live}
            self._terminal = {}
            self._since_sync = 0
            return dropped

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._f.flush()
            if self.fsync != "never":
                os.fsync(self._f.fileno())
            self._since_sync = 0
            self._f.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

"""qlint baseline: the committed known-violation ledger and its diff
(twin of ``repro.analysis.baseline``: the same JSON layout, canonical
form and diff lines).

The sweep's job is to catch REGRESSIONS, not to force every by-design
deviation to zero: those land in ``results/qlint_baseline_torch.json``
once, reviewed (``docs/qlint_torch.md`` gives each entry's reason); the
CLI then exits nonzero only on violations NOT in the baseline (new
(trace, rule, path) keys, or a count increase on an existing key).

The ledger keys on (trace, rule, path) with a count.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List

from .rules import Violation

SCHEMA_VERSION = 1

Ledger = Dict[str, Dict[str, Dict[str, int]]]  # trace -> rule -> path -> n


def to_ledger(violations: Iterable[Violation]) -> Ledger:
    led: Ledger = {}
    for v in violations:
        led.setdefault(v.trace, {}).setdefault(v.rule, {})
        led[v.trace][v.rule][v.path] = led[v.trace][v.rule].get(v.path, 0) + 1
    return led


def diff(current: Ledger, baseline: Ledger) -> List[str]:
    """Human-readable regressions: keys/counts in ``current`` beyond
    ``baseline``.  Violations that DISAPPEARED are not regressions (run
    ``--update-baseline`` to ratchet them out)."""
    out = []
    for trace in sorted(current):
        for rule in sorted(current[trace]):
            for path, n in sorted(current[trace][rule].items()):
                base = baseline.get(trace, {}).get(rule, {}).get(path)
                if base is None:
                    out.append(f"NEW  {trace} :: {rule} :: {path or '<module>'}"
                               f" (x{n})")
                elif n > base:
                    out.append(f"GREW {trace} :: {rule} :: {path or '<module>'}"
                               f" ({base} -> {n})")
    return out


def improvements(current: Ledger, baseline: Ledger) -> List[str]:
    """Baseline entries no longer observed -- candidates for ratcheting."""
    out = []
    for trace in sorted(baseline):
        for rule in sorted(baseline[trace]):
            for path, n in sorted(baseline[trace][rule].items()):
                cur = current.get(trace, {}).get(rule, {}).get(path, 0)
                if cur < n:
                    out.append(f"GONE {trace} :: {rule} :: "
                               f"{path or '<module>'} ({n} -> {cur})")
    return out


def load(path) -> Ledger:
    data = json.loads(Path(path).read_text())
    if data.get("version") != SCHEMA_VERSION:
        raise ValueError(
            f"qlint baseline {path} has schema version "
            f"{data.get('version')!r}, this tool writes {SCHEMA_VERSION}")
    return data["violations"]


def save(path, ledger: Ledger) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"version": SCHEMA_VERSION, "violations": ledger},
        indent=2, sort_keys=True) + "\n")

"""The port's request journal (``repro_torch.serving.journal``): the JAX
package's journal tests on the port, then the two packages against each
other -- the same operations write the same bytes, and a journal written
by either (a torn tail included) reads, reconciles and rotates the same
in the other."""
import json
import shutil
import time

import pytest

from repro.serving import journal as jjournal
from repro_torch.serving import journal as tjournal
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.scheduler import DONE, TIMED_OUT

PACKAGES = {"jax": jjournal, "torch": tjournal}


def test_journal_submit_terminal_pending_reconcile(tmp_path):
    j = RequestJournal(tmp_path / "j.jsonl")
    assert j.record_submit("a", [1, 2], slo="interactive",
                           kw={"max_new_tokens": 4})
    assert j.record_submit("b", [3])
    # duplicate while outstanding: idempotent no-op
    assert not j.record_submit("a", [1, 2])
    assert [r["rid"] for r in j.pending()] == ["a", "b"]
    assert j.reconcile() == {"submitted": 2, "terminal": 0, "pending": 2,
                             "exact": False, "torn_records": 0}
    assert j.record_terminal("a", DONE)
    assert not j.record_terminal("a", "FAILED")   # exactly one terminal
    assert not j.record_terminal("ghost", DONE)   # never submitted
    assert j.terminal_state("a") == DONE
    assert j.terminal_state("b") is None
    assert [r["rid"] for r in j.pending()] == ["b"]
    j.record_terminal("b", TIMED_OUT, error="deadline")
    rec = j.reconcile()
    assert rec["exact"] and rec["pending"] == 0
    j.close()
    # reopen resumes the same state from disk
    j2 = RequestJournal(tmp_path / "j.jsonl")
    assert j2.reconcile()["exact"] and not j2.pending()
    assert j2.terminal_state("b") == TIMED_OUT
    j2.close()


def test_journal_truncates_torn_tail(tmp_path):
    p = tmp_path / "j.jsonl"
    with RequestJournal(p) as j:
        j.record_submit("a", [1])
        j.record_submit("b", [2])
    with open(p, "a") as f:  # crash mid-append: no trailing newline
        f.write('{"e": "terminal", "rid": "a", "st')
    with pytest.warns(RuntimeWarning, match="torn tail"):
        j2 = RequestJournal(p)
    assert j2.torn_records == 1
    # the torn terminal never happened: both rids still pending, and the
    # next append starts on a clean record boundary
    assert [r["rid"] for r in j2.pending()] == ["a", "b"]
    j2.record_terminal("a", DONE)
    j2.close()
    lines = p.read_text().splitlines()
    assert all(json.loads(ln)["rid"] in ("a", "b") for ln in lines)


def test_journal_rotate_drops_terminals_keeps_live(tmp_path):
    p = tmp_path / "j.jsonl"
    j = RequestJournal(p)
    for i in range(4):
        j.record_submit(f"r{i}", [i])
    j.record_terminal("r0", DONE)
    j.record_terminal("r2", "FAILED", error="boom")
    dropped = j.rotate()
    assert dropped == 4  # 2 terminated submits + their 2 terminal events
    assert [r["rid"] for r in j.pending()] == ["r1", "r3"]
    # still appendable after rotation, and the on-disk file is compacted
    j.record_terminal("r1", DONE)
    j.close()
    rids = [json.loads(ln)["rid"] for ln in p.read_text().splitlines()]
    assert rids == ["r1", "r3", "r1"]
    j2 = RequestJournal(p)
    assert [r["rid"] for r in j2.pending()] == ["r3"]
    j2.close()


def test_journal_fsync_policies_and_lag(tmp_path):
    with pytest.raises(ValueError, match="fsync policy"):
        RequestJournal(tmp_path / "x.jsonl", fsync="sometimes")
    j = RequestJournal(tmp_path / "b.jsonl", fsync="batch")
    j.record_submit("a", [1])
    j.record_submit("b", [2])
    assert j.lag() == 2  # appended, flushed, not yet fsync'd
    j.rotate()
    assert j.lag() == 0
    j.close()
    ja = RequestJournal(tmp_path / "a.jsonl", fsync="always")
    ja.record_submit("a", [1])
    assert ja.lag() == 0
    ja.close()


def test_journal_resubmit_after_terminal_is_new_lifecycle(tmp_path):
    p = tmp_path / "j.jsonl"
    j = RequestJournal(p)
    j.record_submit("a", [1])
    j.record_terminal("a", "FAILED", error="transient")
    assert j.record_submit("a", [1])  # terminal rid: resubmission allowed
    assert [r["rid"] for r in j.pending()] == ["a"]
    j.close()
    j2 = RequestJournal(p)  # the scan agrees with the live view
    assert [r["rid"] for r in j2.pending()] == ["a"]
    j2.close()


# -- the two packages against each other -------------------------------------


def _script(mod, path):
    """One journal life: submits (with kwargs, a deadline, a resubmitted
    rid), terminals, a rotation, more appends, then a torn tail."""
    with mod.RequestJournal(path, fsync="batch") as j:
        for i in range(5):
            j.record_submit(f"r{i}", list(range(i + 1)), slo="batch",
                            kw={"max_new_tokens": 3 + i},
                            deadline_unix=None if i % 2 else 1.5e9 + i)
        j.record_terminal("r0", DONE)
        j.record_terminal("r3", "FAILED", error="InjectedFault('x')")
        j.rotate()
        j.record_submit("r3", [9, 9])
        j.record_terminal("r1", TIMED_OUT, error="deadline")
        j.record_submit("late", [7])
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"e": "terminal", "rid": "r2", "sta')


def test_same_operations_write_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = tmp_path / f"{name}.jsonl"
        _script(mod, paths[name])
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()


def _read(mod, path):
    """What one package makes of a journal file: pending, reconcile,
    terminal states, then rotate's count and the compacted bytes."""
    with pytest.warns(RuntimeWarning, match="torn tail"):
        j = mod.RequestJournal(path)
    out = dict(pending=j.pending(), reconcile=j.reconcile(),
               states={r: j.terminal_state(r)
                       for r in ("r0", "r1", "r2", "r3", "r4", "late")},
               lag=j.lag())
    out["dropped"] = j.rotate()
    out["after_rotate"] = j.pending()
    j.close()
    out["bytes"] = path.read_bytes()
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_journal_replays_the_same_in_either_package(tmp_path, writer):
    src = tmp_path / "written.jsonl"
    _script(PACKAGES[writer], src)
    reads = {}
    for name, mod in PACKAGES.items():
        copy = tmp_path / f"read_by_{name}.jsonl"
        shutil.copy(src, copy)
        reads[name] = _read(mod, copy)
    assert reads["torch"] == reads["jax"]
    r = reads["torch"]
    assert [x["rid"] for x in r["pending"]] == ["r2", "r4", "r3", "late"]
    assert r["reconcile"] == {"submitted": 5, "terminal": 1, "pending": 4,
                              "exact": False, "torn_records": 1}
    assert r["states"]["r1"] == TIMED_OUT and r["states"]["r2"] is None

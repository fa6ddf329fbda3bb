"""Supervised serving in the port: the crash/hang fault kinds, the
daemon's crash surface, the ``Supervisor``'s detect -> teardown ->
backoff -> restart -> replay cycle, the circuit breaker, cold-start and
process-kill journal replay, and the daemon CLI's ``--recovery-smoke`` /
``--health-file``.

The JAX package's ``tests/test_supervisor.py`` on the port (reduced qwen,
f32 cache, the CPU), then the port against the JAX package: backoff
schedules, outcomes and DONE tokens under one ``crash@decode`` script
(each package's also equal to its own fault-free reference), and the
``health()`` keys.  Then what the port adds: the teardown waits for the
released serve thread and frees the torn-down engine before the next one
is built, a thread that does not leave or a factory that raises opens
the circuit, the replay agreement check, and chip_smoke's phase 9
rehearsed at reduced width.

Factories warm every shape the workload drives before arming their
injector (``eng.faults = ...``), as the JAX tests do.  Every wait has a
timeout, so a hang fails one test."""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

from repro.serving import supervisor as jsup
from repro_torch.configs.registry import REDUCED
from repro_torch.kernels import ops
from repro_torch.launch import daemon as launch_daemon
from repro_torch.models import dense_lm
from repro_torch.serving import supervisor as tsup
from repro_torch.serving.daemon import ServingDaemon
from repro_torch.serving.engine import Engine
from repro_torch.serving.errors import CircuitOpenError, EngineCrashError
from repro_torch.serving.faults import (FaultAction, FaultInjector,
                                        FaultSpec, InjectedFault,
                                        UncontainedCrash)
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.scheduler import DONE, TIMED_OUT
from repro_torch.serving.supervisor import RestartPolicy, Supervisor
from torch_parity import reduced_lm_params

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (phase 9's cases and checks)

WAIT = 60.0  # seconds: every wait below is bounded


@pytest.fixture(scope="module")
def lm():
    cfg = REDUCED["qwen1.5-0.5b"]
    return cfg, dense_lm.init(cfg, seed=0, device="cpu")


def _engine(lm, **kw):
    cfg, params = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    return Engine(cfg, params, **kw)


def _prompts(n, start_len=4):
    return [np.arange(1, start_len + 1 + i, dtype=np.int32)
            for i in range(n)]


def _warmed_factory(lm, prompts, max_new, arm=None, builds=None,
                    arm_every=False, on_build=None):
    """Factory building engines pre-warmed on the workload's shapes;
    ``arm`` (a fault-spec string) is attached AFTER warmup, to the first
    build only unless ``arm_every``.  ``builds`` counts the builds (a
    list of build indices: no engine is kept)."""
    builds = builds if builds is not None else []

    def factory():
        if on_build is not None:
            on_build(len(builds))
        eng = _engine(lm)
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        if arm is not None and (arm_every or not builds):
            eng.faults = FaultInjector([FaultSpec.parse(arm)])
        builds.append(len(builds))
        return eng

    return factory


def _reference(lm, prompts, max_new):
    eng = _engine(lm)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [r.handle.result() for r in reqs]


_FAST = RestartPolicy(hang_threshold_s=5.0, backoff_base_s=0.01,
                      poll_interval_s=0.02)


# -- fault kinds + policy math (unit) -----------------------------------------


def test_fault_spec_hang_and_crash_parse_and_fire():
    hang = FaultSpec.parse("hang@decode:2")
    assert hang.kind == "hang" and hang.delay_ms == 30_000.0
    assert FaultSpec.parse("hang@decode:2:150").delay_ms == 150.0
    crash = FaultSpec.parse("crash@decode:1")
    assert crash.kind == "crash"
    inj = FaultInjector([crash])
    act = inj.on_call("decode")
    with pytest.raises(UncontainedCrash):
        act.fire()
    # UncontainedCrash must NOT be containable by `except Exception`
    assert not issubclass(UncontainedCrash, Exception)
    assert issubclass(InjectedFault, Exception)


def test_fault_hang_blocks_until_released():
    inj = FaultInjector([FaultSpec.parse("hang@decode:1:10000")])
    act = inj.on_call("decode")
    assert isinstance(act, FaultAction) and act.hang_ms == 10000.0
    done = threading.Event()

    def worker():
        act.fire()  # blocks on the injector's latch
        done.set()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    assert not done.wait(0.15)  # genuinely stuck
    inj.release_hangs()
    assert done.wait(2.0)       # released long before the 10s timeout
    th.join(WAIT)
    assert not th.is_alive()


def test_restart_policy_backoff_deterministic_and_bounded():
    p = RestartPolicy(backoff_base_s=0.1, backoff_max_s=1.0, jitter=0.25,
                      seed=7)
    delays = [p.backoff(k) for k in range(8)]
    assert delays == [p.backoff(k) for k in range(8)]  # deterministic
    for k, d in enumerate(delays):
        base = min(1.0, 0.1 * 2 ** k)
        assert base * 0.75 <= d <= base * 1.25
    assert RestartPolicy(seed=8).backoff(0) != RestartPolicy(seed=9).backoff(0)
    with pytest.raises(ValueError):
        RestartPolicy(hang_threshold_s=0.0)
    with pytest.raises(ValueError):
        RestartPolicy(jitter=1.5)
    with pytest.raises(ValueError):
        RestartPolicy(max_restarts=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=3), dict(seed=11, jitter=0.0),
    dict(backoff_base_s=0.2, backoff_max_s=0.5, jitter=0.9, seed=42)])
def test_backoff_schedules_equal_jax(kw):
    port, ref = tsup.RestartPolicy(**kw), jsup.RestartPolicy(**kw)
    assert [port.backoff(k) for k in range(12)] == \
        [ref.backoff(k) for k in range(12)]
    assert port.interval == ref.interval


# -- uncontained faults through the engine + daemon crash surface -------------


def test_uncontained_crash_escapes_engine_step_containment(lm):
    eng = _engine(lm)
    eng.faults = FaultInjector([FaultSpec.parse("crash@decode:1")])
    eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(UncontainedCrash):  # per-batch containment is
        for _ in range(20):                # `except Exception` -- this
            eng.step()                     # sails straight through
    # whereas a contained fault only fails its own request
    eng2 = _engine(lm)
    eng2.faults = FaultInjector([FaultSpec.parse("raise@decode:1")])
    r = eng2.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
    eng2.run()
    with pytest.raises(InjectedFault):
        r.handle.result()


def test_daemon_records_crash_and_abort_returns_leftovers(lm):
    eng = _engine(lm)
    eng.faults = FaultInjector([FaultSpec.parse("crash@decode:1")])
    daemon = ServingDaemon(eng).start()
    req = daemon.submit(np.arange(1, 5, dtype=np.int32),
                        max_new_tokens=4)
    deadline = time.monotonic() + WAIT
    while daemon.crashed is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert isinstance(daemon.crashed, UncontainedCrash)
    assert not daemon.running
    # the dead daemon rejects new work with a clear error
    with pytest.raises(RuntimeError, match="crashed"):
        daemon.submit(np.arange(1, 4, dtype=np.int32))
    # the in-flight handle was NOT resolved by the crash (that is the
    # supervisor's call: fail it or replay it)
    assert not req.handle.done()
    leftovers = daemon.abort()
    assert req.handle in leftovers
    for h in leftovers:
        h.set_exception(EngineCrashError("torn down"))
    with pytest.raises(EngineCrashError):
        req.handle.result()
    assert daemon.join(WAIT)  # the crashed thread is gone
    daemon.shutdown()  # idempotent on an aborted daemon


# -- Supervisor: recovery end to end (wall clock, real engines) ---------------


def test_supervisor_crash_recovery_replays_to_identical_results(lm, tmp_path):
    max_new = 5
    prompts = _prompts(3)
    expected = _reference(lm, prompts, max_new)
    builds = []
    sup = Supervisor(
        _warmed_factory(lm, prompts, max_new, arm="crash@decode:2",
                        builds=builds),
        journal=RequestJournal(tmp_path / "j.jsonl"), policy=_FAST)
    sup.start()
    handles = [sup.submit(p, request_id=f"r{i}", max_new_tokens=max_new)
               for i, p in enumerate(prompts)]
    outs = [h.result(timeout=WAIT) for h in handles]
    assert sup.restarts == 1 and len(builds) == 2
    entry = sup.restart_log[0]
    assert entry["reason"] == "EngineCrashError"
    assert entry["serve_thread_exited"] and entry["factory_s"] > 0
    assert sup.last_recovery_s is not None and sup.last_recovery_s > 0
    # deterministic greedy decode: replayed results are IDENTICAL to an
    # uninterrupted run
    assert all(list(a) == list(b) for a, b in zip(outs, expected))
    rec = sup.journal.reconcile()
    assert rec["exact"] and rec["submitted"] == 3
    assert sup.ready()["ready"]
    sup.shutdown()
    # reconciliation invariant extends across restarts: every journaled
    # submit has exactly one journaled terminal
    with RequestJournal(tmp_path / "j.jsonl") as j2:
        assert j2.reconcile()["exact"] and not j2.pending()


def test_supervisor_hang_watchdog_detects_and_recovers(lm):
    """hang@decode: detected by step age, torn down, the released thread
    joined BEFORE the next engine is built (no serve thread is alive
    while the factory runs), then replayed."""
    max_new = 5
    prompts = _prompts(2)
    expected = _reference(lm, prompts, max_new)
    policy = RestartPolicy(hang_threshold_s=0.5, backoff_base_s=0.01,
                           poll_interval_s=0.05)
    alive_at_build = []

    def on_build(i):
        alive_at_build.append(sum(
            th.name == "repro-serve" and th.is_alive()
            for th in threading.enumerate()))

    sup = Supervisor(
        _warmed_factory(lm, prompts, max_new, arm="hang@decode:2",
                        on_build=on_build),
        policy=policy)
    sup.start()
    handles = [sup.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = [h.result(timeout=WAIT) for h in handles]
    assert sup.restarts == 1
    entry = sup.restart_log[0]
    assert entry["reason"] == "HungStepError"
    assert entry["serve_thread_exited"]
    assert alive_at_build == [0, 0]  # the rebuild ran with no serve thread
    assert all(list(a) == list(b) for a, b in zip(outs, expected))
    sup.shutdown()


def test_supervisor_streaming_dedup_across_restart(lm):
    """A streaming client sees each token EXACTLY once even though the
    replayed attempt re-decodes the whole sequence."""
    max_new = 6
    prompts = _prompts(1)
    expected = _reference(lm, prompts, max_new)
    streamed = []
    sup = Supervisor(
        _warmed_factory(lm, prompts, max_new, arm="crash@decode:3"),
        policy=_FAST)
    sup.start()
    h = sup.submit(prompts[0], max_new_tokens=max_new,
                   on_token=streamed.append)
    out = h.result(timeout=WAIT)
    assert sup.restarts == 1
    assert list(out) == list(expected[0])
    assert streamed == list(out)  # no duplicated replayed tokens
    sup.shutdown()


def test_supervisor_circuit_breaker_opens_after_restart_budget(lm):
    max_new = 3
    prompts = _prompts(2)
    policy = RestartPolicy(hang_threshold_s=5.0, backoff_base_s=0.005,
                           poll_interval_s=0.02, max_restarts=2,
                           restart_window_s=300.0)
    # EVERY build is armed: the daemon can never serve the workload, so
    # restarts burn through the budget and the breaker must open
    sup = Supervisor(
        _warmed_factory(lm, prompts, max_new, arm="crash@decode:1",
                        arm_every=True),
        policy=policy)
    sup.start()
    handles = [sup.submit(p, max_new_tokens=max_new) for p in prompts]
    for h in handles:
        with pytest.raises(CircuitOpenError):
            h.result(timeout=WAIT)
    assert sup.restarts == policy.max_restarts + 1
    assert sup.ready() == {"ready": False, "reason": "circuit_open"}
    with pytest.raises(CircuitOpenError):  # NOT_READY rejects new work
        sup.submit(prompts[0], max_new_tokens=max_new)
    health = sup.health()
    assert health["state"] == "not_ready"
    assert health["stats"]["rejected"] == 1
    sup.shutdown()


def test_supervisor_cold_start_replays_journal(lm, tmp_path):
    """start() adopts a dead process's journal: non-terminal entries are
    resubmitted (original order), already-expired deadlines resolve
    TIMED_OUT without re-running."""
    max_new = 4
    prompts = _prompts(3)
    expected = _reference(lm, prompts, max_new)
    jpath = tmp_path / "j.jsonl"
    with RequestJournal(jpath) as j:  # what the dead process left behind
        j.record_submit("done-before", [1, 2, 3],
                        kw={"max_new_tokens": max_new})
        j.record_terminal("done-before", DONE)
        for i, p in enumerate(prompts):
            j.record_submit(f"lost-{i}", p.tolist(),
                            kw={"max_new_tokens": max_new})
        j.record_submit("expired", prompts[0].tolist(),
                        kw={"max_new_tokens": max_new},
                        deadline_unix=time.time() - 5.0)
    sup = Supervisor(_warmed_factory(lm, prompts, max_new),
                     journal=RequestJournal(jpath), policy=_FAST)
    sup.start()
    handles = sup.handles()
    assert set(handles) == {f"lost-{i}" for i in range(3)} | {"expired"}
    assert sup.replayed == 4
    with pytest.raises(TimeoutError):
        handles["expired"].result(timeout=10)
    assert handles["expired"].state == TIMED_OUT
    for i in range(3):
        out = handles[f"lost-{i}"].result(timeout=WAIT)
        assert list(out) == list(expected[i])
    sup.shutdown()
    with RequestJournal(jpath) as j2:
        assert j2.reconcile()["exact"]
        assert j2.terminal_state("expired") == TIMED_OUT


def test_supervisor_duplicate_request_id_is_idempotent(lm, tmp_path):
    max_new = 3
    prompts = _prompts(1)
    sup = Supervisor(_warmed_factory(lm, prompts, max_new),
                     journal=RequestJournal(tmp_path / "j.jsonl"),
                     policy=_FAST)
    sup.start()
    h1 = sup.submit(prompts[0], request_id="same", max_new_tokens=max_new)
    h2 = sup.submit(prompts[0], request_id="same", max_new_tokens=max_new)
    assert h1 is h2  # one outstanding lifecycle per rid
    h1.result(timeout=WAIT)
    rec = sup.journal.reconcile()
    assert rec["submitted"] == 1 and rec["exact"]
    # after the terminal, the same rid may start a NEW lifecycle
    h3 = sup.submit(prompts[0], request_id="same", max_new_tokens=max_new)
    assert h3 is not h1
    h3.result(timeout=WAIT)
    sup.shutdown()
    assert sup.stats.submitted == 2 == sup.stats.resolved


def test_supervisor_health_and_ready_surface(lm, tmp_path):
    max_new = 3
    prompts = _prompts(1)
    sup = Supervisor(_warmed_factory(lm, prompts, max_new),
                     journal=RequestJournal(tmp_path / "j.jsonl",
                                            fsync="batch"),
                     policy=_FAST)
    assert sup.ready() == {"ready": False, "reason": "stopped"}
    sup.start()
    h = sup.submit(prompts[0], request_id="hc", max_new_tokens=max_new)
    h.result(timeout=WAIT)
    health = sup.health()
    assert health["state"] == "running" and health["ready"]["ready"]
    assert health["restarts"] == 0 and health["crashed"] is None
    assert health["supervised_outstanding"] == 0
    assert health["daemon_outstanding"] == 0 and health["queue_depth"] == 0
    assert health["heartbeat_age_s"] is None or \
        health["heartbeat_age_s"] >= 0
    assert health["journal"]["pending"] == 0
    assert health["journal"]["fsync"] == "batch"
    # the dispatch trip latch's counters (nothing tripped), and no guard
    assert health["trip_latches"] == {"axes": ops.trip_counts()}
    assert health["trip_latches"]["axes"] == {"dense": 0, "conv": 0,
                                              "attn": 0}
    assert health["stats"]["submitted"] == 1
    json.dumps(health)  # the probe snapshot must be JSON-serializable
    sup.shutdown()
    assert sup.ready()["ready"] is False


# -- the port against the JAX package -----------------------------------------


def _jax_factory(prompts, max_new, arm):
    """The JAX package's reduced-qwen Engine (every dispatch axis off),
    warmed then armed on the first build, as _warmed_factory."""
    from repro.configs.registry import REDUCED as JREDUCED
    from repro.kernels import ops as jops
    from repro.serving import faults as jfaults
    from repro.serving.engine import Engine as JEngine
    jparams, _ = reduced_lm_params()
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    builds = []

    def factory():
        eng = JEngine(JREDUCED["qwen1.5-0.5b"], jparams, dispatch=off,
                      max_batch=2, max_len=64)
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        if not builds:
            eng.faults = jfaults.FaultInjector(
                [jfaults.FaultSpec.parse(arm)])
        builds.append(1)
        return eng

    return factory


def _supervised_run(mod, journal_mod, factory, prompts, max_new, jpath):
    sup = mod.Supervisor(factory, journal=journal_mod.RequestJournal(jpath),
                         policy=mod.RestartPolicy(
                             hang_threshold_s=30.0, backoff_base_s=0.01,
                             poll_interval_s=0.02))
    sup.start()
    hs = [sup.submit(p, request_id=f"r{i}", max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    outs = [[int(t) for t in h.result(timeout=WAIT)] for h in hs]
    health = sup.health()
    sup.shutdown()
    return dict(outcomes=[(h.uid, h.state) for h in hs], tokens=outs,
                restarts=sup.restarts,
                reasons=[e["reason"] for e in sup.restart_log],
                reconcile=sup.journal.reconcile(), health=health)


def test_crash_recovery_matches_jax(tmp_path):
    """One crash@decode script through both packages' supervisors: the
    same outcomes, the same DONE tokens, each equal to its own package's
    fault-free reference, and health() key sets equal but for the one
    stated value."""
    from repro.serving import journal as jjournal
    from repro_torch.serving import journal as tjournal
    max_new = 5
    prompts = _prompts(3)
    _, tparams = reduced_lm_params()
    tlm = (REDUCED["qwen1.5-0.5b"], tparams)
    runs = {
        "jax": _supervised_run(jsup, jjournal, _jax_factory(
            prompts, max_new, "crash@decode:2"), prompts, max_new,
            tmp_path / "jax.jsonl"),
        "torch": _supervised_run(tsup, tjournal, _warmed_factory(
            tlm, prompts, max_new, arm="crash@decode:2"), prompts, max_new,
            tmp_path / "torch.jsonl")}
    j, t = runs["jax"], runs["torch"]
    for key in ("outcomes", "tokens", "restarts", "reasons", "reconcile"):
        assert t[key] == j[key], key
    assert t["restarts"] == 1
    assert t["tokens"] == [list(map(int, r))
                           for r in _reference(tlm, prompts, max_new)]
    # the JAX package's own fault-free reference
    jeng = _jax_factory(prompts, max_new, "raise@decode:99999")()
    reqs = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run()
    assert j["tokens"] == [list(map(int, r.handle.result())) for r in reqs]
    jh, th = j["health"], t["health"]
    assert set(th) == set(jh)
    assert set(th) - {"journal"} == chip_smoke.HEALTH_KEYS
    assert set(th["journal"]) == set(jh["journal"])
    assert set(th["stats"]) == set(jh["stats"])
    assert set(jh["trip_latches"]) == {"axes", "guard"}
    assert set(th["trip_latches"]) == {"axes"}  # no guard in the port
    assert set(th["trip_latches"]["axes"]) == set(jh["trip_latches"]["axes"])
    assert th["trip_latches"]["axes"] == {"dense": 0, "conv": 0, "attn": 0}


# -- what the port adds --------------------------------------------------------


def test_a_serve_thread_that_does_not_leave_opens_the_circuit(lm):
    """A step stuck where release_hangs() cannot reach it: the teardown
    waits hang_threshold_s, then builds nothing beside the live thread --
    the circuit opens and every outstanding handle fails by name."""
    max_new = 4
    prompts = _prompts(2)
    gate = threading.Event()
    builds = []

    def factory():
        eng = _warmed_factory(lm, prompts, max_new)()
        if not builds:
            step = eng.step
            eng.step = lambda: (gate.wait(WAIT), step())[1]
        builds.append(1)
        return eng

    sup = Supervisor(factory, policy=RestartPolicy(
        hang_threshold_s=0.3, poll_interval_s=0.02))
    sup.start()
    try:
        hs = [sup.submit(p, max_new_tokens=max_new) for p in prompts]
        for h in hs:
            with pytest.raises(CircuitOpenError, match="did not exit"):
                h.result(timeout=WAIT)
        assert len(builds) == 1 and sup.restarts == 1
        assert sup.restart_log[0]["serve_thread_exited"] is False
        assert sup.ready() == {"ready": False, "reason": "circuit_open"}
    finally:
        gate.set()
    sup.shutdown()


def test_a_factory_that_raises_opens_the_circuit(lm):
    """A rebuild that raises (on the card: a failed graph capture) is not
    retried on another path: the circuit opens with its error."""
    max_new = 4
    prompts = _prompts(2)
    warmed = _warmed_factory(lm, prompts, max_new, arm="crash@decode:1")
    builds = []

    def factory():
        builds.append(1)
        if len(builds) > 1:
            raise RuntimeError("graph capture failed")
        return warmed()

    sup = Supervisor(factory, policy=_FAST)
    sup.start()
    hs = [sup.submit(p, max_new_tokens=max_new) for p in prompts]
    for h in hs:
        with pytest.raises(CircuitOpenError, match="graph capture failed"):
            h.result(timeout=WAIT)
    assert "graph capture failed" in sup.restart_log[0]["factory_error"]
    assert sup.health()["state"] == "not_ready"
    sup.shutdown()


def test_a_restart_frees_the_old_engine_before_the_next_build(lm):
    """Once the torn-down serve thread has left, the supervisor drops its
    daemon and collects it before the factory runs: no engine of an
    earlier build is alive when the next one is built (on the card its
    graphs and caches are not freed during the new engine's captures),
    and health() reads no daemon while the restart is under way."""
    max_new = 4
    prompts = _prompts(2)
    warmed = _warmed_factory(lm, prompts, max_new, arm="crash@decode:1",
                             arm_every=True)
    alive_at_build, during = [], []
    refs = []

    def factory():
        alive_at_build.append(sum(r() is not None for r in refs))
        if refs:
            during.append(sup.health())
        eng = warmed()
        refs.append(weakref.ref(eng))
        return eng

    sup = Supervisor(factory, policy=RestartPolicy(
        hang_threshold_s=5.0, backoff_base_s=0.01, poll_interval_s=0.02,
        max_restarts=2, restart_window_s=300.0))
    sup.start()
    hs = [sup.submit(p, max_new_tokens=max_new) for p in prompts]
    for h in hs:
        with pytest.raises(CircuitOpenError):
            h.result(timeout=WAIT)
    assert sup.restarts == 3 and alive_at_build == [0, 0, 0]
    assert all("daemon_state" not in h and h["ready"]["reason"]
               == "restarting" for h in during)
    sup.shutdown()


def test_replay_agreement_exact_bounded_and_off(lm, monkeypatch):
    cfg, params = lm
    prompts = _prompts(2)
    groups = launch_daemon.PrefillGroups()
    eng = groups.watch(_engine(lm))
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    greedy = [r.handle.result() for r in reqs]
    assert greedy == _reference(lm, prompts, 5)
    key = launch_daemon.PrefillGroups.key
    assert groups == {key(p): [2, 8] for p in prompts}  # one group, pow2 8
    moved = {key(p): [1, 8] for p in prompts}
    ok = launch_daemon.replay_agreement(cfg, params, prompts, greedy,
                                        greedy, 64, groups, groups)
    assert (ok["exact"], ok["bounded"], ok["off"]) == (2, 0, 0)
    # a reference that differs while the served tokens are the greedy
    # ones: every served token sits at the teacher-forced argmax, which
    # counts only where the replay ran in another prefill group
    other = [list(greedy[0][:-1]) + [(greedy[0][-1] + 1) % cfg.vocab_size],
             greedy[1]]
    b = launch_daemon.replay_agreement(cfg, params, prompts, greedy, other,
                                       64, moved, groups)
    assert (b["exact"], b["bounded"], b["off"]) == (1, 1, 0)
    assert b["rows"][0]["largest_gap"] <= 1e-5
    assert b["rows"][0]["groups"] == [[2, 8], [1, 8]]
    same = launch_daemon.replay_agreement(cfg, params, prompts, greedy,
                                          other, 64, groups, groups)
    assert (same["exact"], same["bounded"], same["off"]) == (1, 0, 1)
    gaps, bound = launch_daemon.teacher_forced_gaps(cfg, params, prompts[0],
                                                    greedy[0], 64)
    assert float(gaps.max()) <= 1e-5 and bound > 0
    # a served token below the argmax by more than the bound is off (here
    # a bound of 0), and so is a result of another length
    with monkeypatch.context() as mp:
        mp.setattr(launch_daemon, "TEACHER_FORCED_BOUND", 0.0)
        off = launch_daemon.replay_agreement(cfg, params, prompts,
                                             [other[0], greedy[1][:-1]],
                                             greedy, 64, moved, groups)
    assert (off["exact"], off["bounded"], off["off"]) == (0, 0, 2)


def test_teacher_forced_logits_batched_equal_one_at_a_time(lm):
    """The batched teacher forcing (chip_smoke's phase 6 holds served
    tokens with it) gives each request the logits it gets alone."""
    cfg, params = lm
    prompts = _prompts(3)
    greedy = _reference(lm, prompts, 4)
    forced = np.array([g[:3] for g in greedy]).T  # (steps, B)
    both = launch_daemon.teacher_forced_logits(cfg, params, prompts, forced,
                                               64)
    assert both.shape == (4, 3, cfg.vocab_size)
    for i, p in enumerate(prompts):
        one = launch_daemon.teacher_forced_logits(cfg, params, [p],
                                                  forced[:, i:i + 1], 64)
        np.testing.assert_allclose(both[:, i].numpy(), one[:, 0].numpy(),
                                   rtol=0, atol=1e-5)
    served = np.array([g[:4] for g in greedy]).T
    assert np.all(launch_daemon.token_gaps(both.numpy(), served) == 0)


def test_daemon_cli_recovery_smoke_and_health_file(capsys, tmp_path):
    base = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--timeout", str(WAIT)]
    with pytest.raises(SystemExit) as e:
        launch_daemon.main(base + ["--no-quant", "--recovery-smoke",
                                   "--requests", "3", "--max-new", "4",
                                   "--max-batch", "2"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    m = re.search(r"recovery smoke ok: crash@decode -> (\d+) restart\(s\)"
                  r".*\((\d+) exact, (\d+) within the teacher-forced "
                  r"bound\), journal exact \((\d+) submits == (\d+) "
                  r"terminals\), (\d+) engine builds", out)
    assert m and int(m[1]) >= 1 and (int(m[2]), int(m[3])) == (3, 0)
    assert m[4] == m[5] == "3" and int(m[6]) == int(m[1]) + 1
    path = tmp_path / "health.json"
    with pytest.raises(SystemExit) as e:
        launch_daemon.main(base + ["--health-file", str(path),
                                   "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "supervised: 4 requests reconciled, restarts=0" in out
    snap = json.loads(path.read_text())  # the whole final snapshot
    assert set(snap) == chip_smoke.HEALTH_KEYS
    assert snap["state"] == "stopped" and snap["restarts"] == 0
    assert snap["stats"]["completed"] == 4
    assert not Path(f"{path}.tmp").exists()


# -- chip_smoke's phase 9, rehearsed at reduced width on the CPU --------------


def test_chip_smoke_supervised_cases_on_the_cpu(tmp_path):
    """Phase 9 (b)'s five cases on the reduced qwen with the int8 cache
    (crash, hang, a streamed request across a restart, the circuit
    breaker, cold start after a process-like stop), (c)'s process kill
    and (d)'s vision crash on the reduced B1: no problem reported,
    launches as routed (plain calls on the CPU)."""
    from repro_torch import recipe
    from repro_torch.configs.efficientvit_b1 import REDUCED as B1
    from repro_torch.models import efficientvit
    cfg = REDUCED["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    qm = recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"),
                         "w4-weights-only")
    res, problems = chip_smoke.supervised_cases(
        qm, dict(max_batch=4, max_len=64, seed=0), tmp_path, hang_s=1.0)
    assert problems == []
    assert [c["restarts"] for c in res["cases"].values()] == [1, 1, 1, 4, 0]
    assert res["cases"]["hang"]["log"][0]["reason"] == "HungStepError"
    assert res["cases"]["cold_start"]["replayed"] >= 1
    # (c): the artifact served by a child process that is SIGKILLed, its
    # journal replayed by a fresh one
    qm.save(tmp_path / "art")
    k, problems = chip_smoke.process_kill_replay(
        qm, tmp_path / "art", tmp_path, dict(max_batch=4, max_len=64,
                                             seed=0), "cpu")
    assert problems == [] and k["replayed"] >= 1
    assert k["agreement"]["off"] == 0 and k["final"]["exact"]
    vis = recipe.quantize(B1, efficientvit.init(B1, seed=0, device="cpu"),
                          "m2q-w8a8")
    v, problems = chip_smoke.supervised_vision(vis, n_images=6)
    assert problems == [] and v["restarts"] == 1 and v["done"] == 6


# -- process-level kill: journal replay across a REAL restart -----------------

_CHILD = """
import os, signal, sys, json
import numpy as np
from repro_torch.configs.registry import REDUCED
from repro_torch.models import dense_lm
from repro_torch.serving.engine import Engine
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.supervisor import Supervisor

phase, jpath = sys.argv[1], sys.argv[2]
cfg = REDUCED["qwen1.5-0.5b"]
params = dense_lm.init(cfg, seed=0, device="cpu")
sup = Supervisor(lambda: Engine(cfg, params, max_batch=2, max_len=64),
                 journal=RequestJournal(jpath))
sup.start()
if phase == "serve":
    hs = [sup.submit(np.arange(1, 5 + i, dtype=np.int32),
                     request_id=f"req-{i}", max_new_tokens=5 if i else 2)
          for i in range(4)]
    hs[0].result(timeout=120)  # at least one completes pre-kill
    print("PHASE1-READY", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)  # hard death: no shutdown
results = {rid: [int(t) for t in h.result(timeout=120)]
           for rid, h in sup.handles().items()}
rec = sup.journal.reconcile()
sup.shutdown()
print("PHASE2-RESULT " + json.dumps(
    {"results": results, "reconcile": rec, "replayed": sup.replayed}),
    flush=True)
"""


def test_journal_replays_across_process_kill(lm, tmp_path):
    """SIGKILL a serving process mid-flight; a fresh process opening the
    same journal replays the lost requests to exact completion."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    jpath = str(tmp_path / "journal.jsonl")
    p1 = subprocess.run([sys.executable, "-c", _CHILD, "serve", jpath],
                        env=env, cwd=ROOT, capture_output=True, text=True,
                        timeout=300)
    assert "PHASE1-READY" in p1.stdout, (p1.stdout, p1.stderr)
    assert p1.returncode == -signal.SIGKILL
    with RequestJournal(jpath) as j:
        rec = j.reconcile()
        assert rec["submitted"] == 4 and rec["pending"] >= 1
    p2 = subprocess.run([sys.executable, "-c", _CHILD, "replay", jpath],
                        env=env, cwd=ROOT, capture_output=True, text=True,
                        timeout=300)
    assert p2.returncode == 0, (p2.stdout, p2.stderr)
    line = [ln for ln in p2.stdout.splitlines()
            if ln.startswith("PHASE2-RESULT ")][0]
    payload = json.loads(line.split(" ", 1)[1])
    assert payload["reconcile"]["exact"]
    assert payload["replayed"] == len(payload["results"]) >= 1
    # replayed results are identical to an uninterrupted greedy decode
    for rid, out in payload["results"].items():
        i = int(rid.split("-")[1])
        want = _reference(lm, [np.arange(1, 5 + i, dtype=np.int32)],
                          5 if i else 2)[0]
        assert out == [int(t) for t in want], rid
    # and the journal on disk closes the loop: every submit terminal
    with RequestJournal(jpath) as j:
        assert j.reconcile()["exact"] and not j.pending()

"""SLO classes, the token engine's streaming and preemption, the wall-clock
``ServingDaemon`` and the port's serving CLIs.

Held against the JAX package: ``SLOClass`` validation and
``ClassFlushPolicy`` deadlines on the same queues; preemption counts,
victims and result lengths of both packages' engines on the same
reduced-qwen weights and script.  The port alone: streamed == result,
non-preemptible requests never evicted, the daemon end to end on the
wall clock (token and vision engines, foreign-thread submits, a crash
recorded, ``shutdown(drain=False)``), and ``launch.serve`` /
``launch.daemon`` run in-process on the CPU.  Every wait and join has a
timeout, so a hang fails one test."""
import dataclasses
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.serving import scheduler as jsched
from repro.serving import slo as jslo
from repro_torch.configs.efficientvit_b1 import REDUCED as B1
from repro_torch.launch import daemon as launch_daemon
from repro_torch.launch import serve as launch_serve
from repro_torch.models import efficientvit
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import slo as tslo
from repro_torch.serving.daemon import ServingDaemon
from repro_torch.serving.errors import QueueFullError, UncontainedCrash
from repro_torch.serving.scheduler import DONE, FLUSH_DEADLINE
from repro_torch.serving.slo import BATCH, INTERACTIVE, SLOClass
from repro_torch.serving.vision import VisionEngine
from torch_parity import done_tokens, lm_engines, outcomes, stats_fields

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 8's scripted drive)

WAIT = 60.0  # seconds: every wait below is bounded


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- SLO classes -------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(max_delay_ms=-1.0), dict(deadline_ms=0), dict(deadline_ms=-5.0),
    dict(max_queued=0), dict(priority=3, max_delay_ms=2.0, deadline_ms=9.0,
                             max_queued=4, preemptible=True)])
def test_slo_class_validation_matches_jax(kw):
    def make(mod):
        try:
            return dataclasses.asdict(mod.SLOClass(name="x", **kw))
        except ValueError as e:
            return str(e)
    assert make(tslo) == make(jslo)
    for mod in (tslo, jslo):
        with pytest.raises(ValueError, match="duplicate"):
            mod.classes_by_name([mod.INTERACTIVE,
                                 mod.SLOClass(name="interactive")])
    assert [dataclasses.asdict(c) for c in tslo.DEFAULT_CLASSES] == \
        [dataclasses.asdict(c) for c in jslo.DEFAULT_CLASSES]


def _policy_script(pkg):
    """The same queues under ClassFlushPolicy in both packages: admission
    deadlines, due reasons and next deadlines on a virtual clock."""
    sched, slo = {"jax": (jsched, jslo), "torch": (tsched, tslo)}[pkg]
    rng = np.random.default_rng(0)
    pol = slo.ClassFlushPolicy.from_classes(
        [slo.INTERACTIVE, slo.BATCH,
         slo.SLOClass(name="bulk", priority=-3, max_delay_ms=80.0)],
        max_batch=6)
    trace = [dataclasses.asdict(pol), pol.delay_ms_for(42)]
    for _ in range(20):
        q = [sched.Handle(uid=i, payload=None,
                          submitted_at=float(rng.uniform(0, 0.1)),
                          priority=int(rng.choice([-3, 0, 10, 42])))
             for i in range(int(rng.integers(0, 5)))]
        trace.append(pol.admission_deadline(q))
    clk = Clock()
    s = sched.Scheduler(policy=pol, clock=clk)
    for step in range(12):
        clk.t += float(rng.uniform(0, 0.03))
        s.submit(step, priority=int(rng.choice([-3, 0, 10])))
        trace.append((s.due(), s.next_deadline()))
        if step % 4 == 3 and s.due():
            trace.append([h.uid for h in s.pop(s.peek(3), s.due())])
    with pytest.raises(ValueError, match="delay for priority"):
        slo.ClassFlushPolicy(delay_ms_by_priority=((1, -2.0),))
    return trace


def test_class_flush_policy_deadlines_match_jax():
    assert _policy_script("torch") == _policy_script("jax")


def test_interactive_arrival_makes_the_queue_due():
    clk = Clock()
    s = tsched.Scheduler(
        policy=tslo.ClassFlushPolicy.from_classes([INTERACTIVE, BATCH], 8),
        clock=clk)
    s.submit("b0", priority=BATCH.priority)
    assert s.due() is None
    clk.t = s.next_deadline()  # sleeping exactly until it IS due
    assert s.due() == FLUSH_DEADLINE
    s.pop(s.peek(8), FLUSH_DEADLINE)
    s.submit("b1", priority=BATCH.priority)
    s.submit("i0", priority=INTERACTIVE.priority)
    assert s.due() == FLUSH_DEADLINE
    assert [h.payload for h in s.peek(8)] == ["i0", "b1"]


# -- the token engine: streaming and preemption -----------------------------


def test_streamed_tokens_equal_the_result():
    _, eng = lm_engines()
    via_cb = []
    r = eng.submit(np.arange(1, 9), max_new_tokens=5, on_token=via_cb.append)
    s = eng.submit(np.arange(3, 7), max_new_tokens=1, stream=True)
    eng.run()
    assert r.handle.result() == via_cb and len(via_cb) == 5
    assert list(r.handle.tokens(timeout=1.0)) == via_cb
    assert list(s.handle.tokens(timeout=1.0)) == s.handle.result()
    assert eng.stats.streamed_tokens == 6
    r2 = eng.submit(np.arange(1, 5), max_new_tokens=3)
    eng.run()
    assert r2.handle.streamed == 0 and len(r2.handle.result()) == 3


def _preempt_script(eng):
    """Two preemptible decodes (priorities 0 and 1) fill both slots;
    interactive arrivals evict the lowest class first, then the one with
    more tokens emitted; every request completes its budget."""
    low = eng.submit(np.arange(1, 7), max_new_tokens=9, priority=0,
                     preemptible=True, stream=True)
    mid = eng.submit(np.arange(2, 9), max_new_tokens=9, priority=1,
                     preemptible=True, stream=True)
    eng.step()
    eng.step()
    before = {r.uid: list(r.handle._stream) for r in (low, mid)}
    hi = [eng.submit(np.arange(3, 6), max_new_tokens=3, priority=10)]
    eng.step()
    hi.append(eng.submit(np.arange(4, 8), max_new_tokens=2, priority=10))
    eng.step()
    eng.run()
    reqs = [low, mid] + hi
    return reqs, before, [r.preemptions for r in reqs]


def test_preemption_matches_jax():
    jeng, teng = lm_engines()
    jreqs, _, jpre = _preempt_script(jeng)
    treqs, before, tpre = _preempt_script(teng)
    assert tpre == jpre
    assert outcomes(treqs) == outcomes(jreqs)
    # the float cache: each continuation equals JAX's token for token
    assert done_tokens(treqs) == done_tokens(jreqs)
    assert len(done_tokens(treqs)) == len(treqs)
    assert stats_fields(teng.stats) == stats_fields(jeng.stats)
    assert tpre[0] >= 1  # the victim: the lowest class
    assert teng.stats.preemptions == sum(tpre)
    for r in treqs[:2]:  # prefix kept, budget met, stream == result
        out = r.handle.result()
        assert len(out) == 9 and out[:len(before[r.uid])] == before[r.uid]
        assert out == list(r.handle.tokens(timeout=1.0))
        assert r.out_prefix == out[:len(r.out_prefix)]
    s = teng.stats
    assert s.submitted == s.resolved == 4  # requeue never double-counts


def test_non_preemptible_is_never_evicted():
    _, eng = lm_engines(max_batch=1)
    low = eng.submit(np.arange(1, 7), max_new_tokens=4, priority=0)
    eng.step()
    hi = eng.submit(np.arange(1, 5), max_new_tokens=2, priority=10)
    eng.run()
    assert low.preemptions == 0 and eng.stats.preemptions == 0
    assert len(low.handle.result()) == 4 and len(hi.handle.result()) == 2


def test_poisoned_victim_fails_instead_of_restarting():
    _, eng = lm_engines(max_batch=1, faults="nan@decode:1")
    low = eng.submit(np.arange(1, 7), max_new_tokens=8, preemptible=True)
    eng.step()
    hi = eng.submit(np.arange(1, 5), max_new_tokens=2, priority=10)
    eng.run()
    assert "caught at preemption" in str(low.handle.exception())
    assert low.preemptions == 0 and len(hi.handle.result()) == 2


def test_chip_smoke_runtime_script_on_the_cpu():
    """Phase 8 (b)'s drive and checks, rehearsed on the reduced qwen with
    the int8 cache: two runs (the CPU runs both eagerly) agree, the
    second prefill group fails with InjectedFault, one poisoned slot with
    NumericalError, and the evicted streamer keeps its stream."""
    runs = {}
    for mode in ("first", "second"):
        _, eng = lm_engines("int8", max_batch=chip_smoke.RUNTIME_BATCH,
                            faults=chip_smoke.RUNTIME_SPEC,
                            debug_numerics=True)
        runs[mode] = chip_smoke.drive_runtime_script(eng)
    assert chip_smoke.runtime_script_problems(eng.cfg, runs, "cpu") == []
    r = runs["first"]
    assert [e for _, _, e in r["outcomes"]].count("InjectedFault") == 1
    assert r["preemptions"][0] == 1 and r["before"][0]
    assert r["stats"]["submitted"] == 10 and r["groups"] == 3


# -- the daemon on the wall clock --------------------------------------------


def test_daemon_rejects_a_virtual_clock():
    _, eng = lm_engines(clock=Clock())
    with pytest.raises(ValueError, match="real clock"):
        ServingDaemon(eng)


def test_daemon_serves_classes_streaming_and_reconciles():
    _, eng = lm_engines(max_batch=2)
    results, streamed = [], []
    with ServingDaemon(eng) as daemon:
        def submitter():
            for _ in range(5):
                results.append(daemon.submit(np.arange(1, 7), slo="batch",
                                             max_new_tokens=12))

        th = threading.Thread(target=submitter)
        th.start()
        th.join(WAIT)
        assert not th.is_alive()
        first = daemon.submit(np.arange(1, 9), slo="interactive",
                              max_new_tokens=4, stream=True)
        results.append(daemon.submit(np.arange(1, 6), slo="interactive",
                                     max_new_tokens=4))
        streamed = list(first.handle.tokens(timeout=WAIT))
        for r in results:
            r.handle.result(timeout=WAIT)
    assert not daemon.running and not daemon._thread.is_alive()
    assert streamed == first.handle.result()
    inter, batch = (daemon.class_stats[n] for n in ("interactive", "batch"))
    assert (inter.submitted, inter.completed) == (2, 2)
    assert (batch.submitted, batch.completed) == (5, 5)
    # whether an interactive request evicted a batch slot depends on
    # timing; the engine's count always equals the requests' own
    assert eng.stats.preemptions == sum(
        r.preemptions for r in results + [first])
    s = eng.stats
    assert s.submitted == s.resolved == s.completed == 7
    assert eng.heartbeat is not None and daemon.heartbeat is not None
    summary = daemon.stats_summary()
    assert summary["engine"]["completed"] == 7
    assert sorted(summary["classes"]) == ["batch", "interactive"]


def test_daemon_expires_queued_requests_under_concurrent_submits():
    """Token engine: queued requests time out while another thread keeps
    submitting; every handle resolves and the counts reconcile.  No
    context manager: a deadlocked daemon must fail the test, not hang its
    exit."""
    _, eng = lm_engines(max_batch=1)
    daemon = ServingDaemon(eng).start()
    reqs = [daemon.submit(np.arange(1, 7), slo="batch", max_new_tokens=8)]

    def submitter():
        for i in range(200):
            reqs.append(daemon.submit(np.arange(1, 5), slo="batch",
                                      max_new_tokens=1,
                                      deadline_ms=0.5 + i % 3))

    th = threading.Thread(target=submitter, daemon=True)
    th.start()
    th.join(WAIT)
    assert not th.is_alive()
    t0 = time.monotonic()
    while (not all(r.handle.done() for r in reqs)
           and time.monotonic() - t0 < WAIT):
        time.sleep(0.01)
    assert all(r.handle.done() for r in reqs)
    daemon.shutdown(timeout=WAIT)
    assert not daemon._thread.is_alive()
    s = eng.stats
    assert s.timed_out >= 1
    assert s.submitted == s.resolved == len(reqs) == 201


def test_daemon_budget_unknown_class_and_idle_wakeup():
    _, eng = lm_engines(max_batch=1)
    tight = (SLOClass(name="interactive", priority=10),
             SLOClass(name="batch", max_delay_ms=5.0, max_queued=1,
                      preemptible=True))
    with ServingDaemon(eng, classes=tight) as daemon:
        time.sleep(0.1)  # the loop goes idle: an untimed wait
        first = daemon.submit(np.arange(1, 9), slo="batch",
                              max_new_tokens=6)
        with pytest.raises(QueueFullError, match="budget exhausted"):
            daemon.submit(np.arange(1, 9), slo="batch")
        with pytest.raises(KeyError, match="unknown SLO class"):
            daemon.submit(np.arange(1, 9), slo="nope")
        first.handle.result(timeout=WAIT)
        daemon.submit(np.arange(1, 9), slo="batch",
                      max_new_tokens=2).handle.result(timeout=WAIT)
    assert daemon.class_stats["batch"].rejected == 1
    assert eng.stats.submitted == eng.stats.resolved == 2


def test_daemon_shutdown_without_drain_cancels_the_rest():
    _, eng = lm_engines(max_batch=1)
    daemon = ServingDaemon(eng).start()
    reqs = [daemon.submit(np.arange(1, 7), slo="batch", max_new_tokens=40)
            for _ in range(3)]
    daemon.shutdown(drain=False, timeout=WAIT)
    assert not daemon.running and not daemon._thread.is_alive()
    assert all(r.handle.done() for r in reqs)
    assert eng.stats.cancelled >= 2
    assert eng.stats.submitted == eng.stats.resolved == 3
    with pytest.raises(RuntimeError, match="daemon is stopped"):
        daemon.submit(np.arange(1, 5))


def test_daemon_records_an_uncontained_crash():
    _, eng = lm_engines(max_batch=1, faults="crash@decode:2")
    daemon = ServingDaemon(eng).start()
    r = daemon.submit(np.arange(1, 7), max_new_tokens=6)
    t0 = time.monotonic()
    while daemon.crashed is None and time.monotonic() - t0 < WAIT:
        time.sleep(0.01)
    assert isinstance(daemon.crashed, UncontainedCrash)
    assert daemon._state == "crashed" and not r.handle.done()
    with pytest.raises(RuntimeError, match="crashed"):
        daemon.submit(np.arange(1, 5))
    daemon.shutdown(timeout=WAIT)
    assert r.handle.cancelled()
    assert eng.stats.submitted == eng.stats.resolved == 1


@pytest.fixture(scope="module")
def b1_params():
    return efficientvit.init(B1, seed=0, device="cpu")


def test_vision_daemon_runs_every_batch_on_its_thread(b1_params):
    """A vision submit is host-only under the daemon: full batches run on
    the serve thread, never inline on the submitter's."""
    eng = VisionEngine(B1, b1_params, max_batch=4)
    threads, run_batch = [], eng._run_batch

    def spy(images, bucket):
        threads.append(threading.current_thread().name)
        return run_batch(images, bucket)

    eng._run_batch = spy
    rng = np.random.default_rng(0)
    imgs = rng.normal(0, 1, (10, B1.img_res, B1.img_res, 3)).astype(
        np.float32)
    hs = []
    with ServingDaemon(eng) as daemon:
        assert not eng.scheduler.execute_on_submit
        th = threading.Thread(target=lambda: hs.extend(
            daemon.submit(img, slo="batch") for img in imgs[:6]))
        th.start()
        th.join(WAIT)
        hs.extend(daemon.submit(img) for img in imgs[6:])
        for h in hs:
            h.result(timeout=WAIT)
    assert all(h.state == DONE for h in hs) and len(hs) == 10
    assert threads and set(threads) == {"repro-serve"}
    assert eng.stats.submitted == eng.stats.resolved == 10
    ref = eng.classify(imgs[:1])
    assert ref.shape == (1, B1.n_classes)


def test_vision_daemon_expiry_callbacks_do_not_block_a_submit(b1_params):
    """The serve thread's first sweep of a tick (``poll`` -> ``due``)
    times out two queued requests; while it runs the first one's
    callbacks, a foreign thread submits (holding the daemon's lock), then
    the second one's daemon callback takes that lock.  Neither thread may
    block the other."""
    eng = VisionEngine(B1, b1_params, max_batch=4)
    # vision images carry no priority: every one waits out the 1.5 s
    # window of priority 0, past the first two's 200 ms deadlines
    slow = (INTERACTIVE, SLOClass(name="batch", max_delay_ms=1500.0))
    img = np.zeros((B1.img_res, B1.img_res, 3), np.float32)
    daemon = ServingDaemon(eng, classes=slow).start()
    a, b = (daemon.submit(img, slo="batch", deadline_ms=200.0)
            for _ in range(2))
    entered, release = threading.Event(), threading.Event()

    def hold(_):
        entered.set()
        release.wait(10.0)

    a.add_done_callback(hold)
    assert entered.wait(WAIT)
    late = []
    th = threading.Thread(target=lambda: late.append(daemon.submit(img)),
                          daemon=True)
    th.start()
    time.sleep(0.2)
    release.set()
    th.join(WAIT)
    assert not th.is_alive()
    late[0].result(timeout=WAIT)
    daemon.shutdown(timeout=WAIT)
    assert not daemon._thread.is_alive()
    assert (a.state, b.state, late[0].state) == ("TIMED_OUT",) * 2 + (DONE,)
    assert eng.stats.submitted == eng.stats.resolved == 3


# -- the CLIs, in-process on the CPU -----------------------------------------


def test_serve_cli_prints_its_lines(capsys):
    launch_serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                       "cpu", "--requests", "5", "--max-new", "6",
                       "--kv-cache-dtype", "int8"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] quantized 9 layers; avg bits=\d+\.\d\d",
                     out)
    m = re.search(r"requests=(\d+) decoded=(\d+) steps=(\d+) "
                  r"tok/s=([\d.]+)", out)
    assert m and int(m[1]) == 5 and float(m[4]) > 0
    assert int(m[2]) == 5 * 5  # the first token of each comes at prefill
    assert re.search(r"queue p50=[\d.]+ms p99=[\d.]+ms", out)


def test_daemon_cli_smoke_and_traffic(capsys):
    base = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        launch_daemon.main(base + ["--smoke", "--timeout", str(WAIT)])
    assert e.value.code == 0
    assert re.search(r"smoke ok: 8 tokens streamed", capsys.readouterr().out)
    with pytest.raises(SystemExit) as e:
        launch_daemon.main(base + ["--no-quant", "--requests", "6",
                                   "--stream", "--timeout", str(WAIT)])
    out = capsys.readouterr().out
    assert e.value.code == 0
    assert len(re.findall(r"stream tok=\d+", out)) == 8
    assert re.search(r"class=interactive completed=3 p50=", out)
    assert re.search(r"class=batch completed=3 p50=", out)
    assert re.search(r"stream ttft=[\d.]+ms tokens=8 gap", out)
    assert re.search(r"reconciled 6 requests; streamed_tokens=8", out)


@pytest.mark.parametrize("cli,argv,names", [
    (launch_serve, ["--mesh", "2x2"], "needs 4 ranks but only 1 exist"),
    (launch_daemon, ["--mesh", "2x2"], "needs 4 ranks but only 1 exist"),
    (launch_daemon, ["--coordinator", "127.0.0.1:1"],
     "--coordinator needs --mesh"),
    # multi-host: --health-file's per-process readiness markers
    (launch_daemon, ["--coordinator", "127.0.0.1:1", "--health-file",
                     "h.json"], "--coordinator needs --mesh")])
def test_unported_flags_exit_naming_their_roadmap_item(cli, argv, names,
                                                       monkeypatch):
    """The sharded flags are ported (ROADMAP A9's serving part): on one
    process they exit before building anything, with the JAX CLIs'
    style of message, and no longer name a ROADMAP item."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu"]
                 + argv)
    assert names in str(e.value.code)
    assert argv[0] in str(e.value.code)
    assert "ROADMAP" not in str(e.value.code)

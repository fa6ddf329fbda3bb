"""The port's scheduler core (``repro_torch.serving.scheduler``) against the
JAX package's: one scripted sequence per usage mode runs through both
packages on the same virtual clock -- submits with priorities and
deadlines, cancels, shed-oldest over two classes, ``requeue``, ``peek`` /
``pop``, executor faults from one spec string -- and every step's uids,
queue order, handle states, exception classes, flush reasons and
``ServeStats`` summary must be equal.  Then the port alone: the streaming
handle (``tokens()`` truncated on failure, ``on_token``), done-callbacks
firing once, ``execute_on_submit`` and a bounded thread stress test."""
import sys
import threading
from collections import Counter

import numpy as np
import pytest

from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.batching import ServeStats
from repro_torch.serving.errors import (CancelledError, InjectedFault,
                                        QueueFullError)
from repro_torch.serving.scheduler import (DONE, FAILED, PENDING,
                                           FlushPolicy, Handle,
                                           OverloadPolicy, Scheduler)

PACKAGES = {"jax": (jsched, jfaults), "torch": (tsched, tfaults)}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1000.0


def _snapshot(s, handles):
    """Everything observable about a scheduler after one step."""
    return {
        "queue": [h.uid for h in s._q],
        "handles": [(h.uid, h.priority, h.state,
                     type(h.exception()).__name__ if h.exception() else None,
                     round(h.submitted_at, 9))
                    for h in handles],
        "stats": s.stats.summary(),
        "resolved": s.stats.resolved,
        "next_deadline": s.next_deadline(),
        "pending": s.pending,
    }


def _admission_script(pkg):
    """Admission mode (the token engine's): a bounded queue that sheds the
    oldest of the lowest class, deadlines, cancels, peek/pop, requeue."""
    sched_mod, _ = PACKAGES[pkg]
    clk = Clock()
    s = sched_mod.Scheduler(
        policy=sched_mod.FlushPolicy(max_batch=3, max_delay_ms=10.0),
        overload=sched_mod.OverloadPolicy(max_queue=4, shed_oldest=True),
        clock=clk)
    hs, trace = [], []

    def step(label):
        trace.append((label, _snapshot(s, hs)))

    hs.append(s.submit("a", deadline_ms=5.0))
    clk.advance_ms(1)
    hs.append(s.submit("b"))
    hs.append(s.submit("c", priority=10))
    clk.advance_ms(1)
    hs.append(s.submit("d", priority=10, deadline_ms=50.0))
    step("four queued")
    hs.append(s.submit("e", priority=10))  # full: sheds a (oldest, prio 0)
    step("shed one of the lowest class")
    hs.append(s.submit("f", priority=10))  # full: sheds b
    step("shed again")
    trace.append(("due", s.due()))
    hs[3].cancel()
    step("cancel d")
    clk.advance_ms(3)
    trace.append(("due at 5 ms", s.due()))
    trace.append(("peek", [h.uid for h in s.peek(2)]))
    live = s.pop(s.peek(2), "full")
    trace.append(("popped", [h.uid for h in live]))
    step("after pop")
    clk.advance_ms(4)
    trace.append(("requeue", s.requeue(live[0])))
    trace.append(("requeue terminal", s.requeue(hs[3])))
    step("requeued")
    live[1].set_result("ok")
    clk.advance_ms(20)
    trace.append(("due at 29 ms", s.due()))
    rest = s.pop(s.peek(5), "deadline")
    for h in rest:
        h.set_result("ok")
    step("drained")
    with pytest.raises(ValueError, match="deadline_ms"):
        s.submit("x", deadline_ms=0)
    rej = sched_mod.Scheduler(
        policy=sched_mod.FlushPolicy(max_batch=2, max_delay_ms=0.0),
        overload=sched_mod.OverloadPolicy(max_queue=1), clock=clk)
    rej.submit("y")
    with pytest.raises(Exception) as e:
        rej.submit("z")
    trace.append(("rejected", type(e.value).__name__, rej.stats.summary()))
    return trace


def _executor_script(pkg):
    """Executor mode (the vision engine's): full / deadline / drain
    flushes, priorities, a cancelled batchmate, and executor faults from
    one spec string contained per batch."""
    sched_mod, faults_mod = PACKAGES[pkg]
    clk = Clock()
    batches = []

    def executor(handles, reason):
        batches.append(([h.uid for h in handles], reason))
        for h in handles:
            h.set_result(h.payload)

    inj = faults_mod.FaultInjector.parse("raise@executor:2,nan@executor:3")
    s = sched_mod.Scheduler(
        policy=sched_mod.FlushPolicy(max_batch=3, max_delay_ms=5.0),
        executor=executor, clock=clk, faults=inj)
    hs, trace = [], []

    def step(label):
        trace.append((label, _snapshot(s, hs), list(batches)))

    hs.append(s.submit(0))
    hs.append(s.submit(1, priority=1))
    step("two queued")
    hs.append(s.submit(2))  # full: executes inline (executor call 1)
    step("full batch inline")
    for i in range(3, 6):
        hs.append(s.submit(i, priority=i % 2))  # call 2 raises
    step("second batch failed")
    hs.append(s.submit(6))
    hs.append(s.submit(7, deadline_ms=2.0))
    hs[-2].cancel()
    hs.append(s.submit(8))
    clk.advance_ms(3)
    trace.append(("poll at 3 ms", s.poll()))
    clk.advance_ms(3)
    trace.append(("poll at 6 ms", s.poll()))
    step("deadline")
    hs.append(s.submit(9, priority=2))
    hs.append(s.submit(10))
    trace.append(("drain", [h.uid for h in s.drain()]))
    step("drained")
    trace.append(("faults", inj.summary()))
    return trace


@pytest.mark.parametrize("script", [_admission_script, _executor_script])
def test_scripted_sequence_matches_jax(script):
    want = script("jax")
    got = script("torch")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]


def test_requeue_bypasses_overload_and_counts_no_submit():
    clk = Clock()
    s = Scheduler(policy=FlushPolicy(max_batch=4, max_delay_ms=0.0),
                  overload=OverloadPolicy(max_queue=1), clock=clk)
    h = s.submit("x", priority=2)
    [live] = s.pop([h], "full")
    s.submit("y")  # the queue is full again
    clk.advance_ms(30)
    assert s.requeue(live)  # engine-internal: never refused
    assert s.pending == 2 and s.stats.submitted == 2
    assert live.submitted_at == pytest.approx(0.030)
    assert [q.payload for q in s.peek(5)] == ["x", "y"]  # class order


def test_tokens_truncated_on_failure_and_on_token():
    h = Handle(uid=8, payload=None, submitted_at=0.0)
    seen = []
    h._on_token = seen.append
    assert h.push_token(5) and h.push_token(6)
    h.set_exception(InjectedFault("poisoned"))
    assert not h.push_token(7)  # dropped after the terminal state
    it = h.tokens(timeout=1.0)
    assert [next(it), next(it)] == [5, 6]  # delivered tokens stand
    with pytest.raises(InjectedFault, match="poisoned"):
        next(it)
    assert seen == [5, 6] and h.streamed == 2
    with pytest.raises(TimeoutError):
        next(Handle(uid=9, payload=None, submitted_at=0.0).tokens(
            timeout=0.01))
    c = Handle(uid=10, payload=None, submitted_at=0.0)
    c.push_token(1)
    assert c.cancel() and c.cancelled()
    with pytest.raises(CancelledError):
        list(c.tokens(timeout=1.0))


def test_tokens_wake_a_blocked_consumer():
    h = Handle(uid=7, payload=None, submitted_at=0.0)
    got = []
    t = threading.Thread(target=lambda: got.extend(h.tokens(timeout=5.0)))
    t.start()
    for tok in (1, 2, 3):
        h.push_token(tok)
    h.set_result([1, 2, 3])
    t.join(5.0)
    assert not t.is_alive() and got == [1, 2, 3]
    assert list(h.tokens(timeout=1.0)) == [1, 2, 3]  # a fresh iterator


def test_done_callbacks_fire_once_and_swallow_errors():
    h = Handle(uid=3, payload=None, submitted_at=0.0)
    calls = []
    h.add_done_callback(lambda hh: calls.append(hh.state))
    h.add_done_callback(lambda hh: 1 / 0)  # must not break the resolver
    assert h.set_result([1])
    assert not h.set_result([2]) and not h.cancel()
    assert calls == [DONE] and h.exception() is None
    h.add_done_callback(lambda hh: calls.append("late"))  # runs at once
    assert calls == [DONE, "late"]
    h2 = Handle(uid=4, payload=None, submitted_at=0.0)
    h2._on_token = lambda tok: 1 / 0
    assert h2.push_token(1)


def test_execute_on_submit_off_leaves_the_batch_to_poll():
    ran = []

    def executor(handles, reason):
        ran.append((threading.current_thread().name, reason))
        for h in handles:
            h.set_result(1)

    s = Scheduler(policy=FlushPolicy(max_batch=2), executor=executor)
    s.execute_on_submit = False
    a, b = s.submit("a"), s.submit("b")
    assert ran == [] and a.state == b.state == PENDING
    assert s.due() == "full"
    t = threading.Thread(target=s.poll, name="server")
    t.start()
    t.join(5.0)
    assert ran == [("server", "full")] and a.state == b.state == DONE


@pytest.mark.parametrize("sweep", ["due", "poll", "expire"])
def test_expiry_callbacks_run_outside_the_scheduler_lock(sweep):
    """A done-callback that takes another lock (the serving daemon's) runs
    after the scheduler's lock is released, so a thread that holds that
    lock and submits is never blocked by the expiring thread."""
    clock = Clock()
    s = Scheduler(FlushPolicy(max_batch=8), clock=clock,
                  executor=(lambda hs, r: None) if sweep == "poll" else None)
    h = s.submit("late", deadline_ms=1.0)
    outer = threading.Lock()
    entered, got = threading.Event(), []

    def on_done(_):
        entered.set()
        got.append(outer.acquire(timeout=5.0))
        if got[-1]:
            outer.release()

    h.add_done_callback(on_done)
    clock.advance_ms(2.0)
    with outer:
        sweeper = threading.Thread(target=getattr(s, sweep))
        sweeper.start()
        assert entered.wait(5.0)
        submitter = threading.Thread(target=s.submit, args=("next",))
        submitter.start()
        submitter.join(5.0)
        assert not submitter.is_alive()
    sweeper.join(5.0)
    assert not sweeper.is_alive() and got == [True]
    assert h.state == "TIMED_OUT" and s.stats.submitted == 2


def test_executor_raise_fails_only_its_batch():
    def executor(handles, reason):
        for h in handles:
            h.set_result(h.payload)

    s = Scheduler(policy=FlushPolicy(max_batch=2), executor=executor,
                  faults=tfaults.FaultInjector.parse("raise@executor:1"))
    hs = [s.submit(i) for i in range(4)]
    assert [h.state for h in hs] == [FAILED, FAILED, DONE, DONE]
    assert isinstance(hs[0].exception(), InjectedFault)
    assert s.stats.failed == 2 and s.stats.completed == 2


def test_thread_stress_reconciles_exactly():
    """8 submitter threads and one consumer on one scheduler, with a
    shortened switch interval: uids stay unique, every handle goes
    terminal, and the outcome counters equal the handles' states under
    shedding, cancellation, expiry and concurrent pops."""
    s = Scheduler(policy=FlushPolicy(max_batch=4, max_delay_ms=0.0),
                  overload=OverloadPolicy(max_queue=32, shed_oldest=True))
    n_threads, per_thread = 8, 50
    handles, lock, stop = [], threading.Lock(), threading.Event()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        mine = []
        for i in range(per_thread):
            r = rng.random()
            h = s.submit(i, priority=int(rng.integers(0, 3)),
                         deadline_ms=0.5 if r < 0.15 else None)
            if r > 0.9:
                h.cancel()
            mine.append(h)
        with lock:
            handles.extend(mine)

    def consumer():
        while not (stop.is_set() and s.pending == 0):
            reason = s.due()
            if reason is not None:
                for h in s.pop(s.peek(4), reason):
                    h.set_result("ok")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        cons = threading.Thread(target=consumer)
        cons.start()
        subs = [threading.Thread(target=submitter, args=(i,))
                for i in range(n_threads)]
        for t in subs:
            t.start()
        for t in subs:
            t.join(30.0)
        stop.set()
        cons.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not cons.is_alive() and not any(t.is_alive() for t in subs)
    assert len(handles) == n_threads * per_thread
    assert len({h.uid for h in handles}) == len(handles)
    assert all(h.state != PENDING for h in handles)
    st = s.stats
    assert st.submitted == st.resolved == len(handles)
    states = Counter(h.state for h in handles)
    assert st.completed == states[DONE]
    assert st.failed + st.shed == states[FAILED]
    assert st.cancelled == states["CANCELLED"]
    assert st.timed_out == states["TIMED_OUT"]
    assert all(isinstance(h.exception(), QueueFullError)
               for h in handles if h.state == FAILED)


def test_servestats_record_outcome_is_thread_safe():
    st = ServeStats()
    ts = [threading.Thread(target=lambda: [st.record_outcome("completed")
                                           for _ in range(2000)])
          for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
    assert st.completed == 16000

"""Fault injection in the port (``repro_torch.serving.faults``) against the
JAX package's: ``FaultSpec.parse`` on every example of the grammar (and
the malformed ones), ``on_call`` sequences and summaries, ``from_env``;
then the reduced qwen1.5-0.5b served by both packages' engines under one
spec and one script -- the same uids fail with the same exception
classes and the outcome counters agree, with an f32 KV cache and with
the int8 cache under ``debug_numerics=True``.  The port alone: the int8
cache with the scan off (the detection boundary: the quantizers send NaN
to code 0), a crash going through ``step()``, hangs released, the vision
``executor`` / ``vision`` / ``nan`` containment, and the ``vision.kernel``
site refused at construction."""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.serving import faults as jfaults
from repro_torch.configs.efficientvit_b1 import REDUCED as B1
from repro_torch.models import efficientvit
from repro_torch.serving import faults as tfaults
from repro_torch.serving.errors import (InjectedFault, NumericalError,
                                        UncontainedCrash)
from repro_torch.serving.scheduler import DONE, FAILED
from repro_torch.serving.vision import VisionEngine
from torch_parity import (done_tokens, lm_engines, lm_prompts, outcomes,
                          stats_fields)

GRAMMAR = ["raise@prefill:2", "nan@decode:3", "raise@decode:*/10",
           "delay@vision:1:50", "nan@vision.kernel:1", "hang@decode:2",
           "hang@*:1:5", "crash@executor:4", " RAISE@vision ",
           "delay@*:*/3:0"]
MALFORMED = ["boom@decode:1", "raise", "raise@:1", "raise@decode:x",
             "raise@decode:0", "raise@decode:*/0", "delay@vision:1:-5",
             "raise@decode:1:abc"]


def _fields(mod, text):
    try:
        return dataclasses.asdict(mod.FaultSpec.parse(text))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("text", GRAMMAR + MALFORMED)
def test_fault_spec_parse_matches_jax(text):
    got, want = _fields(tfaults, text), _fields(jfaults, text)
    assert got == want
    assert (text in MALFORMED) == isinstance(got, tuple)


def _calls(mod, spec, sites):
    inj = mod.FaultInjector.parse(spec)
    acts = []
    for site in sites:
        act = inj.on_call(site)
        acts.append(None if act is None else (
            act.site, act.call_index, act.do_raise, act.do_crash,
            act.delay_ms, act.hang_ms, act.poison))
    return acts, inj.summary()


def test_on_call_sequences_match_jax():
    spec = ("raise@prefill:2,nan@decode:*/3,delay@vision:1:7,"
            "hang@executor:2:9,crash@decode:4,raise@*:5,delay@*:5:3")
    rng = np.random.default_rng(0)
    sites = [str(s) for s in rng.choice(
        ["prefill", "decode", "vision", "executor"], 60)]
    got, want = _calls(tfaults, spec, sites), _calls(jfaults, spec, sites)
    assert got == want
    assert sum(a is not None for a in got[0]) >= 10


def test_from_env_reads_the_same_variable(monkeypatch):
    assert tfaults.ENV_VAR == jfaults.ENV_VAR == "REPRO_FAULT_SPEC"
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    assert tfaults.from_env() is None and jfaults.from_env() is None
    monkeypatch.setenv("REPRO_FAULT_SPEC", "raise@decode:3, nan@vision:*/2")
    assert tfaults.from_env().summary() == jfaults.from_env().summary()
    monkeypatch.setenv("REPRO_FAULT_SPEC", "raise@decode")
    assert tfaults.from_env().specs[0].nth == 1
    monkeypatch.setenv("REPRO_FAULT_SPEC", "oops")
    with pytest.raises(ValueError, match="malformed fault spec"):
        tfaults.from_env()


def test_fire_raises_crashes_and_hangs_until_released():
    inj = tfaults.FaultInjector.parse("raise@a:1,crash@b:1,hang@c:1")
    with pytest.raises(InjectedFault, match="site 'a'"):
        inj.on_call("a").fire()
    with pytest.raises(UncontainedCrash):
        inj.on_call("b").fire()
    assert not issubclass(UncontainedCrash, Exception)
    hang = inj.on_call("c")
    assert hang.hang_ms == 30_000.0
    t = threading.Thread(target=hang.fire)
    t0 = time.monotonic()
    t.start()
    inj.release_hangs()
    t.join(5.0)
    assert not t.is_alive() and time.monotonic() - t0 < 5.0


# -- the token engines of both packages, one spec, one script ---------------

SPEC = "raise@prefill:2,nan@decode:3"


def _serve(eng, n=5, max_new=4):
    reqs = [eng.submit(p, max_new_tokens=max_new)
            for p in lm_prompts(eng.cfg.vocab_size, n, seed=3)]
    eng.run()
    return reqs


@pytest.mark.parametrize("kv,debug", [("bf16", False), ("int8", True)])
def test_engine_fault_outcomes_match_jax(kv, debug):
    """Group 1 (uids 0, 1) prefills; decode step 3 poisons slot 0, whose
    request alone fails with NumericalError (f32 cache: the logits; int8
    cache: the scan over its f32 row scales); the second prefill group
    raises; the last request completes.  On the float cache the DONE
    requests' tokens equal JAX's too; on the int8 cache only their
    lengths are held (XLA's int8 rounding may differ by a step)."""
    jeng, teng = lm_engines(kv, faults=SPEC, debug_numerics=debug)
    treqs, jreqs = _serve(teng), _serve(jeng)
    got, want = outcomes(treqs), outcomes(jreqs)
    assert got == want
    if kv != "int8":
        assert done_tokens(treqs) == done_tokens(jreqs)
    assert [(u, s, e) for u, s, e, _ in got] == [
        (0, FAILED, "NumericalError"), (1, DONE, None),
        (2, FAILED, "InjectedFault"), (3, FAILED, "InjectedFault"),
        (4, DONE, None)]
    assert stats_fields(teng.stats) == stats_fields(jeng.stats)
    assert teng.faults.summary() == jeng.faults.summary()
    assert teng.stats.submitted == teng.stats.resolved == 5


def test_int8_cache_scan_off_is_the_detection_boundary():
    """Port only: with the scan off, ``nan@decode`` on the int8 cache may
    deliver finite tokens (NaN row scales meet code-0 quantizers); the
    batchmate is untouched either way, and the scan catches the slot."""
    _, off = lm_engines("int8", faults="nan@decode:1")
    _, ref = lm_engines("int8")
    _, on = lm_engines("int8", faults="nan@decode:1", debug_numerics=True)
    r_off, r_ref, r_on = (_serve(e, n=2) for e in (off, ref, on))
    poisoned = r_off[0].handle
    assert poisoned.state == DONE or isinstance(poisoned.exception(),
                                                NumericalError)
    if poisoned.state == DONE:
        assert all(0 <= t < off.cfg.vocab_size for t in poisoned.result())
    assert r_off[1].handle.result() == r_ref[1].handle.result()
    assert isinstance(r_on[0].handle.exception(), NumericalError)
    assert r_on[1].handle.result() == r_ref[1].handle.result()


def test_decode_raise_fails_live_slots_and_crash_goes_through():
    _, eng = lm_engines(faults="raise@decode:1")
    reqs = _serve(eng, n=4, max_new=3)
    assert [r.handle.state for r in reqs] == [FAILED, FAILED, DONE, DONE]
    _, eng = lm_engines(faults="crash@decode:2")
    eng.submit(np.arange(1, 6), max_new_tokens=4)
    eng.step()
    with pytest.raises(UncontainedCrash):
        eng.step()


def test_debug_numerics_defaults_off_and_reads_env(monkeypatch):
    monkeypatch.delenv("REPRO_DEBUG_NUMERICS", raising=False)
    assert not lm_engines()[1].debug_numerics
    monkeypatch.setenv("REPRO_DEBUG_NUMERICS", "1")
    assert lm_engines()[1].debug_numerics
    assert not lm_engines(debug_numerics=False)[1].debug_numerics


# -- the vision engine (port only) ------------------------------------------


@pytest.fixture(scope="module")
def b1_params():
    return efficientvit.init(B1, seed=0, device="cpu")


def _images(n):
    rng = np.random.default_rng(1)
    return rng.normal(0, 1, (n, B1.img_res, B1.img_res, 3)).astype(
        np.float32)


def test_vision_fault_containment(b1_params):
    """Executor call 1 raises at the scheduler's site (batch 1 fails
    before any forward); vision call 2 raises (batch 3); vision call 3
    poisons its first row (batch 4: that image alone fails)."""
    eng = VisionEngine(B1, b1_params, max_batch=2,
                       faults=tfaults.FaultInjector.parse(
                           "raise@executor:1,raise@vision:2,nan@vision:3"))
    hs = [eng.submit(img) for img in _images(8)]  # full pairs run inline
    assert [h.state for h in hs] == [FAILED, FAILED, DONE, DONE,
                                    FAILED, FAILED, FAILED, DONE]
    assert [type(hs[i].exception()).__name__ for i in (0, 4, 6)] == [
        "InjectedFault", "InjectedFault", "NumericalError"]
    out = np.stack([h.result() for h in hs if h.state == DONE])
    assert out.shape == (3, B1.n_classes) and np.all(np.isfinite(out))
    assert eng.stats.batches == 2  # forwards run: batches 2 and 4
    assert eng.stats.flush_reasons == {"full": 4}
    assert eng.stats.resolved == 8
    assert eng.faults.calls == {"executor": 4, "vision": 3}


def test_vision_kernel_site_is_refused(b1_params, monkeypatch):
    with pytest.raises(ValueError, match="A5"):
        VisionEngine(B1, b1_params, faults=tfaults.FaultInjector.parse(
            "raise@vision:1,nan@vision.kernel:1"))
    monkeypatch.setenv("REPRO_FAULT_SPEC", "raise@vision.kernel:2")
    with pytest.raises(ValueError, match="FallbackGuard"):
        VisionEngine(B1, b1_params)
    monkeypatch.setenv("REPRO_FAULT_SPEC", "delay@vision:1:1")
    assert VisionEngine(B1, b1_params).faults.specs[0].site == "vision"

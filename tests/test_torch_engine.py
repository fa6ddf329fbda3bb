"""The port's continuous-batching token Engine on the reduced qwen1.5-0.5b
(2 layers, d_model 64) under ``w4-weights-only``, on the CPU: submit
validation, ragged admission with power-of-two prefill padding, requests
finishing at prefill, a slot idled past ``max_len``, greedy tokens equal
to a model-level greedy loop, seeded temperature sampling, a NaN-poisoned
slot failing alone, deadlines and cancellation; the recipe resolution
of the narrow config against the JAX package's, and the same engine
serving the mixed leaves ``m2q-w8a8`` gives the narrow config."""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import REDUCED as JREDUCED
from repro_torch import kernels, recipe
from repro_torch.configs.registry import REDUCED
from repro_torch.models import dense_lm
from repro_torch.serving.batching import pow2_bucket
from repro_torch.serving.engine import Engine
from repro_torch.serving.errors import NumericalError, QueueFullError
from repro_torch.serving.scheduler import (CANCELLED, DONE, FAILED,
                                           TIMED_OUT, OverloadPolicy)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the token paths' checks)

CFG = REDUCED["qwen1.5-0.5b"]
KV = ["int8", "bf16"]


@functools.lru_cache(maxsize=None)
def _qm(kv_cache_dtype):
    cfg = CFG.replace(kv_cache_dtype=kv_cache_dtype)
    return recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"),
                           "w4-weights-only")


def _prompts(n, seed=0, lo=1, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _greedy_loop(qm, prompts, max_new, batch, max_len):
    """The model-level greedy loop the engine must reproduce: the same
    prompts prefilled together into a ``batch``-row cache (right-padded to
    the engine's power-of-two length), then decode steps feeding each
    argmax back."""
    cfg, n = qm.cfg, len(prompts)
    lens = np.array([len(p) for p in prompts], np.int32)
    pmax = pow2_bucket(int(lens.max()), 8, max_len)
    toks = np.zeros((n, pmax), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    with torch.no_grad():
        group = dense_lm.init_cache(cfg, n, max_len, dtype=torch.float32,
                                    device="cpu")
        logits, group = dense_lm.prefill(cfg, qm.params, group,
                                         torch.from_numpy(toks),
                                         lengths=torch.from_numpy(lens))
        cache = dense_lm.init_cache(cfg, batch, max_len,
                                    dtype=torch.float32, device="cpu")
        for name, dst in cache.items():
            if dst.ndim == 1:
                dst[:n] = group[name]
            else:
                dst[:, :n] = group[name]
        tok = torch.zeros((batch, 1), dtype=torch.int64)
        tok[:n, 0] = logits[:, -1, :cfg.vocab_size].argmax(-1)
        out = [[int(t)] for t in tok[:n, 0]]
        for _ in range(max(max_new) - 1):
            logits, cache = dense_lm.decode_step(cfg, qm.params, cache, tok)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            for i in range(n):
                out[i].append(int(tok[i, 0]))
    return [o[:m] for o, m in zip(out, max_new)]


def test_serve_returns_the_token_engine():
    eng = _qm("int8").serve(max_batch=2, max_len=32)
    assert isinstance(eng, Engine) and eng.B == 2 and eng.T == 32
    with pytest.raises(ValueError, match="deadline"):
        _qm("int8").serve(max_delay_ms=None)


@pytest.mark.parametrize("prompt,kw,match", [
    (np.zeros((2, 3), np.int32), {}, "1-D"),
    (np.array([1.0, 2.0]), {}, "integer"),
    (np.array([1, CFG.vocab_size]), {}, r"\[0, 512\)"),
    (np.array([-1, 2]), {}, r"\[0, 512\)"),
    (np.array([], np.int32), {}, "empty"),
    (np.array([1, 2]), {"max_new_tokens": 0}, "max_new_tokens"),
    (np.arange(30), {"max_new_tokens": 3}, "max_len"),
])
def test_submit_validates_up_front(prompt, kw, match):
    eng = _qm("int8").serve(max_batch=2, max_len=32)
    with pytest.raises(ValueError, match=match):
        eng.submit(prompt, **kw)
    assert eng.stats.submitted == 0


@pytest.mark.parametrize("kv", KV)
def test_greedy_tokens_equal_a_model_level_greedy_loop(kv):
    """Ragged admission: the three prompts prefill as one group padded to
    pow2_bucket(9, 8, max_len) = 16 tokens; decode runs all four slots;
    every request's tokens equal the model-level loop's.  On CPU tensors
    every kernel wrapper runs its plain version (int8 cache:
    decode_attn_int8 once per layer and step)."""
    qm = _qm(kv)
    prompts = [p[:n] for p, n in zip(_prompts(3), (3, 9, 5))]
    max_new = [6, 4, 1]
    eng = qm.serve(max_batch=4, max_len=32)
    kernels.reset_counts()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    stats = eng.run()
    assert [r.handle.state for r in reqs] == [DONE] * 3
    assert stats.prefill_batches == 1 and stats.prefills == 3
    assert stats.padded_items == 3 * 16 - 17 and stats.items == 17
    assert stats.steps == 5 and stats.finished == 3
    counts = kernels.counts()
    got = [r.handle.result() for r in reqs]
    assert got == [r.out_tokens for r in reqs]
    assert [len(t) for t in got] == max_new
    assert got == _greedy_loop(qm, prompts, max_new, 4, 32)
    assert counts["int4_matmul"]["plain_calls"] == 1 + stats.steps
    assert counts["decode_attn_int8"]["plain_calls"] == (
        stats.steps * CFG.n_layers if kv == "int8" else 0)
    assert all(c["launches"] == 0 for c in counts.values())


@pytest.mark.parametrize("kv", KV)
def test_decode_step_writes_the_engine_buffers_in_place(kv):
    """What a CUDA graph of the decode step needs: every step (and every
    prefill between steps) writes the same cache, pending-token, output,
    count and non-finite buffers, never rebinding one; the tokens are the
    model-level greedy loop's."""
    qm = _qm(kv)
    prompts = [p[:n] for p, n in zip(_prompts(3, seed=8), (4, 7, 2))]
    max_new = [5, 3, 6]
    eng = qm.serve(max_batch=4, max_len=32)

    def buffers():
        return [t.data_ptr() for t in (*eng.cache.values(), eng._pending,
                                       eng._outbuf, eng._counts,
                                       eng._nonfinite, eng._live)]

    first = buffers()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    while eng.step():
        assert buffers() == first
    assert eng.stats.steps == 5 and buffers() == first
    assert [r.handle.result() for r in reqs] == _greedy_loop(
        qm, prompts, max_new, 4, 32)


def test_max_new_tokens_one_finishes_at_prefill():
    eng = _qm("int8").serve(max_batch=2, max_len=32)
    reqs = [eng.submit(p, max_new_tokens=1) for p in _prompts(3, seed=1)]
    assert eng.step() == 0  # admitted, finished and freed in one step
    assert eng.stats.steps == 0
    assert [r.handle.state for r in reqs[:2]] == [DONE, DONE]
    assert eng.step() == 0 and reqs[2].handle.state == DONE
    assert all(len(r.handle.result()) == 1 for r in reqs)
    assert all(s is None for s in eng.slots)


@pytest.mark.parametrize("kv", KV)
def test_idle_slot_past_max_len_drops_its_writes(kv):
    """Every slot's length advances each step, live or not, and an idle
    slot's row at ``length - 1`` is written, as in JAX; once the idle
    slot passes max_len its writes are dropped, never clamped onto the
    last row.  The engine serves on, and a new request in that slot gets
    the tokens of a clean run."""
    qm = _qm(kv)
    T = 16
    eng = qm.serve(max_batch=2, max_len=T)
    prompts = _prompts(3, seed=2, lo=1, hi=3)
    done = []
    for p in prompts[:2]:  # one at a time: slot 0 works, slot 1 idles
        done.append(eng.submit(p, max_new_tokens=T - 3))
        eng.run()
    assert int(eng.cache["lengths"][1]) > T  # slot 1 idled past max_len
    idle = {k: v[:, 1].clone() for k, v in eng.cache.items()
            if k != "lengths"}
    done.append(eng.submit(prompts[2], max_new_tokens=T - 3))
    eng.run()
    for k, v in idle.items():
        assert torch.equal(eng.cache[k][:, 1], v), k
    # both slots busy: slot 1 takes a request after idling past max_len
    pair = [eng.submit(prompts[0], max_new_tokens=5) for _ in range(2)]
    eng.run()
    for r in done + pair:
        assert r.handle.state == DONE
    assert pair[0].out_tokens == pair[1].out_tokens
    assert done[0].out_tokens == _greedy_loop(qm, [prompts[0]], [T - 3],
                                              2, T)[0]


def test_decode_step_drops_rows_past_the_cache():
    cfg = CFG.replace(kv_cache_dtype="int8")
    qm = _qm("int8")
    cache = dense_lm.init_cache(cfg, 2, 8, device="cpu")
    cache["lengths"] = torch.tensor([8, 3], dtype=torch.int32)
    with torch.no_grad():
        _, cache = dense_lm.decode_step(cfg, qm.params, cache,
                                        torch.tensor([[1], [2]]))
    assert cache["lengths"].tolist() == [9, 4]
    assert not bool(cache["k"][:, 0].any()) and not bool(
        cache["k_scale"][:, 0].any())
    assert bool(cache["k"][:, 1, 3].any()) and not bool(
        cache["k"][:, 1, 4:].any())


def test_temperature_sampling_is_repeatable_by_seed():
    qm = _qm("int8")
    prompts = _prompts(3, seed=3)

    def run(seed):
        eng = qm.serve(max_batch=4, max_len=32, seed=seed)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=0.8)
                for p in prompts]
        greedy = eng.submit(prompts[0], max_new_tokens=8)
        eng.run()
        return [r.handle.result() for r in reqs], greedy.handle.result()

    a, ga = run(7)
    b, gb = run(7)
    c, gc = run(8)
    assert a == b and a != c
    assert ga == gb == gc  # greedy rows ignore the random draws
    assert a[0] != ga


@pytest.mark.parametrize("kv", KV)
def test_nan_poisoned_slot_fails_alone(kv):
    """A slot whose cache rows go NaN produces non-finite logits; the
    sticky flag fails that request alone with NumericalError at
    completion, while its batchmate's tokens are those of a clean run."""
    qm = _qm(kv)
    prompts = _prompts(2, seed=4)
    clean = qm.serve(max_batch=2, max_len=32)
    want = clean.submit(prompts[1], max_new_tokens=5)
    clean.run()
    eng = qm.serve(max_batch=2, max_len=32)
    bad, good = (eng.submit(p, max_new_tokens=5) for p in prompts)
    eng.step()
    name = "k_scale" if kv == "int8" else "k"
    eng.cache[name][:, 0] = float("nan")
    eng.run()
    assert bad.handle.state == FAILED
    with pytest.raises(NumericalError):
        bad.handle.result()
    assert good.handle.state == DONE
    assert good.handle.result() == want.handle.result()
    assert eng.stats.failed == 1 and eng.stats.completed == 1
    # the slot's flag was cleared for its next occupant
    again = eng.submit(prompts[1], max_new_tokens=5)
    eng.run()
    assert again.handle.result() == want.handle.result()


def test_deadlines_and_cancellation():
    clock = Clock()
    eng = _qm("int8").serve(max_batch=1, max_len=32, clock=clock)
    prompts = _prompts(3, seed=5, hi=8)
    running = eng.submit(prompts[0], max_new_tokens=20, deadline_ms=50)
    queued = eng.submit(prompts[1], max_new_tokens=3)
    expired = eng.submit(prompts[2], max_new_tokens=3, deadline_ms=10)
    eng.step()
    queued.handle.cancel()
    clock.t = 0.02  # past `expired`'s deadline while it waits
    eng.step()
    assert expired.handle.state == TIMED_OUT
    clock.t = 0.06  # past `running`'s deadline mid-decode
    eng.step()
    assert running.handle.state == TIMED_OUT
    assert queued.handle.state == CANCELLED
    assert eng.slots == [None] and eng.scheduler.pending == 0
    s = eng.stats
    assert s.submitted == s.resolved == 3


def test_admission_waits_for_the_deadline_and_bounds_the_queue():
    """A positive max_delay_ms holds admission until the oldest request's
    deadline (the scheduler's admission mode: pending, queue,
    oldest_age_ms, next_deadline), and an OverloadPolicy bounds the
    queue."""
    clock = Clock()
    eng = _qm("int8").serve(max_batch=4, max_len=32, max_delay_ms=10.0,
                            clock=clock,
                            overload=OverloadPolicy(max_queue=2))
    a, b = (eng.submit(p, max_new_tokens=2) for p in _prompts(2, seed=6))
    with pytest.raises(QueueFullError):
        eng.submit(_prompts(1, seed=7)[0], max_new_tokens=2)
    assert eng.stats.rejected == 1
    clock.t = 0.004
    assert eng.step() == 0 and eng.queue == [a, b]
    assert eng.scheduler.pending == 2
    assert eng.scheduler.oldest_age_ms() == pytest.approx(4.0)
    assert eng.scheduler.next_deadline() == pytest.approx(0.010)
    clock.t = 0.010
    assert eng.step() == 2 and eng.queue == []
    assert eng.stats.prefill_batches == 1
    eng.run()
    assert a.handle.state == b.handle.state == DONE


def test_narrow_config_resolves_as_jax():
    """d_model <= 256 and no QUANT_OVERRIDES: the taxonomy overrides pin
    every dense/head/expert rule to mixed, as JAX's _arch_overrides does;
    rules, FFN groups and the decode ShapeCtx match too."""
    for name in ("m2q-w8a8", "w4-weights-only", "uniform8"):
        ours = recipe.PRESETS[name].resolve(CFG)
        theirs = jr.PRESETS[name].resolve(JREDUCED["qwen1.5-0.5b"])
        assert [(rx, ov.decision, ov.scheme, ov.bits)
                for rx, ov in ours.overrides] == \
            [(rx, ov.decision, ov.scheme, ov.bits)
             for rx, ov in theirs.overrides]
        assert list(ours.rules) == list(theirs.rules)
        assert [tuple(g) for g in ours.ffn_groups] == \
            [tuple(g) for g in theirs.ffn_groups]
        assert ours.shape_ctx.tokens_per_step == \
            theirs.shape_ctx.tokens_per_step == 2
    assert len(recipe.taxonomy_overrides(dense_lm.QUANT_RULES)) == 4


@pytest.mark.parametrize("kv", KV)
def test_m2q_on_a_narrow_lm_serves_the_mixed_leaves(kv):
    """The taxonomy overrides send the narrow LM's layers to the mixed m2q
    scheme: stacked QExpertM2Q leaves (wq, wk, wv, wo, w2) with per-layer
    activation scales, perm-folded QM2Q w1/w3 with none, a calibrated 2-D
    QM2Q lm_head.  The engine's greedy tokens equal the model-level loop's,
    and every calibrated layer matmul and the lm_head take ``m2q_matmul``
    (5 L + 1 plain calls per prefill group and per decode step)."""
    from repro_torch.core.qtensor import QExpertM2Q, QM2Q
    from repro_torch.core.tree import leaves_with_path
    cfg = CFG.replace(kv_cache_dtype=kv)
    qm = recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"),
                         "m2q-w8a8")
    leaves = dict(leaves_with_path(qm.params))
    for name in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w2"):
        leaf = leaves[f"layers/{name}"]
        assert isinstance(leaf, QExpertM2Q) and leaf.payload.ndim == 3
        assert leaf.act_scale.shape == (CFG.n_layers, 1, 1)
    for name in ("w1", "w3"):
        leaf = leaves[f"layers/mlp/{name}"]
        assert type(leaf) is QM2Q and leaf.act_scale is None
        assert leaf.payload.shape == (CFG.n_layers, CFG.d_model, CFG.d_ff)
    assert type(leaves["lm_head"]) is QM2Q
    assert leaves["lm_head"].act_scale is not None
    prompts = [p[:n] for p, n in zip(_prompts(3), (3, 9, 5))]
    max_new = [6, 4, 1]
    eng = qm.serve(max_batch=4, max_len=32)
    kernels.reset_counts()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    stats = eng.run()
    counts = kernels.counts()
    got = [r.handle.result() for r in reqs]
    assert got == _greedy_loop(qm, prompts, max_new, 4, 32)
    assert counts["m2q_matmul"]["plain_calls"] == \
        (5 * CFG.n_layers + 1) * (stats.prefill_batches + stats.steps)
    assert all(c["launches"] == 0 for c in counts.values())
    # what chip_smoke.py's token-m2q path (int8 cache) checks on the card
    chip_smoke.check_token_leaves(qm, "token-m2q")
    want = chip_smoke.token_launches(cfg, "token-m2q", stats.steps,
                                     stats.prefill_batches)
    if kv != "int8":
        del want["decode_attn_int8"]
    assert {k: c["plain_calls"] for k, c in counts.items()
            if c["plain_calls"]} == want

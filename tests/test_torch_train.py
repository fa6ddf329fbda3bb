"""The port's training step against the JAX package's (``repro.train``,
``repro.optim``, ``repro.dist.compression``), on the CPU: the same numpy
inputs, parameters and optimizer state (through ``repro_torch.convert``)
in both packages.

* ``softmax_xent`` and the loss within 1e-6 relative, padded vocab
  included;
* one ``make_train_step`` step of the reduced qwen1.5-0.5b at 1 and 2
  microbatches, compression off and on: the loss within 1e-5 relative,
  the gradients per leaf within 1e-4 of that leaf's max |g|; with
  compression on, the step's update equal (1e-6) to JAX's AdamW over
  JAX's int8 round trip of the port's own gradients -- the two packages'
  gradients differ by float noise, and a value within that noise of an
  int8 rounding boundary takes the neighbouring code (one code is
  max|block| / 127), so compressed gradients are compared on identical
  inputs, as the codec itself is;
* ``AdamW.update`` on identical numpy gradients (a schedule and clipping
  on): parameters, ``m``, ``v`` and ``grad_norm`` within 1e-6 relative;
* the codecs bit for bit, and ``comp + res == g + res_in`` exactly;
* ``core.tree`` on NamedTuples (the optimizer state), keyed as JAX keys
  them.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REDUCED as JREDUCED
from repro.dist import compression as jcomp
from repro.models import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.tree import leaves_with_path, map_with_path, unflatten
from repro_torch.dist import compression as tcomp
from repro_torch.models import get_model as tget_model
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from torch_parity import jax_to_numpy

QWEN = "qwen1.5-0.5b"


def _flat(tree) -> dict:
    return dict(leaves_with_path(tree))


def _close(got, want, rtol, what=""):
    """Leaf by leaf, ``|got - want| <= rtol * max |want|`` of the leaf."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        tol = rtol * max(float(np.abs(w).max()), 1e-30)
        assert g.shape == w.shape, (what, k)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol, (what, k, err, tol)


# ---------------------------------------------------------------------------
# core.tree on NamedTuples
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    count: object
    m: object


def test_tree_rebuilds_namedtuples_and_keys_their_fields_as_jax():
    tree = ({"w": torch.zeros(2)},
            _Pair(torch.zeros((), dtype=torch.int32),
                  {"w": torch.ones(2), "b": [torch.ones(1)]}))
    out = map_with_path(lambda _, t: t + 1, tree)
    assert isinstance(out, tuple) and isinstance(out[1], _Pair)
    assert int(out[1].count) == 1 and float(out[1].m["w"][0]) == 2.0
    keys = [k for k, _ in leaves_with_path(tree)]
    assert keys == ["0/w", "1/.count", "1/.m/b/0", "1/.m/w"]
    jtree = ({"w": jnp.zeros(2)},
             _Pair(jnp.zeros((), jnp.int32),
                   {"w": jnp.ones(2), "b": [jnp.ones(1)]}))
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    assert keys == ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path) for path, _ in flat]
    back = unflatten(tree, [t for _, t in leaves_with_path(out)])
    assert isinstance(back[1], _Pair)


def test_optimizer_state_keys_equal_jaxs():
    jp = jget_model(JREDUCED[QWEN]).init(JREDUCED[QWEN],
                                         jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(
        (jp, jadamw.AdamW().init(jp)))
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in flat]
    got = [k for k, _ in leaves_with_path((tp, tadamw.AdamW().init(tp)))]
    assert got == want
    assert "1/.count" in got and "1/.m/embed" in got


def test_convert_carries_an_optimizer_state_both_ways():
    jp = jget_model(JREDUCED[QWEN]).init(JREDUCED[QWEN],
                                         jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jst = jadamw.AdamWState(
        count=jnp.asarray(np.int32(7)),
        m=jax.tree.map(lambda p: jnp.asarray(rng.normal(
            size=p.shape).astype(np.float32)), jp),
        v=jax.tree.map(lambda p: jnp.asarray(rng.random(
            p.shape).astype(np.float32)), jp))
    numpy_state = {"count": np.asarray(jst.count), "m": jax_to_numpy(jst.m),
                   "v": jax_to_numpy(jst.v)}
    for src in (numpy_state, jadamw.AdamWState(**numpy_state)):
        st = opt_state_from_numpy(src, "cpu")
        assert isinstance(st, tadamw.AdamWState)
        assert st.count.dtype == torch.int32 and st.count.shape == ()
        back = opt_state_to_numpy(st)
        assert back["count"].dtype == np.int32 and int(back["count"]) == 7
        for name in ("m", "v"):
            a, b = _flat(back[name]), _flat(numpy_state[name])
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(TypeError):
        opt_state_from_numpy(dict(numpy_state, count=np.float32(7)), "cpu")


# ---------------------------------------------------------------------------
# softmax_xent and the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("V,vocab", [(512, 512), (512, 387), (256, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_jax(V, vocab, dtype):
    rng = np.random.default_rng(V + vocab)
    logits = (4 * rng.normal(size=(3, 9, V))).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 9)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = float(jstep.softmax_xent(jl, jnp.asarray(labels), vocab))
    got = float(tstep.softmax_xent(tl, torch.from_numpy(labels), vocab))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    # the gradient w.r.t. the logits: softmax - onehot, zero in the pad
    jg = np.asarray(jax.grad(lambda x: jstep.softmax_xent(
        x, jnp.asarray(labels), vocab))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    tstep.softmax_xent(x, torch.from_numpy(labels), vocab).backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    assert not x.grad[..., vocab:].any()


@pytest.mark.parametrize("name", [QWEN, "granite-3-8b"])
def test_loss_fn_matches_jax(name):
    """The reduced model's loss: granite's vocab 387 pads to 512."""
    jcfg, tcfg = JREDUCED[name], TREDUCED[name]
    jp = jget_model(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = float(jstep.make_loss_fn(jcfg, jget_model(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}))
    with torch.no_grad():
        got = float(tstep.make_loss_fn(tcfg, tget_model(tcfg))(
            tp, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(toks)}))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_case():
    jcfg, tcfg = JREDUCED[QWEN], TREDUCED[QWEN]
    jp = jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    return jcfg, tcfg, jp, tp, {"tokens": toks, "labels": toks}


def _opts():
    return (jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10)),
            tadamw.AdamW(lr=tadamw.cosine_schedule(1e-3, 2, 10)))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compression", [False, True])
def test_train_step_matches_jax(qwen_case, microbatches, compression):
    jcfg, tcfg, jp, tp, batch = qwen_case
    jopt, topt = _opts()
    cfg = jstep.TrainStepConfig(microbatches, compression)
    jfn = jax.jit(jstep.make_train_step(jcfg, jget_model(jcfg), jopt, cfg))
    tfn = tstep.make_train_step(tcfg, tget_model(tcfg), topt,
                                tstep.TrainStepConfig(microbatches,
                                                      compression))
    jp2, jst2, jm = jfn(jp, jopt.init(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, tst2, tm = tfn(tp, topt.init(tp),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    want_loss, got_loss = float(jm["loss"]), float(tm["loss"])
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-5 * float(jm["grad_norm"])
    assert int(tst2.count) == int(jst2.count) == 1
    # the gradients, before any compression: the port's grad_fn against
    # JAX's microbatched value_and_grad
    loss_j = jstep.make_loss_fn(jcfg, jget_model(jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = []
    for i in range(microbatches):
        mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
              for k, v in jbatch.items()}
        jgrads.append(jax.grad(loss_j)(jp, mb))
    jg = jax.tree.map(lambda *g: sum(g) / microbatches, *jgrads)
    _, tg = tstep.make_grad_fn(tcfg, tget_model(tcfg), microbatches)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(params_to_numpy(tg), jax_to_numpy(jg), 1e-4, "gradients")
    if not compression:
        # m after one step is (1 - b1) times the clipped gradients
        _close(params_to_numpy(tst2.m), jax_to_numpy(jst2.m), 1e-4, "m")
        return
    # compression on: JAX's codec and update over the port's gradients
    tg_np = params_to_numpy(tg)
    jg_same = jax.tree.map(jnp.asarray, tg_np)
    jp3, jst3, jn3 = jopt.update(jcomp.compress_decompress(jg_same),
                                 jopt.init(jp), jp)
    _close(params_to_numpy(tst2.m), jax_to_numpy(jst3.m), 1e-6, "m")
    _close(params_to_numpy(tst2.v), jax_to_numpy(jst3.v), 1e-6, "v")
    _close(params_to_numpy(tp2), jax_to_numpy(jp3), 1e-6, "params")
    assert abs(float(tm["grad_norm"]) - float(jn3)) <= 1e-6 * float(jn3)


def test_serve_and_prefill_steps_are_the_models(qwen_case):
    _, tcfg, _, tp, batch = qwen_case
    model = tget_model(tcfg)
    toks = torch.from_numpy(batch["tokens"][:2, :8])
    with torch.no_grad():
        c1 = model.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
        c2 = model.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
        a, c1 = tstep.make_prefill_step(tcfg, model)(tp, c1, toks)
        b, c2 = model.prefill(tcfg, tp, c2, toks)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        nxt = a[:, -1].argmax(-1)[:, None]
        a, _ = tstep.make_serve_step(tcfg, model)(tp, c1, nxt)
        b, _ = model.decode_step(tcfg, tp, c2, nxt)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# AdamW on identical gradients
# ---------------------------------------------------------------------------


def _adamw_tree(rng):
    return {"w": rng.normal(0, 0.05, (24, 40)).astype(np.float32),
            "stack": rng.normal(0, 0.05, (3, 8, 16)).astype(np.float32),
            "gamma": np.ones(40, np.float32),
            "b": {"bias": rng.normal(0, 0.01, (16,)).astype(np.float32)}}


@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_adamw_update_matches_jax(grad_clip):
    rng = np.random.default_rng(0)
    p = _adamw_tree(rng)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
              grad_clip=grad_clip)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(3e-3, 2, 6), **kw)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(3e-3, 2, 6), **kw)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(6):
        # norms of 4-12: clipping acts at every step where it is on
        g = jax.tree.map(lambda a: (rng.normal(0, 0.4, a.shape)
                                    * (1 + step)).astype(np.float32), p)
        jp, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst, tn = topt.update(params_from_numpy(g, "cpu"), tst, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert int(tst.count) == int(jst.count) == step + 1
        assert tst.count.dtype == torch.int32
        _close(params_to_numpy(tp), jax_to_numpy(jp), 1e-6, f"params {step}")
        _close(params_to_numpy(tst.m), jax_to_numpy(jst.m), 1e-6, f"m {step}")
        _close(params_to_numpy(tst.v), jax_to_numpy(jst.v), 1e-6, f"v {step}")


def test_adamw_keeps_the_leaf_dtype_and_decays_matrices_only():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "g": torch.ones(4)}
    opt = tadamw.AdamW(lr=0.1, weight_decay=0.5, grad_clip=None)
    zero = map_with_path(lambda _, t: torch.zeros_like(t), p)
    p2, st, gn = opt.update(zero, opt.init(p), p)
    assert p2["w"].dtype == torch.bfloat16 and float(gn) == 0.0
    assert float(p2["w"][0, 0]) == pytest.approx(1 - 0.1 * 0.5, abs=1e-2)
    assert float(p2["g"][0]) == 1.0                       # no decay on 1-D
    assert st.m["w"].dtype == torch.float32


def test_cosine_schedule_and_global_norm_match_jax():
    jlr = jadamw.cosine_schedule(1e-3, 10, 100)
    tlr = tadamw.cosine_schedule(1e-3, 10, 100)
    for c in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jlr(jnp.asarray(c, jnp.int32)))
        got = float(tlr(torch.tensor(c, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1e-12), (c, got, want)
    p = _adamw_tree(np.random.default_rng(1))
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, p)))
    got = float(tadamw.global_norm(params_from_numpy(p, "cpu")))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# gradient compression, bit for bit
# ---------------------------------------------------------------------------


def _grads(rng):
    g = {"a": rng.normal(0, 1e-3, (64, 64)).astype(np.float32),
         "tail": rng.normal(0, 1.0, (3, 100)).astype(np.float32),  # 300
         "zeros": np.zeros((257,), np.float32),
         "ties": np.repeat(np.float32([0.5, -0.5, 0.25, 2.5]), 64)}
    g["a"][0, :7] = [0.0, 1.5, -1.5, 127.5, -127.5, 3e-40, -0.0]
    return g


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_compress_decompress_is_bit_identical_to_jaxs():
    g = _grads(np.random.default_rng(0))
    want = jcomp.compress_decompress(jax.tree.map(jnp.asarray, g))
    got = tcomp.compress_decompress(params_from_numpy(g, "cpu"))
    for k in g:
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(np.asarray(want[k])), err_msg=k)
    rel = float(np.linalg.norm(got["a"].numpy() - g["a"])
                / np.linalg.norm(g["a"]))
    assert rel < 0.02


@pytest.mark.parametrize("k_ratio", [0.1, 0.25, 0.01])
def test_compress_with_feedback_is_bit_identical_to_jaxs(k_ratio):
    rng = np.random.default_rng(1)
    g = _grads(rng)
    res = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
           for k, v in g.items()}
    jc, jr = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                          jax.tree.map(jnp.asarray, res),
                                          k_ratio)
    tg, tr = params_from_numpy(g, "cpu"), params_from_numpy(res, "cpu")
    tc, tres = tcomp.compress_with_feedback(tg, tr, k_ratio)
    for k in g:
        np.testing.assert_array_equal(_bits(tc[k].numpy()),
                                      _bits(np.asarray(jc[k])), err_msg=k)
        np.testing.assert_array_equal(_bits(tres[k].numpy()),
                                      _bits(np.asarray(jr[k])), err_msg=k)
        # the residual holds exactly what the wire dropped
        np.testing.assert_array_equal((tc[k] + tres[k]).numpy(),
                                      (tg[k] + tr[k]).numpy())
    z = tcomp.init_residual(tg)
    assert all(not z[k].any() and z[k].shape == tg[k].shape for k in g)


def test_ties_at_the_threshold_are_kept():
    v = torch.tensor([3.0, -2.0, 2.0, 1.0, 2.0, 0.5, -2.0, 0.0])
    comp, res = tcomp.compress_with_feedback({"v": v}, {"v": torch.zeros(8)},
                                             k_ratio=0.25)  # k = 2
    jc, _ = jcomp.compress_with_feedback({"v": jnp.asarray(v.numpy())},
                                         {"v": jnp.zeros(8)}, 0.25)
    np.testing.assert_array_equal(comp["v"].numpy(), np.asarray(jc["v"]))
    assert comp["v"].tolist() == [3.0, -2.0, 2.0, 0.0, 2.0, 0.0, -2.0, 0.0]

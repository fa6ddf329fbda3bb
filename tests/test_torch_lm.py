"""The port's token path against the JAX package on a wide test config:
qwen1.5-0.5b at its published widths (d_model 1024, 16 heads x 64, d_ff
2816, QKV bias, rope_theta 1e6) cut to 2 layers and a 1024-token vocab,
in f32.  d_model > 256, so every quantization decision is the one full
width takes: at the decode deployment shape (2 tokens per step) every
dense leaf is 4-bit, the stacked layers are ``axis == 2`` QUniform leaves
(the plain ``x @ dequant`` path in both packages) and only ``lm_head``
reaches a kernel (``int4_matmul``).

Both packages quantize the same JAX-initialised float weights from the
same synthesized calibration prompts, under ``m2q-w8a8`` and
``w4-weights-only``.  Then the JAX-quantized tree is carried across and
run through the port's forward, prefill and int8-KV decode, against
JAX's dispatch-off XLA paths."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.models import dense_lm as jlm
from repro_torch import kernels
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.qtensor import QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import dense_lm as tlm
from torch_parity import jax_to_numpy

WIDE = dict(n_layers=2, vocab_size=1024, dtype="float32")
JCFG = JARCHS["qwen1.5-0.5b"].replace(**WIDE)
TCFG = TARCHS["qwen1.5-0.5b"].replace(**WIDE)
RECIPES = ["m2q-w8a8", "w4-weights-only"]
# teacher-forced decode: 2 ragged prompts, then 8 steps
PROMPT_LENS = np.array([11, 16], np.int32)
N_STEPS = 8
MAX_LEN = 32


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


@functools.lru_cache(maxsize=None)
def _float_params():
    return jax.jit(lambda k: jlm.init(JCFG, k))(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _quantized(name):
    """(JAX QuantizedModel, the port's QuantizedModel) of one recipe."""
    params = _float_params()
    with _off():
        jqm = jr.quantize(JCFG, params, name)
    tqm = tr.quantize(TCFG, params_from_numpy(jax_to_numpy(params), "cpu"),
                      name)
    return jqm, tqm


@pytest.fixture(scope="module", params=RECIPES)
def pair(request):
    return _quantized(request.param)


def test_quantized_leaves_match_jax(pair):
    """Every leaf has the JAX leaf's class and fields, payload bytes,
    scales and zero points bit for bit; the stacked layers keep
    ``axis == 2`` and the embedding ``axis == 0``."""
    jqm, tqm = pair
    ours = dict(leaves_with_path(params_to_numpy(tqm.params)))
    theirs = dict(leaves_with_path(jax_to_numpy(jqm.params)))
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key
    leaves = dict(leaves_with_path(tqm.params))
    assert leaves["embed"].axis == 0 and leaves["lm_head"].axis == 1
    for path in ("layers/attn/wq", "layers/mlp/w2"):
        leaf = leaves[path]
        assert isinstance(leaf, QUniform) and leaf.bits == 4
        assert leaf.axis == 2 and leaf.payload.ndim == 3


def test_reports_and_stats_match_jax(pair):
    """Reports agree field for field (mse to rel 1e-4); the activation
    stats carry the per-layer ``'<path>@<i>'`` keys of the unrolled
    calibration and agree to f32 summation noise (rtol 1e-5)."""
    jqm, tqm = pair
    jrep = {r.path: r for r in jqm.report}
    assert [r.path for r in tqm.report] == list(jrep)
    for r in tqm.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.shape, r.bits) == \
            (j.kind, j.decision, tuple(j.shape), j.bits), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    assert sorted(tqm.act_stats) == sorted(jqm.act_stats)
    if jqm.recipe.policy.quantize_activations:
        assert "layers/attn/wq@1" in tqm.act_stats
        assert "lm_head" in tqm.act_stats
        for k, v in jqm.act_stats.items():
            assert tqm.act_stats[k] == pytest.approx(v, rel=1e-5), k
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step == 2
    assert tqm.provenance == jqm.provenance


@functools.lru_cache(maxsize=None)
def _carried():
    """The JAX m2q-w8a8 tree in both packages, and the int8-KV config."""
    jqm, _ = _quantized("m2q-w8a8")
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


def test_carried_forward_matches_jax():
    """The port's forward on the JAX-quantized tree against JAX's
    dispatch-off forward: all f32 with weights dequantized exactly, so only
    summation order differs (1e-5 of max |logit|); ``lm_head`` is the one
    kernel leaf, and it is called once."""
    jparams, tparams = _carried()
    tokens = np.random.default_rng(3).integers(0, JCFG.vocab_size, (2, 16),
                                               dtype=np.int32)
    with _off():
        want = np.asarray(jax.jit(lambda p, t: jlm.forward(JCFG, p, t))(
            jparams, jnp.asarray(tokens)))
    kernels.reset_counts()
    with torch.inference_mode():
        got = tlm.forward(TCFG, tparams, torch.from_numpy(tokens)).numpy()
    plain = {k: c["plain_calls"] for k, c in kernels.counts().items()
             if c["plain_calls"]}
    assert plain == {"int4_matmul": 1}
    assert got.shape == (2, 16, TCFG.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _teacher_forced():
    """Ragged prefill + N_STEPS teacher-forced int8-KV decode steps in both
    packages: (jax logits, port logits, jax cache, port cache, plain
    calls of the port's decode steps)."""
    jparams, tparams = _carried()
    jcfg = JCFG.replace(kv_cache_dtype="int8")
    tcfg = TCFG.replace(kv_cache_dtype="int8")
    rng = np.random.default_rng(4)
    S = int(PROMPT_LENS.max())
    prompts = rng.integers(0, JCFG.vocab_size, (2, S), dtype=np.int32)
    forced = rng.integers(0, JCFG.vocab_size, (N_STEPS, 2), dtype=np.int32)

    with _off():
        prefill = jax.jit(lambda p, c, t, n: jlm.prefill(jcfg, p, c, t,
                                                         lengths=n))
        step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
        cache = jlm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32)
        lg, cache = prefill(jparams, cache, jnp.asarray(prompts),
                            jnp.asarray(PROMPT_LENS))
        jlogits = [np.asarray(lg[:, 0])]
        for t in forced:
            lg, cache = step(jparams, cache, jnp.asarray(t[:, None]))
            jlogits.append(np.asarray(lg[:, 0]))
        jcache = {k: np.asarray(v) for k, v in cache.items()}

    tcache = tlm.init_cache(tcfg, 2, MAX_LEN, dtype=torch.float32,
                            device="cpu")
    with torch.inference_mode():
        lg, tcache = tlm.prefill(tcfg, tparams, tcache,
                                 torch.from_numpy(prompts).long(),
                                 lengths=torch.from_numpy(PROMPT_LENS))
        tlogits = [lg[:, 0].numpy()]
        kernels.reset_counts()
        for t in forced:
            lg, tcache = tlm.decode_step(tcfg, tparams, tcache,
                                         torch.from_numpy(t[:, None]).long())
            tlogits.append(lg[:, 0].numpy())
        plain = {k: c["plain_calls"] for k, c in kernels.counts().items()
                 if c["plain_calls"]}
    return (np.stack(jlogits), np.stack(tlogits), jcache,
            {k: v.numpy() for k, v in tcache.items()}, plain)


# Each package writes its own int8 cache from f32 rows that differ by an
# ulp, so a few codes sit one step apart (measured: under 1e-4 of the
# prefill codes, under 1e-2 of the decode rows of the second layer); one
# flipped code moves a logit by ~1e-3 of the largest.  5e-3 of max |logit|
# admits a few flips a step and nothing larger.
DECODE_TOL = 5e-3


def test_prefill_and_teacher_forced_int8_decode_match_jax():
    jlog, tlog, _, _, plain = _teacher_forced()
    assert tlog.shape == jlog.shape == (N_STEPS + 1, 2, TCFG.padded_vocab)
    # each decode step: one decode_attn_int8 per layer and one lm_head
    assert plain == {"decode_attn_int8": N_STEPS * TCFG.n_layers,
                     "int4_matmul": N_STEPS}
    scale = np.abs(jlog).max()
    # the prefill logits (float attention) agree to f32 noise
    np.testing.assert_allclose(tlog[0], jlog[0], rtol=0, atol=1e-5 * scale)
    tol = DECODE_TOL * scale
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=tol)
    # the argmax agrees wherever JAX's top-2 margin exceeds the tolerance
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tlog.argmax(-1)[clear],
                                  jlog.argmax(-1)[clear])


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "bf16"])
def test_decode_step_from_jax_cache_matches_jax(kv_cache_dtype):
    """One decode step from the cache JAX's prefill wrote, in both
    packages: the int8 codes start equal, so the logits agree to f32
    noise (1e-5 of max |logit|) on the int8 cache and on the float one
    (``decode_attention``)."""
    jparams, tparams = _carried()
    jcfg = JCFG.replace(kv_cache_dtype=kv_cache_dtype)
    tcfg = TCFG.replace(kv_cache_dtype=kv_cache_dtype)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, JCFG.vocab_size, (2, 16), dtype=np.int32)
    tokens = rng.integers(0, JCFG.vocab_size, (2, 1), dtype=np.int32)
    with _off():
        cache = jlm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32)
        _, cache = jax.jit(lambda p, c, t, n: jlm.prefill(
            jcfg, p, c, t, lengths=n))(jparams, cache, jnp.asarray(prompts),
                                       jnp.asarray(PROMPT_LENS))
        tcache = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
        want, _ = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))(
            jparams, cache, jnp.asarray(tokens))
    want = np.asarray(want)
    with torch.inference_mode():
        got, _ = tlm.decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_int8_cache_contents_match_jax():
    """The int8 rows each package wrote: rows written at prefill carry f32
    noise only (scales rtol 1e-5); rows written by decode steps also
    inherit the upstream int8 attention's flips (rtol 1e-3).  Payload
    codes never differ by more than one step (see DECODE_TOL for the
    measured shares)."""
    _, _, jcache, tcache, _ = _teacher_forced()
    assert sorted(tcache) == sorted(jcache)
    np.testing.assert_array_equal(tcache["lengths"], jcache["lengths"])
    np.testing.assert_array_equal(tcache["lengths"],
                                  PROMPT_LENS + N_STEPS)
    pos = np.arange(MAX_LEN)[None, :]
    prefilled = (pos < PROMPT_LENS[:, None])[None, :, :, None]  # (1,B,T,1)
    for name in ("k_scale", "v_scale"):
        got, want = tcache[name], jcache[name]
        assert got.dtype == np.float32
        for rows, rtol in ((prefilled, 1e-5), (~prefilled, 1e-3)):
            rows = np.broadcast_to(rows, got.shape)
            np.testing.assert_allclose(got[rows], want[rows], rtol=rtol,
                                       atol=1e-12, err_msg=name)
    for name in ("k", "v"):
        assert tcache[name].dtype == np.int8
        diff = np.abs(tcache[name].astype(np.int32)
                      - jcache[name].astype(np.int32))
        assert diff.max() <= 1, name
        pre = np.broadcast_to(prefilled[..., None], diff.shape)
        assert diff[pre].mean() < 1e-3 and diff[~pre].mean() < 1e-2, name


def test_dense_lm_tree_crosses_both_ways():
    """The quantized dense-LM tree (float norms and biases, axis-0
    embedding, stacked axis-2 layers, 2-D head) survives numpy and back
    unchanged; a stacked leaf whose fields disagree with it raises."""
    _, tqm = _quantized("m2q-w8a8")
    tree = params_to_numpy(tqm.params)
    back = dict(leaves_with_path(params_to_numpy(params_from_numpy(
        tree, "cpu"))))
    for key, want in leaves_with_path(tree):
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(back[key], want, err_msg=key)
        else:
            assert back[key] == want, key
    for path, field, bad in [
            ("wq", "scale", lambda a: a[:, :, :-1]),
            ("wq", "payload", lambda a: a[:1]),
            ("wq", "act_scale", lambda a: np.ones((2,), np.float32)),
            ("wq", "axis", lambda a: 1)]:
        t = params_to_numpy(tqm.params)
        leaf = t["layers"]["attn"][path]
        leaf[field] = bad(leaf[field])
        with pytest.raises((TypeError, ValueError)):
            params_from_numpy(t, "cpu")
    t = params_to_numpy(tqm.params)
    t["embed"]["scale"] = t["embed"]["scale"].reshape(1, -1)
    with pytest.raises(ValueError):
        params_from_numpy(t, "cpu")

"""The dense LM pool against the JAX package: qwen3-14b (qk_norm, GQA
G = 5), granite-3-8b (G = 4, a padded vocab), minitron-4b (G = 3, the
squared-ReLU FFN) and internvl2-2b (G = 2, a padded vocab, the stub
frontend's patch prefix), each at its REDUCED config (2 layers, d_model
64-96, f32), from the JAX package's float init at ``PRNGKey(0)``.

Every REDUCED config is a narrow LM (d_model <= 256), so ``m2q-w8a8``
takes the mixed LM path through the taxonomy overrides in both packages:
stacked ``QExpertM2Q`` layers, the FFN group perm-folded (swiglu: w1 and
w3; relu2: w1 alone, ``(w1, None, w2)``), a mixed lm_head.
``w4-weights-only`` makes every leaf 4-bit.  The JAX package runs with
dispatch off (its XLA QTensor paths); the port runs its plain kernel
versions."""
import dataclasses
import functools
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import REDUCED as JREDUCED
from repro.core import apply as japply
from repro.kernels import ops as jops
from repro.models import dense_lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch import kernels, nn
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import apply as tapply
from repro_torch.core.qtensor import QExpertM2Q, QM2Q, QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import dense_lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          done_tokens, jax_to_numpy, lm_prompts, manifest,
                          numpy_to_jax, same_numpy)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 10, rehearsed at REDUCED width)

NAMES = ["qwen3-14b", "granite-3-8b", "minitron-4b", "internvl2-2b"]
RECIPES = ["m2q-w8a8", "w4-weights-only"]
# the GQA group n_heads / n_kv_heads of each REDUCED config (the published
# configs' are 5, 4, 3 and 2 too)
GROUPS = {"qwen3-14b": 5, "granite-3-8b": 4, "minitron-4b": 3,
          "internvl2-2b": 2}
# teacher-forced decode: 2 ragged prompts, then 6 steps
PROMPT_LENS = np.array([9, 14], np.int32)
N_STEPS = 6
MAX_LEN = 48
# f32 through 2 layers: the two packages differ by summation order only
FLOAT_TOL = 1e-5


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


@functools.lru_cache(maxsize=None)
def _float_params(name):
    """JAX's float init of the REDUCED config, and its numbers as the
    port's CPU tree."""
    cfg = JREDUCED[name]
    params = jax.jit(lambda k: jlm.init(cfg, k))(jax.random.PRNGKey(0))
    return params, params_from_numpy(jax_to_numpy(params), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_quantized():
    """JAX's QuantizedModel of every (config, recipe); the eight run in
    threads (each eager op compiles one XLA program, and the compiles
    overlap)."""
    pairs = [(n, r) for n in NAMES for r in RECIPES]

    def run(pair):
        with _off():
            return jr.quantize(JREDUCED[pair[0]], _float_params(pair[0])[0],
                               pair[1])
    with ThreadPoolExecutor(len(pairs)) as pool:
        return dict(zip(pairs, pool.map(run, pairs)))


@functools.lru_cache(maxsize=None)
def _quantized(name, rec):
    """(JAX QuantizedModel, the port's) of one config and recipe, both
    from the same float weights and synthesized calibration prompts."""
    tparams = params_from_numpy(jax_to_numpy(_float_params(name)[0]), "cpu")
    return (_jax_quantized()[name, rec],
            tr.quantize(TREDUCED[name], tparams, rec))


@functools.lru_cache(maxsize=None)
def _carried(name, rec="m2q-w8a8"):
    """The JAX-quantized tree in both packages."""
    jqm, _ = _quantized(name, rec)
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


def _plain_calls():
    return {k: c["plain_calls"] for k, c in kernels.counts().items()
            if c["plain_calls"]}


def _tokens(name, shape, seed):
    return np.random.default_rng(seed).integers(
        0, TREDUCED[name].vocab_size, shape, dtype=np.int32)


# ---------------------------------------------------------------------------
# configs and the float model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registry_resolves_both_names_like_jax(name):
    """The full and REDUCED names resolve to the JAX package's configs,
    field for field; ``get_config`` / ``get_reduced`` / ``list_archs``
    agree; the GQA group is what this file says."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    for ours, theirs in ((tr.resolve_cfg(name), jr._resolve_cfg(name)),
                         (tr.resolve_cfg(f"{name}-reduced"),
                          jr._resolve_cfg(f"{name}-reduced")),
                         (treg.get_config(name), jreg.get_config(name)),
                         (treg.get_reduced(name), jreg.get_reduced(name))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert name in treg.list_archs()
    cfg = TARCHS[name]
    assert cfg.n_heads // cfg.n_kv_heads == GROUPS[name]
    red = TREDUCED[name]
    assert red.n_heads // red.n_kv_heads == GROUPS[name]


@pytest.mark.parametrize("name", NAMES)
def test_float_forward_matches_jax(name):
    """The port's forward on JAX's float weights (qk_norm gammas, the
    relu2 FFN without w3) against JAX's, to 1e-5 of max |logit|."""
    jparams, tparams = _float_params(name)
    cfg = TREDUCED[name]
    leaves = dict(leaves_with_path(tparams))
    assert ("layers/attn/q_gamma" in leaves) == cfg.qk_norm
    assert ("layers/mlp/w3" in leaves) == (cfg.ffn == "swiglu")
    tokens = _tokens(name, (2, 12), 3)
    want = np.asarray(jax.jit(lambda p, t: jlm.forward(JREDUCED[name], p, t))(
        jparams, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tlm.forward(cfg, tparams, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOAT_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["qwen3-14b", "minitron-4b"])
def test_init_fills_stacked_leaves_with_the_draws_of_a_stack(name):
    """``init`` fills each stacked leaf layer by layer (the tree never
    holds a leaf twice): the same draws in the same order as stacking L
    draws, leaf for leaf, bit for bit."""
    cfg = TREDUCED[name]
    got = dict(leaves_with_path(tlm.init(cfg, seed=3, device="cpu")))
    g = nn.generator(3, torch.device("cpu"))
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    shapes = {"wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim),
              "wv": (D, cfg.kv_dim), "wo": (cfg.q_dim, D)}
    want = {f"layers/attn/{k}": torch.stack(
        [nn.lecun_normal(s, g, "cpu") for _ in range(L)])
        for k, s in shapes.items()}
    ffn = ("w1", "w2") if cfg.ffn == "relu2" else ("w1", "w3", "w2")
    for k in ffn:
        s = (F, D) if k == "w2" else (D, F)
        want[f"layers/mlp/{k}"] = torch.stack(
            [nn.lecun_normal(s, g, "cpu") for _ in range(L)])
    want["embed"] = nn.trunc_normal((cfg.padded_vocab, D), g, "cpu")
    want["lm_head"] = nn.lecun_normal((D, cfg.padded_vocab), g, "cpu")
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_internvl2_prefix_forward_matches_jax():
    """internvl2's patch prefix (``n_patches`` embeddings ahead of the
    tokens, positions over both) through the port's forward on JAX's
    float weights: logits (B, P + S, padded_vocab) within 1e-5 of max
    |logit| of JAX's, and not the text-only forward's."""
    name = "internvl2-2b"
    cfg = TREDUCED[name]
    jparams, tparams = _float_params(name)
    tokens = _tokens(name, (2, 10), 4)
    prefix = np.random.default_rng(5).normal(
        0, 1, (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, t, e: jlm.forward(JREDUCED[name], p, t, prefix_embeds=e))(
            jparams, jnp.asarray(tokens), jnp.asarray(prefix)))
    with torch.inference_mode():
        got = tlm.forward(cfg, tparams, torch.from_numpy(tokens),
                          prefix_embeds=torch.from_numpy(prefix)).numpy()
        text = tlm.forward(cfg, tparams, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, cfg.n_patches + 10, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOAT_TOL * np.abs(want).max())
    assert not np.allclose(got[:, cfg.n_patches:], text, atol=1e-3)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_internvl2_prefix_prefill_and_decode_match_jax(kv):
    """A ragged prefill of prefix + prompt (lengths count the prefix) on
    the JAX-quantized m2q-w8a8 tree, then 4 teacher-forced decode steps:
    the prefill's logits within 1e-5 of max |logit| of JAX's, the cache
    lengths equal, the decode logits within the decode bounds below."""
    name = "internvl2-2b"
    jcfg = JREDUCED[name].replace(kv_cache_dtype=kv)
    tcfg = TREDUCED[name].replace(kv_cache_dtype=kv)
    jparams, tparams = _carried(name)
    P = tcfg.n_patches
    prompts = _tokens(name, (2, 12), 6)
    lens = np.array([P + 7, P + 12], np.int32)
    prefix = np.random.default_rng(7).normal(
        0, 1, (2, P, tcfg.d_model)).astype(np.float32)
    forced = _tokens(name, (4, 2), 8)
    with _off():
        cache = jlm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32)
        lg, cache = jax.jit(lambda p, c, t, e, n: jlm.prefill(
            jcfg, p, c, t, prefix_embeds=e, lengths=n))(
                jparams, cache, jnp.asarray(prompts), jnp.asarray(prefix),
                jnp.asarray(lens))
        want = [np.asarray(lg[:, 0])]
        jlens = np.asarray(cache["lengths"])
        step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
        for t in forced:
            lg, cache = step(jparams, cache, jnp.asarray(t[:, None]))
            want.append(np.asarray(lg[:, 0]))
    tcache = tlm.init_cache(tcfg, 2, MAX_LEN, dtype=torch.float32,
                            device="cpu")
    with torch.inference_mode():
        lg, tcache = tlm.prefill(tcfg, tparams, tcache,
                                 torch.from_numpy(prompts).long(),
                                 prefix_embeds=torch.from_numpy(prefix),
                                 lengths=torch.from_numpy(lens))
        got = [lg[:, 0].numpy()]
        np.testing.assert_array_equal(tcache["lengths"].numpy(), jlens)
        for t in forced:
            lg, tcache = tlm.decode_step(tcfg, tparams, tcache,
                                         torch.from_numpy(t[:, None]).long())
            got.append(lg[:, 0].numpy())
    _decode_agrees(np.stack(want), np.stack(got), DECODE_TOL["m2q-w8a8"])


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rec", RECIPES)
@pytest.mark.parametrize("name", NAMES)
def test_quantized_leaves_match_jax(name, rec):
    """Every leaf has the JAX leaf's class and static fields; payload
    bytes, scales and zero points are equal bit for bit.  The activation
    scales come from each package's own float calibration forward, so
    they agree to f32 summation-order noise (rtol 1e-5)."""
    jqm, tqm = _quantized(name, rec)
    ours = dict(leaves_with_path(params_to_numpy(tqm.params)))
    theirs = dict(leaves_with_path(jax_to_numpy(jqm.params)))
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if key.endswith("/act_scale") and want is not None:
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key


@pytest.mark.parametrize("rec", RECIPES)
@pytest.mark.parametrize("name", NAMES)
def test_reports_schemes_and_stats_match_jax(name, rec):
    """Reports agree field for field in JAX's order -- decisions and the
    per-leaf uniform / APoT split (the scheme assignment) exactly, mse to
    rel 1e-4; the per-layer ``'<path>@<i>'`` stats to rtol 1e-5; the
    m2q splits, the deployment shape and the provenance equal."""
    jqm, tqm = _quantized(name, rec)
    jrep = {r.path: r for r in jqm.report}
    assert [r.path for r in tqm.report] == list(jrep)
    for r in tqm.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.shape, r.bits, r.n_uniform,
                r.n_apot) == (j.kind, j.decision, tuple(j.shape), j.bits,
                              j.n_uniform, j.n_apot), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    assert tqm.m2q_splits() == jqm.m2q_splits()
    assert sorted(tqm.act_stats) == sorted(jqm.act_stats)
    for k, v in jqm.act_stats.items():
        assert tqm.act_stats[k] == pytest.approx(v, rel=1e-5), k
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step == 2
    assert tqm.provenance == jqm.provenance


@pytest.mark.parametrize("name", NAMES)
def test_leaf_kinds_of_each_ffn(name):
    """m2q-w8a8: stacked QExpertM2Q wq/wk/wv/wo/w2, the FFN group
    perm-folded -- swiglu's w1 and w3, relu2's w1 alone -- a mixed
    lm_head; qk_norm's gammas stay float.  w4-weights-only: every leaf a
    4-bit QUniform."""
    cfg = TREDUCED[name]
    _, tqm = _quantized(name, "m2q-w8a8")
    leaves = dict(leaves_with_path(tqm.params))
    folded = {r.path for r in tqm.report
              if r.decision == "mixed(perm-folded)"}
    want = {"layers/mlp/w1"} | (set() if cfg.ffn == "relu2"
                                else {"layers/mlp/w3"})
    assert folded == want
    for p in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w2"):
        assert isinstance(leaves[f"layers/{p}"], QExpertM2Q), p
    assert type(leaves["layers/mlp/w1"]) is QM2Q
    assert type(leaves["lm_head"]) is QM2Q
    if cfg.qk_norm:
        assert isinstance(leaves["layers/attn/q_gamma"], torch.Tensor)
    _, w4 = _quantized(name, "w4-weights-only")
    for r in w4.report:
        leaf = dict(leaves_with_path(w4.params))[r.path]
        assert isinstance(leaf, QUniform) and leaf.bits == 4, r.path


def test_relu2_group_folds_like_jax():
    """``_joint_group_quantize(w1, None, w2)`` on REDUCED minitron's float
    weights in both packages: the folded w1's bytes and scales, and w2's
    permuted float rows, equal JAX's bit for bit."""
    params, _ = _float_params("minitron-4b")
    mlp = {k: np.array(v) for k, v in params["layers"]["mlp"].items()}
    assert sorted(mlp) == ["w1", "w2"]
    with _off():
        jup, jgate, jdown = japply._joint_group_quantize(
            jnp.asarray(mlp["w1"]), None, jnp.asarray(mlp["w2"]), None)
    tup, tgate, tdown = tapply._joint_group_quantize(
        torch.from_numpy(mlp["w1"]), None, torch.from_numpy(mlp["w2"]), None)
    assert jgate is None and tgate is None
    same_numpy(params_to_numpy({"w": tup}), jax_to_numpy({"w": jup}))
    np.testing.assert_array_equal(tdown.numpy(), np.asarray(jdown))


@pytest.mark.parametrize("name", ["qwen3-14b", "minitron-4b"])
@pytest.mark.parametrize("rec", RECIPES)
def test_release_quantizes_the_same_bytes(name, rec):
    """``quantize(..., release=True)`` -- each float leaf dropped from the
    caller's tree once its QTensor exists, what lets qwen3-14b quantize
    on the card -- gives the tree, reports and stats of quantizing with
    the whole float tree held; the released tree keeps only the leaves
    that stay float.  The whole-tree model is the one the other tests
    share (``_quantized``); the released one quantizes a fresh copy of the
    same float numbers."""
    cfg = TREDUCED[name]
    whole = _quantized(name, rec)[1]
    params = params_from_numpy(jax_to_numpy(_float_params(name)[0]), "cpu")
    released = tr.quantize(cfg, params, rec, release=True)
    same_numpy(params_to_numpy(released.params),
               params_to_numpy(whole.params))
    assert released.report == whole.report
    assert released.act_stats == whole.act_stats
    left = {k for k, v in leaves_with_path(params) if v is not None}
    assert left == {k for k, v in leaves_with_path(whole.params)
                    if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("kind", ["uniform4", "uniform8", "apot", "m2q"])
def test_stacked_leaf_one_layer_at_a_time_equals_the_whole(kind):
    """``_quantize_stacked`` (one layer at a time) against
    ``_quantize_leaf`` on the whole (3, 48, 40) leaf: every field bit for
    bit; ``_mse`` (layer by layer) against ``mean((w - dequant)^2)``
    exactly."""
    from repro_torch.core import policy as pol
    w = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.1, (3, 48, 40)).astype(np.float32))
    ams = np.array([1.5, 2.0, 0.5], np.float32).reshape(3, 1, 1)
    p, decision = {
        "uniform4": (pol.M2QPolicy(memory_bits=4), pol.DECISION_LOWBIT),
        "uniform8": (pol.M2QPolicy(compute_scheme="uniform8"),
                     pol.DECISION_MIXED),
        "apot": (pol.M2QPolicy(compute_scheme="apot"), pol.DECISION_MIXED),
        "m2q": (pol.M2QPolicy(), pol.DECISION_MIXED)}[kind]
    a = tapply._quantize_leaf(w, pol.KIND_DENSE, decision, p, ams)
    b = tapply._quantize_stacked(w, pol.KIND_DENSE, decision, p, ams)
    same_numpy(params_to_numpy({"w": b}), params_to_numpy({"w": a}))
    want = float(torch.mean((w - a.dequant()) ** 2))
    assert tapply._mse(w, b) == want


@pytest.mark.parametrize("chunk", [1, 7, 1 << 26])
@pytest.mark.parametrize("kind", ["embed", "uniform4", "apot", "m2q"])
def test_mse_in_row_blocks_equals_the_whole(kind, chunk, monkeypatch):
    """``_mse`` dequantizes a 2-D leaf a block of rows at a time (the
    per-row scales of an axis-0 embedding sliced with them, per-filter
    scales kept) and gives ``mean((w - dequant)^2)`` exactly, at any
    block size."""
    from repro_torch.core.qtensor import QAPoT
    from repro_torch.core.scheme_select import select_schemes
    w = torch.from_numpy(np.random.default_rng(9).normal(
        0, 0.1, (37, 40)).astype(np.float32))
    if kind == "embed":
        qt = QUniform.quantize(w, bits=4, axis=0)
    elif kind == "uniform4":
        qt = QUniform.quantize(w, bits=4)
    elif kind == "apot":
        qt = QAPoT.quantize(w)
    else:
        asn = select_schemes(w)
        qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx)
    want = float(torch.mean((w - qt.dequant()) ** 2))
    monkeypatch.setattr(tapply, "MSE_CHUNK", chunk)
    assert tapply._mse(w, qt) == want


# ---------------------------------------------------------------------------
# the JAX-quantized tree through the port's prefill and int8 decode
# ---------------------------------------------------------------------------


# Each package writes its int8 cache rows, and (m2q-w8a8) quantizes the
# next layer's activations, from f32 sums run in different orders; where a
# value sits on an int8 rounding step one code differs, and a flipped
# cache code stays in its row, so every later logit of that row moves.
# The bounds are the single-model tests' (tests/test_torch_lm.py: 5e-3 of
# max |logit| for the 4-bit tree, whose one flipped code moves a logit by
# ~1e-3 of it; tests/test_torch_lm_m2q.py: 5e-2 where an activation code
# of a mixed layer can flip too); the argmax agrees wherever JAX's top-2
# margin exceeds twice the difference.
DECODE_TOL = {"m2q-w8a8": 5e-2, "w4-weights-only": 5e-3}


def _decode_agrees(want, got, tol):
    scale = np.abs(want).max()
    assert got.shape == want.shape
    # the prefill logits (float attention) agree to f32 noise
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=FLOAT_TOL * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    off = np.abs(got - want).max(-1)   # (steps + 1, rows)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * off
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("rec", RECIPES)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_teacher_forced_int8_decode_match_jax(name, rec):
    """Ragged prefill + 6 teacher-forced int8-KV decode steps on the
    JAX-quantized tree in both packages (GQA at each config's group,
    qk_norm on both paths); each decode step launches (here: calls the
    plain version of) decode_attn_int8 once a layer and the lm_head's
    kernel once."""
    jcfg = JREDUCED[name].replace(kv_cache_dtype="int8")
    tcfg = TREDUCED[name].replace(kv_cache_dtype="int8")
    jparams, tparams = _carried(name, rec)
    S = int(PROMPT_LENS.max())
    prompts = _tokens(name, (2, S), 4)
    forced = _tokens(name, (N_STEPS, 2), 5)
    with _off():
        cache = jlm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32)
        lg, cache = jax.jit(lambda p, c, t, n: jlm.prefill(
            jcfg, p, c, t, lengths=n))(jparams, cache, jnp.asarray(prompts),
                                       jnp.asarray(PROMPT_LENS))
        want = [np.asarray(lg[:, 0])]
        step = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t))
        for t in forced:
            lg, cache = step(jparams, cache, jnp.asarray(t[:, None]))
            want.append(np.asarray(lg[:, 0]))
    tcache = tlm.init_cache(tcfg, 2, MAX_LEN, dtype=torch.float32,
                            device="cpu")
    with torch.inference_mode():
        lg, tcache = tlm.prefill(tcfg, tparams, tcache,
                                 torch.from_numpy(prompts).long(),
                                 lengths=torch.from_numpy(PROMPT_LENS))
        got = [lg[:, 0].numpy()]
        kernels.reset_counts()
        for t in forced:
            lg, tcache = tlm.decode_step(tcfg, tparams, tcache,
                                         torch.from_numpy(t[:, None]).long())
            got.append(lg[:, 0].numpy())
        plain = _plain_calls()
    L = tcfg.n_layers
    head = "m2q_matmul" if rec == "m2q-w8a8" else "int4_matmul"
    per_step = {"decode_attn_int8": L,
                head: 5 * L + 1 if rec == "m2q-w8a8" else 1}
    assert plain == {k: N_STEPS * v for k, v in per_step.items()}
    _decode_agrees(np.stack(want), np.stack(got), DECODE_TOL[rec])


# ---------------------------------------------------------------------------
# trees and artifacts across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_trees_cross_both_ways(name):
    """The float tree (qk_norm's q_gamma / k_gamma, an mlp without w3) and
    both quantized trees cross JAX -> port -> numpy unchanged, and the
    port's own quantized tree crosses to JAX, whose dispatch-off forward
    of it equals the port's within 1e-5 of max |logit|."""
    jparams, tparams = _float_params(name)
    same_numpy(params_to_numpy(tparams), jax_to_numpy(jparams))
    for rec in RECIPES:
        jqm, tqm = _quantized(name, rec)
        same_numpy(params_to_numpy(params_from_numpy(
            jax_to_numpy(jqm.params), "cpu")), jax_to_numpy(jqm.params))
        back = numpy_to_jax(params_to_numpy(tqm.params))
        tokens = _tokens(name, (2, 8), 9)
        with _off():
            want = np.asarray(jax.jit(
                lambda p, t: jlm.forward(JREDUCED[name], p, t))(
                    back, jnp.asarray(tokens)))
        got = tqm.forward(tokens).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FLOAT_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_a_port_artifact_loads_in_jax_and_a_jax_artifact_in_the_port(
        name, tmp_path):
    """m2q-w8a8: the port's saved artifact loaded by the JAX package and
    JAX's by the port -- equal leaves and provenance (internvl2's
    ``n_patches`` carried in the config both ways), the same manifest
    when re-saved."""
    jqm, tqm = _quantized(name, "m2q-w8a8")
    pdir = tqm.save(tmp_path / "port")
    loaded_j = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(loaded_j.params), params_to_numpy(tqm.params))
    assert artifact_payload(loaded_j, "jax") == artifact_payload(tqm, "port")
    assert loaded_j.cfg.n_patches == TREDUCED[name].n_patches
    jdir = jqm.save(tmp_path / "jax")
    loaded_t = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    same_numpy(params_to_numpy(loaded_t.params), jax_to_numpy(jqm.params))
    assert artifact_payload(loaded_t, "port") == artifact_payload(jqm, "jax")
    assert loaded_t.cfg == TREDUCED[name]
    assert manifest(loaded_t.save(tmp_path / "port2")) == manifest(jdir)
    assert manifest(loaded_j.save(tmp_path / "jax2")) == manifest(pdir)


@pytest.mark.parametrize("toks", [2, 64])
@pytest.mark.parametrize("name", NAMES)
def test_abstract_twin_equals_jax_at_full_width(name, toks):
    """Each config at its published width under m2q-w8a8 at the decode
    shape (2 tokens a step: every leaf a 4-bit QUniform) and at 64 (the
    mixed LM: QExpertM2Q layers, the folded FFN group, a QM2Q lm_head),
    against JAX's ``abstract_quantize`` (meta tensors, nothing
    allocated): classes, static fields, shapes and dtypes equal."""
    ours = tr.abstract_quantize(name, recipe=tr.PRESETS["m2q-w8a8"].replace(
        tokens_per_step=toks))
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(jr.abstract_quantize(
        name, recipe=jr.PRESETS["m2q-w8a8"].replace(tokens_per_step=toks)))
    kinds = {k: v[0] for k, v in got.items() if v[0] != "float"}
    if toks == 2:
        assert set(kinds.values()) == {"QUniform"}
    else:
        folded = {"layers/mlp/w1"} | ({"layers/mlp/w3"}
                                      if TARCHS[name].ffn == "swiglu"
                                      else set())
        assert {k for k, v in kinds.items() if v == "QM2Q"} == \
            folded | {"lm_head"}
    assert got["lm_head"][1]["shape"] == (TARCHS[name].d_model,
                                          TARCHS[name].padded_vocab)


@pytest.mark.parametrize("name", NAMES)
def test_cfg_json_equals_the_jax_packages(name):
    """The artifact's config payload (``n_patches`` included) as JAX
    writes it, read back by either package."""
    cfg, jcfg = TREDUCED[name], JREDUCED[name]
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert tr._cfg_from_json(want) == cfg
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


# ---------------------------------------------------------------------------
# the token Engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_gqa_engine_tokens_equal_the_jax_engines(kv):
    """qwen3-14b REDUCED (G = 5, qk_norm) on JAX's float weights: both
    packages' engines (JAX's with every dispatch axis off) serve the same
    5 requests at ``max_batch`` 2 to the same tokens."""
    name = "qwen3-14b"
    jparams, tparams = _float_params(name)
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    kw = dict(max_batch=2, max_len=64)
    jeng = JEngine(JREDUCED[name].replace(kv_cache_dtype=kv), jparams,
                   dispatch=off, **kw)
    teng = TEngine(TREDUCED[name].replace(kv_cache_dtype=kv), tparams, **kw)
    prompts = lm_prompts(TREDUCED[name].vocab_size, 5, seed=2)
    reqs = {}
    for tag, eng in (("jax", jeng), ("port", teng)):
        reqs[tag] = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
    assert done_tokens(reqs["port"]) == done_tokens(reqs["jax"])
    toks = done_tokens(reqs["port"]).values()
    assert len(toks) == 5 and all(len(t) == 6 for t in toks)


@pytest.mark.parametrize("name", ["granite-3-8b", "internvl2-2b"])
def test_no_served_token_lies_in_the_padded_vocab(name):
    """granite's and internvl2's vocabularies are padded (387 -> 512, 493
    -> 512 at REDUCED; 49155 -> 49280, 92553 -> 92672 in full).  With the
    lm_head's pad columns made the largest logits, greedy and sampled
    requests still return only ids below ``vocab_size``."""
    cfg = TREDUCED[name]
    assert cfg.padded_vocab > cfg.vocab_size
    params = tlm.init(cfg, seed=0, device="cpu")
    params["lm_head"][:, cfg.vocab_size:] = 50.0
    eng = TEngine(cfg, params, max_batch=4, max_len=64, seed=1)
    reqs = [eng.submit(p, max_new_tokens=8, temperature=t)
            for p, t in zip(lm_prompts(cfg.vocab_size, 6, seed=3),
                            (0.0, 0.0, 0.8, 1.0, 2.0, 0.0))]
    eng.run()
    toks = [t for r in reqs for t in r.handle.result()]
    assert len(toks) == 48 and max(toks) < cfg.vocab_size


# ---------------------------------------------------------------------------
# chip_smoke's phase 10, rehearsed at REDUCED width on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_phase_10_decode_shape_serving_at_reduced_width(name):
    """``chip_smoke.lm_pool_case`` on the CPU at REDUCED width (plain
    versions, eager engines): it quantizes under m2q-w8a8 at the decode
    shape -- at REDUCED width the mixed path, so the launches it expects
    are the mixed LM's -- serves its requests and returns no problem."""
    res, problems = chip_smoke.lm_pool_case(
        torch, TREDUCED[name].replace(kv_cache_dtype="int8"), "decode",
        device="cpu", requests=4, max_new=4, max_len=64)
    assert problems == []
    assert res["served_tokens_max"] < TREDUCED[name].vocab_size
    assert res["teacher_forced_max_abs_diff"] == 0.0  # plain both ways


def test_phase_10_prefix_case_at_reduced_width():
    """``chip_smoke.lm_pool_prefix_case`` on the CPU at REDUCED width: a
    prefix prefill and 4 decode steps, equal to themselves under the
    plain versions."""
    cfg = TREDUCED["internvl2-2b"].replace(kv_cache_dtype="int8")
    qm = tr.quantize(cfg, tlm.init(cfg, seed=0, device="cpu"), "m2q-w8a8")
    res, problems, launches = chip_smoke.lm_pool_prefix_case(
        torch, qm, steps=4, device="cpu")
    assert problems == [] and res["prefix"] == cfg.n_patches
    assert res["max_abs_diff"] == 0.0 and not any(launches.values())

"""The mixed LM path against the JAX package: ``m2q-w8a8`` on two qwen
configs, both quantized from the same JAX-initialised float weights and
the same synthesized calibration prompts.

* ``wide``: qwen1.5-0.5b at its published widths (d_model 1024, 16 heads x
  64, d_ff 2816, QKV bias) cut to 2 layers and a 1024-token vocab, f32,
  at a 64-token deployment shape (``tokens_per_step=64``): every dense
  leaf is compute-bound, as at full width from ~45 tokens a step.
* ``reduced``: the registry's reduced qwen (d_model 64), which reaches
  the mixed path through the taxonomy overrides at its decode shape.

Either way wq, wk, wv, wo and w2 become stacked ``QExpertM2Q`` leaves
with per-layer Eq. 6 splits and (L, 1, 1) activation scales, the SwiGLU
w1/w3 perm-folded ``QM2Q`` leaves with no activation scale (w2's rows
permuted to match), the lm_head a calibrated 2-D ``QM2Q`` and the
embedding a 4-bit ``QUniform``.  The JAX package runs with dispatch off
(its XLA QTensor paths); the port runs its plain kernel versions."""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import REDUCED as JREDUCED
from repro.core import apply as japply
from repro.core import packing as jpacking
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.models import dense_lm as jlm
from repro_torch import kernels
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import apply as tapply
from repro_torch.core import packing as tpacking
from repro_torch.core import quant as tquant
from repro_torch.core.policy import M2QPolicy
from repro_torch.core.qtensor import QExpertM2Q, QM2Q, QUniform, slice_layer
from repro_torch.core.tree import leaves_with_path
from repro_torch.kernels import ops
from repro_torch.models import dense_lm as tlm
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          jax_to_numpy, manifest, same_numpy)

WIDE = dict(n_layers=2, vocab_size=1024, dtype="float32")
CONFIGS = {
    "wide": (JARCHS["qwen1.5-0.5b"].replace(**WIDE),
             TARCHS["qwen1.5-0.5b"].replace(**WIDE), 64),
    "reduced": (JREDUCED["qwen1.5-0.5b"], TREDUCED["qwen1.5-0.5b"], None),
}
NAMES = list(CONFIGS)
STACKED = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w2")
FOLDED = ("mlp/w1", "mlp/w3")
# teacher-forced decode: 2 ragged prompts, then 8 steps
PROMPT_LENS = np.array([11, 16], np.int32)
N_STEPS = 8
MAX_LEN = 32


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


def _recipes(name):
    """(JAX recipe, the port's) of one config: m2q-w8a8, at 64 tokens a
    step for ``wide``."""
    toks = CONFIGS[name][2]
    return tuple(m.PRESETS["m2q-w8a8"].replace(tokens_per_step=toks)
                 for m in (jr, tr))


@functools.lru_cache(maxsize=None)
def _float_params(name):
    jcfg = CONFIGS[name][0]
    return jax.jit(lambda k: jlm.init(jcfg, k))(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_quantized():
    """JAX's QuantizedModel of every config; the two quantize in threads
    (each eager op compiles one XLA program, and the compiles overlap)."""
    def run(name):
        with _off():
            return jr.quantize(CONFIGS[name][0], _float_params(name),
                               _recipes(name)[0])
    with ThreadPoolExecutor(len(NAMES)) as pool:
        return dict(zip(NAMES, pool.map(run, NAMES)))


@functools.lru_cache(maxsize=None)
def _quantized(name):
    """(JAX QuantizedModel, the port's QuantizedModel) of one config."""
    tqm = tr.quantize(CONFIGS[name][1],
                      params_from_numpy(jax_to_numpy(_float_params(name)),
                                        "cpu"), _recipes(name)[1])
    return _jax_quantized()[name], tqm


@functools.lru_cache(maxsize=None)
def _carried(name):
    """The JAX-quantized tree in both packages."""
    jqm, _ = _quantized(name)
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


def _plain_calls():
    return {k: c["plain_calls"] for k, c in kernels.counts().items()
            if c["plain_calls"]}


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_quantized_leaves_match_jax(name):
    """Every leaf has the JAX leaf's class and static fields; payload
    bytes, ``u_scale``, ``u_zp`` and ``a_scale`` are equal bit for bit.
    The activation scales come from each package's own float calibration
    forward, so they agree to f32 summation-order noise (rtol 1e-5;
    measured <= 1.7e-6 at ``wide``)."""
    jqm, tqm = _quantized(name)
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


@pytest.mark.parametrize("name", NAMES)
def test_leaf_kinds_of_the_mixed_lm(name):
    """Stacked QExpertM2Q layers with (L, 1, 1) activation scales and an
    equal split per layer; perm-folded 3-D QM2Q w1/w3 without one; a
    calibrated 2-D QM2Q lm_head; a 4-bit axis-0 embedding."""
    _, tqm = _quantized(name)
    cfg = tqm.cfg
    L = cfg.n_layers
    leaves = dict(leaves_with_path(tqm.params))
    for path in STACKED:
        leaf = leaves[f"layers/{path}"]
        assert isinstance(leaf, QExpertM2Q) and leaf.payload.ndim == 3
        assert leaf.payload.shape[0] == L and leaf.shape == \
            tuple(leaf.payload.shape)
        assert leaf.act_scale.shape == (L, 1, 1)
        assert leaf.u_scale.shape == (L, 1, leaf.shape[-1])
        n = leaf.shape[-1]
        assert (leaf.n_uniform, leaf.n_apot) == (n - n // 2, n // 2)
        # per layer: n_apot columns with an APoT scale, the rest uniform
        assert torch.equal((leaf.a_scale != 0).sum(-1).reshape(-1),
                           torch.full((L,), n // 2))
    for path in FOLDED:
        leaf = leaves[f"layers/{path}"]
        assert type(leaf) is QM2Q and leaf.act_scale is None
        assert leaf.payload.shape == (L, cfg.d_model, cfg.d_ff)
        # [uniform | apot] column order in every layer
        uniform = (leaf.a_scale == 0).reshape(L, -1)
        assert bool(uniform[:, :leaf.n_uniform].all())
        assert not bool(uniform[:, leaf.n_uniform:].any())
    head = leaves["lm_head"]
    assert type(head) is QM2Q and head.payload.ndim == 2
    assert head.act_scale is not None and head.act_scale.ndim == 0
    emb = leaves["embed"]
    assert isinstance(emb, QUniform) and emb.bits == 4 and emb.axis == 0


@pytest.mark.parametrize("name", NAMES)
def test_reports_and_stats_match_jax(name):
    """Reports agree field for field in JAX's order (the folded members'
    ``mixed(perm-folded)`` included; mse to rel 1e-4); the stats carry the
    per-layer ``'<path>@<i>'`` keys and agree to rtol 1e-5; the folded
    members' splits reach ``m2q_splits``."""
    jqm, tqm = _quantized(name)
    jrep = {r.path: r for r in jqm.report}
    assert [r.path for r in tqm.report] == list(jrep)
    for r in tqm.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.shape, r.bits, r.n_uniform,
                r.n_apot) == (j.kind, j.decision, tuple(j.shape), j.bits,
                              j.n_uniform, j.n_apot), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    decisions = {r.path: r.decision for r in tqm.report}
    assert [p for p, d in decisions.items() if d == "mixed(perm-folded)"] \
        == ["layers/mlp/w1", "layers/mlp/w3"]
    assert all(decisions[f"layers/{p}"] == "mixed" for p in STACKED)
    assert decisions["lm_head"] == "mixed"
    splits = tqm.m2q_splits()
    assert splits == jqm.m2q_splits()
    assert splits["layers/mlp/w1"] == (tqm.cfg.d_ff // 2, tqm.cfg.d_ff // 2)
    assert sorted(tqm.act_stats) == sorted(jqm.act_stats)
    for k, v in jqm.act_stats.items():
        assert tqm.act_stats[k] == pytest.approx(v, rel=1e-5), k
    assert "layers/mlp/w2@1" in tqm.act_stats
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step == \
        (CONFIGS[name][2] or 2)
    assert tqm.provenance == jqm.provenance


@pytest.mark.parametrize("name", NAMES)
def test_folded_group_and_permuted_w2_rows_equal_jax(name):
    """``_joint_group_quantize`` on the stacked float w1, w3, w2 in both
    packages: the folded members' bytes and scales, and w2's permuted
    float rows, equal JAX's bit for bit -- a permutation of w2's rows,
    the one that puts each layer's uniform filters first."""
    params = _float_params(name)
    mlp = {k: np.array(v) for k, v in params["layers"]["mlp"].items()}
    with _off():
        jup, jgate, jdown = japply._joint_group_quantize(
            jnp.asarray(mlp["w1"]), jnp.asarray(mlp["w3"]),
            jnp.asarray(mlp["w2"]), None)
    tup, tgate, tdown = tapply._joint_group_quantize(
        *(torch.from_numpy(mlp[k]) for k in ("w1", "w3", "w2")), None)
    for j, t in ((jup, tup), (jgate, tgate)):
        same_numpy(params_to_numpy({"w": t}), jax_to_numpy({"w": j}))
    np.testing.assert_array_equal(tdown.numpy(), np.asarray(jdown))
    for i in range(mlp["w2"].shape[0]):
        rows = {r.tobytes() for r in mlp["w2"][i]}
        assert {r.tobytes() for r in tdown[i].numpy()} == rows
        assert not np.array_equal(tdown[i].numpy(), mlp["w2"][i])


@pytest.mark.parametrize("chunk", [97, 1000, 4096])
def test_chunked_apot_search_gives_the_same_codes(chunk, monkeypatch):
    """The nearest-codebook search in bounded chunks (here 97 to 4096
    weights against a 64 x 300 leaf and a stacked 3 x 64 x 100 one)
    gives the unchunked search's codes and scales, and JAX's."""
    rng = np.random.default_rng(chunk)
    for w, ra in ((rng.normal(0, 0.05, (64, 300)), None),
                  (rng.normal(0, 0.05, (3, 64, 100)), (1,))):
        w = w.astype(np.float32)
        t = torch.from_numpy(w)
        monkeypatch.setattr(tquant, "APOT_CHUNK", w.size)
        whole = tquant.apot_quantize(t, reduce_axes=ra)
        monkeypatch.setattr(tquant, "APOT_CHUNK", chunk)
        part = tquant.apot_quantize(t, reduce_axes=ra)
        assert w.size > 4 * chunk
        codes = tpacking.apot_encode(part).numpy()
        np.testing.assert_array_equal(codes,
                                      tpacking.apot_encode(whole).numpy())
        np.testing.assert_array_equal(part.scale.numpy(),
                                      whole.scale.numpy())
        want = jquant.apot_quantize(jnp.asarray(w), reduce_axes=ra)
        np.testing.assert_array_equal(codes,
                                      np.asarray(jpacking.apot_encode(want)))


# ---------------------------------------------------------------------------
# the JAX-quantized tree through the port's forward, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_carried_forward_matches_jax(name):
    """The port's forward on the JAX-quantized tree against JAX's
    dispatch-off forward, to 1e-5 of max |logit| (measured: equal).  Per
    forward ``m2q_matmul`` has 5 L + 1 plain calls -- every stacked layer
    matmul and the lm_head -- and the folded members none (their plain
    ``x @ dequant``, as in JAX)."""
    jcfg, tcfg, _ = CONFIGS[name]
    jparams, tparams = _carried(name)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    with _off():
        want = np.asarray(jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
            jparams, jnp.asarray(tokens)))
    kernels.reset_counts()
    with torch.inference_mode():
        got = tlm.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    assert _plain_calls() == {"m2q_matmul": 5 * tcfg.n_layers + 1}
    assert got.shape == (2, 16, tcfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _teacher_forced(name):
    """Ragged prefill + N_STEPS teacher-forced int8-KV decode steps in both
    packages: (jax logits, port logits, plain calls of the port's decode
    steps)."""
    jcfg, tcfg = (c.replace(kv_cache_dtype="int8")
                  for c in CONFIGS[name][:2])
    jparams, tparams = _carried(name)
    rng = np.random.default_rng(4)
    S = int(PROMPT_LENS.max())
    prompts = rng.integers(0, jcfg.vocab_size, (2, S), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (N_STEPS, 2), dtype=np.int32)
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
        plain = _plain_calls()
    return np.stack(jlogits), np.stack(tlogits), plain


# Each package writes its int8 cache rows from its own decode attention,
# whose f32 sums run in different orders; where a value sits on an int8
# rounding step, one KV code (or one activation code of the next layer's
# quantized matmul) differs and every later logit of that row moves --
# measured at ``wide``: one k code, one of 18 positions (the last step)
# off by 0.013 of max |logit|, every other position equal.  So at most
# DECODE_OFF positions may leave 1e-5 of max |logit|, none DECODE_TOL.
DECODE_OFF = 2
DECODE_TOL = 5e-2


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_teacher_forced_int8_decode_match_jax(name):
    jlog, tlog, plain = _teacher_forced(name)
    cfg = CONFIGS[name][1]
    assert tlog.shape == jlog.shape == (N_STEPS + 1, 2, cfg.padded_vocab)
    # each decode step: one decode_attn_int8 per layer, 5 L + 1 m2q_matmul
    assert plain == {"decode_attn_int8": N_STEPS * cfg.n_layers,
                     "m2q_matmul": N_STEPS * (5 * cfg.n_layers + 1)}
    scale = np.abs(jlog).max()
    # the prefill logits (float attention) agree to f32 noise
    np.testing.assert_allclose(tlog[0], jlog[0], rtol=0, atol=1e-5 * scale)
    off = np.abs(tlog - jlog).max(-1)   # (steps + 1, rows)
    assert int((off > 1e-5 * scale).sum()) <= DECODE_OFF
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=DECODE_TOL * scale)
    # the argmax agrees wherever JAX's top-2 margin exceeds the difference
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * off
    np.testing.assert_array_equal(tlog.argmax(-1)[clear],
                                  jlog.argmax(-1)[clear])


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_from_jax_cache_matches_jax(name):
    """One int8-KV decode step from the cache JAX's prefill wrote: the
    codes start equal, so the logits agree to 1e-5 of max |logit|."""
    jcfg, tcfg = (c.replace(kv_cache_dtype="int8")
                  for c in CONFIGS[name][:2])
    jparams, tparams = _carried(name)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 1), dtype=np.int32)
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


@pytest.mark.parametrize("name", NAMES)
def test_kernel_routing_agrees_with_jax(name):
    """``ops.kernel_supported`` against JAX's on every quantized leaf and
    every layer slice of it: a layer-sliced QExpertM2Q goes to the kernel
    (2-D payload, activation scale), the unsliced one and every folded
    member do not (no activation scale: the plain ``x @ dequant``)."""
    jparams, tparams = _carried(name)
    ours = dict(leaves_with_path(tparams))
    routed = set()
    for key, leaf in ours.items():
        if not dataclasses.is_dataclass(leaf):
            continue
        jleaf = jparams
        for part in key.split("/"):
            jleaf = jleaf[part]
        assert ops.kernel_supported(leaf) == jops.kernel_supported(jleaf)
        if key.startswith("layers/"):
            for i in range(CONFIGS[name][1].n_layers):
                got = ops.kernel_supported(slice_layer(leaf, i))
                want = jops.kernel_supported(
                    jax.tree.map(lambda a: a[i], jleaf))
                assert got == want, (key, i)
                if got:
                    routed.add(key)
    assert routed == {f"layers/{p}" for p in STACKED}
    assert ops.kernel_supported(ours["lm_head"])
    assert not ops.kernel_supported(ours["layers/attn/wq"])


# ---------------------------------------------------------------------------
# the shape-only twin and artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_abstract_twin_equals_the_concrete_tree(name):
    """Class, static fields, shapes and dtypes of every leaf, from the
    recipe alone and from the reports' splits; nothing allocated."""
    _, tqm = _quantized(name)
    abstract = tqm.abstract_params()
    all_meta(abstract)
    assert abstract_tree(abstract) == abstract_tree(tqm.params)
    assert abstract_tree(tr.abstract_quantize(tqm.cfg, recipe=tqm.recipe)) \
        == abstract_tree(tqm.params)


def test_abstract_twin_with_apot_ratio_none():
    """The Eq. 6 argmin: stacked and folded leaves split 1:1 (as in JAX),
    the 2-D lm_head is data-dependent -- the twin refuses it without the
    reports' splits and equals the concrete tree, and JAX's twin, with
    them."""
    cfg = TREDUCED["qwen1.5-0.5b"]
    rec = tr.PRESETS["m2q-w8a8"].replace(policy=M2QPolicy(apot_ratio=None))
    qm = tr.quantize(cfg, tlm.init(cfg, seed=0, device="cpu"), rec)
    splits = qm.m2q_splits()
    head = splits.pop("lm_head")
    assert head[1] != cfg.padded_vocab // 2
    assert all(nu == na or nu == na + 1 for nu, na in splits.values())
    with pytest.raises(ValueError, match="data-dependent"):
        tr.abstract_quantize(cfg, recipe=qm.recipe)
    ours = qm.abstract_params()
    assert abstract_tree(ours) == abstract_tree(qm.params)
    jrec = jr.PRESETS["m2q-w8a8"].replace(
        policy=jr.M2QPolicy(apot_ratio=None),
        tokens_per_step=qm.recipe.tokens_per_step)
    theirs = jr.abstract_quantize(JREDUCED["qwen1.5-0.5b"], recipe=jrec,
                                  m2q_splits=qm.m2q_splits())
    assert abstract_tree(ours) == abstract_tree(theirs)


def test_abstract_twin_equals_jax_at_full_width():
    """qwen1.5-0.5b at its published widths under m2q-w8a8 at 64 tokens
    a step, against JAX's ``abstract_quantize`` (meta tensors, nothing
    allocated): 5 stacked QExpertM2Q leaves of 24 layers, 2 folded QM2Q,
    a QM2Q lm_head of 151936 filters."""
    jrec, trec = _recipes("wide")
    ours = tr.abstract_quantize("qwen1.5-0.5b", recipe=trec)
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(jr.abstract_quantize("qwen1.5-0.5b",
                                                     recipe=jrec))
    kinds = [v[0] for v in got.values()]
    assert kinds.count("QExpertM2Q") == 5 and kinds.count("QM2Q") == 3
    assert got["layers/attn/wq"][1] == {"shape": (24, 1024, 1024),
                                        "n_uniform": 512, "n_apot": 512}
    assert got["lm_head"][2]["payload"] == ((1024, 151936), "int8")


@pytest.mark.parametrize("name", NAMES)
def test_a_jax_saved_mixed_lm_loads_in_the_port(name, tmp_path):
    """Leaf for leaf equal to ``params_from_numpy`` of JAX's tree, with
    the same provenance; its forward equals the carried tree's; re-saved
    by the port, the manifest is JAX's."""
    jqm, _ = _quantized(name)
    jdir = jqm.save(tmp_path / "jax")
    qm = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    _, carried = _carried(name)
    same_numpy(params_to_numpy(qm.params), params_to_numpy(carried))
    assert artifact_payload(qm, "port") == artifact_payload(jqm, "jax")
    tokens = np.random.default_rng(6).integers(0, qm.cfg.vocab_size, (2, 8))
    with torch.inference_mode():
        assert torch.equal(qm.forward(tokens),
                           tlm.forward(qm.cfg, carried,
                                       torch.from_numpy(tokens)))
    pdir = qm.save(tmp_path / "port")
    assert manifest(pdir) == manifest(jdir)


@pytest.mark.parametrize("name", NAMES)
def test_a_port_saved_mixed_lm_loads_in_the_jax_package(name, tmp_path):
    """The port's own quantization saved, loaded by the JAX package:
    equal leaves and provenance, and JAX's dispatch-off forward of it
    within 1e-5 of max |logit| of the port's."""
    _, tqm = _quantized(name)
    pdir = tqm.save(tmp_path / "port")
    jqm = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(jqm.params), params_to_numpy(tqm.params))
    assert artifact_payload(jqm, "jax") == artifact_payload(tqm, "port")
    assert manifest(jqm.save(tmp_path / "jax")) == manifest(pdir)
    tokens = np.random.default_rng(7).integers(0, tqm.cfg.vocab_size, (2, 8),
                                               dtype=np.int32)
    with _off():
        want = np.asarray(jax.jit(lambda p, t: jlm.forward(jqm.cfg, p, t))(
            jqm.params, jnp.asarray(tokens)))
    got = tqm.forward(tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

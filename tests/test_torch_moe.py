"""The MoE LMs against the JAX package: llama4-scout-17b-a16e (16 experts
top-1 and a shared expert; REDUCED: 4 experts) and dbrx-132b (16 experts
top-4, renormalized gates; REDUCED: 4 experts top-2), each at its
REDUCED config (2 layers, d_model 64, f32) from the JAX package's float
init at ``PRNGKey(0)``, and at a width cut above 256 (d_model 512, a
1024 vocab) where the decode shape leaves every leaf 4-bit.

Both REDUCED configs are narrow LMs (d_model <= 256), so ``m2q-w8a8``
pins every compute kind mixed through the taxonomy overrides: the expert
leaves become (L, E, K, N) ``QExpertM2Q`` leaves with (L, 1, 1, 1)
activation scales, llama4-scout's shared expert a perm-folded group.
The JAX package runs with dispatch off (its XLA QTensor paths); the port
runs its plain kernel versions: the expert products ``m2q_matmul_plain``
expert by expert, which ``QExpertM2Q.expert_matmul`` (JAX's
``expert_matmul``'s arithmetic) equals bit for bit."""
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

from repro import nn as jnn
from repro import recipe as jr
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import REDUCED as JREDUCED
from repro.core import apply as japply
from repro.core import qtensor as jq
from repro.kernels import ops as jops
from repro.models import dense_lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch import kernels, nn
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import apply as tapply
from repro_torch.core import policy as tpol
from repro_torch.core.qtensor import QExpertM2Q, QUniform, slice_layer
from repro_torch.core.tree import leaves_with_path
from repro_torch.kernels import ops as tops
from repro_torch.models import dense_lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.serving.engine import Engine as TEngine
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          done_tokens, jax_to_numpy, lm_prompts, manifest,
                          numpy_to_jax, same_numpy)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 11, rehearsed at REDUCED width)

NAMES = ["llama4-scout-17b-a16e", "dbrx-132b"]
# "reduced": REDUCED (the mixed path); "cut": the width cut above 256,
# quantized at the decode shape (every leaf 4-bit)
KINDS = ["reduced", "cut"]
PROMPT_LENS = np.array([9, 14], np.int32)
N_STEPS = 6
MAX_LEN = 48
# f32 through 2 layers: the two packages differ by summation order only
FLOAT_TOL = 1e-5
# int8-KV teacher-forced decode of the mixed tree (tests/test_torch_lm_m2q
# .py's bound: an activation code of a mixed layer can flip)
DECODE_TOL = 5e-2
LM_NAMES = [n for n, c in TARCHS.items() if c.family != "efficientvit"]


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


def _cut(reg, name):
    """The width cut of ``name`` in registry ``reg``: REDUCED's layers,
    heads and experts at d_model 512, head_dim 128, d_ff 1024 and a 1024
    vocab."""
    return reg[name].replace(name=f"{name}-cut", d_model=512,
                             vocab_size=1024, head_dim=128, d_ff=1024,
                             moe_d_ff=1024)


def _cfgs(name, kind):
    """(JAX config, the port's) of one case."""
    if kind == "reduced":
        return JREDUCED[name], TREDUCED[name]
    return _cut(JREDUCED, name), _cut(TREDUCED, name)


@functools.lru_cache(maxsize=None)
def _float_params(name, kind="reduced"):
    """JAX's float init at ``PRNGKey(0)``, and its numbers as the port's
    CPU tree."""
    jcfg, _ = _cfgs(name, kind)
    params = jax.jit(lambda k: jlm.init(jcfg, k))(jax.random.PRNGKey(0))
    return params, params_from_numpy(jax_to_numpy(params), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_quantized():
    """JAX's m2q-w8a8 QuantizedModel of every (name, kind), in threads
    (each eager op compiles one XLA program; the compiles overlap)."""
    pairs = [(n, k) for n in NAMES for k in KINDS]

    def run(pair):
        with _off():
            return jr.quantize(_cfgs(*pair)[0], _float_params(*pair)[0],
                               "m2q-w8a8")
    with ThreadPoolExecutor(len(pairs)) as pool:
        return dict(zip(pairs, pool.map(run, pairs)))


@functools.lru_cache(maxsize=None)
def _quantized(name, kind):
    """(JAX QuantizedModel, the port's), from the same float weights and
    synthesized calibration prompts."""
    tparams = params_from_numpy(jax_to_numpy(_float_params(name, kind)[0]),
                                "cpu")
    return (_jax_quantized()[name, kind],
            tr.quantize(_cfgs(name, kind)[1], tparams, "m2q-w8a8"))


@functools.lru_cache(maxsize=None)
def _carried(name):
    """The JAX-quantized REDUCED tree in both packages."""
    jqm, _ = _quantized(name, "reduced")
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


def _tokens(name, shape, seed):
    return np.random.default_rng(seed).integers(
        0, TREDUCED[name].vocab_size, shape, dtype=np.int32)


def _plain_calls():
    return {k: c["plain_calls"] for k, c in kernels.counts().items()
            if c["plain_calls"]}


# ---------------------------------------------------------------------------
# configs, the deployment shape and the float model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registry_resolves_both_names_like_jax(name):
    """The full and REDUCED names resolve to the JAX package's configs,
    field for field, through ``resolve_cfg``, ``get_config``,
    ``get_reduced`` and ``list_archs``; the family is ``moe_lm``."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    reduced = TREDUCED[name].name
    for ours, theirs in ((tr.resolve_cfg(name), jr._resolve_cfg(name)),
                         (tr.resolve_cfg(reduced), jr._resolve_cfg(reduced)),
                         (treg.get_config(name), jreg.get_config(name)),
                         (treg.get_reduced(name), jreg.get_reduced(name))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.family == "moe_lm"
    assert name in treg.list_archs()


@pytest.mark.parametrize("name", LM_NAMES)
def test_resolve_gives_jaxs_shape_ctx_for_every_lm(name):
    """``resolve()`` of every registered LM, at its published width and
    at REDUCED, gives JAX's deployment ShapeCtx -- the MoE fields
    included -- and a calibration batch of another size changes only
    ``tokens_per_step`` (the artifact's recipe pins it)."""
    for ours, theirs in ((TARCHS[name], JARCHS[name]),
                         (TREDUCED[name], JREDUCED[name])):
        for toks in (None, 64):
            a = tr.PRESETS["m2q-w8a8"].replace(
                tokens_per_step=toks).resolve(ours).shape_ctx
            b = jr.PRESETS["m2q-w8a8"].replace(
                tokens_per_step=toks).resolve(theirs).shape_ctx
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.tokens_per_expert == b.tokens_per_expert
    if TARCHS[name].moe_experts:
        a = tr.PRESETS["m2q-w8a8"].resolve(TARCHS[name]).shape_ctx
        assert (a.moe_top_k, a.moe_num_experts) == (
            TARCHS[name].moe_top_k, TARCHS[name].moe_experts)


def _decisions(pkg_apply, rules, ctx, overrides, tree):
    """path -> decision of every quantizable leaf of a float tree of
    shapes, as ``quantize_model`` classifies it (experts on (K, N) at
    tokens per expert, stacked leaves on a layer's (K, N))."""
    out = {}
    for key, shape in tree.items():
        kind = pkg_apply.match_kind(rules, key)
        if kind is None or kind == tpol.KIND_SKIP or len(shape) < 2:
            continue
        dec_shape = shape[-2:] if len(shape) >= 3 else shape
        out[key] = pkg_apply.resolve_decision(key, kind, dec_shape, ctx,
                                              *overrides)[0]
    return out


@pytest.mark.parametrize("width,toks", [("reduced", None), ("full", 64),
                                        ("full", 256)])
def test_dbrx_resolves_jaxs_shape_ctx_and_decisions(width, toks):
    """dbrx-132b: both packages' ``resolve()`` give equal ShapeCtx (top-4
    of 16 experts: tokens per expert are a quarter of tokens per step)
    and equal per-leaf decisions, the concrete quantizer's included at
    REDUCED.  At full width and 64 tokens a step the experts see 16
    tokens and stay 4-bit while attention is mixed; at 256 (64 an
    expert) they are mixed.  A ShapeCtx without the MoE fields (the
    fault this guards) classifies the experts at 64 tokens a step as
    mixed."""
    name = "dbrx-132b"
    ours = (TREDUCED if width == "reduced" else TARCHS)[name]
    theirs = (JREDUCED if width == "reduced" else JARCHS)[name]
    a = tr.PRESETS["m2q-w8a8"].replace(tokens_per_step=toks).resolve(ours)
    b = jr.PRESETS["m2q-w8a8"].replace(tokens_per_step=toks).resolve(theirs)
    assert dataclasses.asdict(a.shape_ctx) == dataclasses.asdict(b.shape_ctx)
    shapes = {k: tuple(v.shape) for k, v in leaves_with_path(
        tlm.init(ours, device="meta"))}
    got = _decisions(tapply, a.rules, a.shape_ctx,
                     (a.policy, a.overrides), shapes)
    want = _decisions(japply, b.rules, b.shape_ctx,
                      (b.policy, b.overrides), shapes)
    assert got == want
    experts = {k: v for k, v in got.items() if "experts/" in k}
    assert len(experts) == 3
    if width == "reduced":
        assert set(got.values()) == {"mixed", "lowbit"}  # the embed
        _, tqm = _quantized(name, "reduced")
        assert {r.path: r.decision for r in tqm.report
                if r.decision != "mixed(perm-folded)"} == want
        return
    assert set(experts.values()) == {"lowbit" if toks == 64 else "mixed"}
    assert got["layers/attn/wq"] == "mixed"
    stale = dataclasses.replace(a.shape_ctx, moe_top_k=1, moe_num_experts=1)
    stale_dec = _decisions(tapply, a.rules, stale, (a.policy, a.overrides),
                           shapes)
    assert {stale_dec[k] for k in experts} == {"mixed"}


@pytest.mark.parametrize("name", NAMES)
def test_float_tree_is_jaxs(name):
    """``init`` (on ``meta``: shapes only) builds JAX's MoE tree: the
    router (L, D, E), experts w1/w3 (L, E, D, F) and w2 (L, E, F, D),
    llama4-scout's shared expert, no ``mlp`` -- the same paths, shapes
    and dtypes as JAX's ``init`` at full width; at REDUCED the CPU init
    draws each stacked leaf with the lecun law's scale."""
    cfg = TARCHS[name]
    ours = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves_with_path(tlm.init(cfg, device="meta"))}
    jtree = jax.eval_shape(lambda k: jlm.init(JARCHS[name], k),
                           jax.random.PRNGKey(0))
    theirs = {k: (v[1], v[2]) for k, v in abstract_tree(jtree).items()}
    assert ours == theirs
    E, D, F = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    assert ours["layers/moe/experts/w1"][0] == (cfg.n_layers, E, D, F)
    assert ("layers/shared/w1" in ours) == cfg.moe_shared_expert
    assert not any(k.startswith("layers/mlp") for k in ours)
    red = TREDUCED[name]
    params = tlm.init(red, seed=1, device="cpu")
    w1 = params["layers"]["moe"]["experts"]["w1"]
    std = float(w1.std())
    assert abs(std * (red.moe_experts * red.d_model) ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("name", NAMES)
def test_float_forward_matches_jax(name):
    """The port's forward on JAX's float weights against JAX's, to 1e-5
    of max |logit|."""
    jparams, tparams = _float_params(name)
    cfg = TREDUCED[name]
    tokens = _tokens(name, (2, 12), 3)
    want = np.asarray(jax.jit(lambda p, t: jlm.forward(JREDUCED[name], p, t))(
        jparams, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tlm.forward(cfg, tparams, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOAT_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the MoE layer: routing, ties, overflow, the expert products
# ---------------------------------------------------------------------------


def _jax_route(x, router, cfg):
    """JAX's ``moe_ffn`` dispatch, its own lines: (top_g, top_e, slot,
    ok)."""
    E, K = cfg.num_experts, cfg.top_k
    C = jnn.moe.capacity(x.shape[0], cfg)
    logits = jnn.dense(x, router).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    top_g, top_e = jax.lax.top_k(gates, K)
    if cfg.normalize_gates and K > 1:
        top_g = top_g / jnp.sum(top_g, axis=-1, keepdims=True)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    ok = pos_in_e < C
    slot = jnp.where(ok, flat_e * C + pos_in_e, flat_e * C)
    return [np.asarray(a) for a in (top_g, top_e, slot, ok)]


def _moe_case(case):
    """(x (T, D), the layer's float params, E, K, capacity factor) of one
    routing case, all numpy."""
    rng = np.random.default_rng(4)
    if case in ("top1", "top2"):
        name = NAMES[0] if case == "top1" else NAMES[1]
        cfg = TREDUCED[name]
        p = jax_to_numpy(_float_params(name)[0])["layers"]["moe"]
        p = jax.tree.map(lambda a: a[0], p)
        x = rng.normal(0, 1, (24, cfg.d_model)).astype(np.float32)
        return x, p, cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    E, D, F, T = 8, 32, 48, 40
    p = {"router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
         "experts": {k: rng.normal(0, 0.2, s).astype(np.float32)
                     for k, s in (("w1", (E, D, F)), ("w3", (E, D, F)),
                                  ("w2", (E, F, D)))}}
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    if case == "top4":
        return x, p, E, 4, 1.25
    # a direction every token shares, which the skewed router columns
    # reward: x . u is 3 +- 1 for every token
    u = np.full(D, D ** -0.5, np.float32)
    x = x + 3.0 * u
    if case == "overflow":  # every token prefers expert 3: it overflows
        p["router"][:, 3] += 3.0 * u
        return x, p, E, 2, 1.0
    if case == "tie":  # every gate equal: experts 0..K-1 in index order
        p["router"][:] = 0.0
        return x, p, E, 2, 1.0
    # "tie-pair": experts 2 and 5 share one favoured router column, so
    # their gates are equal and the largest for every token
    p["router"][:, 2] += 3.0 * u
    p["router"][:, 5] = p["router"][:, 2]
    return x, p, E, 2, 4.0


CASES = ["top1", "top2", "top4", "overflow", "tie", "tie-pair"]


@pytest.mark.parametrize("case", CASES)
def test_moe_routing_and_output_match_jax(case):
    """The dispatch of ``moe_ffn`` -- top-k experts with ``lax.top_k``'s
    tie rule, buffer slots, the within-capacity mask -- equals JAX's
    exactly, the gates to f32 rounding, and the layer's output is within
    1e-6 of max |y| of JAX's ``moe_ffn``: top-1 and top-2 on the REDUCED
    layers, top-4 of 8, an overflowing expert at capacity factor 1, all
    gates tied, and two experts tied for every token."""
    x, p, E, K, cf = _moe_case(case)
    D, F = x.shape[1], p["experts"]["w1"].shape[-1]
    jcfg = jnn.MoEConfig(num_experts=E, top_k=K, d_model=D, d_ff=F,
                         capacity_factor=cf)
    tcfg = nn.MoEConfig(num_experts=E, top_k=K, d_model=D, d_ff=F,
                        capacity_factor=cf)
    assert tmoe.capacity(x.shape[0], tcfg) == jnn.moe.capacity(x.shape[0],
                                                               jcfg)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    want = _jax_route(jnp.asarray(x), jp["router"], jcfg)
    got = [t.numpy() for t in tmoe.route(torch.from_numpy(x), tp["router"],
                                         tcfg)]
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i].astype(got[i].dtype))
    # gates in [0, 1]: the two softmaxes differ by f32 rounding steps
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    ok = want[3]
    assert ok.all() == (case not in ("overflow", "tie"))
    if case == "tie":
        np.testing.assert_array_equal(got[1], np.tile(np.arange(K),
                                                      (x.shape[0], 1)))
    if case == "tie-pair":  # the tied pair, where both are taken: 2, 5
        both = (got[1] == 2).any(1) & (got[1] == 5).any(1)
        assert both.mean() > 0.5
        np.testing.assert_array_equal(got[1][both],
                                      np.tile([2, 5], (both.sum(), 1)))
    y = np.asarray(jax.jit(lambda a, q: jnn.moe_ffn(a, q, jcfg))(
        jnp.asarray(x), jp))
    with torch.inference_mode():
        ty = tmoe.moe_ffn(torch.from_numpy(x), tp, tcfg).numpy()
    np.testing.assert_allclose(ty, y, rtol=0, atol=1e-6 * np.abs(y).max())


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 1, (30, 6)).astype(np.float32)
    top_e = rng.integers(0, 6, (30, 2)).astype(np.int32)
    want = float(jnn.moe.aux_load_balance_loss(jnp.asarray(logits),
                                               jnp.asarray(top_e), 6))
    got = float(tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                           torch.from_numpy(top_e), 6))
    assert got == pytest.approx(want, rel=1e-6)


def _expert_leaf(calibrated=True):
    """An (E, K, N) expert weight quantized by both packages'
    ``QExpertM2Q.quantize`` with the same per-expert splits, and an (E,
    C, K) activation buffer (zero rows at the end, as capacity leaves)."""
    from repro_torch.core.scheme_select import select_schemes
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.1, (4, 48, 40)).astype(np.float32)
    xe = rng.normal(0, 1, (4, 16, 48)).astype(np.float32)
    xe[:, 11:] = 0.0
    asn = [select_schemes(torch.from_numpy(w[e])) for e in range(4)]
    ai = np.stack([a.apot_idx for a in asn])
    ui = np.stack([a.uniform_idx for a in asn])
    ams = np.float32(np.abs(xe).max()) if calibrated else None
    tq = QExpertM2Q.quantize(torch.from_numpy(w), ai, ui, act_max_abs=ams)
    with _off():
        jqt = jq.QExpertM2Q.quantize(jnp.asarray(w), ai, ui,
                                     act_max_abs=ams)
    return tq, jqt, xe


@pytest.mark.parametrize("calibrated", [True, False])
def test_expert_matmul_matches_jax(calibrated):
    """``QExpertM2Q.expert_matmul`` on an (E, K, N) leaf: the bytes equal
    JAX's, the integer path's product equal to JAX's ``expert_matmul``
    bit for bit (calibrated) or within f32 noise (dequantized einsum);
    ``ops.qtensor_expert_matmul`` -- ``m2q_matmul`` expert by expert, here
    its plain version, E plain calls -- equals it bit for bit, inside
    ``reference_path()`` too."""
    tq, jqt, xe = _expert_leaf(calibrated)
    same_numpy(params_to_numpy({"w": tq}), jax_to_numpy({"w": jqt}))
    with _off():
        want = np.asarray(jqt.expert_matmul(jnp.asarray(xe)))
    got = tq.expert_matmul(torch.from_numpy(xe)).numpy()
    if calibrated:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    kernels.reset_counts()
    routed = tops.qtensor_expert_matmul(torch.from_numpy(xe), tq).numpy()
    assert _plain_calls() == ({"m2q_matmul": 4} if calibrated else {})
    with tops.reference_path():
        ref = tops.qtensor_expert_matmul(torch.from_numpy(xe), tq).numpy()
    np.testing.assert_array_equal(routed, got)
    np.testing.assert_array_equal(ref, got)
    assert tops.expert_kernel_supported(tq) == calibrated
    assert not tops.kernel_supported(tq)  # a 3-D payload, as JAX's says


def test_slice_layer_keeps_the_expert_axis():
    """A layer slice of a stacked (L, E, K, N) expert leaf: (E, K, N)
    payload, (E, 1, N) scales, a (1, 1, 1) activation scale, the static
    fields (``shape`` the whole leaf's) kept -- mixed and 4-bit."""
    _, tqm = _quantized("llama4-scout-17b-a16e", "reduced")
    leaf = tqm.params["layers"]["moe"]["experts"]["w1"]
    s = slice_layer(leaf, 1)
    E, K, N = leaf.payload.shape[1:]
    assert tuple(s.payload.shape) == (E, K, N)
    assert tuple(s.u_scale.shape) == (E, 1, N)
    assert tuple(s.act_scale.shape) == (1, 1, 1)
    assert s.shape == leaf.shape and s.n_uniform == leaf.n_uniform
    assert torch.equal(s.payload, leaf.payload[1])
    _, cut = _quantized("llama4-scout-17b-a16e", "cut")
    q4 = cut.params["layers"]["moe"]["experts"]["w2"]
    s4 = slice_layer(q4, 0)
    assert isinstance(q4, QUniform) and q4.bits == 4 and q4.axis == 3
    assert tuple(s4.payload.shape) == tuple(q4.payload.shape[1:])
    assert s4.axis == 3 and s4.shape == q4.shape
    assert torch.equal(s4.dequant(), q4.dequant()[0])


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_quantized_leaves_match_jax(name, kind):
    """Every leaf has the JAX leaf's class and static fields; payload
    bytes, scales and zero points are equal bit for bit -- REDUCED's
    mixed (L, E, K, N) QExpertM2Q experts, the cut's 4-bit QUniform ones.
    The activation scales come from each package's own float
    calibration forward, so they agree to f32 summation-order noise
    (rtol 1e-5), in the JAX leaf's shape ((L, 1, 1, 1) on the experts)."""
    jqm, tqm = _quantized(name, kind)
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
    w1 = tqm.params["layers"]["moe"]["experts"]["w1"]
    L, E = _cfgs(name, kind)[1].n_layers, _cfgs(name, kind)[1].moe_experts
    if kind == "reduced":
        assert isinstance(w1, QExpertM2Q) and w1.payload.ndim == 4
        assert tuple(w1.act_scale.shape) == (L, 1, 1, 1)
    else:
        assert isinstance(w1, QUniform) and w1.bits == 4 and w1.axis == 3
        assert tuple(w1.scale.shape) == (L, E, 1, w1.shape[-1])
        assert {r.decision for r in tqm.report} == {"lowbit"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_quantize_model_on_jaxs_stats_is_bit_exact(name, kind):
    """``quantize_model`` on JAX's own activation statistics gives JAX's
    tree bit for bit, the (L, 1, 1, 1) expert activation scales
    included."""
    jqm, _ = _quantized(name, kind)
    cfg = _cfgs(name, kind)[1]
    res = tr.PRESETS["m2q-w8a8"].replace(
        tokens_per_step=jqm.recipe.tokens_per_step).resolve(cfg)
    qparams, report = tapply.quantize_model(
        _float_params(name, kind)[1], res.rules, res.shape_ctx, res.policy,
        act_stats=dict(jqm.act_stats), ffn_groups=res.ffn_groups or None,
        overrides=res.overrides)
    same_numpy(params_to_numpy(qparams), jax_to_numpy(jqm.params))
    assert [(r.path, r.decision, r.n_uniform, r.n_apot) for r in report] == \
        [(r.path, r.decision, r.n_uniform, r.n_apot) for r in jqm.report]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_reports_schemes_and_stats_match_jax(name, kind):
    """Reports agree field for field in JAX's order (decisions, shapes,
    bits, splits exactly; mse to rel 1e-4); the per-layer
    ``'<path>@<i>'`` stats -- the expert leaves' recorded from the
    dispatch buffer -- to rtol 1e-5; splits, deployment shape and
    provenance equal."""
    jqm, tqm = _quantized(name, kind)
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
    assert "layers/moe/experts/w2@1" in tqm.act_stats
    for k, v in jqm.act_stats.items():
        assert tqm.act_stats[k] == pytest.approx(v, rel=1e-5), k
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step == 2
    assert tqm.provenance == jqm.provenance


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_release_quantizes_the_same_bytes(name, kind):
    """``quantize(..., release=True)`` -- each float leaf dropped once its
    QTensor exists, the 4-D expert leaves quantized a layer at a time --
    gives the tree, reports and stats of quantizing with the whole float
    tree held; only the float leaves (norms, the router) stay.  The
    whole-tree model is the one the other tests share (``_quantized``);
    the released one quantizes a fresh copy of the same float numbers."""
    cfg = _cfgs(name, kind)[1]
    whole = _quantized(name, kind)[1]
    params = params_from_numpy(jax_to_numpy(_float_params(name, kind)[0]),
                               "cpu")
    released = tr.quantize(cfg, params, "m2q-w8a8", release=True)
    same_numpy(params_to_numpy(released.params),
               params_to_numpy(whole.params))
    assert released.report == whole.report
    assert released.act_stats == whole.act_stats
    left = {k for k, v in leaves_with_path(params) if v is not None}
    assert left == {k for k, v in leaves_with_path(whole.params)
                    if isinstance(v, torch.Tensor)}
    assert "layers/moe/router" in left


@pytest.mark.parametrize("kind", ["uniform4", "uniform8", "apot", "m2q"])
def test_expert_leaf_one_layer_at_a_time_equals_the_whole(kind):
    """``_quantize_stacked`` (one layer at a time) against
    ``_quantize_leaf`` on the whole (3, 4, 48, 40) expert leaf: every
    field bit for bit, (3, 1, 1, 1) activation scales; ``_mse`` layer by
    layer equals ``mean((w - dequant)^2)`` exactly."""
    from repro_torch.core import policy as pol
    w = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.1, (3, 4, 48, 40)).astype(np.float32))
    ams = np.array([1.5, 2.0, 0.5], np.float32).reshape(3, 1, 1, 1)
    p, decision = {
        "uniform4": (pol.M2QPolicy(memory_bits=4), pol.DECISION_LOWBIT),
        "uniform8": (pol.M2QPolicy(compute_scheme="uniform8"),
                     pol.DECISION_MIXED),
        "apot": (pol.M2QPolicy(compute_scheme="apot"), pol.DECISION_MIXED),
        "m2q": (pol.M2QPolicy(), pol.DECISION_MIXED)}[kind]
    a = tapply._quantize_leaf(w, pol.KIND_EXPERT, decision, p, ams)
    b = tapply._quantize_stacked(w, pol.KIND_EXPERT, decision, p, ams)
    same_numpy(params_to_numpy({"w": b}), params_to_numpy({"w": a}))
    if kind != "uniform4":
        assert tuple(b.act_scale.shape) == (3, 1, 1, 1)
    want = float(torch.mean((w - a.dequant()) ** 2))
    assert tapply._mse(w, b) == want


# ---------------------------------------------------------------------------
# the JAX-quantized tree through the port's forward, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_quantized_forward_matches_jax(name):
    """The JAX-quantized m2q-w8a8 tree's forward in both packages (the
    expert products on the integer path) within 1e-5 of max |logit|."""
    jparams, tparams = _carried(name)
    tokens = _tokens(name, (2, 12), 7)
    with _off():
        want = np.asarray(jax.jit(
            lambda p, t: jlm.forward(JREDUCED[name], p, t))(
                jparams, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tlm.forward(TREDUCED[name], tparams,
                          torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOAT_TOL * np.abs(want).max())


def _decode_agrees(want, got, tol):
    scale = np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=FLOAT_TOL * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    off = np.abs(got - want).max(-1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * off
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_teacher_forced_int8_decode_match_jax(name):
    """Ragged prefill of right-padded prompts (the pad positions routed
    through ``moe_ffn``, taking capacity, in both packages) + 6
    teacher-forced int8-KV decode steps on the JAX-quantized tree: the
    prefill's logits within 1e-5 of max |logit|, the decode within 5e-2;
    each decode step calls decode_attn_int8 once a layer and
    ``m2q_matmul`` once per expert of each expert leaf, per mixed stacked
    slice and for the lm_head (here: their plain versions)."""
    jcfg = JREDUCED[name].replace(kv_cache_dtype="int8")
    tcfg = TREDUCED[name].replace(kv_cache_dtype="int8")
    jparams, tparams = _carried(name)
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
    L, E = tcfg.n_layers, tcfg.moe_experts
    # wq wk wv wo (+ the shared expert's w2) slices, 3 expert leaves
    per_layer = 4 + int(tcfg.moe_shared_expert) + 3 * E
    assert plain == {"decode_attn_int8": N_STEPS * L,
                     "m2q_matmul": N_STEPS * (per_layer * L + 1)}
    _decode_agrees(np.stack(want), np.stack(got), DECODE_TOL)


# ---------------------------------------------------------------------------
# trees and artifacts across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_trees_cross_both_ways(name):
    """The float tree and both quantized trees (mixed and 4-bit experts)
    cross JAX -> port -> numpy unchanged; the port's own quantized tree
    crosses to JAX, whose dispatch-off forward of it equals the port's
    within 1e-5 of max |logit|."""
    jparams, tparams = _float_params(name)
    same_numpy(params_to_numpy(tparams), jax_to_numpy(jparams))
    for kind in KINDS:
        jqm, tqm = _quantized(name, kind)
        same_numpy(params_to_numpy(params_from_numpy(
            jax_to_numpy(jqm.params), "cpu")), jax_to_numpy(jqm.params))
        back = numpy_to_jax(params_to_numpy(tqm.params))
        tokens = np.random.default_rng(9).integers(
            0, tqm.cfg.vocab_size, (2, 8), dtype=np.int32)
        with _off():
            want = np.asarray(jax.jit(
                lambda p, t: jlm.forward(jqm.cfg, p, t))(
                    back, jnp.asarray(tokens)))
        got = tqm.forward(tokens).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FLOAT_TOL * np.abs(want).max())


@pytest.mark.parametrize("field,bad", [
    ("payload", lambda a: a[0]),
    ("u_scale", lambda a: a.reshape(a.shape[0], -1)),
    ("act_scale", lambda a: a.reshape(a.shape[0], 1, 1)),
    ("shape", lambda a: list(a)[1:]),
])
def test_mismatched_expert_fields_raise(field, bad):
    """An (L, E, K, N) QExpertM2Q whose field disagrees with its shape
    raises on the way in."""
    import copy
    jqm, _ = _quantized("dbrx-132b", "reduced")
    tree = copy.deepcopy(jax_to_numpy(jqm.params))
    leaf = tree["layers"]["moe"]["experts"]["w2"]
    leaf[field] = bad(leaf[field])
    with pytest.raises((TypeError, ValueError)):
        params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_a_port_artifact_loads_in_jax_and_a_jax_artifact_in_the_port(
        name, kind, tmp_path):
    """The port's saved artifact loaded by the JAX package and JAX's by
    the port -- equal leaves and provenance (the MoE config fields
    carried both ways), the same manifest when re-saved."""
    jqm, tqm = _quantized(name, kind)
    pdir = tqm.save(tmp_path / "port")
    loaded_j = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(loaded_j.params), params_to_numpy(tqm.params))
    assert artifact_payload(loaded_j, "jax") == artifact_payload(tqm, "port")
    assert loaded_j.cfg == _cfgs(name, kind)[0]
    jdir = jqm.save(tmp_path / "jax")
    loaded_t = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    same_numpy(params_to_numpy(loaded_t.params), jax_to_numpy(jqm.params))
    assert artifact_payload(loaded_t, "port") == artifact_payload(jqm, "jax")
    assert loaded_t.cfg == _cfgs(name, kind)[1]
    assert manifest(loaded_t.save(tmp_path / "port2")) == manifest(jdir)
    assert manifest(loaded_j.save(tmp_path / "jax2")) == manifest(pdir)


@pytest.mark.parametrize("toks", [2, 64, 256])
@pytest.mark.parametrize("name", NAMES)
def test_abstract_twin_equals_jax_at_full_width(name, toks):
    """Each config at its published width under m2q-w8a8 at 2, 64 and 256
    tokens a step, against JAX's ``abstract_quantize`` (meta tensors,
    nothing allocated): classes, static fields, shapes and dtypes equal.
    At 2 every leaf is a 4-bit QUniform (the experts (L, E, K, N) with
    axis 3); the experts turn mixed (QExpertM2Q, (L, 1, 1, 1) activation
    scales) once a step gives each expert 64 tokens."""
    ours = tr.abstract_quantize(name, recipe=tr.PRESETS["m2q-w8a8"].replace(
        tokens_per_step=toks))
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(jr.abstract_quantize(
        name, recipe=jr.PRESETS["m2q-w8a8"].replace(tokens_per_step=toks)))
    cfg = TARCHS[name]
    w1 = got["layers/moe/experts/w1"]
    per_expert = toks * cfg.moe_top_k / cfg.moe_experts
    if toks == 2:
        assert {v[0] for v in got.values() if v[0] != "float"} == \
            {"QUniform"}
        assert w1[1]["axis"] == 3
    assert w1[0] == ("QExpertM2Q" if per_expert >= 64 else "QUniform")
    if w1[0] == "QExpertM2Q":
        assert w1[2]["act_scale"][0] == (cfg.n_layers, 1, 1, 1)
    assert w1[1]["shape"] == (cfg.n_layers, cfg.moe_experts, cfg.d_model,
                              cfg.moe_d_ff)


@pytest.mark.parametrize("name", NAMES)
def test_cfg_json_equals_the_jax_packages(name):
    """The artifact's config payload (the five MoE fields included) as
    JAX writes it, read back by either package."""
    cfg, jcfg = TREDUCED[name], JREDUCED[name]
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert tr._cfg_from_json(want) == cfg
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


# ---------------------------------------------------------------------------
# the token Engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_equal_the_jax_engines(name, kv):
    """On JAX's float weights, both packages' engines (JAX's with every
    dispatch axis off) serve the same 5 requests at ``max_batch`` 2 to
    the same greedy tokens: right-padded prefill groups route their pad
    positions through ``moe_ffn`` alike, and every decode slot, idle ones
    too, takes its capacity alike."""
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


# ---------------------------------------------------------------------------
# chip_smoke's phase 11, rehearsed at REDUCED width on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_phase_11_serving_at_reduced_width(name, tmp_path):
    """``chip_smoke.moe_case`` on the CPU at REDUCED width (plain
    versions, eager engines): quantize (at this width the decode shape
    takes the mixed path, through the taxonomy overrides),
    the artifact round trip, 4 requests served eagerly and "graphed"
    with equal tokens, launches as ``tree_launches`` counts them (E
    expert launches per expert leaf and layer), and no problem."""
    cfg = TREDUCED[name].replace(kv_cache_dtype="int8")
    res, problems, _, qm = chip_smoke.moe_case(
        torch, cfg, tokens_per_step=None, device="cpu", requests=4,
        max_new=4, max_len=64, artifacts=tmp_path)
    assert problems == []
    assert chip_smoke.leaf_problems(qm, mixed=True) == []
    assert chip_smoke.leaf_problems(qm, mixed=False) != []
    assert res["served_tokens_max"] < cfg.vocab_size
    assert res["teacher_forced_max_abs_diff"] == 0.0  # plain both ways
    assert res["leaves"]["layers/moe/experts/w1"].startswith("QExpertM2Q")
    assert res["artifact"]["artifact_bytes"] > 0

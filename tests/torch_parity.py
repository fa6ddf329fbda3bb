"""Helpers the port's parity tests share: the JAX package's trees in the
numpy crossing format (``repro_torch.convert``), a JAX-side quantize of a
resolved recipe with its eager per-leaf work spread over threads, and
JAX's dispatch-off forward."""
import dataclasses
import functools
import json
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import qtensor as jq
from repro.core.apply import quantize_model
from repro.core.calibrate import (rule_matcher, run_calibration,
                                  wrap_for_calibration)
from repro.kernels import ops as jops
from repro.models import efficientvit as jev

# One intra-op thread for the port's tests.  Every pytest-xdist worker
# imports this module at collection, so it holds for every test the
# worker runs: the workers share the host's cores, and torch's default of
# a thread per core oversubscribes them -- a reduced B1 forward took
# 0.11 s on one thread and 4.2 s on eight beside five busy workers.
torch.set_num_threads(1)


def jax_to_numpy(tree):
    """JAX params (QTensor leaves included) -> the numpy crossing format."""
    def opt(a):
        return None if a is None else np.asarray(a)

    if isinstance(tree, (jq.QM2Q, jq.QExpertM2Q)):
        return {"qtensor": type(tree).__name__,
                "payload": np.asarray(tree.payload),
                "u_scale": np.asarray(tree.u_scale),
                "u_zp": np.asarray(tree.u_zp),
                "a_scale": np.asarray(tree.a_scale),
                "act_scale": opt(tree.act_scale),
                "shape": list(tree.shape), "n_uniform": tree.n_uniform,
                "n_apot": tree.n_apot}
    if isinstance(tree, jq.QUniform):
        return {"qtensor": "QUniform", "payload": np.asarray(tree.payload),
                "scale": np.asarray(tree.scale),
                "zero_point": np.asarray(tree.zero_point),
                "act_scale": opt(tree.act_scale),
                "bits": tree.bits, "axis": tree.axis,
                "shape": list(tree.shape)}
    if isinstance(tree, jq.QAPoT):
        return {"qtensor": "QAPoT", "codes": np.asarray(tree.codes),
                "scale": np.asarray(tree.scale),
                "act_scale": opt(tree.act_scale), "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


def numpy_to_jax(tree):
    """The numpy crossing format -> JAX QTensor leaves (numpy fields),
    the inverse of :func:`jax_to_numpy`."""
    if isinstance(tree, dict) and "qtensor" in tree:
        d, shape = tree, tuple(tree["shape"])
        if d["qtensor"] in ("QM2Q", "QExpertM2Q"):
            return getattr(jq, d["qtensor"])(
                d["payload"], d["u_scale"], d["u_zp"], d["a_scale"],
                d["act_scale"], shape=shape, n_uniform=d["n_uniform"],
                n_apot=d["n_apot"])
        if d["qtensor"] == "QUniform":
            return jq.QUniform(d["payload"], d["scale"], d["zero_point"],
                               d["act_scale"], bits=d["bits"],
                               axis=d["axis"], shape=shape)
        return jq.QAPoT(d["codes"], d["scale"], d["act_scale"], shape=shape)
    if isinstance(tree, dict):
        return {k: numpy_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_to_jax(v) for v in tree]
    return tree


def jax_forward(cfg, params, images):
    """JAX's dispatch-off forward (XLA QTensor paths, f32 attention)."""
    with jops.dispatch(dense=False, conv=False, attn=False):
        fwd = jax.jit(lambda p, x: jev.forward(cfg, p, x))
        return np.asarray(fwd(params, images))


def jax_lm_forward(cfg, params, tokens):
    """JAX's dispatch-off forward of a token model (any LM family of the
    registry) over (B, S) tokens: (B, S, padded_vocab) f32 logits."""
    from repro.models import get_model
    model = get_model(cfg)
    with jops.dispatch(dense=False, conv=False, attn=False):
        fwd = jax.jit(lambda p, t: model.forward(cfg, p, t))
        return np.asarray(fwd(params, np.asarray(tokens, np.int32)),
                          np.float32)


def jax_quantize(cfg, params, recipe, batches, groups=4):
    """What ``repro.recipe.quantize(cfg, params, recipe, batches)`` does
    (dispatch off), with its ``quantize_model`` step run over disjoint
    leaf groups in threads.  Each leaf is quantized on its own either way
    (same rules, overrides, shape context and calibration stats); the JAX
    package's eager ops compile one XLA program each, and those compiles
    overlap across threads, which takes a reduced B1 from ~2 min to well
    under one.  Returns (qparams, reports in tree order, act stats)."""
    resolved = recipe.resolve(cfg)
    stats = {}
    if recipe.policy.quantize_activations and recipe.tokens_per_step is None:
        # the deployment shape of the real calibration batches
        resolved = dataclasses.replace(resolved, shape_ctx=dataclasses.replace(
            resolved.shape_ctx,
            tokens_per_step=batches[0].shape[0] * cfg.img_res ** 2))
    with jops.dispatch(dense=False, conv=False, attn=False):
        if recipe.policy.quantize_activations:
            wrapped, stats = wrap_for_calibration(
                params, rule_matcher(resolved.rules))
            run_calibration(
                lambda p, x: jev.forward(cfg, p, x, unroll=True), wrapped,
                batches)
        flat, treedef = jax.tree_util.tree_flatten_with_path(params)

        def run(g):
            leaves = [leaf if i % groups == g else None
                      for i, (_, leaf) in enumerate(flat)]
            return quantize_model(
                jax.tree_util.tree_unflatten(treedef, leaves),
                resolved.rules, resolved.shape_ctx, resolved.policy,
                act_stats=stats, overrides=resolved.overrides)

        with ThreadPoolExecutor(groups) as pool:
            parts = list(pool.map(run, range(groups)))
    part_leaves = [jax.tree_util.tree_leaves(
        q, is_leaf=lambda x: x is None or isinstance(x, jq.QLeaf))
        for q, _ in parts]
    qparams = jax.tree_util.tree_unflatten(
        treedef, [part_leaves[i % groups][i] for i in range(len(flat))])
    order = [jcal.path_str(path) for path, _ in flat]
    reports = {r.path: r for part in parts for r in part[1]}
    return qparams, [reports[k] for k in order if k in reports], stats


# ---------------------------------------------------------------------------
# the recipe paths, built the same way in both packages
# ---------------------------------------------------------------------------

# per recipe: which kernel's function each quantized matmul/conv of the
# reduced B1 forward takes (16 dense leaves: 8 PWConvs, 3x MSA qkv/proj,
# head w_in/w; 7 depthwise: 4 MBConv w_dw, 3 MSA w_agg)
RECIPE_KERNELS = {
    "m2q-w8a8": {"m2q_matmul": 16, "dwconv_w4": 7},
    "uniform8": {"int8_matmul": 16},
    "int8-stem": {"int8_matmul": 1, "m2q_matmul": 16, "dwconv_w4": 7},
    "w4-weights-only": {"int4_matmul": 16, "dwconv_w4": 7},
    "apot-weights-only": {"apot_matmul": 16, "dwconv_w4": 7},
}


def recipe_pair(name):
    """(JAX recipe, the port's recipe) for one recipe path, each built
    through its own package's public API."""
    from repro import recipe as jr
    from repro.core.policy import M2QPolicy as JPolicy
    from repro_torch import recipe as tr
    from repro_torch.core.policy import M2QPolicy as TPolicy
    from repro_torch.models import efficientvit as tev
    if name == "int8-stem":
        return (jr.PRESETS["m2q-w8a8"].replace(
                    rules=tuple(jev.QUANT_RULES) + (jev.STEM_RULE,),
                    overrides=(jev.STEM_OVERRIDE,)),
                tr.PRESETS["m2q-w8a8"].replace(
                    rules=tuple(tev.QUANT_RULES) + (tev.STEM_RULE,),
                    overrides=(tev.STEM_OVERRIDE,)))
    if name == "apot-weights-only":
        return tuple(
            r.QuantRecipe(name=name, policy=P(compute_scheme="apot",
                                              quantize_activations=False))
            for r, P in ((jr, JPolicy), (tr, TPolicy)))
    return jr.PRESETS[name], tr.PRESETS[name]


@functools.lru_cache(maxsize=None)
def recipe_case(name) -> "RecipeCase":
    """The RecipeCase of one recipe path, built once per process."""
    return RecipeCase(name)


class RecipeCase:
    """One recipe path at the reduced B1, run in both packages from the
    same JAX-initialised weights and calibration batches."""

    def __init__(self, name):
        from repro.configs.efficientvit_b1 import REDUCED as JCFG
        from repro_torch import recipe as tr
        from repro_torch.configs.efficientvit_b1 import REDUCED as TCFG
        from repro_torch.convert import params_from_numpy

        self.name = name
        self.kernels = RECIPE_KERNELS[name]
        self.jax_recipe, self.recipe = recipe_pair(name)
        rng = np.random.default_rng(0)
        self.batches = [rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
                        for _ in range(2)]
        self.images = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
        params = jax.jit(lambda k: jev.init(JCFG, k))(jax.random.PRNGKey(0))
        qparams, self.jax_report, self.jax_stats = jax_quantize(
            JCFG, params, self.jax_recipe, self.batches)
        self.jax_qparams = jax_to_numpy(qparams)
        self.jax_qlogits = jax_forward(JCFG, qparams, self.images)
        self.port = tr.quantize(
            TCFG, params_from_numpy(jax_to_numpy(params), "cpu"),
            self.recipe, calib_batches=self.batches, attn="f32")


# ---------------------------------------------------------------------------
# checks every recipe path passes; a test file imports them beside a
# module-scoped ``case`` fixture that yields RecipeCase objects
# ---------------------------------------------------------------------------

_FIELDS = {"QM2Q": ("payload", "u_scale", "u_zp", "a_scale", "n_uniform",
                    "n_apot"),
           "QUniform": ("payload", "scale", "zero_point", "bits", "axis"),
           "QAPoT": ("codes", "scale")}


def test_quantized_leaves_match_jax(case):
    """Both packages quantize the same float weights from the same
    calibration batches: every leaf has the JAX leaf's class, and its
    payload bytes, APoT codes, scales, zero points and Eq. 6 split are
    equal bit for bit.  The activation scales come from each package's own
    float forward over the calibration batches, so they agree to f32
    summation-order noise (rtol 1e-5); the stem's, a max over the input
    images, is exact."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.tree import leaves_with_path
    ours = dict(leaves_with_path(params_to_numpy(case.port.params)))
    theirs = dict(leaves_with_path(case.jax_qparams))
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if key.endswith("/act_scale") and want is not None:
            rtol = 0 if key.startswith("stem/") else 1e-5
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=key)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key
    kinds = Counter(v for k, v in theirs.items() if k.endswith("/qtensor"))
    assert sum(kinds.values()) == sum(case.kernels.values()) + (
        7 if case.name == "uniform8" else 0)


def test_reports_match_jax(case):
    jrep = {r.path: r for r in case.jax_report}
    assert [r.path for r in case.port.report] == list(jrep)
    for r in case.port.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.bits, r.n_apot, r.n_uniform) == \
            (j.kind, j.decision, j.bits, j.n_apot, j.n_uniform), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    assert sorted(case.port.act_stats) == sorted(case.jax_stats)


def test_carried_forward_matches_jax(case):
    """The JAX-quantized tree carried across: the port's forward (f32
    attention) against JAX's dispatch-off forward, each quantized matmul
    through the function of the kernel the recipe routes it to (the plain
    versions, on the CPU).  Weights-only recipes are pure f32 on both
    sides: only summation order differs (1e-5 of the largest logit, as for
    the float forward).  The W8A8 recipes' integer sums are exact; float
    summation order upstream of an activation quantizer could flip one
    int8 rounding step, which 1e-4 of the largest logit admits and nothing
    larger.  The argmax must agree."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.efficientvit_b1 import REDUCED as TCFG
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import efficientvit as tev
    params = params_from_numpy(case.jax_qparams, "cpu")
    kernels.reset_counts()
    with torch.inference_mode():
        y = tev.forward(TCFG, params, torch.from_numpy(case.images),
                        attn="f32").numpy()
    plain = {k: c["plain_calls"] for k, c in kernels.counts().items()
             if c["plain_calls"]}
    assert plain == case.kernels
    want = case.jax_qlogits
    tol = 1e-4 if case.recipe.policy.quantize_activations else 1e-5
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# trees and artifacts compared across packages
# ---------------------------------------------------------------------------


def same_numpy(a, b):
    """Equal numpy crossing trees: leaf classes, static fields, array
    dtypes and bits."""
    from repro_torch.core.tree import leaves_with_path
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    assert sorted(la) == sorted(lb)
    for key, x in la.items():
        y = lb[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert x == y, key


def artifact_payload(qm, package):
    """(cfg, recipe, report, act_stats, provenance) of a QuantizedModel of
    ``package`` (``"jax"`` or ``"port"``) in the JSON form."""
    from repro import recipe as jr
    from repro_torch import recipe as tr
    m = jr if package == "jax" else tr
    return (json.loads(json.dumps(m._cfg_to_json(qm.cfg))),
            m._recipe_to_json(qm.recipe),
            [m._report_to_json(r) for r in qm.report],
            {k: float(v) for k, v in qm.act_stats.items()},
            dict(qm.provenance))


def manifest(step_dir):
    return json.loads((Path(step_dir) / "manifest.json").read_text())


def _dtype(dtype) -> str:
    import torch
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def abstract_fields(leaf):
    """(class, static fields, {field: (shape, numpy dtype name) or None})
    of a QTensor leaf of either package; (``"float"``, shape, dtype) of a
    float leaf."""
    if not dataclasses.is_dataclass(leaf):
        return "float", tuple(leaf.shape), _dtype(leaf.dtype)
    arrays, static = {}, {}
    for f in dataclasses.fields(leaf):
        v = getattr(leaf, f.name)
        if v is None or hasattr(v, "dtype"):
            arrays[f.name] = None if v is None else (tuple(v.shape),
                                                     _dtype(v.dtype))
        else:
            static[f.name] = v
    return type(leaf).__name__, static, arrays


def abstract_tree(tree):
    from repro_torch.core.tree import leaves_with_path
    return {k: abstract_fields(v) for k, v in leaves_with_path(tree)}


def all_meta(tree):
    """Assert every tensor of a port tree is on the ``meta`` device."""
    import torch
    from repro_torch.core.qtensor import QLeaf
    from repro_torch.core.tree import leaves_with_path
    for _, leaf in leaves_with_path(tree):
        for f in (dataclasses.fields(leaf) if isinstance(leaf, QLeaf)
                  else ()):
            v = getattr(leaf, f.name)
            if isinstance(v, torch.Tensor):
                assert v.device.type == "meta"
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta"


# ---------------------------------------------------------------------------
# serving: the reduced qwen1.5-0.5b engines of both packages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reduced_lm_params():
    """The reduced qwen1.5-0.5b's float params from the JAX package's init
    at ``PRNGKey(0)``: (JAX tree, the same numbers as the port's CPU
    tree)."""
    from repro.configs.registry import REDUCED
    from repro.models import dense_lm
    from repro_torch.convert import params_from_numpy
    cfg = REDUCED["qwen1.5-0.5b"]
    jparams = jax.jit(lambda k: dense_lm.init(cfg, k))(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_to_numpy(jparams), "cpu")


def lm_engines(kv_cache_dtype="bf16", **kw):
    """(JAX Engine with every dispatch axis off, the port's Engine on the
    CPU) over the same reduced-qwen weights; ``kw`` goes to both (an
    ``faults=`` spec string is parsed by each package)."""
    from repro.configs.registry import REDUCED as JREDUCED
    from repro.serving import faults as jfaults
    from repro.serving.engine import Engine as JEngine
    from repro_torch.configs.registry import REDUCED as TREDUCED
    from repro_torch.serving import faults as tfaults
    from repro_torch.serving.engine import Engine as TEngine
    jparams, tparams = reduced_lm_params()
    spec = kw.pop("faults", None)
    kw = dict(dict(max_batch=2, max_len=64), **kw)
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    jeng = JEngine(JREDUCED["qwen1.5-0.5b"].replace(
        kv_cache_dtype=kv_cache_dtype), jparams, dispatch=off,
        faults=jfaults.FaultInjector.parse(spec) if spec else None, **kw)
    teng = TEngine(TREDUCED["qwen1.5-0.5b"].replace(
        kv_cache_dtype=kv_cache_dtype), tparams,
        faults=tfaults.FaultInjector.parse(spec) if spec else None, **kw)
    return jeng, teng


def lm_prompts(vocab_size, n, seed=0, lo=4, hi=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def outcomes(reqs):
    """Per request: (uid, state, exception class name or None, tokens
    delivered)."""
    rows = []
    for r in reqs:
        exc = r.handle.exception()
        rows.append((r.uid, r.handle.state,
                     type(exc).__name__ if exc is not None else None,
                     len(r.out_tokens or [])))
    return rows


def done_tokens(reqs):
    """Per DONE request: uid -> the tokens its handle delivered."""
    return {r.uid: list(map(int, r.handle.result())) for r in reqs
            if r.handle.state == "DONE"}


OUTCOME_FIELDS = ("submitted", "completed", "failed", "cancelled",
                  "timed_out", "shed", "rejected", "steps", "prefills",
                  "prefill_batches", "finished", "decoded_tokens",
                  "preemptions", "streamed_tokens")


def stats_fields(stats):
    return {k: getattr(stats, k) for k in OUTCOME_FIELDS}

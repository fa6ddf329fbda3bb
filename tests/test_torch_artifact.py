"""``QuantizedModel.save`` / ``load`` and the shape-only twin
``abstract_quantize`` of the port, against the JAX package's.

* Artifacts cross in both directions: the reduced EfficientViT-B1 under
  ``m2q-w8a8`` (the JAX side from ``torch_parity.RecipeCase``, whose JAX
  QTensors are rebuilt from numpy, so ``repro.recipe.quantize`` never
  runs) and the reduced qwen under ``w4-weights-only``.  Each package
  loads the other's artifact leaf for leaf bit-identical, with equal
  recipe, report, act_stats, provenance and cfg, and a re-save gives the
  same manifest.
* The other four recipe paths round-trip in the port alone, forward
  included.
* The abstract twin equals the concrete tree at the reduced sizes and
  JAX's ``abstract_quantize`` at full width (B1 R224, qwen1.5-0.5b), on
  ``meta`` tensors; ``apot_ratio=None`` needs the saved splits.

The trained proxy's artifact: ``test_torch_artifact_proxy.py``."""
import functools
import inspect
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import REDUCED as JREDUCED
from repro.kernels import ops as jops
from repro.models import dense_lm as jlm
from repro_torch import recipe as tr
from repro_torch.configs.registry import REDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.policy import M2QPolicy
from repro_torch.models import dense_lm, efficientvit
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          jax_to_numpy, manifest, numpy_to_jax, recipe_case,
                          recipe_pair, same_numpy)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the card's proxy gate)

VISION = list(chip_smoke.PATHS)


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


# ---------------------------------------------------------------------------
# artifacts across packages
# ---------------------------------------------------------------------------


def _b1_pair():
    """(JAX QuantizedModel, the port's) of the reduced B1 under m2q-w8a8,
    each quantized by its own package from the same weights and
    calibration batches."""
    from repro.configs.efficientvit_b1 import REDUCED as JCFG
    case = recipe_case("m2q-w8a8")
    toks = case.port.recipe.tokens_per_step
    jqm = jr.QuantizedModel(
        cfg=JCFG, recipe=case.jax_recipe.replace(tokens_per_step=toks),
        params=numpy_to_jax(case.jax_qparams), report=case.jax_report,
        act_stats={k: float(v) for k, v in case.jax_stats.items()},
        provenance={"calib_batches": len(case.batches),
                    "calib_sites": len(case.jax_stats),
                    "tokens_per_step": toks})
    return jqm, case.port


def _qwen_pair():
    """The same for the reduced qwen under w4-weights-only."""
    jcfg = JREDUCED["qwen1.5-0.5b"]
    params = jax.jit(lambda k: jlm.init(jcfg, k))(jax.random.PRNGKey(0))
    with _off():
        jqm = jr.quantize(jcfg, params, "w4-weights-only")
    tqm = tr.quantize(REDUCED["qwen1.5-0.5b"],
                      params_from_numpy(jax_to_numpy(params), "cpu"),
                      "w4-weights-only")
    return jqm, tqm


PAIRS = {"b1-m2q-w8a8": _b1_pair, "qwen-w4-weights-only": _qwen_pair}


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    return PAIRS[request.param]()


def test_a_jax_saved_artifact_loads_in_the_port(pair, tmp_path):
    """Leaf for leaf equal to ``params_from_numpy`` of JAX's tree, with
    the same provenance; re-saved by the port, the manifest (leaf list
    and ``extra``) is JAX's."""
    jqm, _ = pair
    jdir = jqm.save(tmp_path / "jax")
    qm = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    want = params_from_numpy(jax_to_numpy(jqm.params), "cpu")
    same_numpy(params_to_numpy(qm.params), params_to_numpy(want))
    assert artifact_payload(qm, "port") == artifact_payload(jqm, "jax")
    pdir = qm.save(tmp_path / "port")
    assert manifest(pdir) == manifest(jdir)


def test_a_port_saved_artifact_loads_in_the_jax_package(pair, tmp_path):
    _, tqm = pair
    pdir = tqm.save(tmp_path / "port")
    jqm = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(jqm.params), params_to_numpy(tqm.params))
    assert artifact_payload(jqm, "jax") == artifact_payload(tqm, "port")
    jdir = jqm.save(tmp_path / "jax")
    assert manifest(jdir) == manifest(pdir)


@functools.lru_cache(maxsize=None)
def _port_b1(name):
    """The reduced B1 quantized by the port under one recipe path (seed 1,
    one calibration batch), shared by the round-trip and shape-only twin
    tests."""
    cfg = REDUCED["efficientvit-b1-r224"]
    batches = [np.random.default_rng(4).normal(0, 1, (2, 32, 32, 3))
               .astype(np.float32)]
    return tr.quantize(cfg, efficientvit.init(cfg, seed=1, device="cpu"),
                       chip_smoke.path_recipe(name), calib_batches=batches,
                       attn="f32")


@pytest.mark.parametrize("name", VISION)
def test_every_recipe_path_round_trips_in_the_port(name, tmp_path):
    """Quantize the reduced B1 under each recipe path, save, load: every
    leaf, the provenance and the forward equal at zero tolerance."""
    qm = _port_b1(name)
    qm.save(tmp_path)
    back = tr.QuantizedModel.load(tmp_path, device="cpu")
    same_numpy(params_to_numpy(back.params), params_to_numpy(qm.params))
    assert artifact_payload(back, "port") == artifact_payload(qm, "port")
    assert back.cfg == qm.cfg and back.recipe == qm.recipe
    images = np.random.default_rng(5).normal(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    for attn in ("f32", "int8"):
        assert torch.equal(back.forward(images, attn=attn),
                           qm.forward(images, attn=attn))


def test_load_defaults_to_the_card_and_refuses_what_is_no_artifact(tmp_path):
    assert inspect.signature(
        tr.QuantizedModel.load).parameters["device"].default == "cuda"
    with pytest.raises(FileNotFoundError):
        tr.QuantizedModel.load(tmp_path, device="cpu")
    from repro_torch.ckpt import checkpoint as ckpt
    ckpt.save(tmp_path, 0, {"w": torch.zeros(2)}, extra={"kind": "other"})
    with pytest.raises(ValueError, match="not a QuantizedModel"):
        tr.QuantizedModel.load(tmp_path, device="cpu")


# ---------------------------------------------------------------------------
# the shape-only twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", VISION + ["qwen-w4-weights-only"])
def test_abstract_twin_equals_the_concrete_tree(name):
    if name.startswith("qwen"):
        cfg = REDUCED["qwen1.5-0.5b"]
        qm = tr.quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"),
                         "w4-weights-only")
    else:
        cfg, qm = REDUCED["efficientvit-b1-r224"], _port_b1(name)
    abstract = qm.abstract_params()
    all_meta(abstract)
    assert abstract_tree(abstract) == abstract_tree(qm.params)
    assert abstract_tree(tr.abstract_quantize(
        cfg, recipe=qm.recipe, with_act_scales=bool(qm.act_stats))) == \
        abstract_tree(qm.params)


# qwen at full width: every leaf is low-bit at the decode deployment
# shape, so the recipes differ in the bits only
FULL_WIDTH = [("efficientvit-b1-r224", n) for n in VISION] + [
    ("qwen1.5-0.5b", n) for n in ("m2q-w8a8", "uniform8", "w4-weights-only")]


@pytest.mark.parametrize("arch,name", FULL_WIDTH)
def test_abstract_twin_equals_jax_at_full_width(arch, name):
    """At the published widths, against JAX's ``abstract_quantize``
    (``jax.eval_shape`` of init): every leaf's class, static fields,
    shapes and dtypes; nothing allocated (``meta`` tensors throughout,
    the float init included)."""
    jrec, trec = recipe_pair(name)
    ours = tr.abstract_quantize(arch, recipe=trec)
    theirs = jr.abstract_quantize(arch, recipe=jrec)
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(theirs)
    assert {v[0] for v in got.values()} - {"float"}


def test_apot_ratio_none_needs_the_saved_splits(tmp_path):
    """The Eq. 6 argmin split is data-dependent: the twin refuses it
    without splits, and an artifact round-trips with the reports'."""
    cfg = REDUCED["efficientvit-b1-r224"]
    rec = tr.QuantRecipe(name="m2q-argmin", policy=M2QPolicy(
        apot_ratio=None))
    batches = [np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3))
               .astype(np.float32)]
    qm = tr.quantize(cfg, efficientvit.init(cfg, seed=2, device="cpu"), rec,
                     calib_batches=batches, attn="f32")
    assert any(r.n_apot != (r.n_apot + r.n_uniform) // 2 for r in qm.report
               if r.n_apot or r.n_uniform)
    with pytest.raises(ValueError, match="data-dependent"):
        tr.abstract_quantize(cfg, recipe=qm.recipe)
    with pytest.raises(ValueError, match="data-dependent"):
        rec.validate(abstract=True)
    qm.save(tmp_path)
    back = tr.QuantizedModel.load(tmp_path, device="cpu")
    same_numpy(params_to_numpy(back.params), params_to_numpy(qm.params))


@pytest.mark.parametrize("decision", ["lowbit", "mixed"])
def test_expert_leaves_raise_by_name_in_both_paths(decision):
    """MoE expert weights (``nn/moe.py``): the stacked (L, E, K, N)
    expert leaf both paths refused by name before the MoE port now
    quantizes in ``quantize_model`` and in its shape-only twin alike --
    a 4-bit QUniform at 64 tokens a step over one expert, a QExpertM2Q
    with (L, 1, 1, 1) activation scales under a mixed override -- equal
    bit for bit to JAX's ``quantize_model`` of the same weights, and the
    port's twin equal to the concrete leaf and to JAX's twin."""
    from repro.core import apply as japply
    from repro.core import policy as jpol
    from repro_torch.core import apply
    from repro_torch.core.policy import PathOverride, ShapeCtx
    w = np.random.default_rng(3).normal(0, 0.1, (2, 4, 64, 32)).astype(
        np.float32)
    stats = {f"layers/moe/experts/w1@{i}": 1.5 + i for i in range(2)}
    over = () if decision == "lowbit" else (
        (r"experts/", PathOverride(decision="mixed")),)
    jover = () if decision == "lowbit" else (
        (r"experts/", jpol.PathOverride(decision="mixed")),)
    ours, rep = apply.quantize_model(
        {"layers": {"moe": {"experts": {"w1": torch.from_numpy(w)}}}},
        dense_lm.QUANT_RULES, ShapeCtx(tokens_per_step=64),
        act_stats=stats, overrides=over)
    with _off():
        theirs, jrep = japply.quantize_model(
            {"layers": {"moe": {"experts": {"w1": jax.numpy.asarray(w)}}}},
            jlm.QUANT_RULES, jpol.ShapeCtx(tokens_per_step=64),
            act_stats=stats, overrides=jover)
    same_numpy(params_to_numpy(ours), jax_to_numpy(theirs))
    assert [(r.decision, r.n_uniform, r.n_apot) for r in rep] == \
        [(r.decision, r.n_uniform, r.n_apot) for r in jrep] == \
        [(decision, 16 if decision == "mixed" else 0,
          16 if decision == "mixed" else 0)]
    leaf = ours["layers"]["moe"]["experts"]["w1"]
    want_cls = "QUniform" if decision == "lowbit" else "QExpertM2Q"
    assert type(leaf).__name__ == want_cls
    if decision == "mixed":
        assert tuple(leaf.act_scale.shape) == (2, 1, 1, 1)
    twin = apply.abstract_quantize_model(
        {"layers": {"moe": {"experts": {"w1": torch.empty(
            w.shape, device="meta")}}}},
        dense_lm.QUANT_RULES, ShapeCtx(tokens_per_step=64), overrides=over)
    jtwin = japply.abstract_quantize_model(
        {"layers": {"moe": {"experts": {"w1": jax.ShapeDtypeStruct(
            w.shape, np.float32)}}}},
        jlm.QUANT_RULES, jpol.ShapeCtx(tokens_per_step=64), overrides=jover)
    all_meta(twin)
    assert abstract_tree(twin) == abstract_tree(ours) == abstract_tree(jtwin)

"""The port's weights-only recipe paths against the JAX package at the
reduced EfficientViT-B1: ``w4-weights-only`` (every quantizable weight
4-bit uniform: PWConvs -> int4_matmul, depthwise -> dwconv_w4) and the
weights-only APoT recipe (``M2QPolicy(compute_scheme="apot",
quantize_activations=False)``: PWConvs -> apot_matmul).  The checks every
recipe path passes live in ``torch_parity`` and are imported here beside
the ``case`` fixture."""
import numpy as np
import pytest
import torch

from repro_torch import recipe
from repro_torch.core.qtensor import QAPoT, QUniform
from repro_torch.core.tree import leaves_with_path
from torch_parity import (recipe_case,  # noqa: F401 (shared tests)
                          test_carried_forward_matches_jax,
                          test_quantized_leaves_match_jax,
                          test_reports_match_jax)


@pytest.fixture(scope="module",
                params=["w4-weights-only", "apot-weights-only"])
def case(request):
    return recipe_case(request.param)


def test_w4_weights_only_is_4bit_everywhere_without_calibration():
    """The recipe's (".", LOWBIT) override beats efficientvit's mixed
    pins: every quantized leaf is 4-bit uniform with no activation scale,
    and no calibration ran."""
    qm = recipe_case("w4-weights-only").port
    leaves = dict(leaves_with_path(qm.params))
    assert len(qm.report) == 23
    for r in qm.report:
        leaf = leaves[r.path]
        assert isinstance(leaf, QUniform) and leaf.bits == 4, r.path
        assert leaf.act_scale is None and r.decision == "lowbit", r.path
    assert qm.act_stats == {}
    assert qm.provenance["calib_batches"] == 0
    # the deployment shape falls back to the CalibSpec's batch size
    assert qm.recipe.tokens_per_step == recipe.CalibSpec().batch_size * 32 ** 2


def test_apot_weights_only_is_built_from_the_public_api():
    """No preset: the recipe is a QuantRecipe built from its fields, as in
    the JAX package.  Dense leaves become QAPoT without an activation
    scale (the apot_matmul kernel's leaves); depthwise stay 4-bit."""
    assert "apot-weights-only" not in recipe.PRESETS
    qm = recipe_case("apot-weights-only").port
    leaves = dict(leaves_with_path(qm.params))
    for r in qm.report:
        leaf = leaves[r.path]
        if r.kind == "dwconv":
            assert isinstance(leaf, QUniform) and leaf.bits == 4, r.path
        else:
            assert isinstance(leaf, QAPoT) and leaf.act_scale is None, r.path
            assert leaf.codes.dtype == torch.uint8, r.path
    assert qm.provenance["calib_batches"] == 0


def test_4bit_zero_points_are_integral_in_both_packages():
    """The int4 kernel decodes ``q - zp`` exactly in bf16 only for an
    integral zero point: every 4-bit QUniform leaf of the reduced B1 under
    ``w4-weights-only`` has one, in the port and in JAX (same weights)."""
    from repro_torch.convert import params_to_numpy
    case = recipe_case("w4-weights-only")
    trees = (params_to_numpy(case.port.params), case.jax_qparams)
    for tree in trees:
        zps = [v for k, v in leaves_with_path(tree)
               if k.endswith("/zero_point")]
        assert len(zps) == 23
        for zp in zps:
            assert np.array_equal(zp, np.round(zp))
            assert zp.min() >= 0 and zp.max() <= 15

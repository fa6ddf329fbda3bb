"""The port's W8A8 recipe paths against the JAX package at the reduced
EfficientViT-B1: ``uniform8`` (W8A8 uniform PWConvs -> int8_matmul; the
8-bit depthwise filters run the dequantized float conv) and the opt-in
int8 stem (``STEM_RULE`` + ``STEM_OVERRIDE``: im2col + int8_matmul, the
rest as m2q-w8a8).  The checks every recipe path passes live in
``torch_parity`` and are imported here beside the ``case`` fixture."""
import numpy as np
import pytest
import torch

from repro_torch import recipe
from repro_torch.configs.efficientvit_b1 import REDUCED
from repro_torch.core.qtensor import QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import efficientvit as tev
from torch_parity import (recipe_case,  # noqa: F401 (shared tests)
                          test_carried_forward_matches_jax,
                          test_quantized_leaves_match_jax,
                          test_reports_match_jax)


@pytest.fixture(scope="module", params=["uniform8", "int8-stem"])
def case(request):
    return recipe_case(request.param)


def test_uniform8_gives_w8a8_pwconvs_and_8bit_depthwise_filters():
    qm = recipe_case("uniform8").port
    leaves = dict(leaves_with_path(qm.params))
    assert len(qm.report) == 23
    for r in qm.report:
        leaf = leaves[r.path]
        assert isinstance(leaf, QUniform) and leaf.bits == 8, r.path
        assert (leaf.act_scale is None) == (r.kind == "dwconv"), r.path
    assert isinstance(qm.params["stem"]["w"], torch.Tensor)


def test_calibration_follows_the_resolved_rules_to_the_stem():
    """The recipe's own rules drive calibration: with STEM_RULE appended
    the stem records its input max-abs (exactly max|batch|) and becomes a
    calibrated uniform-8 leaf; the model's rules alone leave it float."""
    case = recipe_case("int8-stem")
    qm = case.port
    assert qm.act_stats["stem/w"] == max(float(np.abs(b).max())
                                         for b in case.batches)
    stem = qm.params["stem"]["w"]
    assert isinstance(stem, QUniform) and stem.bits == 8
    assert stem.act_scale is not None
    assert tuple(stem.payload.shape) == (27, REDUCED.widths[0])
    assert qm.recipe.tokens_per_step == 2 * 32 * 32  # pinned from the batches
    plain = recipe.quantize(REDUCED, tev.init(REDUCED, seed=0, device="cpu"),
                            "m2q-w8a8", calib_batches=case.batches[:1],
                            attn="f32")
    assert "stem/w" not in plain.act_stats
    assert isinstance(plain.params["stem"]["w"], torch.Tensor)


def test_recipe_overrides_precede_the_arch_overrides():
    stem = recipe_case("int8-stem").recipe.resolve(REDUCED)
    assert stem.overrides == (tev.STEM_OVERRIDE,) + tev.QUANT_OVERRIDES
    assert stem.rules[-1] == tev.STEM_RULE
    w4 = recipe.PRESETS["w4-weights-only"].resolve(REDUCED)
    assert w4.overrides[0][0] == "." and \
        w4.overrides[0][1].decision == "lowbit"
    assert w4.overrides[1:] == tev.QUANT_OVERRIDES
    with pytest.raises(ValueError, match="compute_scheme"):
        recipe.quantize(REDUCED, {}, recipe.PRESETS["uniform8"].replace(
            policy=recipe.M2QPolicy(compute_scheme="fp8")))

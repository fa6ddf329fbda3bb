"""The whole first slice of the port against the JAX package, at the REDUCED
EfficientViT-B1 (widths (8,16,32), depths (1,1,2), R32, f32; it keeps MSA
and the stride-2 stage entries): JAX-initialised weights carried across,
the float forward, quantization in both packages from the same
calibration batches, and the quantized forward of the JAX-quantized tree
against JAX's dispatch-off forward.  Inputs are numpy arrays from fixed
seeds; the JAX side runs once per module (its eager quantize dominates)."""
import jax
import numpy as np
import pytest
import torch

from repro import recipe as jrecipe
from repro.configs.efficientvit_b1 import REDUCED as JCFG
from repro.models import efficientvit as jev
from repro_torch import recipe
from repro_torch.configs.efficientvit_b1 import REDUCED as TCFG
from repro_torch.convert import params_from_numpy
from repro_torch.core.qtensor import QM2Q, QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import efficientvit as tev
from torch_parity import jax_forward, jax_quantize, jax_to_numpy


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    batches = [rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
               for _ in range(2)]
    images = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    params = jax.jit(lambda k: jev.init(JCFG, k))(jax.random.PRNGKey(0))
    qparams, report, _ = jax_quantize(JCFG, params,
                                      jrecipe.PRESETS["m2q-w8a8"], batches)
    return {"batches": batches, "images": images,
            "params": jax_to_numpy(params),
            "logits": jax_forward(JCFG, params, images),
            "report": report, "qparams": jax_to_numpy(qparams),
            "qlogits": jax_forward(JCFG, qparams, images)}


def test_init_tree_matches_jax(ref):
    """Same paths, shapes and dtypes; ones where JAX has ones; the same
    lecun_normal scale (the random streams differ)."""
    ours = dict(leaves_with_path(tev.init(TCFG, seed=0, device="cpu")))
    theirs = dict(leaves_with_path(ref["params"]))
    assert sorted(ours) == sorted(theirs)
    for path, a in theirs.items():
        b = ours[path].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, path
        if np.all(a == 1.0):
            assert np.all(b == 1.0), path
        else:
            fan_in = int(np.prod(a.shape[:-1]))
            assert 0.5 < b.std() * np.sqrt(fan_in) < 1.5, path


def test_float_forward_matches_jax(ref):
    """f32 end to end; only the float summation order differs (XLA convs
    vs torch convs/matmuls).  Measured: 5.8e-7 of the largest logit; the
    bound, 1e-5 of it, is f32 rounding over ~40 layers with headroom."""
    params = params_from_numpy(ref["params"], "cpu")
    with torch.inference_mode():
        y = tev.forward(TCFG, params, torch.from_numpy(ref["images"]),
                        attn="f32").numpy()
    want = ref["logits"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))


def test_quantize_gives_the_jax_bytes_for_every_leaf(ref):
    """Both packages quantize the same float weights from the same
    calibration batches: every weight payload, scale, zero point and Eq. 6
    split is equal bit for bit.  The activation scales come from each
    package's own float forward over the calibration batches, so they agree
    to f32 summation-order noise (measured 3.5e-7 relative; rtol 1e-5)."""
    params = params_from_numpy(ref["params"], "cpu")
    qm = recipe.quantize(TCFG, params, "m2q-w8a8",
                         calib_batches=ref["batches"], attn="f32")
    ours = dict(leaves_with_path(qm.params))
    theirs = dict(leaves_with_path(ref["qparams"]))  # keys path/field
    n_m2q = n_dw = 0
    for path, leaf in ours.items():
        if isinstance(leaf, QM2Q):
            n_m2q += 1
            fields = ("payload", "u_scale", "u_zp", "a_scale")
            assert theirs[f"{path}/qtensor"] == "QM2Q"
            assert theirs[f"{path}/n_uniform"] == leaf.n_uniform
            assert theirs[f"{path}/n_apot"] == leaf.n_apot
        elif isinstance(leaf, QUniform):
            n_dw += 1
            fields = ("payload", "scale", "zero_point")
            assert theirs[f"{path}/bits"] == leaf.bits == 4
        else:
            np.testing.assert_array_equal(leaf.numpy(), theirs[path])
            continue
        for f in fields:
            np.testing.assert_array_equal(getattr(leaf, f).numpy(),
                                          theirs[f"{path}/{f}"], err_msg=path)
        act = theirs[f"{path}/act_scale"]
        if act is None:
            assert leaf.act_scale is None, path
        else:
            np.testing.assert_allclose(leaf.act_scale.numpy(), act,
                                       rtol=1e-5, err_msg=path)
    assert (n_m2q, n_dw) == (16, 7)
    jrep = {r.path: r for r in ref["report"]}
    assert [r.path for r in qm.report] == [r.path for r in ref["report"]]
    for r in qm.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.bits, r.n_apot, r.n_uniform) == \
            (j.kind, j.decision, j.bits, j.n_apot, j.n_uniform), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)


def test_carried_quantized_forward_matches_jax(ref):
    """The JAX-quantized tree carried across: the port's forward with the
    f32 attention against JAX's dispatch-off forward.  The integer paths
    are exact; what differs is float summation order upstream of each
    activation quantizer (stem conv, norms, the f32 attention einsums),
    which could flip an int8 rounding by one step.  Measured: identical
    logits.  The bound, 1e-4 of the largest logit, admits a rare flip of
    that kind and nothing larger; the argmax must agree."""
    params = params_from_numpy(ref["qparams"], "cpu")
    with torch.inference_mode():
        y = tev.forward(TCFG, params, torch.from_numpy(ref["images"]),
                        attn="f32").numpy()
    want = ref["qlogits"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))


def test_int8_attention_stays_near_the_f32_forward(ref):
    """attn="int8" (the relu_attn kernel's function) moves numerics only by
    int8 quantization error on the MSA token mixer."""
    params = params_from_numpy(ref["qparams"], "cpu")
    x = torch.from_numpy(ref["images"])
    with torch.inference_mode():
        y8 = tev.forward(TCFG, params, x, attn="int8").numpy()
        y32 = tev.forward(TCFG, params, x, attn="f32").numpy()
    assert np.all(np.isfinite(y8))
    rel = np.linalg.norm(y8 - y32) / np.linalg.norm(y32)
    assert 0 < rel < 0.1, rel

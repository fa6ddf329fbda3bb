"""The shapes that set Table III's other EfficientViTs (B1 R256 / R288,
B2 R224) apart from B1 R224, at a small size, against the JAX package
under ``m2q-w8a8``:

* ``b1-odd-maps``: the reduced B1 at ``img_res=36``, whose maps are 18,
  9, then 5 through a stride-2 SAME conv on an odd map (R288's last
  stage enters 18 -> 9 the same way), with MSA over 81 and 25 tokens;
* ``b2-heads-of-32``: a narrow B2 with ``dim_per_head=32`` (2 and 3
  heads of 32, B2's head width).

JAX-initialised weights carried across, quantized in both packages from
the same calibration batches: payloads, codes and Eq. 6 splits bit for
bit; the float and the JAX-quantized forwards within the tolerances
``tests/test_torch_slice.py`` states.  The kernels' call counts of a
forward are ``chip_smoke.main_path_calls``'s, which phase 17 (c) gates
the card's launches with."""
import functools
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import recipe as jrecipe
from repro.configs.efficientvit_b1 import REDUCED as JB1
from repro.configs.efficientvit_b2 import REDUCED as JB2
from repro.models import efficientvit as jev
from repro_torch import kernels, recipe
from repro_torch.configs.efficientvit_b1 import REDUCED as TB1
from repro_torch.configs.efficientvit_b2 import REDUCED as TB2
from repro_torch.convert import params_from_numpy
from repro_torch.core.qtensor import QM2Q, QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.kernels import ops
from repro_torch.models import efficientvit as tev
from torch_parity import jax_forward, jax_quantize, jax_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (main_path_calls)

CASES = {
    "b1-odd-maps": dict(img_res=36),
    "b2-heads-of-32": dict(widths=(16, 64, 96), dim_per_head=32),
}
BASE = {"b1-odd-maps": (JB1, TB1), "b2-heads-of-32": (JB2, TB2)}


def _cfgs(case):
    jb, tb = BASE[case]
    name = f"{tb.name}-{case}"
    return (jb.replace(name=name, **CASES[case]),
            tb.replace(name=name, **CASES[case]))


@functools.lru_cache(maxsize=None)
def _refs():
    """Both cases' JAX sides, in threads (their eager quantizations
    compile one XLA program an op; the compiles overlap)."""
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(_jax_case, CASES)))


def _ref(case):
    return _refs()[case]


def _jax_case(case):
    """The JAX side of one case: float weights, calibration batches and
    images, its m2q-w8a8 quantization and both forwards."""
    jcfg, _ = _cfgs(case)
    res = jcfg.img_res
    rng = np.random.default_rng(0)
    batches = [rng.normal(0, 1, (2, res, res, 3)).astype(np.float32)
               for _ in range(2)]
    images = rng.normal(0, 1, (4, res, res, 3)).astype(np.float32)
    params = jax.jit(lambda k: jev.init(jcfg, k))(jax.random.PRNGKey(0))
    qparams, report, _ = jax_quantize(jcfg, params,
                                      jrecipe.PRESETS["m2q-w8a8"], batches)
    return {"batches": batches, "images": images,
            "params": jax_to_numpy(params),
            "logits": jax_forward(jcfg, params, images),
            "report": report, "qparams": jax_to_numpy(qparams),
            "qlogits": jax_forward(jcfg, qparams, images)}


@functools.lru_cache(maxsize=None)
def _port_quantized(case):
    _, tcfg = _cfgs(case)
    ref = _ref(case)
    return recipe.quantize(tcfg, params_from_numpy(ref["params"], "cpu"),
                           "m2q-w8a8", calib_batches=ref["batches"],
                           attn="f32")


def test_cases_have_the_shapes_they_stand_for():
    _, b1 = _cfgs("b1-odd-maps")
    _, dw_calls, attn_calls = chip_smoke.main_path_calls(b1, 2)
    assert ("stages/2/0/mb/w_dw", 2, 9, 9, 64, 3, 2) in dw_calls
    assert {n for _, n, _, _ in attn_calls} == {81, 25}
    _, b2 = _cfgs("b2-heads-of-32")
    _, _, attn_calls = chip_smoke.main_path_calls(b2, 2)
    assert {(h, d) for _, _, h, d in attn_calls} == {(2, 32), (3, 32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_float_forward_matches_jax(case):
    """f32 end to end; float summation order only (bound as in
    test_torch_slice: 1e-5 of the largest logit)."""
    _, tcfg = _cfgs(case)
    ref = _ref(case)
    params = params_from_numpy(ref["params"], "cpu")
    with torch.inference_mode():
        y = tev.forward(tcfg, params, torch.from_numpy(ref["images"]),
                        attn="f32").numpy()
    want = ref["logits"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_gives_the_jax_bytes_for_every_leaf(case):
    """Payloads, scales, zero points and Eq. 6 splits bit for bit; the
    activation scales to f32 summation-order noise (rtol 1e-5), as in
    test_torch_slice; the layer reports' decisions equal."""
    ref = _ref(case)
    qm = _port_quantized(case)
    theirs = dict(leaves_with_path(ref["qparams"]))
    n_m2q = n_dw = 0
    for path, leaf in leaves_with_path(qm.params):
        if isinstance(leaf, QM2Q):
            n_m2q += 1
            fields = ("payload", "u_scale", "u_zp", "a_scale")
            assert theirs[f"{path}/qtensor"] == "QM2Q"
            assert (theirs[f"{path}/n_uniform"], theirs[f"{path}/n_apot"]) \
                == (leaf.n_uniform, leaf.n_apot)
        elif isinstance(leaf, QUniform):
            n_dw += 1
            fields = ("payload", "scale", "zero_point")
            assert theirs[f"{path}/bits"] == leaf.bits == 4
        else:
            np.testing.assert_array_equal(leaf.numpy(), theirs[path])
            continue
        for f in fields:
            np.testing.assert_array_equal(getattr(leaf, f).numpy(),
                                          theirs[f"{path}/{f}"],
                                          err_msg=f"{path}/{f}")
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_carried_quantized_forward_matches_jax(case):
    """The JAX-quantized tree in the port, f32 attention, against JAX's
    dispatch-off forward: bound 1e-4 of the largest logit (an int8
    rounding step flipped upstream, as test_torch_slice states); argmax
    equal."""
    _, tcfg = _cfgs(case)
    ref = _ref(case)
    params = params_from_numpy(ref["qparams"], "cpu")
    with torch.inference_mode():
        y = tev.forward(tcfg, params, torch.from_numpy(ref["images"]),
                        attn="f32").numpy()
    want = ref["qlogits"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_calls_each_kernel_as_main_path_calls_counts(case):
    """The port's own quantized forward with the kernels' dispatch on
    (their plain versions on the CPU) and int8 attention: every dense,
    depthwise and attention call the card's phase 17 (c) expects, at its
    shape, and finite logits near the f32-attention forward's."""
    _, tcfg = _cfgs(case)
    qm = _port_quantized(case)
    x = torch.from_numpy(_ref(case)["images"][:2])
    m2q, dw, attn = chip_smoke.main_path_calls(tcfg, 2)
    kernels.reset_counts()
    with ops.dispatch(dense=True, conv=True, attn=True), \
            torch.inference_mode():
        y8 = qm.forward(x).numpy()
    counts = kernels.counts()
    assert counts["m2q_matmul"]["plain_calls"] == len(m2q)
    assert counts["dwconv_w4"]["plain_calls"] == len(dw)
    assert counts["relu_attn"]["plain_calls"] == len(attn)
    assert counts["relu_attn_scales"]["plain_calls"] == len(attn)
    assert all(c["launches"] == 0 for c in counts.values())
    with ops.dispatch(dense=True, conv=True, attn=False), \
            torch.inference_mode():
        y32 = qm.forward(x, attn="f32").numpy()
    assert np.all(np.isfinite(y8))
    rel = np.linalg.norm(y8 - y32) / np.linalg.norm(y32)
    assert rel < 0.1, rel


def test_dwconv_plain_at_the_odd_stride2_map_matches_an_xla_twin():
    """The 9 x 9 -> 5 x 5 stride-2 SAME conv alone: the port's plain
    depthwise conv against JAX's dispatch-off QTensor conv."""
    from repro.core import qtensor as jq
    from repro.nn import layers as jl
    from repro_torch.nn import layers as tl
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 9, 16)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 1, 16)).astype(np.float32)
    jw = jq.QUniform.quantize(w.reshape(9, 16), bits=4)
    jw = jw.__class__(jw.payload, jw.scale, jw.zero_point, None, bits=4,
                      axis=jw.axis, shape=(3, 3, 1, 16))
    want = np.asarray(jl.dwconv2d(x, jw, stride=2))
    tw = QUniform.quantize(torch.from_numpy(w.reshape(9, 16)), bits=4)
    tw = tw.__class__(tw.payload, tw.scale, tw.zero_point, None, bits=4,
                      axis=tw.axis, shape=(3, 3, 1, 16))
    kernels.reset_counts()
    with ops.dispatch(dense=True, conv=True, attn=True):
        got = tl.dwconv2d(torch.from_numpy(x), tw, stride=2).numpy()
    assert got.shape == want.shape == (2, 5, 5, 16)
    assert Counter({k: c["plain_calls"] for k, c in
                    kernels.counts().items()})["dwconv_w4"] == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

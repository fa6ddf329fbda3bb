"""The plain versions of the int8, int4 and APoT matmul kernels against the
JAX package's oracles (``kernels/ref.py``) and its Pallas kernels in
interpret mode (explicit blocks, so the ragged shapes are padded the way
the TPU wrapper pads them); the port's leaf routing against JAX's
``kernel_supported``; and ``_im2col`` against JAX's.  Inputs are numpy
arrays from fixed seeds.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jq
from repro.core import quant as jquant
from repro.core import scheme_select as jss
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.nn import layers as jlayers
from repro_torch import kernels
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import apot_matmul, int4_matmul, int8_matmul, ops
from repro_torch.nn import layers as tlayers
from torch_parity import jax_to_numpy

# the main path's ragged shapes: K=27 (the im2col'd stem), K=16 (stage 0),
# N=100 standing in for the head's N=1000 (500 int4 payload bytes a row)
SHAPES = [(40, 27, 16), (20, 16, 40), (8, 128, 100)]
# explicit Pallas blocks: none of the shapes above is a multiple of them
BLOCKS = (16, 32, 16)


def _rng(*key):
    return np.random.default_rng(sum((i + 1) * k for i, k in enumerate(key)))


def _x_w(M, K, N):
    rng = _rng(M, K, N)
    return (rng.normal(0, 1, (M, K)).astype(np.float32),
            rng.normal(0, 0.05, (K, N)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _within_f32_bound(got, want, x, w_hat):
    """The two f32 dots sum in different orders: each is within
    K * 2^-24 * (|x| @ |W|) of the exact dot, so they differ by at most
    K * 2^-23 * (|x| @ |W|); one more 2^-23 covers an epilogue scale
    multiply rounded on each side."""
    K = x.shape[1]
    bound = (K + 1) * 2.0 ** -23 * (np.abs(x).astype(np.float64)
                                    @ np.abs(np.asarray(w_hat, np.float64)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= bound), float((err / bound).max())


def _uniform(bits, M, K, N):
    x, w = _x_w(M, K, N)
    qa = jq.QUniform.quantize(jnp.asarray(w), bits=bits,
                              act_max_abs=jnp.float32(np.abs(x).max())
                              if bits == 8 else None)
    return x, qa


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_plain_equals_ref_and_pallas(M, K, N):
    """Integer-exact: bit for bit against the oracle and the interpreted
    Pallas kernel (both compute the same elementwise epilogue)."""
    x, qa = _uniform(8, M, K, N)
    args = (qa.payload, qa.act_scale, qa.scale.reshape(-1),
            qa.zero_point.reshape(-1))
    y = int8_matmul.int8_matmul_plain(torch.from_numpy(x), *_t(*args))
    xq = jquant.quantize_act(jnp.asarray(x), qa.act_scale)
    np.testing.assert_array_equal(y.numpy(), ref.int8_matmul_ref(xq, *args))
    y_pl = jops.int8_matmul_op(jnp.asarray(x), *args, interpret=True,
                               blocks=BLOCKS)
    np.testing.assert_array_equal(y.numpy(), y_pl)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int4_plain_matches_ref_and_pallas(M, K, N):
    x, qa = _uniform(4, M, K, N)
    args = (qa.payload, qa.scale.reshape(-1), qa.zero_point.reshape(-1))
    y = int4_matmul.int4_matmul_plain(torch.from_numpy(x), *_t(*args))
    w_hat = qa.dequant()
    _within_f32_bound(y.numpy(), ref.int4_matmul_ref(jnp.asarray(x), *args),
                      x, w_hat)
    y_pl = jops.int4_matmul_op(jnp.asarray(x), *args, interpret=True,
                               blocks=BLOCKS)
    _within_f32_bound(y.numpy(), y_pl, x, w_hat)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_apot_plain_matches_ref_and_pallas(M, K, N):
    """Ragged N: the Pallas wrapper pads the codes with 0x80 (decodes to
    0); the port masks instead, and both must agree."""
    x, w = _x_w(M, K, N)
    qa = jq.QAPoT.quantize(jnp.asarray(w))
    args = (qa.codes, qa.scale.reshape(-1))
    y = apot_matmul.apot_matmul_plain(torch.from_numpy(x), *_t(*args))
    w_hat = qa.dequant()
    _within_f32_bound(y.numpy(), ref.apot_matmul_ref(jnp.asarray(x), *args),
                      x, w_hat)
    y_pl = jops.apot_matmul_op(jnp.asarray(x), *args, interpret=True,
                               blocks=BLOCKS)
    _within_f32_bound(y.numpy(), y_pl, x, w_hat)


def test_float_kernels_widen_bf16_activations_exactly():
    """bf16 x is widened to f32 before the dot: the same result as
    handing the widened values in f32."""
    x, qa = _uniform(4, 20, 16, 40)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = _t(qa.payload, qa.scale.reshape(-1), qa.zero_point.reshape(-1))
    assert torch.equal(int4_matmul.int4_matmul_plain(xb, *args),
                       int4_matmul.int4_matmul_plain(xb.float(), *args))
    qp = jq.QAPoT.quantize(jnp.asarray(_x_w(20, 16, 40)[1]))
    pargs = _t(qp.codes, qp.scale.reshape(-1))
    assert torch.equal(apot_matmul.apot_matmul_plain(xb, *pargs),
                       apot_matmul.apot_matmul_plain(xb.float(), *pargs))


def _leaves():
    """The same weight as each leaf kind the recipes produce, in both
    packages: (name, JAX leaf, the port's leaf, the plain version the
    port routes it to or None)."""
    x, w = _x_w(6, 32, 24)
    wj = jnp.asarray(w)
    ams = jnp.float32(np.abs(x).max())
    asn = jss.select_schemes(wj)
    cases = [
        ("uniform8+act", jq.QUniform.quantize(wj, bits=8, act_max_abs=ams),
         "int8_matmul"),
        ("uniform8", jq.QUniform.quantize(wj, bits=8), None),
        ("uniform4", jq.QUniform.quantize(wj, bits=4), "int4_matmul"),
        ("uniform4+act", jq.QUniform.quantize(wj, bits=4, act_max_abs=ams),
         "int4_matmul"),
        ("apot", jq.QAPoT.quantize(wj), "apot_matmul"),
        ("apot+act", jq.QAPoT.quantize(wj, act_max_abs=ams), None),
        ("m2q+act", jq.QM2Q.quantize(wj, asn.apot_idx, asn.uniform_idx,
                                     act_max_abs=ams), "m2q_matmul"),
        ("m2q", jq.QM2Q.quantize(wj, asn.apot_idx, asn.uniform_idx), None),
    ]
    return x, [(name, leaf, params_from_numpy(jax_to_numpy(leaf), "cpu"),
                kernel) for name, leaf, kernel in cases]


def test_routing_matches_jax_kernel_supported():
    """Exactly the leaves JAX routes to a kernel go to a kernel's wrapper
    (its plain version here, on the CPU); the others take their plain
    QTensor matmul, as JAX's qmatmul does, and the result equals JAX's
    QTensor matmul of the same leaf to f32 rounding."""
    x, cases = _leaves()
    for name, jleaf, tleaf, kernel in cases:
        assert ops.kernel_supported(tleaf) == \
            jops.kernel_supported(jleaf) == (kernel is not None), name
        kernels.reset_counts()
        y = ops.qtensor_matmul(torch.from_numpy(x).reshape(2, 3, 32), tleaf)
        assert tuple(y.shape) == (2, 3, 24), name
        plain = {k for k, c in kernels.counts().items() if c["plain_calls"]}
        assert plain == ({kernel} if kernel else set()), name
        assert all(c["launches"] == 0 for c in kernels.counts().values())
        want = np.asarray(jleaf.matmul(jnp.asarray(x)))
        np.testing.assert_allclose(y.reshape(6, 24).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("H,W,k,stride,padding", [
    (32, 32, 3, 2, "SAME"), (7, 9, 3, 2, "SAME"), (8, 8, 3, 1, "SAME"),
    (9, 7, 3, 2, "VALID")])
def test_im2col_equals_jax(H, W, k, stride, padding):
    x = _rng(H, W, k).normal(0, 1, (2, H, W, 3)).astype(np.float32)
    want = np.asarray(jlayers._im2col(jnp.asarray(x), k, k, stride, padding))
    got = tlayers._im2col(torch.from_numpy(x), k, k, stride, padding)
    np.testing.assert_array_equal(got.numpy(), want)

"""int8_matmul on the CPU: ``launch_plan`` over every shape the served
uniform8 and int8-stem paths launch, the CUDA kernel's arithmetic
emulated in numpy under its plans (the reciprocal quantizer and its tie
filter, int32 partial sums and rowsums per K split, the rounded epilogue,
the bf16 store) held bit for bit against the plain version and the JAX
package's oracle (``kernels/ref.py::int8_matmul_ref`` behind JAX's
``quantize_act``), the bf16 output of the plain version, and the
wrapper's routing.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ref
from repro_torch import kernels
from repro_torch.configs.registry import ARCHS
from repro_torch.core.qtensor import QUniform
from repro_torch.core.quant import quantize_act
from repro_torch.kernels import int8_matmul, m2q_matmul, ops
from m2q_cases import adversarial_int8

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the served paths' shapes)

BK = 32  # K per step of the kernel


def _served_shapes(B):
    """Each (M, K, N) the uniform8 forward launches at batch B, and the
    int8 stem's im2col'd 3x3 stride-2 conv."""
    cfg = ARCHS["efficientvit-b1-r224"]
    dense = chip_smoke.main_path_calls(cfg, B)[0]
    r = -(-cfg.img_res // 2)
    return sorted(Counter(c[1:] for c in dense)) + [(B * r * r, 27,
                                                     cfg.widths[0])]


def test_uniform8_forward_has_seventeen_shapes_and_the_stem():
    shapes = Counter(c[1:] for c in chip_smoke.main_path_calls(
        ARCHS["efficientvit-b1-r224"], 8)[0])
    assert len(shapes) == 17 and sum(shapes.values()) == 42
    assert _served_shapes(8)[-1] == (100352, 27, 16)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("i", range(18))
def test_int8_launch_plan_covers_every_served_shape(B, i):
    """VisionEngine runs pow2 buckets, so every shape at B = 1, 2, 4, 8:
    a tile the kernel builds whose width covers narrow N without waste,
    a power-of-two K split of at most 8 that divides the tile's rows, the
    blocks counted, and K split only where the unsplit tiles leave half
    the SMs idle."""
    M, K, N = _served_shapes(B)[i]
    p = int8_matmul.launch_plan(M, K, N)
    assert (p["bm"], p["bn"]) in m2q_matmul.TILES
    assert p["splits"] in (1, 2, 4, 8) and p["bm"] % p["splits"] == 0
    tiles = -(-M // p["bm"]) * -(-N // p["bn"])
    assert p["blocks"] == tiles * p["splits"]
    assert p["splits"] == 1 or 2 * tiles <= m2q_matmul.SMS
    assert p["splits"] <= -(-K // BK)
    assert N > 32 or p["bn"] >= N
    assert -(-M // p["bm"]) <= 65535  # grid.y


# ---------------------------------------------------------------------------
# The kernel's arithmetic in numpy
# ---------------------------------------------------------------------------


def _clip127(v):
    """__float2int_rn then the +-127 clip: NaN -> 0, +-inf -> +-127."""
    return np.where(np.isnan(v), 0, np.clip(v, -127, 127)).astype(np.int64)


def _kernel_quantize(x, sa, per16, filtered=True):
    """csrc/m2q_matmul.cu's Quantizer: t = RN(x * RN(1/sa)) rounded half to
    even, except that a chunk of ``per16`` consecutive K (the 16 bytes a
    thread reads) holding a near-tie (|t| < 128 and |t - rint(t)| >
    0.5 - 2^-12), or any chunk when sa is outside [2^-125, 2^125], takes
    the IEEE quotient.  K is padded with zeros to whole steps.
    ``filtered=False``: the reciprocal alone, for comparison."""
    M, K = x.shape
    kp = -(-K // BK) * BK
    v = np.zeros((M, kp), np.float32)
    v[:, :K] = x
    sa = np.float32(sa)
    with np.errstate(all="ignore"):
        t = v * (np.float32(1) / sa)
        n = np.rint(t)
        near = (np.abs(t) < 128) & (np.abs(t - n) > np.float32(0.5 - 2 ** -12))
        exact = np.rint(v / sa)
    assert t.dtype == np.float32 and exact.dtype == np.float32
    fast = 2.0 ** -125 <= abs(float(sa)) <= 2.0 ** 125
    chunk = near.reshape(M, kp // per16, per16).any(-1, keepdims=True)
    chunk = np.broadcast_to(chunk | (not fast), (M, kp // per16, per16))
    q = _clip127(np.where(chunk.reshape(M, kp) & filtered, exact, n))
    q[:, K:] = 0
    return q


def _emulate(x, sa, wq, scale, zp, plan, per16):
    """The kernel's blocks: per (bm x bn) tile and K split, the int32
    partial sums and rowsums of the split's steps, added across the
    cluster; then (acc - rowsum*zp) * RN(sa*scale), each op rounded once
    in f32."""
    q = _kernel_quantize(x, sa, per16)
    M, K = x.shape
    N = wq.shape[1]
    bm, bn, splits = plan["bm"], plan["bn"], plan["splits"]
    steps = -(-K // BK)
    per = -(-steps // splits)
    s = np.float32(sa) * scale
    y = np.full((M, N), np.nan, np.float32)
    w = np.pad(wq.astype(np.int64), ((0, q.shape[1] - K), (0, 0)))
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            rows, cols = slice(m0, m0 + bm), slice(n0, n0 + bn)
            acc = np.zeros((len(range(M)[rows]), len(range(N)[cols])),
                           np.int64)
            xsum = np.zeros(acc.shape[0], np.int64)
            for split in range(splits):
                s0 = min(split * per, steps)
                ks = slice(s0 * BK, min(s0 + per, steps) * BK)
                part = q[rows, ks] @ w[ks, cols]
                assert np.abs(part).max(initial=0) < 2 ** 31
                acc += part
                xsum += q[rows, ks].sum(1)
            assert acc.dtype == np.int64 and np.abs(acc).max() < 2 ** 24
            corr = xsum.astype(np.float32)[:, None] * zp[cols]
            y[rows, cols] = (acc.astype(np.float32) - corr) * s[cols]
    assert not np.isnan(y).any()
    return y


def _bf16_bits(y):
    """f32 -> bf16 rounded to nearest even (finite values), as uint16."""
    u = y.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


EMULATED_PLANS = [None, dict(bm=32, bn=32, splits=1),
                  dict(bm=64, bn=64, splits=2), dict(bm=128, bn=16, splits=8),
                  dict(bm=32, bn=64, splits=4)]


@pytest.mark.parametrize("sa", [0.01, 2.0 ** -7, 1e-39])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(40, 27, 16), (33, 16, 64),
                                   (8, 1024, 1000), (70, 300, 130)])
def test_kernel_arithmetic_emulated_equals_plain_and_jax(M, K, N, dtype, sa):
    """Adversarial x (at and one ulp beside rounding ties of x / sa, beyond
    the clip, NaN and +-inf; a subnormal sa sends every chunk through the
    IEEE quotient), K tails of 27 and 16, N = 1000: under launch_plan's
    plan and four others, the emulated kernel equals the plain version
    and JAX's oracle (at normal scales) bit for bit in f32, and the plain
    version's bf16 output bit for bit."""
    x, sa_, wq, scale, zp = adversarial_int8(M, K, N, seed=M + K + N, sa=sa,
                                             nonfinite=True)
    xt = torch.from_numpy(x).to(dtype)
    x32 = xt.float().numpy()  # the values the kernel widens to f32
    args = (xt, torch.from_numpy(wq), torch.tensor(sa_),
            torch.from_numpy(scale), torch.from_numpy(zp))
    y32 = int8_matmul.int8_matmul_plain(*args).numpy()
    y16 = int8_matmul.int8_matmul_plain(
        *args, out_dtype=torch.bfloat16).view(torch.int16).numpy()
    if sa > 2.0 ** -126:  # XLA on the CPU flushes subnormals to zero
        xq = jquant.quantize_act(jnp.asarray(x32), jnp.float32(sa_))
        want = np.asarray(ref.int8_matmul_ref(xq, wq, jnp.float32(sa_),
                                              scale, zp))
        np.testing.assert_array_equal(y32.view(np.int32),
                                      want.view(np.int32))
    per16 = 16 // xt.element_size()
    for plan in EMULATED_PLANS:
        p = plan or int8_matmul.launch_plan(M, K, N)
        got = _emulate(x32, sa_, wq, scale, zp, p, per16)
        np.testing.assert_array_equal(got.view(np.int32), y32.view(np.int32),
                                      err_msg=str(p))
        np.testing.assert_array_equal(_bf16_bits(got), y16.view(np.uint16),
                                      err_msg=str(p))


@pytest.mark.parametrize("per16", [4, 8])
def test_tie_filter_decides_what_the_reciprocal_gets_wrong(per16):
    """On values at and beside rounding ties the reciprocal multiply alone
    rounds some quotients the wrong way; the filtered quantizer equals the
    plain version's (the IEEE quotient) everywhere, NaN and +-inf
    included."""
    x, sa, *_ = adversarial_int8(256, 64, 1, seed=per16, nonfinite=True)
    want = quantize_act(torch.from_numpy(x), torch.tensor(sa))
    got = _kernel_quantize(x, sa, per16)[:, :64]
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    assert (_kernel_quantize(x, sa, per16, filtered=False)[:, :64]
            != got).any()
    assert np.isnan(x).any() and np.isinf(x).any()


def test_plain_bf16_out_is_the_f32_result_cast():
    x, sa, wq, scale, zp = adversarial_int8(50, 72, 40, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.tensor(sa),
            torch.from_numpy(scale), torch.from_numpy(zp))
    y = int8_matmul.int8_matmul_plain(*args)
    y16 = int8_matmul.int8_matmul_plain(*args, out_dtype=torch.bfloat16)
    assert y.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert torch.equal(y16, y.to(torch.bfloat16))


def _leaf(K, N, x):
    w = torch.from_numpy(np.random.default_rng(K + N).normal(
        0, K ** -0.5, (K, N)).astype(np.float32))
    return QUniform.quantize(w, bits=8, act_max_abs=float(x.abs().max()))


def test_qtensor_matmul_uniform8_returns_x_dtype_through_one_plain_call():
    """On the CPU the int8 leaf takes the plain version once, which
    stores x's dtype itself; the values equal the f32 result cast, and
    reference_path() gives the same."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 5, 48)).astype(np.float32))
    qt = _leaf(48, 24, x)
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_counts()
        y = ops.qtensor_matmul(x.to(dtype), qt)
        assert y.dtype == dtype and tuple(y.shape) == (2, 5, 24)
        assert kernels.counts()["int8_matmul"] == {"launches": 0,
                                                   "plain_calls": 1}
        want = int8_matmul.int8_matmul_plain(
            x.to(dtype).reshape(10, 48), qt.payload, qt.act_scale,
            qt.scale.reshape(-1), qt.zero_point.reshape(-1))
        assert torch.equal(y.reshape(10, 24), want.to(dtype))
        with ops.reference_path():
            assert torch.equal(ops.qtensor_matmul(x.to(dtype), qt), y)
    kernels.reset_counts()


def test_int8_wrapper_refuses_an_output_dtype_before_it_builds():
    x = torch.zeros((4, 16))
    qt = _leaf(16, 8, x + 1)
    args = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
            qt.zero_point.reshape(-1))
    with pytest.raises(ValueError, match="out_dtype"):
        int8_matmul._launch(*args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="shapes disagree"):
        int8_matmul._launch(x[:, :8].contiguous(), *args[1:])

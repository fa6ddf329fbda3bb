"""dwconv_w4 on the CPU: the plain version against the JAX package's
oracle (``kernels/ref.py::dwconv_w4_ref``) with f32 and bf16 output bit for
bit, ``launch_plan`` over every depthwise shape the served B1 R224 paths
launch, the kernel's tiling emulated in numpy under the plans it takes,
and the wrapper's routing and counters.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.packing import pack_int4
from repro.kernels import ref
from repro_torch import kernels
from repro_torch.configs.registry import ARCHS
from repro_torch.core.qtensor import QUniform
from repro_torch.kernels import dwconv_w4, ops

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the served paths' shapes)


def _case(B, H, W, C, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, (k, k, C)).astype(np.float32)
    u = jquant.uniform_quantize(jnp.asarray(w.reshape(k * k, C)), bits=4)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return (x, np.asarray(pack_int4(u.q)), np.asarray(u.scale).reshape(-1),
            np.asarray(u.zero_point).reshape(-1))


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("C", [16, 10])
@pytest.mark.parametrize("H,W", [(8, 8), (7, 9)])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1)])
def test_dwconv_plain_equals_ref_bit_for_bit_in_f32_and_bf16(H, W, k, stride,
                                                             C):
    """The f32 sums are the same rounded operations in the same order, so
    the plain version equals the oracle bit for bit, and its bf16 output
    equals the oracle's f32 output cast to bf16 by JAX (both round to
    nearest even).  C = 10: a channel tail of a vector of 8."""
    x, packed, scale, zp = _case(2, H, W, C, k, H * W + k + stride + C)
    y_ref = ref.dwconv_w4_ref(jnp.asarray(x), packed, scale, zp, kh=k, kw=k,
                              stride=stride)
    args = _torch(x, packed, scale, zp) + [k, k, stride]
    y32 = dwconv_w4.dwconv_w4_plain(*args)
    y16 = dwconv_w4.dwconv_w4_plain(*args, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_array_equal(y32.numpy().view(np.int32),
                                  np.asarray(y_ref).view(np.int32))
    np.testing.assert_array_equal(
        y16.view(torch.int16).numpy(),
        np.asarray(y_ref.astype(jnp.bfloat16)).view(np.int16))


def _forward_shapes(B):
    """Each depthwise conv of one B1 R224 forward at batch B: (B, H, W, C,
    k, stride) -> launches per forward."""
    cfg = ARCHS["efficientvit-b1-r224"]
    return Counter(c[1:] for c in chip_smoke.main_path_calls(cfg, B)[1])


def test_forward_has_the_eleven_depthwise_shapes():
    shapes = _forward_shapes(8)
    assert len(shapes) == 11 and sum(shapes.values()) == 20
    assert shapes[(8, 112, 112, 64, 3, 1)] == 1
    assert shapes[(8, 7, 7, 768, 5, 1)] == 4


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(_forward_shapes(1)))
def test_dwconv_launch_plan_covers_every_served_shape(B, shape):
    """VisionEngine runs pow2 buckets, so every forward shape at B = 1, 2,
    4, 8: a plan the kernel builds, a grid within CUDA's limits, tiles
    that cover HO x WO x C, shared memory under the 227 KB cap for f32 as
    well as bf16 x, and a block for each of the 132 SMs wherever there
    are 132 warps of output vectors (one vector of 8 channels a thread)."""
    _, H, W, C, k, s = shape
    p = dwconv_w4.launch_plan(B, H, W, C, k, s)
    assert p["r"] in dwconv_w4.RS and (k, s) in dwconv_w4.WINDOWS
    got = dwconv_w4.plan_shape(p, B, H, W, C, k, s, itemsize=4)
    assert got["blocks"] == p["blocks"]
    assert 1 <= got["threads"] <= dwconv_w4.MAX_THREADS and p["th"] <= 64
    assert got["smem"] <= dwconv_w4.MAX_SMEM
    grid = got["grid"]
    assert grid[0] < 2 ** 31 and grid[1] <= 65535 and grid[2] <= 65535
    HO, WO = -(-H // s), -(-W // s)
    assert grid[0] * dwconv_w4.CPT * p["cv"] >= C
    n_wt = -(-WO // (p["sw"] * p["r"]))
    assert grid[1] % n_wt == 0
    assert (grid[1] // n_wt) * p["th"] >= HO
    assert n_wt * p["sw"] * p["r"] >= WO and grid[2] == B
    vectors = B * HO * WO * -(-C // dwconv_w4.CPT)
    assert p["blocks"] >= min(dwconv_w4.SMS, vectors // 32)


def _emulate(x, packed, scale, zp, k, s, plan):
    """csrc/dwconv_w4.cu's blocks in numpy: each block's zero-filled halo,
    its weights decoded once, and each thread's R outputs x 8 channels
    summed by sliding over its halo row, tap row by tap row, in f32."""
    B, H, W, C = x.shape
    HO, WO = -(-H // s), -(-W // s)
    ph, pw = (dwconv_w4.same_padding(n, k, s)[0] for n in (H, W))
    cv, sw, th, R = plan["cv"], plan["sw"], plan["th"], plan["r"]
    cs, tw = dwconv_w4.CPT * cv, sw * R
    hin, win = (th - 1) * s + k, (tw - 1) * s + k
    n_ct, n_ht, n_wt = -(-C // cs), -(-HO // th), -(-WO // tw)
    cpad = n_ct * cs
    q = np.stack([packed & 0x0F, packed >> 4], -1).reshape(k * k, C)
    w = (q.astype(np.float32) - zp) * scale  # f32 subtract, then multiply
    w = np.pad(w, ((0, 0), (0, cpad - C)))
    y = np.full((B, HO, WO, C), np.nan, np.float32)
    rows = np.arange(th)[:, None] * s          # a thread row's halo row
    cols = np.arange(sw)[None, :] * R * s      # a strip's first halo column
    for b in range(B):
        for ht in range(n_ht):
            for wt in range(n_wt):
                h0, w0 = ht * th * s - ph, wt * tw * s - pw
                xs = np.zeros((hin, win, cpad), np.float32)
                hs = [h for h in range(hin) if 0 <= h0 + h < H]
                ws_ = [c for c in range(win) if 0 <= w0 + c < W]
                if hs and ws_:
                    xs[hs[0]:hs[-1] + 1, ws_[0]:ws_[-1] + 1, :C] = x[
                        b, h0 + hs[0]:h0 + hs[-1] + 1,
                        w0 + ws_[0]:w0 + ws_[-1] + 1]
                acc = np.zeros((th, sw, R, cpad), np.float32)
                for i in range(k):
                    for c in range((R - 1) * s + k):
                        xv = xs[rows + i, cols + c]  # (th, sw, cpad)
                        for r in range(R):
                            j = c - r * s
                            if 0 <= j < k:
                                acc[:, :, r] = acc[:, :, r] + xv * w[i * k + j]
                out = acc.reshape(th, tw, cpad)[:, :, :C]
                ho, wo = ht * th, wt * tw
                nh, nw = min(th, HO - ho), min(tw, WO - wo)
                y[b, ho:ho + nh, wo:wo + nw] = out[:nh, :nw]
    return y


EMULATED_PLANS = [None, dict(cv=1, sw=1, th=1, r=1), dict(cv=2, sw=3, th=2,
                                                          r=2),
                  dict(cv=1, sw=2, th=3, r=4), dict(cv=4, sw=1, th=5, r=8)]


@pytest.mark.parametrize("B,H,W,C,k,stride", [
    (2, 8, 8, 16, 3, 1), (1, 7, 9, 10, 3, 2), (1, 8, 8, 24, 5, 1),
    (2, 9, 7, 2, 5, 2), (1, 14, 14, 64, 3, 2), (1, 7, 7, 40, 5, 1)])
def test_kernel_tiling_emulated_equals_plain(B, H, W, C, k, stride):
    """The kernel's halo origins, padding, channel slices, ragged tiles and
    sliding tap order, emulated, give the plain version's bits under
    launch_plan's plan (None) and plans of every R the kernel builds."""
    x, packed, scale, zp = _case(B, H, W, C, k, B + H + W + C)
    y_ref = dwconv_w4.dwconv_w4_plain(*_torch(x, packed, scale, zp), k, k,
                                      stride).numpy()
    for plan in EMULATED_PLANS:
        p = plan or dwconv_w4.launch_plan(B, H, W, C, k, stride)
        np.testing.assert_array_equal(
            _emulate(x, packed, scale, zp, k, stride, p).view(np.int32),
            y_ref.view(np.int32), err_msg=str(p))


def _leaf(C, k, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.2, (k, k, 1, C)).astype(np.float32))
    qt = QUniform.quantize(w.reshape(k * k, C), bits=4)
    return QUniform(qt.payload, qt.scale, qt.zero_point, None, 4, 1,
                    (k, k, 1, C))


def test_qtensor_dwconv_stores_x_dtype_through_one_plain_call():
    """On the CPU the wrapper runs the plain version once, counts no
    launch, and returns x's dtype with no separate cast."""
    qt = _leaf(16, 3)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 6, 6, 16)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_counts()
        y = ops.qtensor_dwconv(x.to(dtype), qt, stride=2)
        assert y.dtype == dtype and tuple(y.shape) == (2, 3, 3, 16)
        assert kernels.counts()["dwconv_w4"] == {"launches": 0,
                                                 "plain_calls": 1}
        want = dwconv_w4.dwconv_w4_plain(
            x.to(dtype), qt.payload, qt.scale.reshape(-1),
            qt.zero_point.reshape(-1), 3, 3, 2).to(dtype)
        assert torch.equal(y, want)
    kernels.reset_counts()


def test_dwconv_routes_only_the_windows_the_kernel_builds():
    x = torch.zeros((1, 8, 8, 16))
    for k in (3, 5):
        for stride in (1, 2):
            assert ops.dwconv_kernel_supported(_leaf(16, k), x, stride, 16, "SAME")
    assert not ops.dwconv_kernel_supported(_leaf(16, 7), x, 1, 16, "SAME")
    assert not ops.dwconv_kernel_supported(_leaf(16, 3), x, 3, 16, "SAME")
    assert not ops.dwconv_kernel_supported(_leaf(16, 3), x, 1, 16, "VALID")


def test_dwconv_wrapper_refuses_before_it_builds():
    """Windows and output dtypes the kernel does not build are refused
    before any compiler is asked."""
    qt = _leaf(16, 7)
    x = torch.zeros((1, 8, 8, 16))
    args = (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1))
    with pytest.raises(ValueError, match="square windows"):
        dwconv_w4._launch(*args, 7, 7, 1)
    qt = _leaf(16, 3)
    args = (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1))
    with pytest.raises(ValueError, match="out_dtype"):
        dwconv_w4._launch(*args, 3, 3, 1, out_dtype=torch.float16)

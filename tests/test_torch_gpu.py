"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in a
fixture, so every pytest-xdist worker collects the same tests).  On a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import ctypes
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.registry import ARCHS
from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform
from repro_torch.core.quant import quantize_act
from repro_torch.core.scheme_select import select_schemes
from repro_torch.kernels import (apot_matmul, build, decode_attn_int8,
                                 dwconv_w4, int4_matmul, int8_matmul,
                                 m2q_matmul, ops, relu_attn, relu_attn_scales)
from repro_torch.nn.attention import quantize_kv_rows
from m2q_cases import adversarial_int8, adversarial_m2q

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the served paths' shapes)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _randn(shape, seed, device, std=1.0, dtype=torch.float32):
    a = np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)
    return torch.from_numpy(a).to(device).to(dtype)


# The kernels' integer sums are exact and their float steps repeat the
# plain versions' operations in the same order with IEEE rounding, so the
# outputs are expected equal; assert_close with zero tolerance says so.
def _equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# shapes that pick each launch route of the kernel (m2q_matmul.launch_plan):
# 128-row tiles at N = 16 and N = 64, 32-row tiles split over 2, 4 and 8
# cluster blocks (late stages, the head, a long K of 128 steps), payload
# rows not 16-byte aligned (N = 1000: 8-byte copies; N = 130: plain loads)
# and a ragged K of 72
M2Q_SHAPES = [(100, 16, 64), (65, 72, 1000), (8, 1024, 1000), (777, 256, 130),
              (392, 1024, 256), (392, 512, 256), (100352, 64, 16),
              (64, 4096, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", M2Q_SHAPES)
def test_m2q_kernel_equals_plain(cuda, M, K, N, dtype):
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    w = _randn((K, N), N, cuda, std=K ** -0.5)
    asn = select_schemes(w)
    qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                       act_max_abs=float(x.abs().max()))
    args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
            qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
    kernels.reset_counts()
    y = m2q_matmul.m2q_matmul(*args)
    assert kernels.counts()["m2q_matmul"] == {"launches": 1,
                                              "plain_calls": 0}
    _equal(y, m2q_matmul.m2q_matmul_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mixed", "uniform", "apot"])
@pytest.mark.parametrize("M,K,N", [(96, 512, 64), (8, 1024, 1000),
                                   (300, 80, 24)])
def test_m2q_kernel_equals_plain_on_adversarial_payloads(cuda, M, K, N, kind,
                                                          dtype):
    """Every APoT code (+-256 units included) and the zero code, all-uniform
    and all-APoT layers, and activations that mostly clip at +-127."""
    x, *rest = adversarial_m2q(M, K, N, kind, seed=M + K + N)
    args = (torch.from_numpy(x).to(cuda).to(dtype),
            *(torch.as_tensor(a).to(cuda) for a in rest))
    assert float((m2q_matmul.m2q_matmul_plain(args[0], args[1], *args[2:])
                  .abs() > 0).float().mean()) > 0.5
    xq = torch.round(args[0].float() / args[1]).abs()
    assert float((xq >= 127).float().mean()) > 0.5
    _equal(m2q_matmul.m2q_matmul(*args), m2q_matmul.m2q_matmul_plain(*args))


@pytest.mark.parametrize("bm,bn", m2q_matmul.TILES)
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_m2q_kernel_equals_plain_at_every_tile_and_split(cuda, bm, bn,
                                                         splits):
    """Every tile the kernel builds, unsplit and split over clusters of 2
    and 8, at a shape launch_plan gives another launch shape."""
    x = _randn((200, 640), 7, cuda, dtype=torch.bfloat16)
    w = _randn((640, 72), 8, cuda, std=640 ** -0.5)
    asn = select_schemes(w)
    qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                       act_max_abs=float(x.abs().max()))
    args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
            qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
    plan = dict(bm=bm, bn=bn, splits=splits)
    _equal(m2q_matmul._launch(*args, plan=plan),
           m2q_matmul.m2q_matmul_plain(*args))


def _dw_args(B, H, W, C, k, stride, device, dtype, seed):
    x = _randn((B, H, W, C), seed, device, dtype=dtype)
    qt = QUniform.quantize(_randn((k * k, C), seed + 1, device, std=0.3),
                           bits=4)
    return (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1),
            k, k, stride)


OUT_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(14, 14), (7, 9), (112, 112)])
@pytest.mark.parametrize("k,stride", dwconv_w4.WINDOWS)
def test_dwconv_kernel_equals_plain(cuda, H, W, k, stride, dtype, out_dtype):
    args = _dw_args(2, H, W, 64, k, stride, cuda, dtype, H * W + k)
    y = dwconv_w4.dwconv_w4(*args, out_dtype=out_dtype)
    assert y.dtype == out_dtype
    _equal(y, dwconv_w4.dwconv_w4_plain(*args, out_dtype=out_dtype))


# every R the kernel instantiates at every window, under block shapes
# that leave ragged row, column and channel tiles (13 x 19 x 40: 5 vectors
# of 8 channels); the largest halo (f32, r = 8, 5x5 stride 2) is 177 KB
DW_BLOCKS = [(1, 1, 1), (2, 3, 5), (8, 2, 8)]


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cv,sw,th", DW_BLOCKS)
@pytest.mark.parametrize("r", dwconv_w4.RS)
@pytest.mark.parametrize("k,stride", dwconv_w4.WINDOWS)
def test_dwconv_kernel_equals_plain_at_every_plan(cuda, k, stride, r, cv, sw,
                                                  th, dtype, out_dtype):
    plan = dict(cv=cv, sw=sw, th=th, r=r)
    assert dwconv_w4.plan_shape(plan, 2, 13, 19, 40, k, stride,
                                itemsize=4)["smem"] <= dwconv_w4.MAX_SMEM
    args = _dw_args(2, 13, 19, 40, k, stride, cuda, dtype, k + r + cv)
    y = dwconv_w4._launch(*args, out_dtype=out_dtype, plan=plan)
    _equal(y, dwconv_w4.dwconv_w4_plain(*args, out_dtype=out_dtype))


# the 11 depthwise shapes of one B1 R224 forward (B, H, W, C, k, stride)
DW_FORWARD = [(112, 112, 64, 3, 1), (112, 112, 64, 3, 2),
              (56, 56, 128, 3, 1), (56, 56, 128, 3, 2), (28, 28, 256, 3, 1),
              (28, 28, 256, 3, 2), (14, 14, 384, 5, 1), (14, 14, 512, 3, 1),
              (14, 14, 512, 3, 2), (7, 7, 768, 5, 1), (7, 7, 1024, 3, 1)]


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("H,W,C,k,stride", DW_FORWARD)
def test_dwconv_kernel_equals_plain_at_the_forward_shapes(cuda, H, W, C, k,
                                                          stride, B,
                                                          out_dtype):
    args = _dw_args(B, H, W, C, k, stride, cuda, torch.bfloat16, C + B)
    _equal(dwconv_w4.dwconv_w4(*args, out_dtype=out_dtype),
           dwconv_w4.dwconv_w4_plain(*args, out_dtype=out_dtype))


# odd maps, stride 2 on even and odd maps, and channel counts from one
# pair (scalar copies) through a tail of 2 past a vector to 1024
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("C", [2, 10, 64, 1024])
@pytest.mark.parametrize("H,W,k,stride", [(7, 9, 3, 1), (7, 9, 5, 1),
                                          (8, 8, 3, 2), (9, 7, 3, 2),
                                          (10, 11, 5, 2)])
def test_dwconv_kernel_equals_plain_at_edge_shapes(cuda, H, W, k, stride, C,
                                                   out_dtype):
    args = _dw_args(3, H, W, C, k, stride, cuda, torch.bfloat16, C + H)
    _equal(dwconv_w4.dwconv_w4(*args, out_dtype=out_dtype),
           dwconv_w4.dwconv_w4_plain(*args, out_dtype=out_dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwconv_kernel_equals_plain_on_a_misaligned_x(cuda, dtype):
    """x starting 2 or 4 bytes past a 16-byte boundary takes the scalar
    copies."""
    B, H, W, C, k = 2, 9, 9, 64, 3
    flat = _randn((B * H * W * C + 1,), 3, cuda, dtype=dtype)
    x = flat[1:].view(B, H, W, C)
    assert x.data_ptr() % 16 != 0
    args = (x,) + _dw_args(B, H, W, C, k, 1, cuda, dtype, 4)[1:]
    _equal(dwconv_w4.dwconv_w4(*args, out_dtype=torch.bfloat16),
           dwconv_w4.dwconv_w4_plain(*args, out_dtype=torch.bfloat16))


def test_dwconv_kernel_refuses_a_plan_it_does_not_build(cuda):
    args = _dw_args(1, 8, 8, 16, 3, 1, cuda, torch.bfloat16, 0)
    for plan in (dict(cv=1, sw=1, th=1, r=3), dict(cv=8, sw=8, th=8, r=1),
                 dict(cv=1, sw=1, th=65, r=1), dict(cv=0, sw=1, th=1, r=1)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            dwconv_w4._launch(*args, plan=plan)
    # a halo past the 227 KB cap: f32, 3x3 stride 2, 17 x 65 x 64 channels
    plan = dict(cv=8, sw=4, th=8, r=8)
    args = _dw_args(1, 40, 80, 64, 3, 2, cuda, torch.float32, 0)
    assert dwconv_w4.plan_shape(plan, 1, 40, 80, 64, 3, 2, itemsize=4)[
        "smem"] > dwconv_w4.MAX_SMEM
    with pytest.raises(RuntimeError, match="failed to launch"):
        dwconv_w4._launch(*args, plan=plan)


def test_qtensor_dwconv_launches_once_and_stores_bf16(cuda):
    qt = QUniform.quantize(_randn((3, 3, 1, 64), 1, cuda, std=0.3)
                           .reshape(9, 64), bits=4)
    leaf = QUniform(qt.payload, qt.scale, qt.zero_point, None, 4, 1,
                    (3, 3, 1, 64))
    x = _randn((2, 14, 14, 64), 2, cuda, dtype=torch.bfloat16)
    kernels.reset_counts()
    y = ops.qtensor_dwconv(x, leaf, stride=1)
    assert kernels.counts()["dwconv_w4"] == {"launches": 1, "plain_calls": 0}
    assert y.dtype == torch.bfloat16
    with ops.reference_path():
        _equal(y, ops.qtensor_dwconv(x, leaf, stride=1))
    kernels.reset_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", [(8, 196, 8, 16), (8, 49, 16, 16),
                                     (2, 300, 2, 64), (1, 5, 3, 8)])
def test_relu_attn_kernel_equals_plain_on_strided_views(cuda, B, N, H, D,
                                                        dtype):
    qkv = _randn((B, N, 3 * H * D), B * N + D, cuda, dtype=dtype)
    q, k, v = (t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1))
    scales = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    y = relu_attn.relu_attn(q, k, v, *scales)
    _equal(y, relu_attn.relu_attn_plain(q, k, v, *scales))


def test_relu_attn_refuses_wide_heads(cuda):
    q = torch.zeros((1, 4, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        relu_attn.relu_attn(q, q, q,
                            *relu_attn_scales.relu_attn_scales_plain(q, q, q))


def _attn_inputs(B, N, H, D, seed, device, dtype=torch.bfloat16):
    """q, k, v: column slices of one (B, N, 3C) tensor, as the MSA hands
    them over."""
    qkv = _randn((B, N, 3 * H * D), seed, device, dtype=dtype)
    return [t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1)]


def _attn_plans():
    """Every split the kernel takes (at every shape)."""
    return [dict(splits=s) for s in relu_attn.SPLITS]


# the B1 R224 MSA shapes of the served paths (stage 3 and stage 4), at
# VisionEngine's buckets
ATTN_SHAPES = sorted(set(chip_smoke.main_path_calls(
    ARCHS["efficientvit-b1-r224"], 1)[2]))


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("N,H,D", [s[1:] for s in ATTN_SHAPES])
def test_relu_attn_kernel_equals_plain_at_every_plan(cuda, B, N, H, D):
    """bf16 in and out (as served) under every plan, and f32 out under
    launch_plan's, bit for bit; the plain result is the f32 one rounded
    once."""
    q, k, v = _attn_inputs(B, N, H, D, B + N, cuda)
    sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    want = relu_attn.relu_attn_plain(q, k, v, *sc, out_dtype=torch.bfloat16)
    for plan in _attn_plans():
        y = relu_attn._launch(q, k, v, *sc, 1e-6, torch.bfloat16, plan)
        assert y.dtype == torch.bfloat16, plan
        torch.testing.assert_close(y, want, rtol=0, atol=0, msg=str(plan))
    _equal(relu_attn.relu_attn(q, k, v, *sc),
           relu_attn.relu_attn_plain(q, k, v, *sc))


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", [(2, 1, 2, 16), (3, 2, 4, 16),
                                     (2, 197, 8, 16), (1, 50, 16, 16),
                                     (2, 300, 2, 32), (1, 700, 1, 64),
                                     (2, 33, 4, 8), (2, 45, 3, 12),
                                     (1, 9, 2, 5)])
def test_relu_attn_kernel_equals_plain_at_edge_shapes(cuda, B, N, H, D,
                                                      dtype, out_dtype):
    """One token, token counts no slice divides, slices longer than a
    CTA's 256-token chunk (q requantized chunk by chunk), D = 8 / 16 / 32 /
    64 and head dims the kernel pads (12, 5; scalar loads), under every
    plan."""
    q, k, v = _attn_inputs(B, N, H, D, N + D, cuda, dtype)
    sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    want = relu_attn.relu_attn_plain(q, k, v, *sc, out_dtype=out_dtype)
    for plan in _attn_plans():
        y = relu_attn._launch(q, k, v, *sc, 1e-6, out_dtype, plan)
        torch.testing.assert_close(y, want, rtol=0, atol=0, msg=str(plan))


def test_relu_attn_kernel_refuses_a_plan_it_does_not_build(cuda):
    q, k, v = _attn_inputs(1, 8, 2, 64, 0, cuda)
    sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    for plan in (dict(splits=0), dict(splits=3), dict(splits=16)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            relu_attn._launch(q, k, v, *sc, 1e-6, torch.float32, plan)


def _scale_plans():
    return [dict(ctas=c) for c in relu_attn_scales.CTAS]


def _equal_scales(got, want):
    torch.testing.assert_close(torch.stack(list(got)),
                               torch.stack(list(want)), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("N,H,D", [s[1:] for s in ATTN_SHAPES])
def test_scale_kernel_equals_plain_chain_at_every_plan(cuda, B, N, H, D):
    q, k, v = _attn_inputs(B, N, H, D, 3 * B + N, cuda)
    want = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    for plan in _scale_plans():
        _equal_scales(relu_attn_scales._launch(q, k, v, plan), want)
    kernels.reset_counts()
    got = relu_attn_scales.relu_attn_scales(q, k, v)
    assert kernels.counts()["relu_attn_scales"] == {"launches": 1,
                                                    "plain_calls": 0}
    assert all(s.shape == () and s.dtype == torch.float32 for s in got)
    _equal_scales(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["nan", "inf", "-inf", "negative", "-0.0",
                                  "zero", "misaligned", "odd_width"])
def test_scale_kernel_equals_plain_chain_on_special_inputs(cuda, kind,
                                                           dtype):
    """NaN in a tensor: its scale NaN; +inf: inf; -inf, all-negative q/k
    and -0.0: the 1e-8 floor (|-inf| = inf for v); a view that starts off
    16-byte alignment and a row width no 16-byte load divides (scalar
    loads)."""
    B, N, H, D = 2, 49, 4, 16
    if kind == "odd_width":
        H, D = 3, 5
    q, k, v = _attn_inputs(B, N, H, D, 11, cuda, dtype)
    if kind == "misaligned":
        big = _randn((B, N, 3 * H * D + 1), 12, cuda, dtype=dtype)[..., 1:]
        q, k, v = (t.reshape(B, N, H, D)
                   for t in torch.split(big, H * D, -1))
    for t in (q, k, v):
        if kind == "nan":
            t[1, 7, 2, 3] = float("nan")
        elif kind == "inf":
            t[0, 3, 1, 0] = float("inf")
        elif kind == "-inf":
            t[1, 0, 0, 9] = float("-inf")
        elif kind == "negative":
            t.copy_(-t.abs() - 0.5)
        elif kind == "-0.0":
            t.fill_(-0.0)
        elif kind == "zero":
            t.zero_()
    want = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    for plan in (dict(ctas=1), dict(ctas=4),
                 relu_attn_scales.launch_plan(B, N, H * D,
                                              dtype == torch.bfloat16)):
        _equal_scales(relu_attn_scales._launch(q, k, v, plan), want)


def test_scale_kernel_refuses_bad_plans_and_operands(cuda):
    q, k, v = _attn_inputs(1, 8, 2, 16, 0, cuda)
    for plan in (dict(ctas=0), dict(ctas=3), dict(ctas=32)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            relu_attn_scales._launch(q, k, v, plan)
    with pytest.raises(ValueError, match="dtype"):
        relu_attn_scales.relu_attn_scales(q, k, v.float())


def test_relu_attn_op_launches_both_kernels_and_stores_bf16(cuda):
    q, k, v = _attn_inputs(8, 196, 8, 16, 5, cuda)
    kernels.reset_counts()
    y = ops.relu_attn_op(q, k, v)
    c = kernels.counts()
    assert c["relu_attn"] == c["relu_attn_scales"] == {"launches": 1,
                                                       "plain_calls": 0}
    assert y.dtype == torch.bfloat16
    with ops.reference_path():
        _equal(y, ops.relu_attn_op(q, k, v))
    kernels.reset_counts()


def test_scales_and_attention_replay_from_one_cuda_graph(cuda):
    """The scale kernel and relu_attn captured in one CUDA graph, replayed
    with new inputs copied in: equal to the plain chain both times."""
    B, N, H, D = 8, 49, 16, 16
    qkv = torch.zeros((B, N, 3 * H * D), device=cuda, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1))

    def step():
        return ops.relu_attn_op(q, k, v)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = step()
    for seed in (1, 2):
        qkv.copy_(_randn(qkv.shape, seed, cuda, std=seed,
                         dtype=torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
        _equal(y, relu_attn.relu_attn_plain(q, k, v, *sc,
                                            out_dtype=torch.bfloat16))


def test_kernel_rejects_bad_operands(cuda):
    x = torch.zeros((4, 16), device=cuda, dtype=torch.float16)
    s = torch.ones((), device=cuda)
    with pytest.raises(ValueError):
        m2q_matmul.m2q_matmul(x, s, torch.zeros((16, 8), dtype=torch.int8,
                                                device=cuda),
                              *(torch.zeros(8, device=cuda),) * 3)


# the main path's matmul shapes: the im2col'd stem (K=27, N=16), stage 0
# (K=16), the head (M=8, K=1024, N=1000) and a ragged middle
MATMUL_SHAPES = [(100352, 27, 16), (100, 16, 64), (65, 72, 1000),
                 (8, 1024, 1000), (777, 256, 130)]


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_int8_kernel_equals_plain(cuda, M, K, N, dtype, out_dtype):
    """f32 and bf16 x, f32 and bf16 y (the f32 result rounded to nearest
    even, as the plain version's cast rounds it)."""
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    qt = QUniform.quantize(_randn((K, N), N, cuda, std=K ** -0.5), bits=8,
                           act_max_abs=float(x.abs().max()))
    args = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
            qt.zero_point.reshape(-1))
    kernels.reset_counts()
    y = int8_matmul.int8_matmul(*args, out_dtype=out_dtype)
    assert kernels.counts()["int8_matmul"] == {"launches": 1,
                                               "plain_calls": 0}
    assert y.dtype == out_dtype
    _equal(y, int8_matmul.int8_matmul_plain(*args, out_dtype=out_dtype))


def _int8_args(M, K, N, device, dtype, seed):
    x = _randn((M, K), seed, device, dtype=dtype)
    qt = QUniform.quantize(_randn((K, N), seed + 1, device, std=K ** -0.5),
                           bits=8, act_max_abs=float(x.abs().max()))
    return (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
            qt.zero_point.reshape(-1))


# the distinct (M, K, N) of one uniform8 B1 R224 batch-8 forward (17) and
# the im2col'd int8 stem
INT8_FORWARD = sorted(
    {c[1:] for c in chip_smoke.main_path_calls(
        ARCHS["efficientvit-b1-r224"], 8)[0]}) + [(100352, 27, 16)]
# every launch shape the kernel builds
INT8_PLANS = [dict(bm=bm, bn=bn, splits=s) for bm, bn in m2q_matmul.TILES
              for s in (1, 2, 4, 8)]


def _equal_under_plans(args, plans, equal=_equal):
    for out_dtype in OUT_DTYPES:
        want = int8_matmul.int8_matmul_plain(*args, out_dtype=out_dtype)
        for plan in plans:
            y = int8_matmul._launch(*args, out_dtype=out_dtype, plan=plan)
            try:
                equal(y, want)
            except AssertionError as e:
                raise AssertionError(f"plan {plan}, y {out_dtype}") from e


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", INT8_FORWARD)
def test_int8_kernel_equals_plain_at_every_plan_at_the_served_shapes(
        cuda, M, K, N, dtype):
    """Every tile and K split the kernel builds, launch_plan's own
    included, with f32 and bf16 y."""
    args = _int8_args(M, K, N, cuda, dtype, M + K + N)
    assert {k: v for k, v in int8_matmul.launch_plan(M, K, N).items()
            if k != "blocks"} in INT8_PLANS
    _equal_under_plans(args, INT8_PLANS)


@pytest.mark.parametrize("sa", [0.01, 2.0 ** -7, 1e-39])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(300, 27, 16), (100, 16, 64),
                                   (8, 1024, 1000), (200, 640, 72),
                                   (777, 256, 130)])
def test_int8_kernel_equals_plain_on_adversarial_inputs(cuda, M, K, N, dtype,
                                                        sa):
    """x at and one ulp beside rounding ties of x / sa (exact ties in bf16
    as well at sa = 2^-7), beyond the clip, NaN and +-inf; a subnormal
    scale, whose reciprocal overflows, sends every element through the
    IEEE division.  Every plan, f32 and bf16 y."""
    x, sa_, wq, scale, zp = adversarial_int8(M, K, N, seed=M + K + N, sa=sa,
                                             nonfinite=True)
    xt = torch.from_numpy(x).to(cuda).to(dtype)
    args = (xt, torch.from_numpy(wq).to(cuda),
            torch.tensor(sa_, device=cuda), torch.from_numpy(scale).to(cuda),
            torch.from_numpy(zp).to(cuda))
    if dtype == torch.float32 or sa == 2.0 ** -7:  # bf16 keeps these ties
        q = xt.float() / args[2]
        assert float(((q - q.round()).abs() > 0.499).float().mean()) > 0.05
    _equal_under_plans(args, INT8_PLANS, _equal_nan)


def test_int8_kernel_on_a_misaligned_x_and_refused_plans(cuda):
    """x 2 bytes past a 16-byte boundary takes the plain loads; plans and
    output dtypes the kernel does not build are refused."""
    M, K, N = 300, 64, 48
    flat = _randn((M * K + 1,), 3, cuda, dtype=torch.bfloat16)
    x = flat[1:].view(M, K)
    assert x.data_ptr() % 16 != 0
    args = (x,) + _int8_args(M, K, N, cuda, torch.bfloat16, 4)[1:]
    _equal_under_plans(args, [dict(bm=64, bn=64, splits=1),
                              dict(bm=32, bn=32, splits=2)])
    for plan in (dict(bm=48, bn=64, splits=1), dict(bm=64, bn=64, splits=3),
                 dict(bm=64, bn=64, splits=16), dict(bm=128, bn=64, splits=1)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            int8_matmul._launch(*args, plan=plan)
    with pytest.raises(ValueError, match="out_dtype"):
        int8_matmul._launch(*args, out_dtype=torch.float16)


def test_qtensor_matmul_int8_is_one_kernel_and_no_cast(cuda):
    """A uniform8 leaf on bf16 x: the kernel stores bf16 itself, so the
    device runs one kernel and no cast after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = _randn((2, 196, 64), 5, cuda, dtype=torch.bfloat16)
    w = _randn((64, 128), 6, cuda, std=0.125)
    qt = QUniform.quantize(w, bits=8, act_max_abs=float(x.abs().max()))
    ops.qtensor_matmul(x, qt)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y = ops.qtensor_matmul(x, qt)
        torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 196, 128)
    assert kernels.counts()["int8_matmul"] == {"launches": 1,
                                               "plain_calls": 0}
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "matmul_kernel" in names[0], names
    with ops.reference_path():
        _equal(y, ops.qtensor_matmul(x, qt))


def _within_f32_bound(y, y_ref, x, w_hat):
    """Two f32 dots summed in different orders differ by at most
    K * 2^-23 * (|x| @ |W|); one more 2^-23 covers an epilogue scale
    multiply rounded on each side."""
    K = x.shape[1]
    bound = (K + 1) * 2.0 ** -23 * (x.float().abs().double()
                                    @ w_hat.abs().double())
    err = (y.double() - y_ref.double()).abs()
    assert bool(torch.all(err <= bound)), float((err / bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_int4_kernel_within_f32_bound_of_plain(cuda, M, K, N, dtype):
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    qt = QUniform.quantize(_randn((K, N), N, cuda, std=K ** -0.5), bits=4)
    args = (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1))
    y = int4_matmul.int4_matmul(*args)
    _within_f32_bound(y, int4_matmul.int4_matmul_plain(*args), x,
                      qt.dequant())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_apot_kernel_within_f32_bound_of_plain(cuda, M, K, N, dtype):
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    qt = QAPoT.quantize(_randn((K, N), N, cuda, std=K ** -0.5))
    args = (x, qt.codes, qt.scale.reshape(-1))
    y = apot_matmul.apot_matmul(*args)
    _within_f32_bound(y, apot_matmul.apot_matmul_plain(*args), x,
                      qt.dequant())


def test_qtensor_matmul_launches_a_kernel_for_every_supported_leaf(cuda):
    """On the card every leaf JAX's kernel_supported accepts launches its
    kernel (no plain call, no CPU); the others run their QTensor matmul."""
    x = _randn((6, 32), 3, cuda, dtype=torch.bfloat16)
    w = _randn((32, 24), 4, cuda, std=0.2)
    ams = float(x.abs().max())
    asn = select_schemes(w)
    cases = [
        (QUniform.quantize(w, bits=8, act_max_abs=ams), "int8_matmul"),
        (QUniform.quantize(w, bits=4), "int4_matmul"),
        (QAPoT.quantize(w), "apot_matmul"),
        (QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx, act_max_abs=ams),
         "m2q_matmul"),
        (QUniform.quantize(w, bits=8), None),
        (QAPoT.quantize(w, act_max_abs=ams), None),
    ]
    for qt, name in cases:
        kernels.reset_counts()
        y = ops.qtensor_matmul(x, qt)
        assert y.device.type == "cuda" and y.dtype == torch.bfloat16
        launched = {k for k, c in kernels.counts().items() if c["launches"]}
        assert launched == ({name} if name else set()), (qt, launched)
        assert all(c["plain_calls"] == 0 for c in kernels.counts().values())


def test_int4_kernel_at_the_lm_head_shape(cuda):
    """qwen1.5-0.5b's lm_head: M = decode batch 8, K = 1024, N = 151936."""
    M, K, N = 8, 1024, 151936
    x = _randn((M, K), 5, cuda, dtype=torch.bfloat16)
    qt = QUniform.quantize(_randn((K, N), 6, cuda, std=K ** -0.5), bits=4)
    args = (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1))
    y = int4_matmul.int4_matmul(*args)
    _within_f32_bound(y, int4_matmul.int4_matmul_plain(*args), x,
                      qt.dequant())


def decode_inputs(B, T, H, G, D, lengths, device, seed=0,
                  q_dtype=torch.float32):
    """q (B, H, G, D) and an int8 cache quantized from random rows, the
    way the model writes it (``quantize_kv_rows``)."""
    q = _randn((B, H, G, D), seed, device, dtype=q_dtype)
    k8, ks = quantize_kv_rows(_randn((B, T, H, D), seed + 1, device))
    v8, vs = quantize_kv_rows(_randn((B, T, H, D), seed + 2, device))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k8, v8, ks, vs, lens


# (B, T, Hkv, G, D, lengths, window): the token path's shape with ragged
# lengths (0, 1, T and a slot idled past T included), GQA with D = 128,
# a window, and a cache longer than 1040 rows (|PV| sums above 2^24)
DECODE_CASES = [
    (8, 256, 16, 1, 64, [0, 1, 17, 100, 255, 256, 300, 64], None),
    (3, 40, 2, 4, 128, [1, 17, 40], None),
    (3, 40, 2, 4, 64, [1, 17, 40], 8),
    (2, 1500, 2, 2, 64, [1500, 700], None),
]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,G,D,lengths,window", DECODE_CASES)
def test_decode_attn_kernel_within_two_p8_codes_of_plain(
        cuda, B, T, H, G, D, lengths, window, q_dtype):
    args = decode_inputs(B, T, H, G, D, lengths, cuda, seed=T + G,
                         q_dtype=q_dtype)
    scale = D ** -0.5
    kernels.reset_counts()
    y = decode_attn_int8.decode_attn_int8(*args, scale, window)
    assert kernels.counts()["decode_attn_int8"] == {"launches": 1,
                                                    "plain_calls": 0}
    y_ref = decode_attn_int8.decode_attn_int8_plain(*args, scale, window)
    bound = decode_attn_int8.error_bound(*args, scale, window)
    assert bool(torch.all((y - y_ref).abs() <= bound)), \
        float(((y - y_ref).abs() / bound).max())
    # a length-0 slot gets the uniform softmax, as the plain version does
    assert bool(torch.isfinite(y).all())


def test_decode_attn_kernel_rejects_bad_operands(cuda):
    q, k8, v8, ks, vs, lens = decode_inputs(2, 8, 2, 1, 64, [1, 2], cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attn_int8.decode_attn_int8(q[..., :40].contiguous(),
                                          k8[..., :40].contiguous(),
                                          v8[..., :40].contiguous(), ks, vs,
                                          lens, 0.125)
    with pytest.raises(ValueError, match="lengths"):
        decode_attn_int8.decode_attn_int8(q, k8, v8, ks, vs, lens.long(),
                                          0.125)
    with pytest.raises(ValueError, match="shared"):
        big = decode_inputs(1, 60000, 1, 1, 64, [1], cuda)
        decode_attn_int8.decode_attn_int8(*big, 0.125)
    for plan in ({"rows": 2, "depth": 2}, {"rows": 48, "depth": 2},
                 {"rows": 64, "depth": 3}):  # not plans
        with pytest.raises(RuntimeError, match="cudaError"):
            decode_attn_int8._launch(q, k8, v8, ks, vs, lens, 0.125, None,
                                     plan=plan)


def _within_two_codes(y, args, scale, window):
    y_ref = decode_attn_int8.decode_attn_int8_plain(*args, scale, window)
    bound = decode_attn_int8.error_bound(*args, scale, window)
    assert bool(torch.all((y - y_ref).abs() <= bound)), \
        float(((y - y_ref).abs() / bound).max())


def _every_decode_plan():
    return [{"rows": r, "depth": d} for r in decode_attn_int8.ROWS
            for d in decode_attn_int8.DEPTHS]


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_decode_attn_every_plan_at_the_served_shape(cuda, B):
    """Every plan the sweep tries, at qwen1.5-0.5b's decode shape (T 256,
    Hkv 16, G 1, D 64, bf16 q) with served-like ragged lengths: the f32
    store within two p8 codes of the plain version, the bf16 store the
    f32 store rounded once, and the same bits as the chosen plan's where
    the rounding of the softmax sum does not move (every plan sums in
    its own order, so only the bound is asserted across plans)."""
    lengths = [int(x) for x in np.random.default_rng(B).integers(8, 137, B)]
    lengths[0] = 256
    args = decode_inputs(B, 256, 16, 1, 64, lengths, cuda, seed=B,
                         q_dtype=torch.bfloat16)
    for plan in _every_decode_plan():
        y = decode_attn_int8._launch(*args, 0.125, None, plan=plan)
        _within_two_codes(y, args, 0.125, None)
        y16 = decode_attn_int8._launch(*args, 0.125, None, torch.bfloat16,
                                       plan=plan)
        _equal(y16, y.to(torch.bfloat16))


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,G,D,lengths,window", DECODE_CASES)
def test_decode_attn_bf16_store_is_the_cast_of_the_f32_store(
        cuda, B, T, H, G, D, lengths, window, q_dtype):
    args = decode_inputs(B, T, H, G, D, lengths, cuda, seed=T + 3 * G,
                         q_dtype=q_dtype)
    y = decode_attn_int8.decode_attn_int8(*args, D ** -0.5, window)
    y16 = decode_attn_int8.decode_attn_int8(*args, D ** -0.5, window,
                                            out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    _equal(y16, y.to(torch.bfloat16))


def _first_version_max_T(G, D):
    """The longest cache the first version of the kernel launched: its
    G x T f32 scores and int8 codes, q8, two scales per row g and the PV
    partials in dynamic shared memory, and 32 bytes of static reduction
    slots, within the block's 232448 bytes."""
    fixed = 2 * G * 4 + max(G * D, 256) * 4 + G * D + 32
    return (decode_attn_int8.SMEM_LIMIT - fixed) // (5 * G)


@pytest.mark.parametrize("G,D", [(1, 64), (4, 128)])
def test_decode_attn_kernel_at_the_longest_cache(cuda, G, D):
    """T 1500 and the longest cache the first version took: the ring
    shrinks to fit beside the G x T scores and codes, and the result stays
    within two p8 codes (one slot idled past T, one windowed)."""
    for T in (1500, _first_version_max_T(G, D)):
        plan = decode_attn_int8.launch_plan(2, T, 1, G, D)
        assert plan["smem"] <= decode_attn_int8.SMEM_LIMIT
        args = decode_inputs(2, T, 1, G, D, [T, T + 5], cuda, seed=G,
                             q_dtype=torch.bfloat16)
        for window in (None, 700):
            y = decode_attn_int8.decode_attn_int8(*args, D ** -0.5, window)
            _within_two_codes(y, args, D ** -0.5, window)


def test_decode_attn_smem_matches_the_source(cuda):
    """The wrapper's shared-memory count is the source's layout."""
    fn = build.load("decode_attn_int8").decode_attn_int8_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    for T, G, D in ((256, 1, 64), (256, 4, 128), (40, 2, 48), (46000, 1, 64),
                    (7, 3, 16)):
        for plan in _every_decode_plan():
            want = fn(T, G, D, plan["rows"], plan["depth"])
            assert decode_attn_int8.smem_bytes(T, G, D, plan) == want


def test_decode_attn_graph_replays_give_the_same_bits(cuda):
    """The decode attention captured in a CUDA graph at the served shape
    (bf16 q, bf16 store as the op launches it): two replays give the
    bits of the eager launch, and new inputs copied in give new bits
    within the bound."""
    B, T, H, G, D = 8, 256, 16, 1, 64
    lengths = [1, 256] + [int(x) for x in
                          np.random.default_rng(3).integers(8, 137, 6)]
    args = decode_inputs(B, T, H, G, D, lengths, cuda, seed=4,
                         q_dtype=torch.bfloat16)
    q = args[0]

    def step():
        return decode_attn_int8.decode_attn_int8(*args, 0.125, None,
                                                 out_dtype=torch.bfloat16)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = step()
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(y.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager)
    q.copy_(_randn(q.shape, 5, cuda, dtype=torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    _within_two_codes(decode_attn_int8.decode_attn_int8(*args, 0.125, None),
                      args, 0.125, None)
    _equal(y, decode_attn_int8.decode_attn_int8(*args, 0.125, None)
           .to(torch.bfloat16))


def test_decode_attn_op_stores_q_dtype_without_a_cast(cuda):
    """``decode_attn_int8_op`` on bf16 q: one kernel launch storing bf16,
    the same bits as the kernel's f32 store rounded once; f32 q keeps
    the f32 store."""
    B, T, H, G, D = 2, 64, 2, 2, 64
    q, k8, v8, ks, vs, lens = decode_inputs(B, T, H, G, D, [9, 64], cuda,
                                            seed=6, q_dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        q4 = q.to(dtype).reshape(B, 1, H * G, D)
        kernels.reset_counts()
        y = ops.decode_attn_int8_op(q4, k8, v8, ks, vs, lens)
        assert y.dtype == dtype and y.shape == (B, 1, H * G, D)
        assert kernels.counts()["decode_attn_int8"] == {"launches": 1,
                                                        "plain_calls": 0}
        y32 = decode_attn_int8.decode_attn_int8(
            q.to(dtype), k8, v8, ks, vs, lens, D ** -0.5)
        _equal(y, y32.to(dtype).reshape(B, 1, H * G, D))
    kernels.reset_counts()


# ---------------------------------------------------------------------------
# the weights-only tensor-core template (csrc/weights_only_matmul.cu)
# ---------------------------------------------------------------------------


def _weights_only_case(kind, M, K, N, device, dtype, seed=0):
    """x, the kernel's operands, the plain version and the dequantized W
    the f32 bound is taken over."""
    x = _randn((M, K), seed + M + K, device, dtype=dtype)
    w = _randn((K, N), seed + N, device, std=K ** -0.5)
    if kind == "int4":
        qt = QUniform.quantize(w, bits=4)
        args = (x, qt.payload, qt.scale.reshape(-1),
                qt.zero_point.reshape(-1))
        return args, int4_matmul, qt.dequant()
    qt = QAPoT.quantize(w)
    return (x, qt.codes, qt.scale.reshape(-1)), apot_matmul, qt.dequant()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int4", "apot"])
def test_weights_only_kernels_at_the_lm_head_shape(cuda, kind, dtype):
    """qwen1.5-0.5b's lm_head shape (M = 8, K = 1024, N = 151936) through
    both decodes: the narrow tensor-core plan for bf16 x, the FMA kernel
    for f32 x."""
    args, mod, w_hat = _weights_only_case(kind, 8, 1024, 151936, cuda, dtype)
    plan = int4_matmul.launch_plan(8, 1024, 151936,
                                   dtype == torch.bfloat16)
    assert plan["kernel"] == ("mma" if dtype == torch.bfloat16 else "fma")
    name = f"{kind}_matmul"
    kernels.reset_counts()
    y = getattr(mod, name)(*args)
    assert kernels.counts()[name] == {"launches": 1, "plain_calls": 0}
    _within_f32_bound(y, getattr(mod, f"{name}_plain")(*args), args[0], w_hat)


# every tile the kernel builds, unsplit and split over clusters of 2 and 8,
# at shapes with a ragged K (640 = 10 steps of 64: a split of 8 leaves
# blocks with no step) and N; the narrow tiles at M below their token count
WO_PLANS = ([(bm, bn, s) for bm, bn in int4_matmul.TILES for s in (1, 2, 8)]
            + [(bm, bn, s) for bm, bn in int4_matmul.NARROW_TILES
               for s in (1, 2, 8)])


@pytest.mark.parametrize("kind", ["int4", "apot"])
@pytest.mark.parametrize("bm,bn,splits", WO_PLANS)
def test_weights_only_kernel_within_f32_bound_at_every_plan(cuda, kind, bm,
                                                            bn, splits):
    M = {8: 5, 16: 13}.get(bm, 200)
    N = 328 if bm <= 16 else 72
    args, mod, w_hat = _weights_only_case(kind, M, 640, N, cuda,
                                          torch.bfloat16, seed=bm + bn)
    plan = dict(kernel="mma", bm=bm, bn=bn, splits=splits)
    y = mod._launch(*args, plan=plan)
    _within_f32_bound(y, getattr(mod, f"{kind}_matmul_plain")(*args),
                      args[0], w_hat)


def test_weights_only_kernels_refuse_a_plan_they_do_not_build(cuda):
    args, mod, _ = _weights_only_case("int4", 20, 64, 32, cuda,
                                      torch.bfloat16)
    for plan in (dict(bm=48, bn=64, splits=1), dict(bm=64, bn=64, splits=3),
                 dict(bm=8, bn=64, splits=1)):  # M = 20 > 8 tokens
        with pytest.raises(RuntimeError, match="failed to launch"):
            mod._launch(*args, plan=plan)
    with pytest.raises(RuntimeError, match="failed to launch"):
        mod._launch(args[0].float(), *args[1:],
                    plan=dict(bm=64, bn=32, splits=1))


# ---------------------------------------------------------------------------
# NaN and +-inf: the int8 quantizers send NaN to 0 and +-inf to +-127, as
# the plain versions (and XLA) do; ReLU and relu_attn's kv maximum
# propagate NaN.  Equal at zero tolerance, NaN in the same places.
# ---------------------------------------------------------------------------


def _equal_nan(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _with_nonfinite(t, seed):
    """t with NaN, +inf and -inf at ~2% of its elements each."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    flat = t.clone().reshape(-1)
    pos = torch.randperm(flat.numel(), generator=g)[:3 * max(1, flat.numel()
                                                             // 50)]
    for i, v in enumerate((float("nan"), float("inf"), float("-inf"))):
        flat[pos[i::3].to(t.device)] = v
    return flat.reshape(t.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(100, 16, 64), (392, 1024, 256),
                                   (8, 1024, 1000), (777, 256, 130)])
def test_m2q_kernel_equals_plain_on_nan_and_inf(cuda, M, K, N, dtype):
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    w = _randn((K, N), N, cuda, std=K ** -0.5)
    asn = select_schemes(w)
    qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                       act_max_abs=float(x.abs().max()))
    x = _with_nonfinite(x, M)
    args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
            qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
    y = m2q_matmul.m2q_matmul(*args)
    _equal_nan(y, m2q_matmul.m2q_matmul_plain(*args))
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(100352, 27, 16), (65, 72, 1000)])
def test_int8_kernel_equals_plain_on_nan_and_inf(cuda, M, K, N, dtype):
    x = _randn((M, K), M + K, cuda, dtype=dtype)
    qt = QUniform.quantize(_randn((K, N), N, cuda, std=K ** -0.5), bits=8,
                           act_max_abs=float(x.abs().max()))
    x = _with_nonfinite(x, K)
    args = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
            qt.zero_point.reshape(-1))
    y = int8_matmul.int8_matmul(*args)
    _equal_nan(y, int8_matmul.int8_matmul_plain(*args))
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,k,stride", [(14, 14, 64, 3, 1),
                                            (7, 9, 10, 5, 1),
                                            (28, 28, 256, 3, 2)])
def test_dwconv_kernel_equals_plain_on_nan_and_inf(cuda, H, W, C, k, stride,
                                                   dtype, out_dtype):
    """NaN and +-inf in x reach the outputs whose taps read them (inf * 0
    weight is NaN), in the same places as the plain version's."""
    args = list(_dw_args(2, H, W, C, k, stride, cuda, dtype, C + k))
    args[0] = _with_nonfinite(args[0], C)
    y = dwconv_w4.dwconv_w4(*args, out_dtype=out_dtype)
    _equal_nan(y, dwconv_w4.dwconv_w4_plain(*args, out_dtype=out_dtype))
    assert not bool(torch.isfinite(y).all())


@pytest.mark.parametrize("scales", ["finite", "nan_sv", "from_inputs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_attn_kernel_equals_plain_on_nan_and_inf(cuda, dtype, scales):
    """Finite scales: non-finite q/k/v quantize to 0 / +-127 and the
    output stays finite.  A NaN sv (or scales reduced from the non-finite
    batch) reaches every output through the kv maximum."""
    B, N, H, D = 8, 49, 4, 16
    qkv = _with_nonfinite(_randn((B, N, 3 * H * D), 3, cuda, dtype=dtype), 4)
    q, k, v = (t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1))
    if scales == "from_inputs":
        sc = relu_attn_scales.relu_attn_scales(q, k, v)
        _equal_nan(torch.stack(list(sc)), torch.stack(list(
            relu_attn_scales.relu_attn_scales_plain(q, k, v))))
    else:
        sc = [torch.tensor(s, device=cuda) for s in (0.02, 0.02, 0.03)]
        if scales == "nan_sv":
            sc[2] = torch.tensor(float("nan"), device=cuda)
    y = relu_attn.relu_attn(q, k, v, *sc)
    _equal_nan(y, relu_attn.relu_attn_plain(q, k, v, *sc))
    assert bool(torch.isfinite(y).all()) == (scales == "finite")


def test_decode_attn_kernel_equals_plain_on_nan_and_inf(cuda):
    """Rows of one valid cache row (softmax exactly 1, so the kernel and
    the plain version agree bit for bit); a NaN or inf in a q row, or a
    NaN row scale the row's softmax reads, makes that (b, h, g) row NaN."""
    B, T, H, G, D = 5, 16, 2, 2, 64
    q, k8, v8, ks, vs, lens = decode_inputs(B, T, H, G, D, [1] * B, cuda,
                                            seed=9, q_dtype=torch.bfloat16)
    q[0, 0, 1, 5] = float("nan")
    q[1, 1, 0, 7] = float("inf")
    q[2, 0, 0, 3] = float("-inf")
    ks[3, 0, 1] = float("nan")  # the valid row of (b=3, h=1)
    vs[4, 9, 0] = float("nan")  # a masked row: p * v_scale still reads it
    args = (q, k8, v8, ks, vs, lens, D ** -0.5, None)
    y = decode_attn_int8.decode_attn_int8(*args)
    _equal_nan(y, decode_attn_int8.decode_attn_int8_plain(*args))
    nan_rows = torch.isnan(y).any(-1).cpu().tolist()
    assert nan_rows == [[[False, True], [False, False]],
                        [[False, False], [True, False]],
                        [[True, False], [False, False]],
                        [[False, False], [True, True]],
                        [[True, True], [False, False]]]


def test_plain_versions_cast_nan_to_zero_on_the_card(cuda):
    """torch's float -> int8 cast on CUDA sends NaN to 0 as the CPU's and
    XLA's do (+-inf clamp to +-127 first), so each plain version gives on
    the card what it gives on the CPU."""
    x = _with_nonfinite(_randn((64, 40), 0, "cpu"), 1)
    s = torch.tensor(0.02)
    q = quantize_act(x.to(cuda), s.to(cuda))
    assert q.device.type == "cuda"
    assert torch.equal(q.cpu(), quantize_act(x, s))
    assert bool((q[torch.isnan(x).to(cuda)] == 0).all())
    assert torch.equal(torch.full((3,), float("nan"), device=cuda)
                       .to(torch.int8).cpu(), torch.zeros(3, dtype=torch.int8))
    B, N, H, D = 2, 16, 2, 8
    qkv = _with_nonfinite(_randn((B, N, 3 * H * D), 5, "cpu"), 6)
    qkv_ = [t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1)]
    sc = [torch.tensor(v) for v in (0.02, 0.02, 0.03)]
    torch.testing.assert_close(
        relu_attn.relu_attn_plain(*(t.to(cuda) for t in qkv_),
                                  *(t.to(cuda) for t in sc)).cpu(),
        relu_attn.relu_attn_plain(*qkv_, *sc), rtol=0, atol=0,
        equal_nan=True)
    dq = _with_nonfinite(_randn((4, 2, 2, 64), 7, "cpu"), 8)
    for eps in (1e-9, 1e-12):
        q8, qs = decode_attn_int8._quant_rows(dq.to(cuda), eps)
        q8c, qsc = decode_attn_int8._quant_rows(dq, eps)
        assert torch.equal(q8.cpu(), q8c)
        torch.testing.assert_close(qs.cpu(), qsc, rtol=0, atol=0,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# The engines' CUDA graphs (serving/graphs.py): graph-served outputs equal
# the eager engine's on the same batches and seeds at zero tolerance, with
# the same launch counts and no plain calls.
# ---------------------------------------------------------------------------


def _vision_cfg(width):
    from repro_torch.configs.efficientvit_b1 import REDUCED
    return REDUCED if width == "reduced" else ARCHS["efficientvit-b1-r224"]


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("path", list(chip_smoke.PATHS))
def test_vision_engine_graphs_equal_eager(cuda, path, width):
    """Batches of 1, 2, 3, 8 and 5 images (buckets 1, 2, 4, 8, 8), twice:
    one graph per bucket, and the graph-served logits equal the eager
    engine's on every batch."""
    from repro_torch import recipe
    from repro_torch.models import efficientvit
    cfg = _vision_cfg(width)
    qm = recipe.quantize(cfg, efficientvit.init(cfg, seed=0, device=cuda),
                         chip_smoke.path_recipe(path))
    rng = np.random.default_rng(5)
    batches = [rng.normal(0, 1, (n, cfg.img_res, cfg.img_res, 3))
               .astype(np.float32) for n in (1, 2, 3, 8, 5)]
    served = {}
    for graphs in (False, True):
        eng = qm.serve(max_batch=8, graphs=graphs)
        for rep in range(2):
            kernels.reset_counts()
            served[graphs, rep] = ([eng.classify(b) for b in batches],
                                   kernels.counts())
        assert (eng.step_graphs is not None) == graphs
    assert len(eng.step_graphs) == 4
    want, want_counts = served[False, 0]
    assert sum(c["launches"] for c in want_counts.values()) > 0
    assert all(c["plain_calls"] == 0 for c in want_counts.values())
    for key, (got, counts) in served.items():
        assert counts == want_counts, key
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _token_requests(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 40)),
                          dtype=np.int32), int(rng.integers(3, 12)),
             0.8 if i >= 5 else 0.0) for i in range(7)]


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_token_engine_graphs_equal_eager(cuda, kv, width):
    """Five greedy and two sampled requests over four slots at seed 0:
    two graphed engines and the eager engine give the same tokens and
    the same launch counts; the graphed engines capture one greedy and
    one drawing step."""
    from repro_torch import recipe
    from repro_torch.configs.registry import REDUCED
    from repro_torch.models import dense_lm
    base = (REDUCED if width == "reduced" else ARCHS)["qwen1.5-0.5b"]
    cfg = base.replace(kv_cache_dtype=kv)
    qm = recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device=cuda),
                         "w4-weights-only" if width == "reduced"
                         else "m2q-w8a8")
    reqs = _token_requests(cfg)
    runs = []
    for graphs in (False, True, True):
        eng = qm.serve(max_batch=4, max_len=64, seed=0, graphs=graphs)
        kernels.reset_counts()
        hs = [eng.submit(p, max_new_tokens=n, temperature=t)
              for p, n, t in reqs]
        eng.run()
        runs.append(([h.handle.result() for h in hs], kernels.counts(),
                     eng.stats.steps))
        if graphs:
            assert len(eng.step_graphs) == 2
    (want, want_counts, steps), *graphed = runs
    assert want_counts["int4_matmul"]["launches"] > steps
    assert want_counts["decode_attn_int8"]["launches"] == (
        cfg.n_layers * steps if kv == "int8" else 0)
    assert all(c["plain_calls"] == 0 for c in want_counts.values())
    for got, counts, n in graphed:
        assert got == want and counts == want_counts and n == steps


# ---------------------------------------------------------------------------
# Artifacts (QuantizedModel.save / load) on the card: a loaded model is
# the saved one -- its forward, graph-served logits and tokens and launch
# counts equal the original's at zero tolerance.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", list(chip_smoke.PATHS))
def test_loaded_artifact_serves_as_the_original(cuda, path, tmp_path):
    from repro_torch import recipe
    from repro_torch.configs.efficientvit_b1 import REDUCED
    from repro_torch.models import efficientvit
    qm = recipe.quantize(REDUCED, efficientvit.init(REDUCED, seed=0,
                                                    device=cuda),
                         chip_smoke.path_recipe(path))
    qm.save(tmp_path)
    back = recipe.QuantizedModel.load(tmp_path)   # the card by default
    assert back.device.type == "cuda"
    chip_smoke.check_same_model(torch, path, qm, back)
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (5, 32, 32, 3)).astype(np.float32)
    runs = []
    for model in (qm, back):
        kernels.reset_counts()
        y = model.forward(images)
        counts = kernels.counts()
        eng = model.serve(max_batch=8, graphs=True)
        runs.append((y, counts, eng.classify(images), eng.classify(images)))
    (y, counts, g1, g2), (y_b, counts_b, g1_b, g2_b) = runs
    assert sum(c["launches"] for c in counts.values()) > 0
    assert counts_b == counts
    _equal(y_b, y)
    for a, b in ((g1, g1_b), (g2, g2_b), (g1, g2_b)):
        np.testing.assert_array_equal(a, b)


def test_loaded_token_artifact_serves_the_same_tokens(cuda, tmp_path):
    from repro_torch import recipe
    from repro_torch.configs.registry import REDUCED
    from repro_torch.models import dense_lm
    cfg = REDUCED["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    qm = recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device=cuda),
                         "w4-weights-only")
    qm.save(tmp_path)
    back = recipe.QuantizedModel.load(tmp_path)
    chip_smoke.check_same_model(torch, "token", qm, back)
    reqs = _token_requests(cfg)
    runs = []
    for model in (qm, back):
        eng = model.serve(max_batch=4, max_len=64, seed=0, graphs=True)
        kernels.reset_counts()
        hs = [eng.submit(p, max_new_tokens=n, temperature=t)
              for p, n, t in reqs]
        eng.run()
        runs.append(([h.handle.result() for h in hs], kernels.counts()))
    assert runs[1] == runs[0]
    assert runs[0][1]["decode_attn_int8"]["launches"] > 0


def test_committed_proxy_artifact_on_the_card(cuda):
    """The JAX-written artifact of the trained proxy: f32-attention logits
    against the JAX package's within ``chip_smoke.proxy_vs_jax``'s
    bounds, and the forward through the kernels (int8 and f32 attention)
    equal to the same forward's plain versions."""
    import json
    from repro_torch import recipe
    from repro_torch.data import proxy
    expected = json.loads((proxy.ARTIFACT / "expected.json").read_text())
    qm = recipe.QuantizedModel.load(proxy.ARTIFACT)
    got, labels = proxy.logits(qm.params, attn="f32")
    assert labels.tolist() == expected["labels"]
    want = np.array(expected["quantized"]["logits"], np.float32)
    assert chip_smoke.proxy_vs_jax(got, want)[1] == []
    kernels.reset_counts()
    got8, _ = proxy.logits(qm.params, n_batches=1, attn="int8")
    counts = kernels.counts()
    assert counts["m2q_matmul"]["launches"] > 0
    assert counts["relu_attn"]["launches"] > 0
    assert all(c["plain_calls"] == 0 for c in counts.values())
    with ops.reference_path():
        ref8, _ = proxy.logits(qm.params, n_batches=1, attn="int8")
        ref, _ = proxy.logits(qm.params, attn="f32")
    np.testing.assert_array_equal(got8, ref8)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The mixed LM (m2q-w8a8 at 64 tokens a step on qwen1.5-0.5b): m2q_matmul
# at its decode-step, lm_head and prefill-group shapes, the stacked
# QExpertM2Q layers through the kernel, the token Engine from graphs and
# its artifact.
# ---------------------------------------------------------------------------

LM_M2Q_SHAPES = sorted({c[1:] for calls in chip_smoke.token_m2q_calls(
    ARCHS["qwen1.5-0.5b"], chip_smoke.TOKEN_BATCH,
    chip_smoke.PREFILL_LEN).values() for c in calls})


@pytest.mark.parametrize("M,K,N", LM_M2Q_SHAPES)
def test_m2q_kernel_equals_plain_at_the_mixed_lm_shapes(cuda, M, K, N):
    x = _randn((M, K), M + N, cuda, dtype=torch.bfloat16)
    w = _randn((K, N), K, cuda, std=K ** -0.5)
    asn = select_schemes(w)
    qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                       act_max_abs=float(x.abs().max()))
    args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
            qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
    _equal(m2q_matmul.m2q_matmul(*args), m2q_matmul.m2q_matmul_plain(*args))


def test_a_layer_slice_of_a_qexpertm2q_launches_m2q_matmul(cuda):
    """A stacked (L, K, N) QExpertM2Q: each layer slice (2-D payload, a
    (1, 1) activation scale) launches the kernel once, equal to its plain
    matmul; the unsliced leaf and a perm-folded QM2Q (no activation
    scale) launch nothing."""
    from repro_torch.core.qtensor import QExpertM2Q, slice_layer
    L, K, N = 3, 256, 96
    w = _randn((L, K, N), 7, cuda, std=K ** -0.5)
    x = _randn((5, K), 8, cuda, dtype=torch.bfloat16)
    asn = [select_schemes(w[i]) for i in range(L)]
    qt = QExpertM2Q.quantize(w, np.stack([a.apot_idx for a in asn]),
                             np.stack([a.uniform_idx for a in asn]))
    qt.act_scale = torch.tensor([1.0, 2.0, 3.0], device=cuda).reshape(
        L, 1, 1) * float(x.abs().max()) / 127
    assert not ops.kernel_supported(qt)
    for i in range(L):
        layer = slice_layer(qt, i)
        kernels.reset_counts()
        y = ops.qtensor_matmul(x, layer)
        assert kernels.counts()["m2q_matmul"] == {"launches": 1,
                                                  "plain_calls": 0}
        with ops.reference_path():
            _equal(y, ops.qtensor_matmul(x, layer))
    folded = QM2Q.quantize(w[0], asn[0].apot_idx, asn[0].uniform_idx,
                           fold_perm=True)
    kernels.reset_counts()
    ops.qtensor_matmul(x, folded)
    assert all(c["launches"] == 0 for c in kernels.counts().values())


def _mixed_lm(width, device):
    """qwen1.5-0.5b under m2q-w8a8 with the int8 cache: the reduced config
    (mixed through the taxonomy overrides) or full width at 64 tokens a
    step."""
    from repro_torch import recipe
    from repro_torch.configs.registry import REDUCED
    from repro_torch.models import dense_lm
    base = (REDUCED if width == "reduced" else ARCHS)["qwen1.5-0.5b"]
    cfg = base.replace(kv_cache_dtype="int8")
    toks = 64 if width == "full" else None
    return recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device=device),
                           recipe.PRESETS["m2q-w8a8"].replace(
                               tokens_per_step=toks))


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mixed_token_engine_graphs_equal_eager(cuda, width):
    """The eager engine and two graphed ones serve the same tokens with
    the same launch counts: every stacked layer matmul and the lm_head on
    m2q_matmul in each decode step and prefill group."""
    qm = _mixed_lm(width, cuda)
    chip_smoke.check_token_leaves(qm, "token-m2q")
    reqs = _token_requests(qm.cfg)
    runs = []
    for graphs in (False, True, True):
        eng = qm.serve(max_batch=4, max_len=64, seed=0, graphs=graphs)
        kernels.reset_counts()
        hs = [eng.submit(p, max_new_tokens=n, temperature=t)
              for p, n, t in reqs]
        eng.run()
        runs.append(([h.handle.result() for h in hs], kernels.counts(),
                     eng.stats.steps, eng.stats.prefill_batches))
    (want, want_counts, steps, groups), *graphed = runs
    assert {k: c["launches"] for k, c in want_counts.items()
            if c["launches"]} == chip_smoke.token_launches(
                qm.cfg, "token-m2q", steps, groups)
    assert all(c["plain_calls"] == 0 for c in want_counts.values())
    for got, counts, n, g in graphed:
        assert got == want and counts == want_counts and n == steps


def test_loaded_mixed_lm_artifact_serves_the_same_tokens(cuda, tmp_path):
    from repro_torch import recipe
    qm = _mixed_lm("reduced", cuda)
    qm.save(tmp_path)
    back = recipe.QuantizedModel.load(tmp_path)
    chip_smoke.check_same_model(torch, "token-m2q", qm, back)
    reqs = _token_requests(qm.cfg)
    runs = []
    for model in (qm, back):
        eng = model.serve(max_batch=4, max_len=64, seed=0, graphs=True)
        kernels.reset_counts()
        hs = [eng.submit(p, max_new_tokens=n, temperature=t)
              for p, n, t in reqs]
        eng.run()
        runs.append(([h.handle.result() for h in hs], kernels.counts()))
    assert runs[1] == runs[0]
    assert runs[0][1]["m2q_matmul"]["launches"] > 0


# ---------------------------------------------------------------------------
# The serving runtime on the card: fault poisoning inside graph mode, the
# daemon capturing its graphs on its own thread, chip_smoke's phase 8 (b)
# at reduced width.
# ---------------------------------------------------------------------------


def _reduced_lm(kv, device):
    from repro_torch import recipe
    from repro_torch.configs.registry import REDUCED
    from repro_torch.models import dense_lm
    cfg = REDUCED["qwen1.5-0.5b"].replace(kv_cache_dtype=kv)
    return recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device=device),
                           "w4-weights-only")


@pytest.mark.parametrize("kv,scan", [("bf16", False), ("int8", True)])
def test_poisoning_in_graph_mode_hits_the_graphs_buffers(cuda, kv, scan):
    """``nan@decode:3`` poisons slot 0's cache rows in place after the
    decode graph was captured (step 1): the replayed graph reads them, so
    that request fails as in eager mode (f32 cache: through the logits;
    int8 cache: the captured cache scan), and its batchmates' tokens
    equal the eager run's."""
    from repro_torch.serving.faults import FaultInjector
    qm = _reduced_lm(kv, cuda)
    reqs = _token_requests(qm.cfg)[:4]
    runs = {}
    for graphs in (False, True):
        eng = qm.serve(max_batch=4, max_len=64, seed=0, graphs=graphs,
                       debug_numerics=scan,
                       faults=FaultInjector.parse("nan@decode:3"))
        hs = [eng.submit(p, max_new_tokens=max(n, 4), temperature=0.0)
              for p, n, _ in reqs]
        eng.run()
        runs[graphs] = [(h.handle.state, h.out_tokens) for h in hs]
        if graphs:
            assert len(eng.step_graphs) == 1
    assert runs[True] == runs[False]
    assert runs[True][0] == ("FAILED", [])
    assert all(state == "DONE" for state, _ in runs[True][1:])


def test_daemon_captures_its_graphs_while_another_thread_submits(cuda):
    """The serve thread captures the decode graphs while a foreign thread
    keeps submitting (host-only submits): every request completes, every
    capture ran on the serve thread, the counts reconcile."""
    from repro_torch.serving.daemon import ServingDaemon
    qm = _reduced_lm("int8", cuda)
    eng = qm.serve(max_batch=4, max_len=64, seed=0)
    captured, capture = [], eng.step_graphs._capture

    def spy(*args):
        captured.append(threading.current_thread().name)
        return capture(*args)

    eng.step_graphs._capture = spy
    reqs = _token_requests(qm.cfg)
    out = []
    with ServingDaemon(eng) as daemon:
        def submitter():
            for i, (p, n, t) in enumerate(reqs * 2):
                out.append(daemon.submit(p, slo="batch" if i % 2 else
                                         "interactive", max_new_tokens=n,
                                         temperature=t))
                time.sleep(0.002)

        th = threading.Thread(target=submitter)
        th.start()
        th.join(120.0)
        assert not th.is_alive()
        for r in out:
            assert len(r.handle.result(timeout=120.0)) == r.max_new_tokens \
                + len(r.out_prefix)
    assert captured and set(captured) == {"repro-serve"}
    assert len(eng.step_graphs) == 2 and not daemon._thread.is_alive()
    assert eng.stats.submitted == eng.stats.completed == len(reqs) * 2


def test_phase8_script_at_reduced_width(cuda):
    """chip_smoke's phase 8 (b) on the reduced qwen: the graphed and the
    eager run fail the same uids with the same classes, deliver the same
    tokens, preempt with the evicted stream kept, and launch
    decode_attn_int8 once per layer and step."""
    from repro_torch.serving.faults import FaultInjector
    qm = _reduced_lm("int8", cuda)
    runs = {}
    for graphs in (True, False):
        eng = qm.serve(max_batch=chip_smoke.RUNTIME_BATCH, max_len=64,
                       seed=0, graphs=graphs, debug_numerics=True,
                       faults=FaultInjector.parse(chip_smoke.RUNTIME_SPEC))
        runs[graphs] = chip_smoke.drive_runtime_script(eng)
        if graphs:
            assert len(eng.step_graphs) == 2
    assert chip_smoke.runtime_script_problems(qm.cfg, runs, "cuda") == []


def test_supervised_cases_at_reduced_width(cuda, tmp_path):
    """chip_smoke's phase 9 (b) on the reduced qwen (int8 cache, graphs):
    crash, hang, a streamed request across a restart, the circuit breaker
    (allocated memory after restart 3 within half an engine of restart
    1's) and cold start -- no problem, every build captured its graph."""
    qm = _reduced_lm("int8", cuda)
    res, problems = chip_smoke.supervised_cases(
        qm, dict(max_batch=4, max_len=64, seed=0), tmp_path, hang_s=1.0)
    assert problems == []
    assert [c["restarts"] for c in res["cases"].values()] == [1, 1, 1, 4, 0]
    assert all(b["graphs"] >= 1 for c in res["cases"].values()
               for b in c["builds"])
    assert res["cases"]["circuit"]["memory"]["engine_bytes"] > 0


def test_captures_after_a_released_hang_run_alone(cuda):
    """hang@decode: the teardown releases the hang and waits for the old
    serve thread; the rebuilt engine's warm-up captures its decode graph
    on the watchdog thread while no serve thread is alive, and the
    replayed requests complete from the new graphs."""
    from repro_torch.serving.supervisor import RestartPolicy, Supervisor
    qm = _reduced_lm("int8", cuda)
    reqs = _token_requests(qm.cfg)[:4]
    seen = []

    def factory():
        eng = qm.serve(max_batch=4, max_len=64, seed=0)
        capture = eng.step_graphs._capture

        def spy(*args):
            seen.append((threading.current_thread().name, sum(
                th.name == "repro-serve" and th.is_alive()
                for th in threading.enumerate())))
            return capture(*args)

        eng.step_graphs._capture = spy
        for p, n, _ in reqs:
            eng.submit(p, max_new_tokens=n)
        eng.run()
        if len(seen) == 1:
            eng.faults = chip_smoke.timed_injector("hang@decode:3")
        return eng

    sup = Supervisor(factory, policy=RestartPolicy(
        hang_threshold_s=1.0, poll_interval_s=0.05, backoff_base_s=0.01))
    sup.start()
    hs = [sup.submit(p, max_new_tokens=n) for p, n, _ in reqs]
    outs = [h.result(timeout=120.0) for h in hs]
    sup.shutdown()
    assert sup.restarts == 1
    assert sup.restart_log[0]["reason"] == "HungStepError"
    assert sup.restart_log[0]["serve_thread_exited"]
    assert seen == [("MainThread", 0), ("repro-supervisor", 0)]
    assert [len(o) for o in outs] == [n for _, n, _ in reqs]


def test_supervised_vision_crash_restart(cuda):
    """chip_smoke's phase 9 (d) on the reduced B1 under m2q-w8a8:
    crash@vision, one restart, every image DONE, launches as routed."""
    from repro_torch import recipe
    from repro_torch.configs.efficientvit_b1 import REDUCED as B1
    from repro_torch.models import efficientvit
    vis = recipe.quantize(B1, efficientvit.init(B1, seed=0, device=cuda),
                          "m2q-w8a8")
    v, problems = chip_smoke.supervised_vision(vis, n_images=10,
                                               max_batch=4)
    assert problems == [] and v["restarts"] == 1 and v["done"] == 10
    assert v["counts"]["relu_attn"] > 0

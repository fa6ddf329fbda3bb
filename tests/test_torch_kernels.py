"""Each kernel's plain PyTorch version against the JAX package's oracles
(``kernels/ref.py``), the dispatch-off QTensor path and, for m2q, the Pallas
kernel itself in interpret mode with explicit blocks at padded shapes.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py); on the CPU the wrappers run
the plain versions and never count a launch."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jq
from repro.core import quant as jquant
from repro.core import scheme_select as jss
from repro.core.packing import pack_int4
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch import kernels
from repro_torch.core import quant as tquant
from repro_torch.core.qtensor import QM2Q
from repro_torch.kernels import (apot_matmul, build, decode_attn_int8,
                                 dwconv_w4, int4_matmul, int8_matmul,
                                 m2q_matmul, ops, relu_attn,
                                 relu_attn_scales)
from m2q_cases import adversarial_m2q, apot_codes


def _rng(*key):
    return np.random.default_rng(sum((i + 1) * k for i, k in enumerate(key)))


@functools.lru_cache(maxsize=None)
def _m2q_case(M, K, N):
    """Float x and the JAX QM2Q leaf (quantizing eagerly in JAX is the
    slow part of these tests, so each shape is built once)."""
    rng = _rng(M, K, N)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    asn = jss.select_schemes(jnp.asarray(w))
    qa = jq.QM2Q.quantize(jnp.asarray(w), asn.apot_idx, asn.uniform_idx,
                          act_max_abs=jnp.float32(np.abs(x).max()))
    return x, qa


def _flat(qa):
    return (qa.act_scale, qa.payload, qa.u_scale.reshape(-1),
            qa.u_zp.reshape(-1), qa.a_scale.reshape(-1))


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


# integer sums are exact on both sides and the f32 epilogue is the same
# elementwise sequence, so only a fused multiply-add on one side could move
# a last bit: 1e-6 relative to the output's magnitude bounds that
def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(np.abs(want).max(), 1.0))


# K=16 as at stage 0, N=100 ragged as at the head (N=1000)
@pytest.mark.parametrize("M,K,N", [(20, 16, 40), (8, 128, 100)])
def test_m2q_plain_matches_ref_qtensor_and_pallas(M, K, N):
    x, qa = _m2q_case(M, K, N)
    args = _flat(qa)
    y = m2q_matmul.m2q_matmul_plain(torch.from_numpy(x), *_torch(args))
    _close(y.numpy(), ref.m2q_merged_ref(jnp.asarray(x), *args))
    _close(y.numpy(), qa.matmul(jnp.asarray(x)))
    # the Pallas kernel body, interpreted, blocks given explicitly so the
    # (padded) shapes are not multiples of K/N
    y_pl = jops.m2q_matmul_op(jnp.asarray(x), *args, interpret=True,
                              blocks=(16, 32, 16))
    _close(y.numpy(), y_pl)


@pytest.mark.parametrize("kind", ["mixed", "uniform", "apot"])
def test_m2q_plain_matches_ref_and_pallas_on_adversarial_payloads(kind):
    """Every APoT code (+-256 units, the kernel's hi plane, included) and
    the zero code, all-uniform and all-APoT layers, and activations that
    mostly clip at +-127: exactly the inputs the CUDA kernel's decode must
    get right, against the reference and the interpreted Pallas kernel."""
    x, *args = adversarial_m2q(12, 96, 40, kind, seed=3)
    payload = args[1]
    if kind != "uniform":
        apot_cols = np.flatnonzero(args[4])
        assert set(apot_codes()) <= set(payload[:, apot_cols[0]].view(np.uint8))
    y = m2q_matmul.m2q_matmul_plain(torch.from_numpy(x), *_torch(args))
    xq = np.abs(np.asarray(jquant.quantize_act(jnp.asarray(x), args[0])))
    assert (xq == 127).mean() > 0.5
    _close(y.numpy(), ref.m2q_merged_ref(jnp.asarray(x), *args))
    y_pl = jops.m2q_matmul_op(jnp.asarray(x), *args, interpret=True,
                              blocks=(8, 32, 32))
    _close(y.numpy(), y_pl)


def test_m2q_apot_planes_rebuild_the_decode():
    """The kernel's split of an APoT byte's units into int8 planes,
    ``(hi << 7) + lo`` with hi = s*(units >> 7), lo = s*(units & 127),
    holds for all 256 byte values (the uniform columns' bytes too)."""
    from repro_torch.core.packing import apot_decode_units
    units = apot_decode_units(torch.arange(256, dtype=torch.uint8)).numpy()
    sign = np.sign(units)
    hi, lo = sign * (np.abs(units) >> 7), sign * (np.abs(units) & 127)
    assert hi.min() >= -128 and hi.max() <= 127
    assert lo.min() >= -128 and lo.max() <= 127
    np.testing.assert_array_equal(hi * 128 + lo, units)
    codes = apot_codes()
    assert int(apot_decode_units(torch.from_numpy(codes)).abs().max()) == 256


@pytest.mark.parametrize("sa", [0.01, 0.0371, 3.3e-3, 1.7, 1.3 * 2.0 ** -20,
                                2.0 ** 100])
def test_m2q_quantize_filter_decides_like_the_ieee_quotient(sa):
    """The kernel's Quantizer, in numpy float32: wherever the reciprocal
    product t = RN(x * RN(1/sa)) is not within 2^-12 of a half-integer
    (|t - rint(t)| > 0.5 - 2^-12) below 128, clip(rint(t)) equals
    clip(rint(RN(x / sa))); the near-ties (which the kernel divides) stay
    rare."""
    rng = np.random.default_rng(11)
    sa = np.float32(sa)
    ties = (rng.integers(-140, 140, 4000) + np.float32(0.5)) * sa
    x = np.concatenate([
        rng.normal(0, 60, 100_000).astype(np.float32) * sa,
        rng.normal(0, 1, 20_000).astype(np.float32),
        *(np.nextafter(ties, np.float32(np.inf) * d).astype(np.float32)
          for d in (1, -1)), ties.astype(np.float32),
        np.array([0, -0.0, 1e-45, -1e-38, 3e38, -3e38, np.inf, -np.inf],
                 dtype=np.float32)]).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        exact = np.clip(np.rint(x / sa), -127, 127)
        t = x * (np.float32(1) / sa)
        n = np.rint(t)
        near = (np.abs(t) < 128) & (np.abs(t - n) > 0.5 - 2.0 ** -12)
        fast = np.clip(n, -127, 127)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(fast[~near], exact[~near])
    assert near[:120_000].mean() < 1e-2


@pytest.mark.parametrize("M,K,N", [
    (100352, 16, 64), (100352, 64, 16), (25088, 64, 32), (6272, 128, 64),
    (1568, 512, 128), (392, 1024, 256), (392, 256, 768), (8, 1024, 1000),
    (64, 4096, 96), (5, 16, 3)])
def test_m2q_launch_plan_fills_the_card(M, K, N):
    """Tiles the kernel instantiates; every SM gets a block unless the
    shape is too small for 32-row tiles split 8 ways (or too short in K
    to split further); a cluster's blocks divide the tile's rows."""
    p = m2q_matmul.launch_plan(M, K, N)
    assert (p["bm"], p["bn"]) in m2q_matmul.TILES
    assert p["splits"] in (1, 2, 4, 8) and p["bm"] % p["splits"] == 0
    tiles = -(-M // p["bm"]) * -(-N // p["bn"])
    assert p["blocks"] == tiles * p["splits"]
    steps = -(-K // m2q_matmul.BK)
    assert steps >= 2 * p["splits"] or p["splits"] == 1
    if p["blocks"] < m2q_matmul.SMS:
        assert p["splits"] == m2q_matmul.MAX_SPLIT or steps < 8 \
            or steps < 4 * p["splits"]
    assert N > 32 or p["bn"] >= N  # narrow layers waste no tile columns


def test_m2q_plain_bf16_activations_quantize_in_f32():
    x, qa = _m2q_case(20, 16, 40)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = _flat(qa)
    y = m2q_matmul.m2q_matmul_plain(xb, *_torch(args))
    _close(y.numpy(), ref.m2q_merged_ref(jnp.asarray(xb.float().numpy()),
                                         *args))


def test_qm2q_matmul_routes_through_the_wrapper_on_cpu():
    x, qa = _m2q_case(20, 16, 40)
    x = x[:6]
    qt = QM2Q(*_torch((qa.payload, qa.u_scale, qa.u_zp, qa.a_scale,
                       qa.act_scale)), qa.shape, qa.n_uniform, qa.n_apot)
    xt = torch.from_numpy(x).reshape(2, 3, 16)
    kernels.reset_counts()
    y = ops.qtensor_matmul(xt, qt)
    assert tuple(y.shape) == (2, 3, 40)
    c = kernels.counts()["m2q_matmul"]
    assert c == {"launches": 0, "plain_calls": 1}
    _close(y.reshape(6, 40).numpy(), qa.matmul(jnp.asarray(x)))


def _dw_case(B, H, W, C, k, seed):
    rng = _rng(B, H, W, C, k, seed)
    w = rng.normal(0, 0.2, (k, k, C)).astype(np.float32)
    u = jquant.uniform_quantize(jnp.asarray(w.reshape(k * k, C)), bits=4)
    packed = pack_int4(u.q)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return x, packed, u.scale.reshape(-1), u.zero_point.reshape(-1)


@pytest.mark.parametrize("H,W", [(8, 8), (7, 9)])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1)])
def test_dwconv_plain_matches_ref(H, W, k, stride):
    x, packed, scale, zp = _dw_case(2, H, W, 16, k, stride)
    y = dwconv_w4.dwconv_w4_plain(torch.from_numpy(x),
                                  *_torch((packed, scale, zp)), kh=k, kw=k,
                                  stride=stride)
    y_ref = ref.dwconv_w4_ref(jnp.asarray(x), packed, scale, zp, kh=k, kw=k,
                              stride=stride)
    assert tuple(y.shape) == tuple(y_ref.shape)
    _close(y.numpy(), y_ref)


@pytest.mark.parametrize("size,k,stride,want", [
    (112, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (14, 5, 1, (2, 2)),
    (8, 3, 1, (1, 1))])
def test_same_padding_is_xla_same(size, k, stride, want):
    from repro.kernels.dwconv_w4 import same_padding as jsame
    assert dwconv_w4.same_padding(size, k, stride) == want == \
        jsame(size, k, stride)


def _attn_case(B, N, H, D):
    rng = _rng(B, N, H, D)
    qkv = rng.normal(0, 1, (B, N, 3 * H * D)).astype(np.float32)
    return [np.ascontiguousarray(qkv[..., i * H * D:(i + 1) * H * D]
                                 .reshape(B, N, H, D)) for i in range(3)]


@pytest.mark.parametrize("B,N,H,D", [(2, 16, 2, 8), (1, 49, 4, 16)])
def test_relu_attn_plain_matches_ref_with_equal_integers(B, N, H, D):
    q, k, v = _attn_case(B, N, H, D)
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    sq, sk, sv = relu_attn_scales.relu_attn_scales_plain(tq_, tk, tv)
    # the scales as ops._relu_attn_core computes them
    jsq = jquant.act_scale_from_stats(jnp.maximum(jnp.max(q), 0.0))
    jsk = jquant.act_scale_from_stats(jnp.maximum(jnp.max(k), 0.0))
    jsv = jquant.act_scale_from_stats(jnp.max(jnp.abs(v)))
    for a, b in ((jsq, sq), (jsk, sk), (jsv, sv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # int8 codes and int32 accumulators, bit for bit
    jq8 = jquant.quantize_act(jnp.maximum(q, 0), jsq).astype(jnp.int32)
    jk8 = jquant.quantize_act(jnp.maximum(k, 0), jsk).astype(jnp.int32)
    jv8 = jquant.quantize_act(jnp.asarray(v), jsv).astype(jnp.int32)
    q8 = tquant.quantize_act(torch.relu(tq_), sq).to(torch.int32)
    k8 = tquant.quantize_act(torch.relu(tk), sk).to(torch.int32)
    v8 = tquant.quantize_act(tv, sv).to(torch.int32)
    for a, b in ((jq8, q8), (jk8, k8), (jv8, v8)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jkv = jnp.einsum("bnhd,bnhe->bhde", jk8, jv8,
                     preferred_element_type=jnp.int32)
    kv = tquant.int_einsum("bnhd,bnhe->bhde", k8, v8)
    np.testing.assert_array_equal(np.asarray(jkv).astype(np.float32),
                                  kv.numpy())
    y = relu_attn.relu_attn_plain(tq_, tk, tv, sq, sk, sv)
    _close(y.numpy(), ref.relu_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jsq, jsk, jsv))


def test_relu_attn_plain_takes_strided_slices():
    """The MSA hands q/k/v as strided views of one qkv tensor."""
    B, N, H, D = 2, 9, 2, 8
    qkv = torch.from_numpy(_rng(5).normal(0, 1, (B, N, 3 * H * D))
                           .astype(np.float32))
    views = [t.reshape(B, N, H, D) for t in torch.split(qkv, H * D, -1)]
    assert not views[0].is_contiguous()
    dense = [t.contiguous() for t in views]
    y1 = ops.relu_attn_op(*views)
    y2 = ops.relu_attn_op(*dense)
    assert torch.equal(y1, y2)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    kernels.reset_counts()
    x, qa = _m2q_case(20, 16, 40)
    m2q_matmul.m2q_matmul(torch.from_numpy(x), *_torch(_flat(qa)))
    xd, packed, scale, zp = _dw_case(1, 5, 5, 8, 3, 0)
    dwconv_w4.dwconv_w4(torch.from_numpy(xd), *_torch((packed, scale, zp)))
    q, k, v = (torch.from_numpy(a) for a in _attn_case(1, 4, 1, 8))
    relu_attn.relu_attn(q, k, v, *relu_attn_scales.relu_attn_scales(q, k, v))
    xm = torch.ones((3, 4))
    s1, s2 = torch.ones(()), torch.ones(2)
    int8_matmul.int8_matmul(xm, torch.ones((4, 2), dtype=torch.int8), s1,
                            s2, s2)
    int4_matmul.int4_matmul(xm, torch.ones((4, 1), dtype=torch.uint8), s2,
                            s2)
    apot_matmul.apot_matmul(xm, torch.ones((4, 2), dtype=torch.uint8), s2)
    cache = torch.ones((1, 4, 1, 16), dtype=torch.int8)
    decode_attn_int8.decode_attn_int8(
        torch.ones((1, 1, 1, 16)), cache, cache, torch.ones((1, 4, 1)),
        torch.ones((1, 4, 1)), torch.tensor([2], dtype=torch.int32), 0.25)
    assert kernels.counts() == {
        name: {"launches": 0, "plain_calls": 1}
        for name in ("m2q_matmul", "dwconv_w4", "relu_attn",
                     "relu_attn_scales", "int8_matmul", "int4_matmul",
                     "apot_matmul", "decode_attn_int8")}
    kernels.reset_counts()
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in kernels.counts().values())


def test_reference_path_runs_plain_versions():
    x, qa = _m2q_case(20, 16, 40)
    qt = QM2Q(*_torch((qa.payload, qa.u_scale, qa.u_zp, qa.a_scale,
                       qa.act_scale)), qa.shape, qa.n_uniform, qa.n_apot)
    kernels.reset_counts()
    with ops.reference_path():
        ops.qtensor_matmul(torch.from_numpy(x), qt)
    assert kernels.counts()["m2q_matmul"] == {"launches": 0,
                                              "plain_calls": 1}


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        m2q_matmul.m2q_matmul(x, x, x, x, x, x)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without a compiler the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_kernel_sources_are_the_built_ones():
    for source, entry_points in build.SOURCES.items():
        text = (build.CSRC / f"{source}.cu").read_text()
        for name in entry_points:
            assert f'extern "C" int {name}(' in text
        assert "cudaGetLastError" in text
    assert sorted(build.CSRC.glob("*.cu")) == sorted(
        build.CSRC / f"{source}.cu" for source in build.SOURCES)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

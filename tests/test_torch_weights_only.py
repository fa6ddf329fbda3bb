"""What the CPU can check of the weights-only kernels' bf16 tensor-core
design, and the port's plain int8 quantizers on non-finite inputs.

``csrc/weights_only_matmul.cu`` multiplies bf16 x by decoded weights on
bf16 tensor cores, which is exact only because every decoded weight is
exact in bf16: each APoT code's value, and ``q - zp`` for every 4-bit code
against an integral zero point.  The tests below check those facts (and
the kernel's bit-level decodes, emulated in numpy), that the 4-bit
quantizers of both packages make integral zero points, and that
``int4_matmul.launch_plan`` covers every shape the served paths launch.
The kernels themselves run only on the card (tests/test_torch_gpu.py).

The CUDA int8 quantizers send NaN to 0 and +-inf to +-127, as XLA's
float -> int8 cast does; the port's plain versions are held to JAX's here
on inputs holding NaN and +-inf, and to the kernels on the card.
"""
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jq
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.nn import attention as ja
from repro_torch.configs.registry import ARCHS
from repro_torch.core import quant as tquant
from repro_torch.core.packing import apot_decode_values
from repro_torch.core.qtensor import QUniform
from repro_torch.kernels import decode_attn_int8 as tdec
from repro_torch.kernels import int4_matmul, relu_attn, relu_attn_scales

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the served paths' shapes)


def _bf16_bits(v: torch.Tensor) -> np.ndarray:
    return v.to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)


def _kernel_apot_bits(c: np.ndarray) -> np.ndarray:
    """ApotDec::value of the kernel in numpy: the f32 sum 2^-e1 + 2^-e2,
    its top 16 bits as the bf16 value, bit 6 moved to the sign, 0 where
    bit 7 is set."""
    c = c.astype(np.uint32)
    e1 = (127 - ((c >> 3) & 7)) << 23
    e2 = (127 - (c & 7)) << 23
    f = e1.view(np.float32) + e2.view(np.float32)
    b = (f.view(np.uint32) >> 16) | ((c & 0x40) << 9)
    return np.where(c & 0x80, 0, b).astype(np.uint16)


def test_every_apot_code_is_exact_in_bf16():
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    v = apot_decode_values(codes)
    assert torch.equal(v.to(torch.bfloat16).to(torch.float32), v)
    assert np.array_equal(_kernel_apot_bits(codes.numpy()), _bf16_bits(v))
    # zero code (bit 7) and both signs of every magnitude are present
    assert int((v == 0).sum()) == 128 and float(v.max()) == 2.0


def test_every_int4_offset_is_exact_in_bf16():
    """q - zp for every code q and integral zero point zp in [0, 15], and
    the kernel's route to it: bf16 bits 0x4300 | q are 128 + q, and one
    bf16 subtraction of bf16(128 + zp) leaves q - zp exactly."""
    q, zp = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    want = torch.from_numpy((q - zp).astype(np.float32))
    assert torch.equal(want.to(torch.bfloat16).to(torch.float32), want)
    biased = torch.from_numpy((0x4300 | q).astype(np.int16)).view(
        torch.bfloat16)
    assert torch.equal(biased.float(), torch.from_numpy(128.0 + q).float())
    z = torch.from_numpy(128.0 + zp).float().to(torch.bfloat16)
    assert torch.equal(z.float(), torch.from_numpy(128.0 + zp).float())
    assert torch.equal((biased - z).float(), want)


@pytest.mark.parametrize("dist", ["normal", "positive", "negative",
                                  "constant", "zero_column", "laplace"])
def test_4bit_zero_points_are_integral_in_both_packages(dist):
    """The kernel's exact bf16 decode needs integral zero points; both
    packages' 4-bit quantizers round them, on the same numpy weights."""
    rng = np.random.default_rng(sum(map(ord, dist)))
    w = {"normal": lambda: rng.normal(0, 0.05, (48, 24)),
         "positive": lambda: rng.uniform(0.1, 1.0, (48, 24)),
         "negative": lambda: -rng.uniform(0.1, 1.0, (48, 24)),
         "constant": lambda: np.full((48, 24), 0.3),
         "zero_column": lambda: np.concatenate(
             [rng.normal(0, 1, (48, 23)), np.zeros((48, 1))], axis=1),
         "laplace": lambda: rng.laplace(0, 0.1, (48, 24))}[dist]()
    w = w.astype(np.float32)
    port = QUniform.quantize(torch.from_numpy(w), bits=4)
    jax_leaf = jq.QUniform.quantize(jnp.asarray(w), bits=4)
    for zp in (port.zero_point.numpy(), np.asarray(jax_leaf.zero_point)):
        assert np.array_equal(zp, np.round(zp))
        assert zp.min() >= 0 and zp.max() <= 15
    np.testing.assert_array_equal(port.zero_point.numpy(),
                                  np.asarray(jax_leaf.zero_point))


def _served_shapes():
    """Every (M, K, N) the weights-only kernels launch on the served paths
    (the B1 R224 batch-8 forward's PWConvs and head, the qwen lm_head at
    decode batch 8), plus ragged ones the tests force."""
    cfg = ARCHS["efficientvit-b1-r224"]
    shapes = Counter(c[1:] for c in chip_smoke.main_path_calls(cfg, 8)[0])
    qwen = ARCHS["qwen1.5-0.5b"]
    shapes[(8, qwen.d_model, qwen.padded_vocab)] += 1
    for s in [(100352, 27, 16), (65, 72, 1000), (777, 256, 130),
              (13, 640, 328), (5, 16, 2), (1, 4096, 64), (17, 64, 8)]:
        shapes[s] += 1
    return sorted(shapes)


@pytest.mark.parametrize("M,K,N", _served_shapes())
def test_weights_only_launch_plan_covers_every_served_shape(M, K, N):
    """A tile the kernel instantiates (the narrow plan exactly for
    M <= 16, with no more tokens than its tile holds); every SM gets a
    block unless K is too short to split further or the cluster is full;
    each split keeps at least two 64-deep steps; narrow layers waste no
    tile columns; f32 x takes the FMA kernel's one shape."""
    p = int4_matmul.launch_plan(M, K, N)
    assert p["kernel"] == "mma"
    narrow = M <= 16
    tiles = int4_matmul.NARROW_TILES if narrow else int4_matmul.TILES
    assert (p["bm"], p["bn"]) in tiles
    assert (p["bm"] <= 16) == narrow
    assert M <= p["bm"] or not narrow
    assert p["splits"] in (1, 2, 4, 8)
    n_tiles = -(-M // p["bm"]) * -(-N // p["bn"])
    assert p["blocks"] == n_tiles * p["splits"]
    steps = -(-K // int4_matmul.BK)
    assert p["splits"] == 1 or steps >= 2 * p["splits"]
    if p["blocks"] < int4_matmul.SMS:
        assert p["splits"] == int4_matmul.MAX_SPLIT \
            or steps < 4 * p["splits"]
    if narrow:  # the widest tile that still gives every SM a block
        assert p["bn"] == 64 or -(-N // p["bn"]) >= int4_matmul.SMS
    else:  # the tallest tile that still does
        assert p["bm"] == 32 or n_tiles >= int4_matmul.SMS
        assert N > 32 or p["bn"] >= N
    fma = int4_matmul.launch_plan(M, K, N, bf16=False)
    assert fma["kernel"] == "fma" and fma["splits"] == 1
    assert (fma["bm"], fma["bn"]) == int4_matmul.FMA_TILE


def test_served_shapes_take_the_expected_plans():
    """The lm_head streams its payload unsplit over 594 narrow blocks;
    B1's head is narrow and split; the largest layers take 128-row
    tiles; late-stage long-K layers take 32-row tiles and split."""
    assert int4_matmul.launch_plan(8, 1024, 151936) == {
        "kernel": "mma", "bm": 8, "bn": 256, "splits": 1, "blocks": 594}
    head = int4_matmul.launch_plan(8, 1024, 1000)
    assert (head["bm"], head["bn"], head["splits"]) == (8, 64, 8)
    late = int4_matmul.launch_plan(392, 1024, 256)
    assert (late["bm"], late["bn"], late["splits"]) == (32, 64, 4)
    big = int4_matmul.launch_plan(100352, 16, 64)
    assert (big["bm"], big["bn"], big["splits"]) == (128, 64, 1)


# ---------------------------------------------------------------------------
# the plain int8 quantizers on NaN and +-inf, against JAX
# ---------------------------------------------------------------------------


def _nonfinite(shape, seed, std=1.0):
    """Seeded normal values with NaN, +inf and -inf at fixed positions."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, std, shape).astype(np.float32)
    flat = a.reshape(-1)
    pos = rng.choice(flat.size, 3 * max(1, flat.size // 50), replace=False)
    for i, v in enumerate((np.nan, np.inf, -np.inf)):
        flat[pos[i::3]] = v
    return a


def test_plain_quantize_act_matches_jax_on_nan_and_inf():
    """NaN -> 0, +inf -> 127, -inf -> -127, as XLA casts them."""
    x = _nonfinite((64, 40), 0)
    s = np.float32(0.02)
    want = np.asarray(jquant.quantize_act(jnp.asarray(x), jnp.asarray(s)))
    got = tquant.quantize_act(torch.from_numpy(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[np.isnan(x)] == 0)
    assert np.all(got[x == np.inf] == 127) and np.all(got[x == -np.inf] == -127)


@pytest.mark.parametrize("scales", ["finite", "nan_sv", "from_inputs"])
def test_plain_relu_attn_matches_jax_on_nan_and_inf(scales):
    """Non-finite q/k/v under finite scales quantize to 0 / +-127 and give
    finite output; a NaN scale (a NaN in the batch's v, reduced into sv)
    reaches every output through the kv maximum, as in the reference."""
    B, N, H, D = 2, 16, 2, 8
    q, k, v = (_nonfinite((B, N, H, D), s) for s in (1, 2, 3))
    if scales == "from_inputs":
        tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        sq, sk, sv = (s.numpy() for s in
                      relu_attn_scales.relu_attn_scales_plain(tq_, tk, tv))
        assert np.isnan(sv)
    else:
        sq, sk, sv = (np.float32(x) for x in (0.02, 0.02, 0.03))
        if scales == "nan_sv":
            sv = np.float32(np.nan)
    got = relu_attn.relu_attn_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        *(torch.tensor(s) for s in (sq, sk, sv))).numpy()
    want = np.asarray(ref.relu_attn_ref(
        *(jnp.asarray(a) for a in (q, k, v)),
        *(jnp.asarray(s) for s in (sq, sk, sv))))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(np.nanmax(np.abs(want))
                                               if np.isfinite(want).any()
                                               else 0.0, 1.0))
    assert np.isfinite(got).all() == (scales == "finite")


def test_plain_decode_attn_matches_jax_on_nan_and_inf():
    """A NaN or inf in a q row, or a NaN row scale the row's softmax
    reads, makes that (b, h, g) output NaN in both packages; the other
    rows stay finite and within the stated two-code limit."""
    B, T, Hkv, G, D = 4, 12, 2, 2, 64
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (B, 1, Hkv * G, D)).astype(np.float32)
    q[0, 0, 1, 5] = np.nan
    q[1, 0, 2, 7] = np.inf
    k8, ks = ja.quantize_kv_rows(jnp.asarray(
        rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)))
    v8, vs = ja.quantize_kv_rows(jnp.asarray(
        rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)))
    ks, vs = np.array(ks), np.array(vs)
    ks[2, 1, 0] = np.nan   # a valid row of (b=2, h=0)
    vs[3, 9, 1] = np.nan   # a masked row of (b=3, h=1): p * v_scale reads it
    lengths = np.array([3, 5, 4, 2], np.int32)
    jargs = (jnp.asarray(q), k8, v8, jnp.asarray(ks), jnp.asarray(vs),
             jnp.asarray(lengths))
    with jops.dispatch(dense=False, conv=False, attn=False):
        want = np.asarray(ja.decode_attention_int8(*jargs))
    targs = [torch.from_numpy(np.array(a)) for a in
             (q.reshape(B, Hkv, G, D), k8, v8, ks, vs, lengths)]
    got = tdec.decode_attn_int8_plain(*targs, D ** -0.5).numpy()
    got = got.reshape(B, 1, Hkv * G, D)
    nan_rows = np.isnan(want).any(-1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert nan_rows.reshape(B, Hkv, G).tolist() == [
        [[False, True], [False, False]], [[False, False], [True, False]],
        [[True, True], [False, False]], [[False, False], [True, True]]]
    assert np.all(np.isnan(want[nan_rows]))
    bound = tdec.error_bound(*targs, D ** -0.5).numpy().reshape(
        B, 1, Hkv * G, 1)
    fin = ~nan_rows
    err = np.abs(got - want)[fin]
    assert np.all(err <= np.broadcast_to(bound, got.shape)[fin])

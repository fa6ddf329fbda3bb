"""The port's int8 ReLU linear attention and its scale chain against the
JAX package, on the CPU (plain versions; the CUDA kernels run only on the
card, see ``test_torch_gpu.py``).

The same numpy inputs (f32, or rounded to bf16 for both packages) go
through the JAX Pallas kernel in interpret mode (``ops.relu_attn_op`` with
explicit ``blocks``, so no autotune probe runs) and through the port's
plain ``relu_attn_scales_plain`` + ``relu_attn_plain``.  Scales and int8
codes and int32 sums agree bit for bit; the output within 1e-6 of the
largest |y|: the interpreted kernel is compiled by XLA's CPU backend,
which may round the epilogue's division an ulp differently.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.core import quant as tquant
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops, relu_attn, relu_attn_scales

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the served paths' shapes)


def _qkv(B, N, H, D, dtype, seed, std=1.0):
    """q, k, v as the MSA hands them: column slices of one (B, N, 3C)
    tensor, made from a numpy seed; and the same values for JAX."""
    a = np.random.default_rng(seed).normal(0, std, (B, N, 3 * H * D))
    t = torch.from_numpy(a.astype(np.float32)).to(dtype)
    views = [x.reshape(B, N, H, D) for x in torch.split(t, H * D, -1)]
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jin = [jnp.asarray(x.float().numpy()).astype(jdtype) for x in views]
    return views, jin


def _jax_scales(q, k, v):
    """The scales as ``ops._relu_attn_core`` computes them."""
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    return (jquant.act_scale_from_stats(jnp.maximum(jnp.max(qf), 0.0)),
            jquant.act_scale_from_stats(jnp.maximum(jnp.max(kf), 0.0)),
            jquant.act_scale_from_stats(jnp.max(jnp.abs(vf))))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the two EfficientViT-B1 R224 MSA shapes at batch 2 (stage 3: 14x14
# tokens, 8 heads; stage 4: 7x7 tokens, 16 heads; D = 16), and D = 8 / 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,bn", [(2, 196, 8, 16, 128),
                                        (2, 49, 16, 16, 64),
                                        (2, 20, 2, 8, 32),
                                        (1, 30, 1, 64, 32)])
def test_plain_relu_attn_matches_pallas_interpret(B, N, H, D, bn, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(B, N, H, D, dtype, B * N + H + D)
    sq, sk, sv = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    jsq, jsk, jsv = _jax_scales(jq, jk, jv)
    for s, js in ((sq, jsq), (sk, jsk), (sv, jsv)):
        _same(s, js)
    # int8 codes and the int32 kv and ksum, bit for bit
    codes = [tquant.quantize_act(torch.relu(q.float()), sq),
             tquant.quantize_act(torch.relu(k.float()), sk),
             tquant.quantize_act(v.float(), sv)]
    jqf, jkf, jvf = (x.astype(jnp.float32) for x in (jq, jk, jv))
    jcodes = [jquant.quantize_act(jnp.maximum(jqf, 0), jsq),
              jquant.quantize_act(jnp.maximum(jkf, 0), jsk),
              jquant.quantize_act(jvf, jsv)]
    for c, jc in zip(codes, jcodes):
        _same(c, jc)
    k8, v8 = (c.to(torch.int32) for c in codes[1:])
    jk8, jv8 = (c.astype(jnp.int32) for c in jcodes[1:])
    _same(torch.einsum("bnhd,bnhe->bhde", k8, v8),
          jnp.einsum("bnhd,bnhe->bhde", jk8, jv8,
                     preferred_element_type=jnp.int32))
    _same(k8.sum(dim=1, dtype=torch.int32), jnp.sum(jk8, axis=1))
    y = relu_attn.relu_attn_plain(q, k, v, sq, sk, sv)
    want = np.asarray(jops.relu_attn_op(jq, jk, jv, interpret=True,
                                        blocks=(bn, 16, 1)))
    assert y.dtype == torch.float32 and y.shape == (B, N, H, D)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1.0))


def _special(kind: str, shape, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1)
    if kind == "nan":
        flat[7] = np.nan
    elif kind == "inf":
        flat[3] = np.inf
    elif kind == "-inf":
        flat[5] = -np.inf
    elif kind == "negative":
        x = -np.abs(x) - 0.5
    elif kind == "-0.0":
        x = np.full(shape, -0.0, np.float32)
    elif kind == "zero":
        x = np.zeros(shape, np.float32)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "nan", "inf", "-inf",
                                  "negative", "-0.0", "zero"])
def test_scale_chain_matches_jax_expressions(kind, dtype):
    """NaN in a tensor makes its scale NaN, +inf makes it inf; -inf, an
    all-negative q/k and -0.0 give the 1e-8 floor (for v, |-inf| = inf)."""
    shape = (2, 9, 2, 8)
    arrays = [_special(kind, shape, s) for s in (1, 2, 3)]
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    got = relu_attn_scales.relu_attn_scales_plain(*ts)
    want = _jax_scales(*(jnp.asarray(t.float().numpy()).astype(jdtype)
                         for t in ts))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sq, sk, sv = (float(g) for g in got)
    if kind == "nan":
        assert np.isnan(sq) and np.isnan(sk) and np.isnan(sv)
    elif kind == "inf":
        assert sq == sk == sv == np.inf
    elif kind in ("negative", "-0.0", "zero"):
        assert sq == sk == np.float32(1e-8)
    if kind == "-inf":
        assert sv == np.inf
    if kind in ("-0.0", "zero"):
        assert sv == np.float32(1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_out_dtype_is_the_f32_result_rounded_once(dtype):
    (q, k, v), _ = _qkv(2, 49, 4, 16, dtype, 7)
    sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
    y32 = relu_attn.relu_attn_plain(q, k, v, *sc)
    y16 = relu_attn.relu_attn_plain(q, k, v, *sc, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.to(torch.bfloat16))
    assert torch.equal(relu_attn.relu_attn(q, k, v, *sc,
                                           out_dtype=torch.bfloat16), y16)
    # the op stores q's dtype
    kernels.reset_counts()
    y = ops.relu_attn_op(q, k, v)
    assert y.dtype == dtype
    assert torch.equal(y, y32.to(dtype))
    c = kernels.counts()
    assert c["relu_attn"] == c["relu_attn_scales"] == {"launches": 0,
                                                       "plain_calls": 1}


def test_reference_path_runs_the_plain_scale_chain():
    (q, k, v), _ = _qkv(1, 16, 2, 8, torch.float32, 3)
    kernels.reset_counts()
    with ops.reference_path():
        y = ops.relu_attn_op(q, k, v)
    assert kernels.counts()["relu_attn_scales"] == {"launches": 0,
                                                    "plain_calls": 1}
    assert torch.equal(y, ops.relu_attn_op(q, k, v))


def test_scales_wrapper_checks_its_operands():
    (q, k, v), _ = _qkv(1, 8, 2, 8, torch.float32, 4)
    bad = [
        ((q, k[:, :4], v), "shape"),
        ((q, k, v.to(torch.bfloat16)), "dtype"),
        ((q.half(), k.half(), v.half()), "float32/bfloat16"),
        ((q, k, torch.zeros((1, 8, 8, 2)).transpose(2, 3)), "strides"),
        ((q[..., 0], k[..., 0], v[..., 0]), r"\(B, N, H, D\)"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            relu_attn_scales._launch(*args)
    empty = torch.zeros((0, 8, 2, 8))
    with pytest.raises(ValueError, match="empty"):
        relu_attn_scales._launch(empty, empty, empty)
    meta = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        relu_attn_scales.relu_attn_scales(meta, meta, meta)
    with pytest.raises(ValueError, match="out_dtype"):
        relu_attn._launch(q, k, v, *(torch.ones(()),) * 3, 1e-6,
                          out_dtype=torch.float16)


# the best split per (batch, tokens) of the on-card sweep
# (tools/m2q_tune.py --kernel relu_attn; PERF.md section 6)
SWEPT_SPLITS = {(1, 49): 1, (2, 49): 1, (4, 49): 1, (8, 49): 1,
                (1, 196): 4, (2, 196): 4, (4, 196): 4, (8, 196): 1}


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_launch_plans_at_the_served_shapes(B):
    """Both B1 R224 MSA shapes: the plan is the sweep's best -- one CTA
    per (b, h) at 49 tokens at every batch; at 196 tokens four cluster
    CTAs per (b, h) at batch 1-4 and one at batch 8, where a split would
    put more than one CTA on an SM."""
    cfg = ARCHS["efficientvit-b1-r224"]
    shapes = sorted(set(chip_smoke.main_path_calls(cfg, B)[2]))
    assert [(N, H, D) for _, N, H, D in shapes] == [(49, 16, 16),
                                                    (196, 8, 16)]
    for b, N, H, D in shapes:
        p = relu_attn.launch_plan(b, N, H, D)
        assert p["splits"] == SWEPT_SPLITS[b, N]
        assert p["ctas"] == b * H * p["splits"]
        assert p["tokens"] == -(-N // p["splits"])
        s = relu_attn_scales.launch_plan(b, N, H * D, True)
        assert s["ctas"] in relu_attn_scales.CTAS
        assert s["ctas"] * relu_attn_scales.THREADS \
            * relu_attn_scales.LOADS_PER_THREAD >= b * N * H * D / 8 \
            or s["ctas"] == relu_attn_scales.CTAS[-1]


@pytest.mark.parametrize("N", [1, 2, 3, 5, 49, 64, 65, 196, 300])
def test_token_slices_cover_every_token_once(N):
    """The kernel's slices (per = ceil(N / splits), slice r = [min(N, r *
    per), min(N, r * per + per))) cover 0..N-1 once under every splits,
    empty slices included; the plan never asks for more slices than
    tokens."""
    for splits in relu_attn.SPLITS:
        per = -(-N // splits)
        seen = []
        for r in range(splits):
            lo = min(N, r * per)
            seen += range(lo, min(N, lo + per))
        assert seen == list(range(N))
    for B, H in ((1, 1), (8, 16)):
        assert relu_attn.launch_plan(B, N, H, 16)["splits"] <= N


def test_launch_plan_limits_and_head_dim():
    """A plan splits only runs longer than SHORT_SLICE tokens, into
    SPLIT slices, and only while the card holds TARGET_CTAS CTAs or
    fewer; head dims above 64 are refused before any launch."""
    for B in (1, 2, 3, 8, 64):
        for N in (1, 49, 64, 65, 196, 4096):
            for H in (1, 8, 16):
                p = relu_attn.launch_plan(B, N, H, 16)
                assert p["splits"] in (1, relu_attn.SPLIT)
                assert p["splits"] in relu_attn.SPLITS
                split = N > relu_attn.SHORT_SLICE \
                    and B * H * relu_attn.SPLIT <= relu_attn.TARGET_CTAS
                assert (p["splits"] > 1) == split
    with pytest.raises(ValueError, match="head dim"):
        relu_attn._launch(*(torch.zeros((1, 4, 1, 128)),) * 3,
                          *(torch.ones(()),) * 3, 1e-6)

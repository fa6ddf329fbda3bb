"""The PyTorch port's quantizers and QTensor leaves against the JAX package:
the same float weights (numpy, fixed seeds) must give the same payload
bytes, zero points, scales, APoT codes, merged layouts and Eq. 6 scheme
assignments -- bit for bit.  Plus the port's import hygiene."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import qtensor as jq
from repro.core import quant as jquant
from repro.core import scheme_select as jss
from repro_torch.core import packing as tpack
from repro_torch.core import qtensor as tq
from repro_torch.core import quant as tquant
from repro_torch.core import scheme_select as tss

SHAPES = [(72, 48), (9, 32), (256, 130)]


def _w(K, N, seed=0, std=0.05):
    return np.random.default_rng(seed + 7 * K + N).normal(
        0, std, (K, N)).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", SHAPES)
def test_uniform_payload_bytes_match_jax(K, N, bits):
    w = _w(K, N)
    a = jq.QUniform.quantize(jnp.asarray(w), bits=bits)
    b = tq.QUniform.quantize(torch.from_numpy(w), bits=bits)
    _eq(a.payload, b.payload)
    _eq(a.scale, b.scale)
    _eq(a.zero_point, b.zero_point)
    _eq(a.dequant(), b.dequant())
    assert b.payload.dtype == (torch.int8 if bits == 8 else torch.uint8)


@pytest.mark.parametrize("K,N", SHAPES)
def test_apot_codes_match_jax(K, N):
    w = _w(K, N, seed=1)
    a = jquant.apot_quantize(jnp.asarray(w))
    b = tquant.apot_quantize(torch.from_numpy(w))
    _eq(jpack.apot_encode(a), tpack.apot_encode(b))
    _eq(a.scale, b.scale)
    _eq(jquant.apot_dequantize(a), tquant.apot_dequantize(b))
    # decoded values agree, and the integer decode is the same function
    codes = tpack.apot_encode(b)
    _eq(jpack.apot_decode_values(jpack.apot_encode(a)),
        tpack.apot_decode_values(codes))
    np.testing.assert_array_equal(
        tpack.apot_decode_units(codes).numpy().astype(np.float32) / 128.0,
        tpack.apot_decode_values(codes).numpy())


def test_apot_index_lookup_mirrors_reference():
    """The reference flags the SMALLEST codebook magnitude as zero and
    shifts the exponent lookup by one entry; the port keeps that exactly
    (payload equality depends on it)."""
    mags, _, _ = tquant._apot_code_pairs()
    w = np.array([[0.0], [mags[3]], [1.0]], np.float32)  # scale = 1
    a = jquant.apot_quantize(jnp.asarray(w))
    b = tquant.apot_quantize(torch.from_numpy(w))
    for f in ("e1", "e2", "is_zero", "sign"):
        _eq(getattr(a, f), getattr(b, f))
    assert b.is_zero.reshape(-1).tolist() == [True, False, False]


@pytest.mark.parametrize("K,N", SHAPES)
def test_select_schemes_matches_jax(K, N):
    """Eq. 6 assignments equal; the per-filter MSEs agree to f32 rounding
    (the two frameworks reduce in different orders).  A filter may only
    switch sides where its APoT penalty ties the split boundary within
    EPS, which bounds what reduction-order noise can move."""
    EPS = 1e-9
    w = _w(K, N, seed=2)
    a = jss.select_schemes(jnp.asarray(w))
    b = tss.select_schemes(torch.from_numpy(w))
    np.testing.assert_allclose(b.mse_uniform, a.mse_uniform, rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(b.mse_apot, a.mse_apot, rtol=1e-5, atol=1e-12)
    moved = set(a.apot_idx.tolist()) ^ set(b.apot_idx.tolist())
    if moved:
        d = a.mse_apot - a.mse_uniform
        boundary = np.sort(d)[len(a.apot_idx) - 1:len(a.apot_idx) + 1]
        for i in moved:
            assert np.min(np.abs(boundary - d[i])) <= EPS, (i, d[i], boundary)
    else:
        np.testing.assert_array_equal(a.apot_idx, b.apot_idx)
        np.testing.assert_array_equal(a.uniform_idx, b.uniform_idx)


@pytest.mark.parametrize("K,N", SHAPES)
def test_qm2q_merged_layout_matches_jax(K, N):
    w = _w(K, N, seed=3)
    asn = jss.select_schemes(jnp.asarray(w))
    a = jq.QM2Q.quantize(jnp.asarray(w), asn.apot_idx, asn.uniform_idx,
                         act_max_abs=jnp.float32(2.75))
    b = tq.QM2Q.quantize(torch.from_numpy(w), asn.apot_idx, asn.uniform_idx,
                         act_max_abs=2.75)
    for f in ("payload", "u_scale", "u_zp", "a_scale", "act_scale"):
        _eq(getattr(a, f), getattr(b, f))
    assert (a.n_uniform, a.n_apot, a.shape) == (b.n_uniform, b.n_apot,
                                                b.shape)
    _eq(a.dequant(), b.dequant())


def test_conv_filter_quantizes_through_flattening():
    """A HWIO depthwise filter flattens to (kh*kw, C) and packs to
    (kh*kw, C/2) nibbles -- the layout the dwconv kernel reads."""
    w = np.random.default_rng(4).normal(0, 0.2, (3, 3, 1, 24)).astype(
        np.float32)
    a = jq.QUniform.quantize(jnp.asarray(w.reshape(9, 24)), bits=4)
    b = tq.QUniform.quantize(torch.from_numpy(w.reshape(9, 24)), bits=4)
    assert tuple(b.payload.shape) == (9, 12)
    _eq(a.payload, b.payload)
    _eq(jpack.unpack_int4(a.payload), tpack.unpack_int4(b.payload))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_act_rounds_half_to_even_like_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (64, 33)).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 200.0, -300.0],
                        np.float32)
    s = np.float32(1.0) if seed == 0 else np.float32(np.abs(x).max() / 127)
    _eq(jquant.quantize_act(jnp.asarray(x), jnp.asarray(s)),
        tquant.quantize_act(torch.from_numpy(x), torch.tensor(s)))
    # bf16 activations quantize in f32 as JAX promotes bf16 / f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _eq(jquant.quantize_act(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(s)),
        tquant.quantize_act(xb, torch.tensor(s)))


def test_act_scale_from_stats_matches_jax():
    for m in (0.0, 1e-12, 3.3, 1234.5):
        _eq(jquant.act_scale_from_stats(jnp.float32(m)),
            tquant.act_scale_from_stats(torch.tensor(m, dtype=torch.float32)))


def test_fake_quant_and_filterwise_mse_match_jax():
    w = _w(40, 24, seed=5)
    _eq(jquant.fake_quant_uniform(jnp.asarray(w), bits=8),
        tquant.fake_quant_uniform(torch.from_numpy(w), bits=8))
    _eq(jquant.fake_quant_apot(jnp.asarray(w)),
        tquant.fake_quant_apot(torch.from_numpy(w)))
    np.testing.assert_allclose(
        tquant.filterwise_mse(torch.from_numpy(w),
                              torch.zeros(40, 24)).numpy(),
        np.asarray(jquant.filterwise_mse(jnp.asarray(w), jnp.zeros((40, 24)))),
        rtol=1e-6)


def test_pack_int4_roundtrip_and_layout():
    q = torch.arange(16, dtype=torch.int32).reshape(2, 8) % 16
    p = tpack.pack_int4(q)
    assert p.tolist()[0][0] == 0x10  # low nibble = even index
    assert torch.equal(tpack.unpack_int4(p).to(torch.int32), q)
    with pytest.raises(ValueError):
        tpack.pack_int4(torch.zeros(2, 3, dtype=torch.int32))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    assert len(PORT_FILES) > 20
    bad = []
    for path in PORT_FILES:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_calibration_rejects_non_finite_activations():
    """A NaN/Inf activation statistic raises and names the layer instead of
    baking a NaN scale into the QTensor."""
    from repro_torch.configs.efficientvit_b1 import REDUCED
    from repro_torch.models import efficientvit
    from repro_torch.recipe import quantize
    params = efficientvit.init(REDUCED, seed=0, device="cpu")
    bad = np.zeros((1, 32, 32, 3), np.float32)
    bad[0, 3, 4, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite activation statistic"):
        quantize(REDUCED, params, calib_batches=[bad])

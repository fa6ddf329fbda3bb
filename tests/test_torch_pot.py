"""The port's PoT quantizers (paper Eq. 3), APoT codebook and
``fake_quant_model`` against the JAX package's, bit for bit: the same
float weights (numpy, fixed seeds; the committed trained proxy) give the
same signs, exponents, zero masks, scales and dequantized bytes, and the
same fake-quantized leaves under every scheme the accuracy tables use.

The reference's CPU backend flushes subnormal floats to zero and computes
``exp2`` as ``exp(f32(ln 2) * p)``; the subnormal case and the exponent
table below hold the port to both.  The JAX side's fake quantization
runs eagerly, as ``benchmarks/tables.py`` runs it (its compiles overlap
in threads), once per module."""
import functools
import re
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply as japply
from repro.core import quant as jquant
from repro.models import efficientvit as jev
from repro_torch import core as tcore
from repro_torch.core import apply as tapply
from repro_torch.core import quant as tquant
from repro_torch.core.tree import leaves_with_path
from repro_torch.data import proxy
from repro_torch.models import efficientvit as tev
from torch_parity import jax_to_numpy


def _normal(shape, seed, std=0.05):
    return np.random.default_rng(seed).normal(0, std, shape).astype(
        np.float32)


# (weights, bits, axis, reduce_axes)
POT_CASES = {
    # the paper's worked example: W = -0.26, S = 2 -> s = -1, p = -3
    "paper-example": (np.array([[-0.26, 1.74]], np.float32), 5, None, None),
    # subnormal and tiny weights at bits 8 (exponents down to -127)
    "subnormal": (np.array([[1e-40, -3e-39, 1e-30, 0.5, -1.0, 2e-38,
                             1.5e-38, -1.5e-38]], np.float32), 8, None,
                  None),
    **{f"bits{b}-axis-1": (_normal((64, 48), b), b, -1, None)
       for b in (3, 5, 8)},
    **{f"bits{b}-axis-none": (_normal((40, 24), 10 + b), b, None, None)
       for b in (3, 5, 8)},
    "bits3-conv-axis-1": (_normal((3, 3, 1, 24), 3), 3, -1, None),
    "bits3-reduce-axes": (_normal((4, 32, 16), 4), 3, -1, (1,)),
    "bits5-reduce-axes-neg": (_normal((2, 16, 8), 5), 5, -1, (-2,)),
    "zeros-and-ties": (np.concatenate([
        _normal((8, 8), 6), np.zeros((4, 8), np.float32),
        np.full((2, 8), 2.0 ** -3.5, np.float32)]), 3, -1, None),
}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", sorted(POT_CASES))
def test_pot_quantize_matches_jax_bit_for_bit(case):
    w, bits, axis, ra = POT_CASES[case]
    j = jquant.pot_quantize(jnp.asarray(w), bits=bits, axis=axis,
                            reduce_axes=ra)
    t = tquant.pot_quantize(torch.from_numpy(w), bits=bits, axis=axis,
                            reduce_axes=ra)
    for field in ("sign", "p", "is_zero", "scale"):
        want, got = np.asarray(getattr(j, field)), getattr(t, field).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=field)
    assert (t.bits, t.axis) == (j.bits, j.axis)
    np.testing.assert_array_equal(
        _bits(tquant.pot_dequantize(t).numpy()),
        _bits(jquant.pot_dequantize(j)))


@pytest.mark.parametrize("case", ["subnormal", "bits3-axis-1",
                                  "bits5-axis-none", "bits8-axis-1"])
def test_fake_quant_pot_matches_jax(case):
    w, bits, axis, _ = POT_CASES[case]
    np.testing.assert_array_equal(
        _bits(tquant.fake_quant_pot(torch.from_numpy(w), bits=bits,
                                    axis=axis).numpy()),
        _bits(jquant.fake_quant_pot(jnp.asarray(w), bits=bits, axis=axis)))


def test_pot_exponent_magnitudes_are_the_references():
    """Every exponent an int8 holds: the port's table equals
    ``jnp.exp2(p)``, which is not 2^p from p = -13 down."""
    p = -np.arange(128, dtype=np.float32)
    np.testing.assert_array_equal(_bits(tquant._pot_magnitudes()),
                                  _bits(jnp.exp2(jnp.asarray(p))))
    assert not np.array_equal(tquant._pot_magnitudes(),
                              np.exp2(p.astype(np.float64)).astype(
                                  np.float32))


def test_pot_worked_example_value():
    t = tquant.pot_quantize(torch.tensor([[-0.26, 1.74]]), bits=5,
                            axis=None)
    assert int(t.sign[0, 0]) == -1 and int(t.p[0, 0]) == -3
    assert float(tquant.pot_dequantize(t)[0, 0]) == -0.25


@pytest.mark.parametrize("emax", [7, 3, 0])
def test_apot_codebook_matches_jax(emax):
    got, want = tquant.apot_codebook(emax), jquant.apot_codebook(emax)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(tquant.apot_codebook()) == 37


def test_core_exports_the_quantizers():
    for name in ("PoTQ", "pot_quantize", "pot_dequantize",
                 "fake_quant_pot", "apot_codebook"):
        assert hasattr(tquant, name)
    for name in ("pot_quantize", "pot_dequantize", "fake_quant_pot",
                 "apot_codebook", "fake_quant_model", "select_schemes"):
        assert name in tcore.__all__ and hasattr(tcore, name)


# ---------------------------------------------------------------------------
# fake_quant_model on the trained proxy
# ---------------------------------------------------------------------------

# (scheme, keyword arguments): every scheme the tables use; the mixed
# ones on a path filter of two leaves (JAX's Eq. 6 runs eagerly, ~5 s a
# leaf here)
FQ_CASES = {
    "uniform8-tree": ("uniform", {}),
    "uniform4-dwconv": ("uniform", {"bits": 4, "kinds": {"dwconv"}}),
    "pot-tree": ("pot", {}),
    "pot-bits-ignored": ("pot", {"bits": 8, "kinds": {"dense"}}),
    "apot-tree": ("apot", {}),
    "m2q-two-leaves": ("m2q", {"kinds": {"dense"}, "path_filter":
                               r"stages/2/0/msa/w_qkv|head/w_in"}),
    "pot_mix-two-leaves": ("pot_mix", {"kinds": {"dense"}, "path_filter":
                                       r"stages/1/0/mb/w_pw1|head/w$"}),
}


@functools.lru_cache(maxsize=None)
def _proxy():
    """The committed trained proxy in both packages."""
    from benchmarks.proxy_model import train_proxy
    return train_proxy(), proxy.load_proxy("cpu")


@functools.lru_cache(maxsize=None)
def _jax_fake_quant():
    """JAX's eager fake_quant_model of every case, as numpy by path."""
    jp, _ = _proxy()

    def run(case):
        scheme, kw = FQ_CASES[case]
        out = japply.fake_quant_model(jp, jev.QUANT_RULES, scheme=scheme,
                                      **kw)
        return dict(leaves_with_path(jax_to_numpy(out)))

    with ThreadPoolExecutor(len(FQ_CASES)) as pool:
        return dict(zip(FQ_CASES, pool.map(run, FQ_CASES)))


@pytest.mark.parametrize("case", sorted(FQ_CASES))
def test_fake_quant_model_matches_jax_leaf_for_leaf(case):
    scheme, kw = FQ_CASES[case]
    _, tp = _proxy()
    asn = {}
    out = tapply.fake_quant_model(tp, tev.QUANT_RULES, scheme=scheme,
                                  assignments=asn, **kw)
    want = _jax_fake_quant()[case]
    got = dict(leaves_with_path(out))
    before = dict(leaves_with_path(tp))
    assert sorted(got) == sorted(want)
    replaced = 0
    for path, leaf in got.items():
        np.testing.assert_array_equal(_bits(leaf.numpy()), _bits(want[path]),
                                      err_msg=path)
        if leaf is before[path]:
            continue  # untouched leaves are the caller's own tensors
        replaced += 1
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
        assert not np.array_equal(leaf.numpy(), before[path].numpy()), path
    kinds = kw.get("kinds")
    pattern = kw.get("path_filter")
    expect = {p for p, v in before.items()
              if v.ndim >= 2 and tapply.match_kind(tev.QUANT_RULES, p)
              not in (None, "skip")
              and (kinds is None or tapply.match_kind(tev.QUANT_RULES, p)
                   in kinds)
              and (pattern is None or re.search(pattern, p))}
    assert replaced == len(expect) > 0
    assert set(asn) == (expect if scheme in ("m2q", "pot_mix") else set())
    for path, a in asn.items():
        n = before[path].shape[-1]
        assert len(a.apot_idx) == n // 2 and len(a.uniform_idx) == n - n // 2


def test_fake_quant_model_leaves_the_callers_tree_unchanged():
    _, tp = _proxy()
    snapshot = {k: v.clone() for k, v in leaves_with_path(tp)}
    tapply.fake_quant_model(tp, tev.QUANT_RULES, scheme="apot")
    for k, v in leaves_with_path(tp):
        assert torch.equal(v, snapshot[k]), k


def test_mixed_schemes_split_like_select_schemes():
    """An m2q leaf is uniform 8 on ``select_schemes``'s uniform half and
    APoT on the other; pot_mix takes PoT-3 on the same APoT half."""
    from repro_torch.core.scheme_select import select_schemes
    w = torch.from_numpy(_normal((96, 40), 11))
    asn = select_schemes(w, ratio=0.5)
    for scheme, alt in (("m2q", tquant.fake_quant_apot(w)),
                        ("pot_mix", tquant.fake_quant_pot(w, bits=3))):
        out = tapply.mixed_fake_quant(w, asn, scheme)
        u, a = list(asn.uniform_idx), list(asn.apot_idx)
        assert torch.equal(out[:, u],
                           tquant.fake_quant_uniform(w, bits=8)[:, u])
        assert torch.equal(out[:, a], alt[:, a])


def test_default_scheme_raises_in_both_packages():
    """``scheme="uniform8"`` (the default) is not a scheme the reference
    handles: both packages raise ``ValueError``."""
    jp, tp = _proxy()
    with pytest.raises(ValueError):
        japply.fake_quant_model(jp, jev.QUANT_RULES)
    with pytest.raises(ValueError):
        tapply.fake_quant_model(tp, tev.QUANT_RULES)
    with pytest.raises(ValueError):
        tapply.fake_quant_model(tp, tev.QUANT_RULES, scheme="pot8")


def test_fake_quant_model_embedding_is_per_row():
    """An embedding leaf is quantized per row (axis 0), as in the
    reference."""
    w = _normal((12, 6), 12)
    rules = [(r"embed", "embedding")]
    got = tapply.fake_quant_model({"embed": torch.from_numpy(w)}, rules,
                                  scheme="uniform", bits=4)["embed"]
    want = japply.fake_quant_model({"embed": jnp.asarray(w)}, rules,
                                   scheme="uniform", bits=4)["embed"]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        got.numpy(), tquant.fake_quant_uniform(torch.from_numpy(w), bits=4,
                                               axis=0).numpy())

"""The port's attention primitives of the token path against the JAX
package, from seeded numpy inputs: the plain version of the
``decode_attn_int8`` kernel against JAX's dispatch-off XLA chain
(``nn.attention.decode_attention_int8``) and its Pallas kernel in
interpret mode; ``quantize_kv_rows`` bit for bit; RoPE, the prefill
attention and the float-cache decode attention.  The CUDA kernel is held
against the same plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.nn import attention as ja
from repro_torch import kernels
from repro_torch.kernels import decode_attn_int8 as tdec
from repro_torch.kernels import ops
from repro_torch.nn import attention as ta


def _rng(*key):
    return np.random.default_rng(sum((i + 1) * k for i, k in enumerate(key)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_case(B, T, Hkv, G, D):
    """q (B, 1, Hq, D) f32 and an int8 cache quantized by JAX's
    quantize_kv_rows from random rows (numpy arrays)."""
    rng = _rng(B, T, Hkv, G, D)
    q = rng.normal(0, 1, (B, 1, Hkv * G, D)).astype(np.float32)
    k8, ks = ja.quantize_kv_rows(jnp.asarray(
        rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)))
    v8, vs = ja.quantize_kv_rows(jnp.asarray(
        rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)))
    return q, *(np.asarray(a) for a in (k8, v8, ks, vs))


# (T, Hkv, G, D, window): MHA (G=1) and GQA (G=4) at D 64 and 128, with
# and without a window; lengths 0 (every row masked), 1, ragged and T
DECODE_CASES = [(40, 2, 1, 64, None), (40, 2, 4, 128, None),
                (40, 1, 4, 64, 8), (24, 2, 1, 128, 8)]


@pytest.mark.parametrize("T,Hkv,G,D,window", DECODE_CASES)
def test_plain_decode_attn_matches_jax_chain_and_interpreted_kernel(
        T, Hkv, G, D, window):
    """Within the stated tolerance of two flipped p8 codes per (b, h, g)
    row, ``2 * p_s * max|v8|``: JAX's exp and softmax sum order differ
    from torch's by an ulp.  The plain version runs through the port's
    public entry (``nn.attention.decode_attention_int8`` on CPU tensors:
    the plain version, counted as such)."""
    B = 4
    lengths = np.array([0, 1, 17, T], np.int32)
    q, k8, v8, ks, vs = _decode_case(B, T, Hkv, G, D)
    jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lengths))
    with jops.dispatch(dense=False, conv=False, attn=False):
        chain = np.asarray(ja.decode_attention_int8(*jargs, window=window))
    interp = np.asarray(jops.decode_attn_int8_op(*jargs, window=window,
                                                 interpret=True))
    kernels.reset_counts()
    targs = [_t(a) for a in (q, k8, v8, ks, vs, lengths)]
    got = ta.decode_attention_int8(*targs, window=window).numpy()
    assert kernels.counts()["decode_attn_int8"] == {"launches": 0,
                                                    "plain_calls": 1}
    targs[0] = targs[0].reshape(B, Hkv, G, D)
    bound = tdec.error_bound(*targs, D ** -0.5, window).numpy()
    bound = bound.reshape(B, 1, Hkv * G, 1)
    for want in (chain, interp):
        err = np.abs(got - want)
        assert np.all(err <= bound), float((err / bound).max())
        # most elements agree far tighter than the stated bound
        assert np.mean(err <= 1e-6 * np.abs(want).max()) > 0.99
    # every position masked: the uniform softmax over all T rows
    assert np.all(np.isfinite(got[0]))


def test_decode_attn_op_reference_path_runs_plain():
    q, k8, v8, ks, vs = _decode_case(2, 8, 1, 1, 64)
    args = [_t(a) for a in (q, k8, v8, ks, vs, np.array([3, 8], np.int32))]
    kernels.reset_counts()
    with ops.reference_path():
        y = ops.decode_attn_int8_op(*args)
    assert y.shape == (2, 1, 1, 64) and y.dtype == torch.float32
    assert kernels.counts()["decode_attn_int8"]["plain_calls"] == 1


@pytest.mark.parametrize("shape", [(3, 5, 2, 64), (2, 7, 16, 128)])
def test_quantize_kv_rows_bit_for_bit(shape):
    x = _rng(*shape).normal(0, 2, shape).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1e-9, payload 0
    x[-1, -1, 0] *= 1e4
    want_q, want_s = ja.quantize_kv_rows(jnp.asarray(x))
    got_q, got_s = ta.quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope_matches_jax(decode):
    """f32 split-half rotation; XLA's and torch's pow/sin/cos may differ
    by an ulp, so 1e-6 of max|x| (the angles reach S rad)."""
    B, S, H, D = 2, 37, 3, 64
    x = _rng(B, S, D).normal(0, 1, (B, S, H, D)).astype(np.float32)
    if decode:
        x = x[:, :1]
        pos = np.array([[5], [36]], np.int32)
    else:
        pos = np.arange(S, dtype=np.int32)[None, :]
    want = np.asarray(ja.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = ta.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("causal,window,kv_len", [(True, None, None),
                                                  (True, 8, None),
                                                  (False, None, 13)])
def test_flash_attention_matches_jax(causal, window, kv_len):
    """One pass over the whole score matrix against JAX's online softmax
    (one chunk at these sizes): f32 summation order only, 1e-5 of
    max|out|."""
    B, S, T, Hkv, G, D = 2, 21, 21, 2, 2, 64
    rng = _rng(S, T, D)
    q = rng.normal(0, 1, (B, S, Hkv * G, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
    want = np.asarray(ja.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, kv_len=kv_len))
    got = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window, kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("window", [None, 4])
def test_float_cache_decode_attention_matches_jax(window):
    B, T, Hkv, G, D = 3, 16, 2, 2, 64
    rng = _rng(T, D, 7)
    q = rng.normal(0, 1, (B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
    lengths = np.array([1, 9, 16], np.int32)
    want = np.asarray(ja.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        window=window))
    got = ta.decode_attention(*(torch.from_numpy(a)
                                for a in (q, k, v, lengths)),
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# qwen1.5-0.5b's decode attention at VisionEngine-like batch buckets
SERVED_ROWS = [(B, 256, 16, 1, 64) for B in (1, 2, 4, 8)]


@pytest.mark.parametrize("B,T,H,G,D", SERVED_ROWS)
def test_launch_plan_at_the_served_rows(B, T, H, G, D):
    """The plan rule as a pure function: the swept plan (PERF.md), its
    shared memory as the source lays it out, one block per (b, kv-head)."""
    plan = tdec.launch_plan(B, T, H, G, D)
    assert {k: plan[k] for k in ("rows", "depth")} == tdec.PLAN
    assert plan["ctas"] == B * H
    assert plan["smem"] == tdec.smem_bytes(T, G, D, tdec.PLAN)
    assert plan["smem"] <= tdec.SMEM_LIMIT


def _first_version_smem(T, G, D):
    """The first version's shared memory: G x T f32 scores and int8
    codes, q8, two scales per row g, the PV partials, and 32 static
    bytes."""
    return G * T * 5 + 2 * G * 4 + max(G * D, 256) * 4 + G * D + 32


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_every_cache_the_first_version_took_still_fits(G):
    """At each head dim and group size, the longest cache the first
    version launched fits under the fitted plan, and shared memory grows
    with T by at most the first version's 5 bytes a row and query."""
    for D in range(16, 129, 16):
        T = (tdec.SMEM_LIMIT - _first_version_smem(0, G, D)) // (5 * G)
        assert _first_version_smem(T, G, D) <= tdec.SMEM_LIMIT
        plan = tdec.fit_plan(T, G, D, tdec.PLAN)
        assert tdec.smem_bytes(T, G, D, plan) <= tdec.SMEM_LIMIT
        assert plan["rows"] >= 4 and plan["depth"] >= 1
        for t in (T // 4, T // 2):
            grow = (tdec.smem_bytes(T, G, D, tdec.PLAN)
                    - tdec.smem_bytes(t, G, D, tdec.PLAN))
            # the codes' block rounded up to 16 bytes
            assert grow <= 5 * G * (T - t) + 16
    with pytest.raises(ValueError, match="shared memory"):
        tdec.fit_plan(60000, 1, 64, tdec.PLAN)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7
    of the 8-byte pair (y:x)."""
    pair = (y << 32) | x
    return sum(((pair >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _dp4a(a, b):
    """Signed 4 x int8 dot of two 32-bit words."""
    ai = np.array([a], np.uint32).view(np.int8).astype(np.int64)
    bi = np.array([b], np.uint32).view(np.int8).astype(np.int64)
    return int((ai * bi).sum())


def test_the_kernels_pv_transpose_gives_the_integer_dot():
    """The PV pass's __byte_perm transposition and quad-row rotation, read
    from csrc/decode_attn_int8.cu and run in Python: for every rotation x
    a warp's streams use, the four column words dotted with the permuted
    p8 word give sum_j p8_j * v8_j per column, as the plain version's
    integer einsum does."""
    import re
    from pathlib import Path
    src = (Path(tdec.__file__).resolve().parent.parent / "csrc"
           / "decode_attn_int8.cu").read_text()
    steps = re.findall(r"const (?:unsigned|int) (\w+) = \(?(?:int\)\s*)?"
                       r"__byte_perm\(([\w\[\]]+), ([\w\[\]]+), "
                       r"(0x[0-9a-f]+)\)", src)
    assert [s[0] for s in steps] == ["t0", "t1", "t2", "t3", "col0", "col1",
                                     "col2", "col3"]
    rng = np.random.default_rng(0)
    for x in range(4):
        v8 = rng.integers(-127, 128, (4, 4)).astype(np.int8)  # rows x cols
        p8 = rng.integers(-127, 128, 4).astype(np.int8)
        words = v8.view(np.uint32).reshape(4)  # one word per row
        env = {f"a[{j}]": int(words[j ^ x]) for j in range(4)}
        for name, a, b, sel in steps:
            env[name] = _byte_perm(env[a], env[b], int(sel, 16))
        psel = (0 ^ x) | (1 ^ x) << 4 | (2 ^ x) << 8 | (3 ^ x) << 12
        pp = _byte_perm(int(p8.view(np.uint32)[0]), 0, psel)
        got = [_dp4a(env[f"col{c}"], pp) for c in range(4)]
        want = (p8.astype(np.int64)[:, None] * v8.astype(np.int64)).sum(0)
        assert got == want.tolist()


def test_decode_attn_op_returns_q_dtype_and_matches_jax_chain():
    """``decode_attn_int8_op`` on bf16 q returns bf16 (the plain version's
    f32 result cast once on the CPU), within the two-code bound of JAX's
    dispatch-off chain cast to bf16, plus one bf16 ulp of the value for
    the two casts of values that differ by less than the bound."""
    B, T, Hkv, G, D = 4, 40, 2, 2, 64
    lengths = np.array([0, 1, 17, T], np.int32)
    q, k8, v8, ks, vs = _decode_case(B, T, Hkv, G, D)
    q16 = jnp.asarray(q).astype(jnp.bfloat16)
    jargs = (q16, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
             jnp.asarray(vs), jnp.asarray(lengths))
    with jops.dispatch(dense=False, conv=False, attn=False):
        want = ja.decode_attention_int8(*jargs)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tq = torch.from_numpy(np.asarray(q16.astype(jnp.float32))).to(
        torch.bfloat16)
    targs = [tq] + [_t(a) for a in (k8, v8, ks, vs, lengths)]
    kernels.reset_counts()
    got = ops.decode_attn_int8_op(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, Hkv * G, D)
    assert kernels.counts()["decode_attn_int8"] == {"launches": 0,
                                                    "plain_calls": 1}
    bound = tdec.error_bound(tq.reshape(B, Hkv, G, D), *targs[1:],
                             D ** -0.5).numpy().reshape(B, 1, Hkv * G, 1)
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= bound + 2.0 ** -7 * np.abs(want))

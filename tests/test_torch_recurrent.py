"""The recurrent families against the JAX package: ``nn/ssm.py``
(RWKV6 time and channel mix, RG-LRU, the temporal conv, ``gelu``),
rwkv6-3b and recurrentgemma-9b at their REDUCED configs (2 and 5 layers,
d_model 64, f32; recurrentgemma's window 8) from the JAX package's float
init at ``PRNGKey(0)``, and the token Engine's exact-length prefill
buckets.

REDUCED rwkv is a narrow LM (d_model <= 256), so ``m2q-w8a8`` takes the
mixed LM path through the taxonomy overrides in both packages: stacked
``QExpertM2Q`` projections, the channel mix's ``(cw_k, None, cw_v)``
group perm-folded, a mixed lm_head.  recurrentgemma quantizes under
``w4-weights-only`` only: a calibrating recipe fails in the reference
(its forward reshapes the stacked ``rec`` leaves, which a ``CalibTensor``
cannot do), and the port refuses it by name.  The JAX package runs with
dispatch off (its XLA QTensor paths); the port runs its plain kernel
versions."""
import functools
import json
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import REDUCED as JREDUCED
from repro.kernels import ops as jops
from repro.models import recurrentgemma as jrg
from repro.models import rwkv as jrwkv
from repro.nn import layers as jlayers
from repro.nn import ssm as jssm
from repro.serving.engine import Engine as JEngine
from repro_torch import kernels, nn
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.qtensor import QExpertM2Q, QM2Q, QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import recurrentgemma as trg
from repro_torch.models import rwkv as trwkv
from repro_torch.nn import ssm as tssm
from repro_torch.serving.engine import Engine as TEngine
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          done_tokens, jax_to_numpy, lm_prompts, manifest,
                          numpy_to_jax, outcomes, same_numpy, stats_fields)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 12, rehearsed at REDUCED width)

NAMES = ["rwkv6-3b", "recurrentgemma-9b"]
JMODELS = {"rwkv6-3b": jrwkv, "recurrentgemma-9b": jrg}
TMODELS = {"rwkv6-3b": trwkv, "recurrentgemma-9b": trg}
# (config, recipe) pairs both packages quantize
CASES = [("rwkv6-3b", "m2q-w8a8"), ("rwkv6-3b", "w4-weights-only"),
         ("recurrentgemma-9b", "w4-weights-only")]
MAX_LEN = 32
# f32 through the REDUCED depths: the packages differ by summation order
# (einsum, the RG-LRU scan's product order) only
FLOAT_TOL = 1e-5
# bf16 activations: one bf16 step at max |y| (2^-7 of it: the spacing of
# bf16 numbers in [m, 2m) is 2^-7 m), as each package's elementwise
# chains round in their own places (XLA fuses a chain and rounds once;
# torch rounds each op)
BF16_TOL = 2 ** -7


def _off():
    return jops.dispatch(dense=False, conv=False, attn=False)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(
        np.array(a)).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# nn/ssm.py and gelu against their JAX twins
# ---------------------------------------------------------------------------

B, T, H, DH = 2, 9, 3, 8
D = H * DH


def _rwkv_params(seed=0):
    rng = _rng(seed)
    p = {k: rng.uniform(0, 1, (D,)).astype(np.float32)
         for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_cr", "mu_ck")}
    for k in ("wr", "wk", "wv", "wg", "cw_r"):
        p[k] = rng.normal(0, D ** -0.5, (D, D)).astype(np.float32)
    p["cw_k"] = rng.normal(0, D ** -0.5, (D, 40)).astype(np.float32)
    p["cw_v"] = rng.normal(0, 40 ** -0.5, (40, D)).astype(np.float32)
    p["w_lora_a"] = rng.normal(0, 0.3, (D, 16)).astype(np.float32)
    p["w_lora_b"] = rng.normal(0, 0.3, (16, D)).astype(np.float32)
    p["w0"] = rng.normal(-1.0, 1.0, (D,)).astype(np.float32)
    p["u"] = rng.normal(0, 0.5, (H, DH)).astype(np.float32)
    return p


def _lru_params(R=D, seed=1):
    rng = _rng(seed)
    return {"wa": rng.normal(0, R ** -0.5, (R, R)).astype(np.float32),
            "wx": rng.normal(0, R ** -0.5, (R, R)).astype(np.float32),
            "ba": rng.normal(0, 0.1, (R,)).astype(np.float32),
            "bx": rng.normal(0, 0.1, (R,)).astype(np.float32),
            "lam": np.linspace(0.5, 4.0, R, dtype=np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _case_timemix(dtype):
    jp, tp = _both(_rwkv_params())
    x = _rng(2).normal(0, 1, (B, T, D)).astype(np.float32)
    xp = _rng(3).normal(0, 1, (B, T, D)).astype(np.float32)
    (jx, tx), (jxp, txp) = _pair(x, dtype), _pair(xp, dtype)
    want = jssm.rwkv6_timemix_inputs(jx, jxp, jp, H)
    got = tssm.rwkv6_timemix_inputs(tx, txp, tp, H)
    out = [(_np(g), _np(w), g.dtype) for g, w in zip(got, want)]
    out.append((_np(tssm.rwkv6_decay(tx, tp)),
                _np(jssm.rwkv6_decay(jx, jp)), torch.float32))
    return out


def _case_attend(dtype, chunk):
    rng = _rng(4)
    r, k, v = (rng.normal(0, 1, (B, T, H, DH)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, T, H, DH)).astype(np.float32)
    s0 = rng.normal(0, 1, (B, H, DH, DH)).astype(np.float32)
    u = rng.normal(0, 0.5, (H, DH)).astype(np.float32)
    j = [_pair(a, dtype) for a in (r, k, v, w)]
    js, ts = jnp.asarray(s0), torch.from_numpy(s0)
    jst, jout = jssm.rwkv6_attend(js, *[a for a, _ in j], jnp.asarray(u),
                                  chunk=chunk)
    tst, tout = tssm.rwkv6_attend(ts, *[b for _, b in j], torch.from_numpy(u))
    # the stepwise recurrence (JAX's decode path) is the same function
    st, steps = js, []
    for t in range(T):
        st, o = jssm.rwkv6_attend_step(st, *[a[:, t] for a, _ in j],
                                       jnp.asarray(u))
        steps.append(o)
    return [(_np(tst), _np(jst), tst.dtype), (_np(tout), _np(jout),
                                              tout.dtype),
            (_np(tout), _np(jnp.stack(steps, 1)), tout.dtype)]


def _case_channelmix(dtype):
    jp, tp = _both(_rwkv_params())
    x = _rng(5).normal(0, 1, (B, T, D)).astype(np.float32)
    xp = _rng(6).normal(0, 1, (B, T, D)).astype(np.float32)
    (jx, tx), (jxp, txp) = _pair(x, dtype), _pair(xp, dtype)
    got = tssm.rwkv6_channelmix(tx, txp, tp)
    return [(_np(got), _np(jssm.rwkv6_channelmix(jx, jxp, jp)), got.dtype)]


def _case_rg_lru(dtype):
    jp, tp = _both(_lru_params())
    x = _rng(7).normal(0, 1, (B, T, D)).astype(np.float32)
    h0 = _rng(8).normal(0, 1, (B, D)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jh, jy = jssm.rg_lru(jx, jnp.asarray(h0), jp)
    th, ty = tssm.rg_lru(tx, torch.from_numpy(h0), tp)
    ja, jb = jssm.rg_lru_gates(jx, jp)
    ta, tb = tssm.rg_lru_gates(tx, tp)
    jh1, jy1 = jssm.rg_lru_step(jx[:, 0], jnp.asarray(h0), jp)
    th1, ty1 = tssm.rg_lru_step(tx[:, 0], torch.from_numpy(h0), tp)
    return [(_np(th), _np(jh), th.dtype), (_np(ty), _np(jy), ty.dtype),
            (_np(ta), _np(ja), ta.dtype), (_np(tb), _np(jb), tb.dtype),
            (_np(th1), _np(jh1), th1.dtype), (_np(ty1), _np(jy1), ty1.dtype)]


def _case_conv(dtype, with_state):
    rng = _rng(9)
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (D,)).astype(np.float32)
    st = rng.normal(0, 1, (B, 3, D)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, jst = jssm.temporal_conv1d(jx, jnp.asarray(w), jnp.asarray(b),
                                   state=jnp.asarray(st) if with_state
                                   else None)
    ty, tst = tssm.temporal_conv1d(tx, torch.from_numpy(w),
                                   torch.from_numpy(b),
                                   state=torch.from_numpy(st) if with_state
                                   else None)
    return [(_np(ty), _np(jy), ty.dtype), (_np(tst), _np(jst), tst.dtype)]


def _case_gelu(dtype):
    x = _rng(10).normal(0, 3, (B, T, D)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = nn.gelu(tx)
    return [(_np(got), _np(jlayers.gelu(jx)), got.dtype)]


SSM_CASES = {
    "timemix_inputs": _case_timemix,
    "attend_chunk_128": functools.partial(_case_attend, chunk=128),
    "attend_chunk_4": functools.partial(_case_attend, chunk=4),
    "channelmix": _case_channelmix,
    "rg_lru_h0": _case_rg_lru,
    "conv_zero_state": functools.partial(_case_conv, with_state=False),
    "conv_with_state": functools.partial(_case_conv, with_state=True),
    "gelu": _case_gelu,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_ssm_function_matches_jax(case, dtype):
    """Each ``nn/ssm.py`` function (and ``gelu``) on the same numpy
    inputs as its JAX twin: the same output dtypes (the RWKV state, the
    RG-LRU gates and state f32, the rest in the input's dtype; the decay
    rounded to the input's dtype before the f32 recurrence), values
    within 1e-5 of max |y| in f32 and one bf16 step at max |y| (2^-7 of
    it) where an output or an input is bf16.  The RWKV attend over T also
    equals JAX's stepwise recurrence, and JAX's chunked scan at a chunk
    that does not divide T (pad steps decay by 1)."""
    for got, want, tdtype in SSM_CASES[case](dtype):
        assert str(tdtype).split(".")[-1] in (dtype, "float32"), case
        tol = FLOAT_TOL if dtype == "float32" else BF16_TOL
        _close(got, want, tol, case)


def test_temporal_conv_sums_taps_in_the_activation_dtype():
    """The bf16 conv rounds after each tap product and each add, in tap
    order: the port's result is the numpy emulation of that order bit for
    bit (an f32 accumulation would differ)."""
    rng = _rng(11)
    x = torch.from_numpy(rng.normal(0, 1, (2, 7, 16)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(0, 1, (4, 16)).astype(np.float32))
    y, st = tssm.temporal_conv1d(x, w)
    xp = torch.nn.functional.pad(x, (0, 0, 3, 0))
    want = (xp[:, 0:7] * w[0].bfloat16())
    for i in range(1, 4):
        want = (want + (xp[:, i:i + 7] * w[i].bfloat16())).bfloat16()
    assert torch.equal(y, want)
    f32 = sum(xp[:, i:i + 7].float() * w[i].bfloat16().float()
              for i in range(4)).bfloat16()
    assert not torch.equal(y, f32)
    assert torch.equal(st, x[:, -3:])


# ---------------------------------------------------------------------------
# the float models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _float_params(name):
    cfg = JREDUCED[name]
    params = jax.jit(lambda k: JMODELS[name].init(cfg, k))(
        jax.random.PRNGKey(0))
    return params, params_from_numpy(jax_to_numpy(params), "cpu")


def _tokens(name, shape, seed):
    return _rng(seed).integers(0, TREDUCED[name].vocab_size, shape,
                               dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_float_forward_matches_jax(name, dtype):
    """The port's forward on JAX's float weights against JAX's, over 12
    tokens (past recurrentgemma's window of 8): within 1e-5 of max
    |logit| in f32; in bf16 within four bf16 steps at max |logit| (2^-5
    of it): each function is within one step (above), and the packages'
    one-ulp roundings of different elements compound over the layers
    (1.1e-2 for rwkv, 2.4e-2 for recurrentgemma on this input)."""
    jparams, tparams = _float_params(name)
    jcfg, tcfg = (JREDUCED[name].replace(dtype=dtype),
                  TREDUCED[name].replace(dtype=dtype))
    tokens = _tokens(name, (2, 12), 3)
    want = jax.jit(lambda p, t: JMODELS[name].forward(jcfg, p, t))(
        jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        got = TMODELS[name].forward(tcfg, tparams, torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 12, tcfg.padded_vocab)
    _close(_np(got), _np(want), FLOAT_TOL if dtype == "float32"
           else 4 * BF16_TOL, name)


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_equals_jax(name):
    """``init``'s tree: JAX's paths, shapes and dtypes, on the CPU and on
    the meta device (nothing allocated); the constant leaves equal JAX's
    (unit norms, the decay bias, zero biases), ``lam``'s linspace within
    two f32 ulps (XLA's linspace arithmetic rounds some entries the other
    way)."""
    jparams, _ = _float_params(name)
    want = {k: (v.shape, v.dtype) for k, v in
            leaves_with_path(jax_to_numpy(jparams))}
    for dev in ("cpu", "meta"):
        got = TMODELS[name].init(TREDUCED[name], seed=0, device=dev)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in leaves_with_path(got)} == \
            {k: (tuple(s), str(d)) for k, (s, d) in want.items()}
    got = dict(leaves_with_path(params_to_numpy(
        TMODELS[name].init(TREDUCED[name], seed=0, device="cpu"))))
    theirs = dict(leaves_with_path(jax_to_numpy(jparams)))
    const = [k for k in theirs if k.split("/")[-1] in (
        "ln0", "ln1", "ln2", "final_norm", "gn", "w0", "conv_b", "ba", "bx",
        "lam")]
    assert const
    for k in const:
        if k.endswith("/lam"):
            np.testing.assert_array_max_ulp(got[k], theirs[k], maxulp=2)
        else:
            np.testing.assert_array_equal(got[k], theirs[k], err_msg=k)


def _jax_decode(name, jcfg, jparams, prompts, forced):
    cache = JMODELS[name].init_cache(jcfg, prompts.shape[0], MAX_LEN,
                                     dtype=jnp.float32)
    lg, cache = jax.jit(lambda p, c, t: JMODELS[name].prefill(jcfg, p, c, t))(
        jparams, cache, jnp.asarray(prompts))
    out = [np.asarray(lg[:, 0])]
    step = jax.jit(lambda p, c, t: JMODELS[name].decode_step(jcfg, p, c, t))
    for t in forced:
        lg, cache = step(jparams, cache, jnp.asarray(t[:, None]))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out), jax_to_numpy(cache)


def _port_decode(name, tcfg, tparams, prompts, forced):
    model = TMODELS[name]
    cache = model.init_cache(tcfg, prompts.shape[0], MAX_LEN,
                             dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        lg, cache = model.prefill(tcfg, tparams, cache,
                                  torch.from_numpy(prompts).long())
        out = [lg[:, 0].float().numpy()]
        for t in forced:
            lg, cache = model.decode_step(tcfg, tparams, cache,
                                          torch.from_numpy(t[:, None]).long())
            out.append(lg[:, 0].float().numpy())
    return np.stack(out), {k: v.numpy() for k, v in cache.items()}


# prompt length, decode steps: recurrentgemma's window is 8, so (5, 8)
# wraps the ring during decode and (11, 4) fills it from a prompt longer
# than the window
DECODE_SHAPES = [(5, 8), (11, 4)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_float_prefill_and_decode_match_jax(name, shape):
    """Prefill + teacher-forced decode steps on JAX's float weights in
    both packages: logits within 1e-5 of max |logit|; every cache leaf
    (the carried tokens, WKV / LRU states, conv state, the KV ring with
    its wrapped rows, lengths) within 1e-5 of its max, lengths equal; and
    the logits equal the float forward's over prompt + forced tokens."""
    S, steps = shape
    jparams, tparams = _float_params(name)
    prompts = _tokens(name, (2, S), 4)
    forced = _tokens(name, (steps, 2), 5)
    want, jcache = _jax_decode(name, JREDUCED[name], jparams, prompts,
                               forced)
    got, tcache = _port_decode(name, TREDUCED[name], tparams, prompts,
                               forced)
    _close(got, want, FLOAT_TOL, name)
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        if k == "lengths":
            np.testing.assert_array_equal(tcache[k], v)
            assert int(v[0]) == S + steps
        else:
            assert tcache[k].shape == v.shape, k
            _close(tcache[k], v, FLOAT_TOL, k)
    full = np.concatenate([prompts, forced.T], axis=1)
    with torch.inference_mode():
        fwd = TMODELS[name].forward(TREDUCED[name], tparams,
                                    torch.from_numpy(full)).numpy()
    _close(got, np.moveaxis(fwd[:, S - 1:], 1, 0), FLOAT_TOL, "forward")


def test_ring_write_and_valid_rows_are_tensor_ops():
    """recurrentgemma's decode step reads nothing back to the host: the
    ring slot is ``(len - 1) % W`` and the valid rows ``min(len, W)`` on
    tensors, so a step runs with ``torch.Tensor.item`` and ``tolist``
    forbidden; rows land where JAX's ``.at[bidx, slot]`` puts them."""
    name = "recurrentgemma-9b"
    cfg = TREDUCED[name]
    _, tparams = _float_params(name)
    cache = trg.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                           device="cpu")
    cache["lengths"] = torch.tensor([7, 12], dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        for attr in ("item", "tolist", "__bool__", "__int__", "__index__"):
            mp.setattr(torch.Tensor, attr, _host_read)
        with torch.inference_mode():
            _, cache = trg.decode_step(cfg, tparams, cache,
                                       torch.tensor([[1], [2]]))
    k = cache["k"][0]  # (B, W, Hkv, hd)
    # slot (8 - 1) % 8 = 7 for row 0, (13 - 1) % 8 = 4 for row 1
    assert bool(k[0, 7].abs().sum() > 0) and bool(k[1, 4].abs().sum() > 0)
    assert float(k[0, :7].abs().sum()) == 0.0
    assert cache["lengths"].tolist() == [8, 13]


def _host_read(*_, **__):
    raise AssertionError("decode step read a tensor back to the host")


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_quantized():
    """JAX's QuantizedModel of every case, in threads."""
    def run(case):
        with _off():
            return jr.quantize(JREDUCED[case[0]], _float_params(case[0])[0],
                               case[1])
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(run, CASES)))


@functools.lru_cache(maxsize=None)
def _quantized(name, rec):
    tparams = params_from_numpy(jax_to_numpy(_float_params(name)[0]), "cpu")
    return _jax_quantized()[name, rec], tr.quantize(TREDUCED[name], tparams,
                                                    rec)


@functools.lru_cache(maxsize=None)
def _carried(name, rec):
    jqm, _ = _quantized(name, rec)
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


@pytest.mark.parametrize("name,rec", CASES)
def test_quantized_leaves_match_jax(name, rec):
    """Every leaf has the JAX leaf's class and static fields; payload
    bytes, APoT codes, scales and zero points are equal bit for bit; the
    activation scales (each package's own f32 calibration forward) agree
    to rtol 1e-5."""
    jqm, tqm = _quantized(name, rec)
    ours = dict(leaves_with_path(params_to_numpy(tqm.params)))
    theirs = dict(leaves_with_path(jax_to_numpy(jqm.params)))
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if key.endswith("/act_scale") and want is not None:
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key


@pytest.mark.parametrize("name,rec", CASES)
def test_reports_and_stats_match_jax(name, rec):
    """Reports field for field in JAX's order (decisions and the uniform
    / APoT split exactly, mse to rel 1e-4), the per-layer stats to rtol
    1e-5, splits, the deployment shape and the provenance equal."""
    jqm, tqm = _quantized(name, rec)
    jrep = {r.path: r for r in jqm.report}
    assert [r.path for r in tqm.report] == list(jrep)
    for r in tqm.report:
        j = jrep[r.path]
        assert (r.kind, r.decision, r.shape, r.bits, r.n_uniform,
                r.n_apot) == (j.kind, j.decision, tuple(j.shape), j.bits,
                              j.n_uniform, j.n_apot), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    assert tqm.m2q_splits() == jqm.m2q_splits()
    assert sorted(tqm.act_stats) == sorted(jqm.act_stats)
    for k, v in jqm.act_stats.items():
        assert tqm.act_stats[k] == pytest.approx(v, rel=1e-5), k
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step
    assert tqm.provenance == jqm.provenance


def test_rwkv_leaf_kinds():
    """m2q-w8a8 on REDUCED rwkv: stacked QExpertM2Q projections (time mix
    r/k/v/g/o, channel mix r and v), cw_k perm-folded alone, a mixed
    lm_head; mixes, LoRA, bonus, decay bias and norms stay float.
    w4-weights-only: every quantized leaf a 4-bit QUniform."""
    _, tqm = _quantized("rwkv6-3b", "m2q-w8a8")
    leaves = dict(leaves_with_path(tqm.params))
    assert {r.path for r in tqm.report
            if r.decision == "mixed(perm-folded)"} == {"layers/cm/cw_k"}
    for p in ("tm/wr", "tm/wk", "tm/wv", "tm/wg", "tm/wo", "cm/cw_r",
              "cm/cw_v"):
        assert isinstance(leaves[f"layers/{p}"], QExpertM2Q), p
    assert type(leaves["layers/cm/cw_k"]) is QM2Q
    assert type(leaves["lm_head"]) is QM2Q
    for p in ("tm/mu_r", "tm/w_lora_a", "tm/u", "tm/w0", "tm/gn", "ln1"):
        assert isinstance(leaves[f"layers/{p}"], torch.Tensor), p
    _, w4 = _quantized("rwkv6-3b", "w4-weights-only")
    w4leaves = dict(leaves_with_path(w4.params))
    for r in w4.report:
        leaf = w4leaves[r.path]
        assert isinstance(leaf, QUniform) and leaf.bits == 4, r.path


@pytest.mark.parametrize("rec", ["m2q-w8a8", "uniform8"])
def test_calibrating_recipe_on_recurrentgemma_raises_as_in_jax(rec):
    """A calibrating recipe on recurrentgemma: the reference's calibration
    forward fails (``AttributeError`` on a ``CalibTensor``), and the port
    raises ``NotImplementedError`` naming that failure before any work."""
    name = "recurrentgemma-9b"
    with _off(), pytest.raises(AttributeError, match="reshape"):
        jr.quantize(JREDUCED[name], _float_params(name)[0], rec)
    with pytest.raises(NotImplementedError, match="CalibTensor"):
        tr.quantize(TREDUCED[name], _float_params(name)[1], rec)


@pytest.mark.parametrize("name,rec", CASES)
def test_quantized_prefill_and_decode_match_jax(name, rec):
    """The JAX-quantized tree through prefill + 6 teacher-forced decode
    steps in both packages (JAX dispatch off, the port's plain kernel
    versions): logits within 1e-5 of max |logit| -- every integer sum is
    exact and the float steps differ in summation order only -- and each
    decode step calls the lm_head's kernel once (m2q-w8a8: the mixed
    layers' ``m2q_matmul`` once a leaf and layer too)."""
    jparams, tparams = _carried(name, rec)
    prompts = _tokens(name, (2, 7), 6)
    forced = _tokens(name, (6, 2), 7)
    with _off():
        want, _ = _jax_decode(name, JREDUCED[name], jparams, prompts, forced)
    kernels.reset_counts()
    got, _ = _port_decode(name, TREDUCED[name], tparams, prompts, forced)
    plain = {k: c["plain_calls"] for k, c in kernels.counts().items()
             if c["plain_calls"]}
    _close(got, want, FLOAT_TOL, f"{name} {rec}")
    L = TREDUCED[name].n_layers
    head = "m2q_matmul" if rec == "m2q-w8a8" else "int4_matmul"
    per_pass = 7 * L + 1 if rec == "m2q-w8a8" else 1
    assert plain == {head: (len(forced) + 1) * per_pass}


@pytest.mark.parametrize("toks", [2, 64])
@pytest.mark.parametrize("rec", ["m2q-w8a8", "w4-weights-only"])
@pytest.mark.parametrize("name", NAMES)
def test_abstract_twin_equals_jax_at_full_width(name, rec, toks):
    """Each config at its published width under the recipe at the decode
    shape (2 tokens a step) and at 64, against JAX's
    ``abstract_quantize`` (meta tensors, nothing allocated): classes,
    static fields, shapes and dtypes equal.  m2q-w8a8 at the decode
    shape is all 4-bit; rwkv at 64 tokens mixes its projections and
    lm_head and folds cw_k."""
    recipe = tr.PRESETS[rec].replace(tokens_per_step=toks)
    ours = tr.abstract_quantize(name, recipe=recipe)
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(jr.abstract_quantize(
        name, recipe=jr.PRESETS[rec].replace(tokens_per_step=toks)))
    kinds = {k: v[0] for k, v in got.items() if v[0] != "float"}
    if toks == 2 or rec == "w4-weights-only":
        assert set(kinds.values()) == {"QUniform"}
    elif name == "rwkv6-3b":
        assert {k for k, v in kinds.items() if v == "QM2Q"} == \
            {"layers/cm/cw_k", "lm_head"}
    assert got["lm_head"][1]["shape"] == (TARCHS[name].d_model,
                                          TARCHS[name].padded_vocab)


# ---------------------------------------------------------------------------
# trees and artifacts across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,rec", CASES)
def test_trees_cross_both_ways(name, rec):
    """The float and quantized trees cross JAX -> port -> numpy
    unchanged; the port's quantized tree crosses to JAX, whose
    dispatch-off forward of it equals the port's within 1e-5 of max
    |logit|."""
    jparams, tparams = _float_params(name)
    same_numpy(params_to_numpy(tparams), jax_to_numpy(jparams))
    jqm, tqm = _quantized(name, rec)
    same_numpy(params_to_numpy(params_from_numpy(
        jax_to_numpy(jqm.params), "cpu")), jax_to_numpy(jqm.params))
    back = numpy_to_jax(params_to_numpy(tqm.params))
    tokens = _tokens(name, (2, 10), 9)
    with _off():
        want = jax.jit(lambda p, t: JMODELS[name].forward(
            JREDUCED[name], p, t))(back, jnp.asarray(tokens))
    _close(tqm.forward(tokens).numpy(), _np(want), FLOAT_TOL, name)


@pytest.mark.parametrize("name,rec", CASES)
def test_artifacts_load_across_packages(name, rec, tmp_path):
    """The port's artifact loaded by the JAX package and JAX's by the
    port: equal leaves and provenance (the recurrent config fields
    carried both ways), the same manifest when re-saved."""
    jqm, tqm = _quantized(name, rec)
    pdir = tqm.save(tmp_path / "port")
    loaded_j = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(loaded_j.params), params_to_numpy(tqm.params))
    assert artifact_payload(loaded_j, "jax") == artifact_payload(tqm, "port")
    assert loaded_j.cfg == JREDUCED[name]
    jdir = jqm.save(tmp_path / "jax")
    loaded_t = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    same_numpy(params_to_numpy(loaded_t.params), jax_to_numpy(jqm.params))
    assert artifact_payload(loaded_t, "port") == artifact_payload(jqm, "jax")
    assert loaded_t.cfg == TREDUCED[name]
    assert manifest(loaded_t.save(tmp_path / "port2")) == manifest(jdir)
    assert manifest(loaded_j.save(tmp_path / "jax2")) == manifest(pdir)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_registry_and_cfg_json_equal_the_jax_packages(name, reduced):
    """The full and REDUCED names resolve to JAX's configs (``lru_width``,
    ``conv1d_width``, ``rwkv_head_dim`` included); the artifact's config
    payload is JAX's, read back by either package."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    key = f"{name}-reduced" if reduced else name
    cfg, jcfg = tr.resolve_cfg(key), jr._resolve_cfg(key)
    assert (treg.get_reduced(name) if reduced else treg.get_config(name)) \
        == cfg
    assert (jreg.get_reduced(name) if reduced else jreg.get_config(name)) \
        == jcfg
    assert name in treg.list_archs()
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert tr._cfg_from_json(want) == cfg
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


# ---------------------------------------------------------------------------
# the token Engine's exact-length buckets
# ---------------------------------------------------------------------------


def _engines(name, params=None, **kw):
    jparams, tparams = params or _float_params(name)
    kw = dict(dict(max_batch=3, max_len=MAX_LEN), **kw)
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    return (JEngine(JREDUCED[name], jparams, dispatch=off, **kw),
            TEngine(TREDUCED[name], tparams, **kw))


@pytest.mark.parametrize("name,rec", [(n, None) for n in NAMES] + CASES)
def test_engine_tokens_equal_the_jax_engines(name, rec):
    """Both packages' engines serve the same 7 requests of mixed prompt
    lengths (4-8 tokens, repeats included, one finished at prefill) at
    ``max_batch`` 3 -- on the float weights, or on the JAX-quantized tree
    -- to the same tokens, through the same number of prefill passes
    (one length a pass), none of them padded."""
    params = None if rec is None else _carried(name, rec)
    jeng, teng = _engines(name, params)
    prompts = lm_prompts(TREDUCED[name].vocab_size, 7, seed=2, lo=4, hi=9)
    news = [5, 1, 4, 6, 3, 5, 2]
    reqs = {}
    for tag, eng in (("jax", jeng), ("port", teng)):
        with _off():
            reqs[tag] = [eng.submit(p, max_new_tokens=n)
                         for p, n in zip(prompts, news)]
            eng.run()
    assert done_tokens(reqs["port"]) == done_tokens(reqs["jax"])
    assert [len(r.handle.result()) for r in reqs["port"]] == news
    assert stats_fields(teng.stats) == stats_fields(jeng.stats)
    assert teng.stats.padded_fraction == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_exact_length_buckets_one_length_a_pass(name):
    """A queue of prompts of lengths 5, 7, 5, 9, 7 into 4 free slots:
    the first pass prefills the two of length 5 (the head's length, its
    later match taken with it), the next passes 7 and then 9 within the
    same ``_admit``; every prefill runs unpadded at its own length and
    without ``lengths``."""
    cfg = TREDUCED[name]
    _, tparams = _float_params(name)
    eng = TEngine(cfg, tparams, max_batch=4, max_len=MAX_LEN)
    seen = []
    real = eng.model.prefill

    def spy(cfg_, params, cache, tokens, **kw):
        seen.append((tuple(tokens.shape), sorted(kw)))
        return real(cfg_, params, cache, tokens, **kw)

    eng.model = types.SimpleNamespace(prefill=spy,
                                      init_cache=eng.model.init_cache,
                                      decode_step=eng.model.decode_step)
    lens = [5, 7, 5, 9, 7]
    reqs = [eng.submit(np.arange(1, n + 1), max_new_tokens=3) for n in lens]
    eng.step()
    assert seen == [((2, 5), []), ((1, 7), []), ((1, 9), [])]
    assert [s is not None for s in eng.slots] == [True] * 4
    eng.run()
    assert seen[3:] == [((1, 7), [])]
    assert all(len(r.handle.result()) == 3 for r in reqs)


@pytest.mark.parametrize("name", NAMES)
def test_preemption_matches_jax(name):
    """The daemon tests' preemption script on the recurrent engines: two
    preemptible decodes evicted by interactive arrivals restart from
    prefill over prompt + tokens (a new exact length) -- the same
    evictions, outcomes, tokens and stats as the JAX engine's, each
    continuation keeping its prefix."""
    jeng, teng = _engines(name, max_batch=2)

    def script(eng):
        low = eng.submit(np.arange(1, 7), max_new_tokens=9, priority=0,
                         preemptible=True, stream=True)
        mid = eng.submit(np.arange(2, 9), max_new_tokens=9, priority=1,
                         preemptible=True, stream=True)
        eng.step()
        eng.step()
        before = {r.uid: list(r.handle._stream) for r in (low, mid)}
        hi = [eng.submit(np.arange(3, 6), max_new_tokens=3, priority=10)]
        eng.step()
        hi.append(eng.submit(np.arange(4, 8), max_new_tokens=2,
                             priority=10))
        eng.step()
        eng.run()
        reqs = [low, mid] + hi
        return reqs, before, [r.preemptions for r in reqs]

    with _off():
        jreqs, _, jpre = script(jeng)
    treqs, before, tpre = script(teng)
    assert tpre == jpre and tpre[0] >= 1
    assert outcomes(treqs) == outcomes(jreqs)
    assert done_tokens(treqs) == done_tokens(jreqs)
    assert len(done_tokens(treqs)) == 4
    assert stats_fields(teng.stats) == stats_fields(jeng.stats)
    for r in treqs[:2]:
        out = r.handle.result()
        assert len(out) == 9 and out[:len(before[r.uid])] == before[r.uid]


@pytest.mark.parametrize("name", NAMES)
def test_poisoned_slot_fails_alone(name):
    """``nan@decode`` poisons one live slot's recurrent state in place
    (batch axis 1 of every float leaf): that request alone fails with
    NumericalError, its neighbour completes with the tokens of a clean
    run."""
    from repro_torch.serving import faults as tfaults
    _, tparams = _float_params(name)
    cfg = TREDUCED[name]
    prompts = [np.arange(1, 6), np.arange(2, 7)]
    clean = TEngine(cfg, tparams, max_batch=2, max_len=MAX_LEN)
    want = [clean.submit(p, max_new_tokens=4) for p in prompts]
    clean.run()
    eng = TEngine(cfg, tparams, max_batch=2, max_len=MAX_LEN,
                  faults=tfaults.FaultInjector.parse("nan@decode:1"))
    got = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    assert type(got[0].handle.exception()).__name__ == "NumericalError"
    assert got[1].handle.result() == want[1].handle.result()


# ---------------------------------------------------------------------------
# chip_smoke's phase 12, rehearsed at REDUCED width on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind", [
    (name, kind) for name, _, kind in chip_smoke.RECURRENT_CASES])
def test_phase_12_case_at_reduced_width(name, kind):
    """``chip_smoke.recurrent_case`` on the CPU at REDUCED width (plain
    versions, eager engines): ``init``, ``quantize(..., release=True)``,
    8 requests of three prompt lengths served eagerly and "graphed" (on
    the CPU, eagerly again) through three exact-length prefill groups,
    tokens equal, none >= vocab, plain calls as the tree predicts, the
    teacher-forced logits equal to themselves under the plain versions
    and within the bound of the forward's; recurrentgemma also a request
    past its window of 8 that wraps the ring."""
    cfg = TREDUCED[name]
    res, problems, _ = chip_smoke.recurrent_case(
        torch, cfg, kind, device="cpu", max_new=4,
        window_prompt=cfg.window + 3 if cfg.window else None)
    assert problems == []
    assert res["served_tokens_max"] < cfg.vocab_size
    assert res["prefill_groups"] == len(chip_smoke.RECURRENT_LENGTHS)
    assert res["teacher_forced_max_abs_diff"] == 0.0  # plain both ways
    assert res["forward_max_abs_diff"] <= res["forward_bound"]
    if cfg.window:
        w = res["window"]
        assert w["ring_rows"] == cfg.window
        assert w["prompt_tokens"] + 4 > w["ring_rows"]
        assert w["forward_max_abs_diff"] <= w["forward_bound"]

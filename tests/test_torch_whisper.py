"""whisper-large-v3, the encoder-decoder family, against the JAX package:
``nn`` ``layer_norm`` / ``tied_head`` / ``geglu``, the attention shapes
whisper adds (a 1500-frame encoder, cross attention over 1500 memory
rows), ``models/whisper.py`` at its REDUCED config (2 + 2 layers,
d_model 64, 32 frames, f32) from the JAX package's float init at
``PRNGKey(0)`` and at its published widths with the depth cut (2 + 2
layers, vocab 1024, 64 frames, bf16), ``w4-weights-only`` leaves,
reports and artifacts, the shape-only twin at full width, and what fails
on whisper in both packages (a calibrating recipe; a request through the
token Engine, which prefills without frames).

The JAX package runs with dispatch off (its XLA QTensor paths); no
whisper leaf reaches a kernel in either package."""
import dataclasses
import functools
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import recipe as jr
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import REDUCED as JREDUCED
from repro.core import qtensor as jq
from repro.kernels import ops as jops
from repro.models import dense_lm as jdense
from repro.models import whisper as jw
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.serving.engine import Engine as JEngine
from repro_torch import kernels, nn
from repro_torch import recipe as tr
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.qtensor import QUniform, slice_layer
from repro_torch.core.tree import leaves_with_path
from repro_torch.kernels import ops
from repro_torch.models import whisper as tw
from repro_torch.serving.engine import Engine as TEngine
from torch_parity import (abstract_tree, all_meta, artifact_payload,
                          done_tokens, jax_to_numpy, lm_engines, lm_prompts,
                          manifest, numpy_to_jax, same_numpy, stats_fields)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 13, rehearsed at REDUCED width)

NAME = "whisper-large-v3"
JCFG, TCFG = JREDUCED[NAME], TREDUCED[NAME]
MAX_LEN = 24
# f32 through the REDUCED depth: the packages differ by summation order
FLOAT_TOL = 1e-5
# one bf16 step at max |y| (2^-7 of it), for a single function
BF16_TOL = 2 ** -7
# whole bf16 models: four bf16 steps at max |logit|, as the recurrent LMs
BF16_MODEL_TOL = 2 ** -5
# the published widths, the depth and vocab cut (and 64 frames)
CUT = dict(n_layers=2, n_enc_layers=2, vocab_size=1024, n_audio_ctx=64)


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


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(
        np.array(a)).to(getattr(torch, dtype))


def _inputs(cfg, batch, seq, seed):
    """Seeded prompts (batch, seq) and frames (batch, n_audio_ctx,
    d_model)."""
    rng = _rng(seed)
    return (rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32),
            rng.normal(0, 1, (batch, cfg.n_audio_ctx, cfg.d_model))
            .astype(np.float32))


# ---------------------------------------------------------------------------
# nn: layer_norm, tied_head, geglu; attention at whisper's shapes
# ---------------------------------------------------------------------------

NB, NT, ND, NF, NV = 2, 5, 32, 48, 96


def _case_layer_norm(dtype):
    rng = _rng(1)
    x = rng.normal(0.5, 2.0, (NB, NT, ND)).astype(np.float32)
    g = rng.normal(1.0, 0.2, (ND,)).astype(np.float32)
    b = rng.normal(0.0, 0.2, (ND,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = nn.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    return got, jlayers.layer_norm(jx, jnp.asarray(g), jnp.asarray(b))


def _case_tied_head(dtype):
    rng = _rng(2)
    x = rng.normal(0, 1, (NB, NT, ND)).astype(np.float32)
    table = rng.normal(0, 0.02, (NV, ND)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    return (nn.tied_head(tx, torch.from_numpy(table)),
            jlayers.tied_head(jx, jnp.asarray(table)))


def _case_tied_head_q4(dtype):
    """A 4-bit per-row table (the w4 recipe's embedding), carried from
    JAX's quantizer: both dequantize it to x's dtype."""
    rng = _rng(3)
    x = rng.normal(0, 1, (NB, NT, ND)).astype(np.float32)
    jtable = jq.QUniform.quantize(jnp.asarray(
        rng.normal(0, 0.02, (NV, ND)).astype(np.float32)), bits=4, axis=0)
    ttable = params_from_numpy({"t": jax_to_numpy(jtable)}, "cpu")["t"]
    assert isinstance(ttable, QUniform) and ttable.axis == 0
    jx, tx = _pair(x, dtype)
    return nn.tied_head(tx, ttable), jlayers.tied_head(jx, jtable)


def _case_geglu(dtype):
    rng = _rng(4)
    x = rng.normal(0, 1, (NB, NT, ND)).astype(np.float32)
    w1, w3 = (rng.normal(0, ND ** -0.5, (ND, NF)).astype(np.float32)
              for _ in range(2))
    w2 = rng.normal(0, NF ** -0.5, (NF, ND)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    return (nn.geglu(tx, *(torch.from_numpy(w) for w in (w1, w3, w2))),
            jlayers.geglu(jx, *(jnp.asarray(w) for w in (w1, w3, w2))))


NN_CASES = {"layer_norm": _case_layer_norm, "tied_head": _case_tied_head,
            "tied_head_q4": _case_tied_head_q4, "geglu": _case_geglu}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nn_function_matches_jax(case, dtype):
    """Each new ``nn`` function on the same numpy inputs as its JAX twin:
    the input's dtype out; values within 1e-5 of max |y| in f32 and one
    bf16 step at max |y| in bf16."""
    got, want = NN_CASES[case](dtype)
    assert str(got.dtype).split(".")[-1] == dtype
    _close(_np(got), _np(want),
           FLOAT_TOL if dtype == "float32" else BF16_TOL, case)


@pytest.mark.parametrize("n_pos,d", [(32, 64), (1500, 1280)])
def test_sinusoid_equals_jax(n_pos, d):
    """The encoder's position table, float64 then f32: bit for bit."""
    got, want = tw._sinusoid(n_pos, d), jw._sinusoid(n_pos, d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_attention_at_whisper_shapes():
    """The encoder's unmasked attention over 1500 frames (one pass over
    the (S, T) scores in the port, JAX's chunked online softmax) and
    decode attention over a 1500-row cross cache at full lengths, against
    JAX's and against each other (one query row of the unmasked
    attention is a full-length decode)."""
    rng = _rng(5)
    T, H, D = 1500, 2, 64
    q = rng.normal(0, 1, (1, T, H, D)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, T, H, D)).astype(np.float32)
            for _ in range(2))
    got = nn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=False)
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=False)
    _close(_np(got), _np(want), FLOAT_TOL, "encoder attention")
    qd = rng.normal(0, 1, (3, 1, H, D)).astype(np.float32)
    kd, vd = (rng.normal(0, 1, (3, T, H, D)).astype(np.float32)
              for _ in range(2))
    full = np.full((3,), T, np.int32)
    got = nn.decode_attention(*(torch.from_numpy(a)
                                for a in (qd, kd, vd, full)))
    want = jattn.decode_attention(*(jnp.asarray(a)
                                    for a in (qd, kd, vd, full)))
    _close(_np(got), _np(want), FLOAT_TOL, "cross decode attention")
    flash = nn.flash_attention(*(torch.from_numpy(a) for a in (qd, kd, vd)),
                               causal=False)
    _close(_np(got), _np(flash), FLOAT_TOL, "decode vs flash")


# ---------------------------------------------------------------------------
# the float model at REDUCED
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _float_params(cut: bool = False):
    """(JAX's float tree at PRNGKey(0), the same numbers as the port's
    CPU tree) of REDUCED, or of the published widths cut (``CUT``)."""
    cfg = JARCHS[NAME].replace(**CUT) if cut else JCFG
    params = jax.jit(lambda k: jw.init(cfg, k))(jax.random.PRNGKey(0))
    return params, params_from_numpy(jax_to_numpy(params), "cpu")


def test_init_tree_equals_jax():
    """``init``'s tree: JAX's paths, shapes and dtypes (two stacks of
    nested self / cross / mlp dicts, f32 biases and layer-norm leaves,
    ``pos_dec`` of 32768 rows, no ``lm_head``), on the CPU and on the meta
    device; the constant leaves (gains 1, biases 0) equal JAX's."""
    jparams, _ = _float_params()
    theirs = dict(leaves_with_path(jax_to_numpy(jparams)))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.items()}
    assert "lm_head" not in want
    assert want["pos_dec"][0] == (tw.MAX_TARGET_POSITIONS, TCFG.d_model)
    for dev in ("cpu", "meta"):
        got = tw.init(TCFG, seed=0, device=dev)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in leaves_with_path(got)} == want
    ours = dict(leaves_with_path(params_to_numpy(
        tw.init(TCFG, seed=0, device="cpu"))))
    const = [k for k in theirs if k.endswith(("_g", "_b", "b_q", "b_v",
                                              "b_o", "b_1", "b_2"))]
    # final norms 4; an encoder layer's 4 norm leaves + 3 + 2 biases, a
    # decoder layer's 6 + 2 x 3 + 2
    assert len(const) == 4 + 9 + 14
    for k in const:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_encode_matches_jax():
    jparams, tparams = _float_params()
    _, frames = _inputs(TCFG, 2, 1, 6)
    want = jax.jit(lambda p, f: jw.encode(JCFG, p, f))(
        jparams, jnp.asarray(frames))
    with torch.inference_mode():
        got = tw.encode(TCFG, tparams, torch.from_numpy(frames))
    assert got.shape == (2, TCFG.n_audio_ctx, TCFG.d_model)
    _close(_np(got), _np(want), FLOAT_TOL, "encode")


@pytest.mark.parametrize("given", ["frames", "memory"])
def test_forward_matches_jax(given):
    """The teacher-forced forward over 9 tokens, from the frames or from
    a given encoder memory: within 1e-5 of max |logit| of JAX's."""
    jparams, tparams = _float_params()
    tokens, frames = _inputs(TCFG, 2, 9, 7)
    jkw = {"frames": jnp.asarray(frames)}
    if given == "memory":
        jkw = {"memory": jw.encode(JCFG, jparams, jnp.asarray(frames))}
    want = jax.jit(lambda p, t, kw: jw.forward(JCFG, p, t, **kw))(
        jparams, jnp.asarray(tokens), jkw)
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in jkw.items()}
    with torch.inference_mode():
        got = tw.forward(TCFG, tparams, torch.from_numpy(tokens), **tkw)
    assert got.shape == (2, 9, TCFG.padded_vocab)
    _close(_np(got), _np(want), FLOAT_TOL, given)


def _jax_decode(cfg, jparams, prompts, frames, forced, dtype=jnp.float32):
    cache = jw.init_cache(cfg, prompts.shape[0], MAX_LEN, dtype=dtype)
    lg, cache = jax.jit(lambda p, c, t, f: jw.prefill(cfg, p, c, t,
                                                      frames=f))(
        jparams, cache, jnp.asarray(prompts), jnp.asarray(frames))
    out = [_np(lg[:, 0])]
    step = jax.jit(lambda p, c, t: jw.decode_step(cfg, p, c, t))
    for t in forced:
        lg, cache = step(jparams, cache, jnp.asarray(t[:, None]))
        out.append(_np(lg[:, 0]))
    return np.stack(out), {k: _np(v) if k != "lengths" else np.asarray(v)
                           for k, v in cache.items()}


def _port_decode(cfg, tparams, prompts, frames, forced,
                 dtype=torch.float32):
    cache = tw.init_cache(cfg, prompts.shape[0], MAX_LEN, dtype=dtype,
                          device="cpu")
    with torch.inference_mode():
        lg, cache = tw.prefill(cfg, tparams, cache,
                               torch.from_numpy(prompts).long(),
                               frames=torch.from_numpy(frames))
        out = [_np(lg[:, 0])]
        for t in forced:
            lg, cache = tw.decode_step(cfg, tparams, cache,
                                       torch.from_numpy(t[:, None]).long())
            out.append(_np(lg[:, 0]))
    return np.stack(out), {k: _np(v) if k != "lengths" else v.numpy()
                           for k, v in cache.items()}


@pytest.mark.parametrize("prompt", [1, 6])
def test_float_prefill_and_decode_match_jax(prompt):
    """Prefill plus 8 teacher-forced decode steps on JAX's float weights
    (an f32 cache) in both packages: logits within 1e-5 of max |logit|;
    the cache -- self rows ``k`` / ``v``, cross ``xk`` / ``xv`` of 32
    memory rows -- within 1e-5 of its max, ``lengths`` equal; and the
    logits equal the forward's over prompt + forced tokens."""
    jparams, tparams = _float_params()
    prompts, frames = _inputs(TCFG, 2, prompt, 8)
    forced = _rng(9).integers(0, TCFG.vocab_size, (8, 2), dtype=np.int32)
    want, jcache = _jax_decode(JCFG, jparams, prompts, frames, forced)
    got, tcache = _port_decode(TCFG, tparams, prompts, frames, forced)
    _close(got, want, FLOAT_TOL, "logits")
    assert sorted(tcache) == sorted(jcache) == ["k", "lengths", "v", "xk",
                                                 "xv"]
    for k, v in jcache.items():
        assert tcache[k].shape == v.shape, k
        if k == "lengths":
            np.testing.assert_array_equal(tcache[k], v)
            assert int(v[0]) == prompt + len(forced)
        else:
            _close(tcache[k], v, FLOAT_TOL, k)
    full = np.concatenate([prompts, forced.T], axis=1)
    with torch.inference_mode():
        fwd = tw.forward(TCFG, tparams, torch.from_numpy(full),
                         frames=torch.from_numpy(frames)).numpy()
    _close(got, np.moveaxis(fwd[:, prompt - 1:], 1, 0), FLOAT_TOL,
           "forward")


def _host_read(*_, **__):
    raise AssertionError("decode step read a tensor back to the host")


def test_decode_step_reads_nothing_back_to_the_host():
    """The decode step captures in a CUDA graph: with ``item``,
    ``tolist`` and the scalar conversions forbidden it still runs,
    writes row ``lengths - 1`` by tensor indices (a row past ``max_len``
    dropped), gathers ``pos_dec`` on the device and attends over all 32
    cross rows."""
    _, tparams = _float_params()
    cache = tw.init_cache(TCFG, 2, MAX_LEN, dtype=torch.float32,
                          device="cpu")
    cache["lengths"] = torch.tensor([5, MAX_LEN], dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        for attr in ("item", "tolist", "__bool__", "__int__", "__index__"):
            mp.setattr(torch.Tensor, attr, _host_read)
        with torch.inference_mode():
            lg, cache = tw.decode_step(TCFG, tparams, cache,
                                       torch.tensor([[1], [2]]))
    assert lg.shape == (2, 1, TCFG.padded_vocab)
    k = cache["k"][0]
    assert bool(k[0, 5].abs().sum() > 0)
    assert float(k[0, 6:].abs().sum()) == 0.0
    assert float(k[1].abs().sum()) == 0.0  # row 24 is past max_len
    assert cache["lengths"].tolist() == [6, MAX_LEN + 1]


def test_prefill_without_frames_fails_as_in_jax():
    """Without frames both packages' prefill fail before touching the
    cache: JAX's ``encode`` on None (AttributeError), the port with an
    error that names the frames."""
    jparams, tparams = _float_params()
    prompts, _ = _inputs(TCFG, 1, 3, 10)
    with pytest.raises(AttributeError):
        jw.prefill(JCFG, jparams, jw.init_cache(JCFG, 1, MAX_LEN),
                   jnp.asarray(prompts))
    with pytest.raises(ValueError, match="frames"):
        tw.prefill(TCFG, tparams, tw.init_cache(TCFG, 1, MAX_LEN,
                                                device="cpu"),
                   torch.from_numpy(prompts))


# ---------------------------------------------------------------------------
# the published widths, depth cut, bf16
# ---------------------------------------------------------------------------


def test_bf16_published_width_matches_jax():
    """d 1280, 20 heads of 64, d_ff 5120 at 2 + 2 layers, vocab 1024 and
    64 frames, bf16 activations (JAX's float tree carried): the forward,
    and prefill plus 4 decode steps over a bf16 cache, within 2^-5 of
    max |logit| of JAX's."""
    jcfg, tcfg = JARCHS[NAME].replace(**CUT), TARCHS[NAME].replace(**CUT)
    assert tcfg.dtype == "bfloat16" and tcfg.d_model == 1280
    jparams, tparams = _float_params(cut=True)
    tokens, frames = _inputs(tcfg, 2, 6, 11)
    want = jax.jit(lambda p, t, f: jw.forward(jcfg, p, t, frames=f))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    with torch.inference_mode():
        got = tw.forward(tcfg, tparams, torch.from_numpy(tokens),
                         frames=torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    _close(_np(got), _np(want), BF16_MODEL_TOL, "forward")
    forced = _rng(12).integers(0, tcfg.vocab_size, (4, 2), dtype=np.int32)
    want, _ = _jax_decode(jcfg, jparams, tokens, frames, forced,
                          dtype=jnp.bfloat16)
    got, _ = _port_decode(tcfg, tparams, tokens, frames, forced,
                          dtype=torch.bfloat16)
    _close(got, want, BF16_MODEL_TOL, "prefill + decode")


# ---------------------------------------------------------------------------
# w4-weights-only
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _quantized():
    jparams, tparams = _float_params()
    with _off():
        jqm = jr.quantize(JCFG, jparams, "w4-weights-only")
    return jqm, tr.quantize(TCFG, tparams, "w4-weights-only")


@functools.lru_cache(maxsize=None)
def _carried():
    jqm, _ = _quantized()
    return jqm.params, params_from_numpy(jax_to_numpy(jqm.params), "cpu")


def test_quantized_leaves_match_jax():
    """Every leaf has the JAX leaf's class and static fields, every
    payload, scale and zero point equal bit for bit: stacked (L, K, N/2)
    4-bit layers (axis 2) and the embedding per row (axis 0); biases,
    layer norms and ``pos_dec`` stay f32."""
    jqm, tqm = _quantized()
    ours = dict(leaves_with_path(params_to_numpy(tqm.params)))
    theirs = dict(leaves_with_path(jax_to_numpy(jqm.params)))
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key
    leaves = dict(leaves_with_path(tqm.params))
    for r in tqm.report:
        leaf = leaves[r.path]
        assert isinstance(leaf, QUniform) and leaf.bits == 4, r.path
        assert leaf.axis == (0 if r.path == "embed" else 2), r.path
    assert leaves["pos_dec"].dtype == torch.float32


def test_reports_match_jax():
    """Reports field for field in JAX's order, the deployment shape and
    the provenance equal."""
    jqm, tqm = _quantized()
    assert [r.path for r in tqm.report] == [r.path for r in jqm.report]
    assert len(tqm.report) == 1 + 8 + 2 + 4 + 2
    for r, j in zip(tqm.report, jqm.report):
        assert (r.kind, r.decision, r.shape, r.bits, r.n_uniform,
                r.n_apot) == (j.kind, j.decision, tuple(j.shape), j.bits,
                              j.n_uniform, j.n_apot), r.path
        assert r.mse == pytest.approx(j.mse, rel=1e-4)
    assert tqm.recipe.tokens_per_step == jqm.recipe.tokens_per_step
    assert tqm.provenance == jqm.provenance
    assert tqm.act_stats == jqm.act_stats == {}


def test_kernel_supported_equals_jax():
    """No whisper leaf reaches a kernel in either package: every
    quantized leaf and every layer slice of a stacked one is refused by
    both ``kernel_supported`` (axis-2 slices, the axis-0 embedding, which
    the tied head dequantizes)."""
    jparams, tparams = _carried()
    n = 0
    for key, leaf in leaves_with_path(tparams):
        if not dataclasses.is_dataclass(leaf):
            continue
        jleaf = jparams
        for part in key.split("/"):
            jleaf = jleaf[part]
        assert ops.kernel_supported(leaf) is False
        assert bool(jops.kernel_supported(jleaf)) is False
        if key != "embed":
            for i in range(leaf.shape[0]):
                assert ops.kernel_supported(slice_layer(leaf, i)) is False
                assert not jops.kernel_supported(
                    jax.tree.map(lambda a: a[i], jleaf))
        n += 1
    assert n == 17


def test_quantized_prefill_and_decode_match_jax():
    """The JAX-quantized tree through the forward, and prefill + 8
    teacher-forced decode steps (a bf16 cache, JAX's default), in both
    packages: within 1e-5 of max |logit|; no kernel and no plain version
    is called."""
    jparams, tparams = _carried()
    prompts, frames = _inputs(TCFG, 2, 5, 13)
    forced = _rng(14).integers(0, TCFG.vocab_size, (8, 2), dtype=np.int32)
    with _off():
        want, jcache = _jax_decode(JCFG, jparams, prompts, frames, forced,
                                   dtype=jnp.bfloat16)
        wfwd = jax.jit(lambda p, t, f: jw.forward(JCFG, p, t, frames=f))(
            jparams, jnp.asarray(prompts), jnp.asarray(frames))
    kernels.reset_counts()
    got, tcache = _port_decode(TCFG, tparams, prompts, frames, forced,
                               dtype=torch.bfloat16)
    with torch.inference_mode():
        gfwd = tw.forward(TCFG, tparams, torch.from_numpy(prompts),
                          frames=torch.from_numpy(frames))
    assert not any(c["launches"] or c["plain_calls"]
                   for c in kernels.counts().values())
    _close(got, want, FLOAT_TOL, "decode")
    _close(_np(gfwd), _np(wfwd), FLOAT_TOL, "forward")
    for k in ("xk", "xv"):
        _close(tcache[k], jcache[k], BF16_TOL, k)


@pytest.mark.parametrize("name", [NAME, "internvl2-2b"])
def test_quantized_model_forward_passes_model_keywords(name):
    """``QuantizedModel.forward(inputs, **kw)`` hands the model's own
    inputs through, as JAX's does: whisper's ``frames=`` (numpy), and
    internvl2's ``prefix_embeds=``."""
    if name == NAME:
        jqm, tqm = _quantized()
        tokens, extra = _inputs(TCFG, 2, 4, 15)
        kw = "frames"
    else:
        jcfg, tcfg = JREDUCED[name], TREDUCED[name]
        jparams = jax.jit(lambda k: jdense.init(jcfg, k))(
            jax.random.PRNGKey(0))
        with _off():
            jqm = jr.quantize(jcfg, jparams, "w4-weights-only")
        tqm = tr.quantize(tcfg, params_from_numpy(jax_to_numpy(jparams),
                                                  "cpu"), "w4-weights-only")
        rng = _rng(16)
        tokens = rng.integers(0, tcfg.vocab_size, (2, 4), dtype=np.int32)
        extra = rng.normal(0, 1, (2, tcfg.n_patches, tcfg.d_model)).astype(
            np.float32)
        kw = "prefix_embeds"
    with _off():
        want = jqm.forward(jnp.asarray(tokens), **{kw: jnp.asarray(extra)})
    got = tqm.forward(tokens, **{kw: extra})
    assert got.shape == want.shape
    _close(_np(got), _np(want), FLOAT_TOL, name)


@pytest.mark.parametrize("rec", ["m2q-w8a8", "uniform8"])
def test_calibrating_recipe_raises_as_in_jax(rec):
    """A calibrating recipe on whisper: the reference's calibration
    forward fails (``encode`` scans the wrapped encoder leaves:
    TypeError, a CalibTensor is not a JAX type), and the port raises
    ``NotImplementedError`` naming that failure before any work."""
    jparams, tparams = _float_params()
    tokens, frames = _inputs(TCFG, 2, 4, 17)
    with _off(), pytest.raises(TypeError, match="CalibTensor"):
        jr.quantize(JCFG, jparams, rec, calib_batches=[
            {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}])
    with pytest.raises(NotImplementedError, match="TypeError"):
        tr.quantize(TCFG, tparams, rec, calib_batches=[
            {"tokens": tokens, "frames": frames}])


@pytest.mark.parametrize("rec", ["m2q-w8a8", "w4-weights-only"])
def test_abstract_twin_equals_jax_at_full_width(rec):
    """whisper-large-v3 at full width and depth (meta tensors, nothing
    allocated): JAX's ``abstract_quantize`` leaf for leaf -- classes,
    static fields, shapes, dtypes -- and 1.578 B float parameters in a
    0.947 GB 4-bit tree (at the decode shape ``m2q-w8a8`` is all 4-bit
    too)."""
    ours = tr.abstract_quantize(NAME, recipe=rec)
    all_meta(ours)
    got = abstract_tree(ours)
    assert got == abstract_tree(jr.abstract_quantize(NAME, recipe=rec))
    kinds = {v[0] for k, v in got.items() if v[0] != "float"}
    assert kinds == {"QUniform"}
    n_float = sum(v.numel() for _, v in leaves_with_path(
        tw.init(TARCHS[NAME], device="meta")))
    assert round(n_float / 1e9, 3) == 1.578
    assert round(chip_smoke.tree_bytes(ours) / 1e9, 3) == 0.947


# ---------------------------------------------------------------------------
# trees and artifacts across packages; the registry
# ---------------------------------------------------------------------------


def test_trees_cross_both_ways():
    """The float and 4-bit trees cross JAX -> port -> numpy unchanged;
    the port's 4-bit tree crosses to JAX, whose dispatch-off forward of
    it equals the port's within 1e-5 of max |logit|."""
    jparams, tparams = _float_params()
    same_numpy(params_to_numpy(tparams), jax_to_numpy(jparams))
    jqm, tqm = _quantized()
    same_numpy(params_to_numpy(params_from_numpy(
        jax_to_numpy(jqm.params), "cpu")), jax_to_numpy(jqm.params))
    back = numpy_to_jax(params_to_numpy(tqm.params))
    tokens, frames = _inputs(TCFG, 2, 7, 18)
    with _off():
        want = jax.jit(lambda p, t, f: jw.forward(JCFG, p, t, frames=f))(
            back, jnp.asarray(tokens), jnp.asarray(frames))
    _close(tqm.forward(tokens, frames=frames).numpy(), _np(want),
           FLOAT_TOL, "forward")


def test_artifacts_load_across_packages(tmp_path):
    """The port's artifact loaded by the JAX package and JAX's by the
    port: equal leaves and provenance (``norm``, ``n_enc_layers``,
    ``n_audio_ctx`` carried both ways), the same manifest re-saved."""
    jqm, tqm = _quantized()
    pdir = tqm.save(tmp_path / "port")
    loaded_j = jr.QuantizedModel.load(str(tmp_path / "port"))
    same_numpy(jax_to_numpy(loaded_j.params), params_to_numpy(tqm.params))
    assert artifact_payload(loaded_j, "jax") == artifact_payload(tqm, "port")
    assert loaded_j.cfg == JCFG
    jdir = jqm.save(tmp_path / "jax")
    loaded_t = tr.QuantizedModel.load(tmp_path / "jax", device="cpu")
    same_numpy(params_to_numpy(loaded_t.params), jax_to_numpy(jqm.params))
    assert artifact_payload(loaded_t, "port") == artifact_payload(jqm, "jax")
    assert loaded_t.cfg == TCFG
    assert manifest(loaded_t.save(tmp_path / "port2")) == manifest(jdir)
    assert manifest(loaded_j.save(tmp_path / "jax2")) == manifest(pdir)


@pytest.mark.parametrize("reduced", [False, True])
def test_registry_and_cfg_json_equal_the_jax_packages(reduced):
    """The full and REDUCED names resolve to JAX's configs; the registry
    lists JAX's names in JAX's order, ``ASSIGNED`` and ``SUBQUADRATIC``
    too; the artifact's config payload is JAX's, read back by either
    package."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    key = f"{NAME}-reduced" if reduced else NAME
    cfg, jcfg = tr.resolve_cfg(key), jr._resolve_cfg(key)
    assert (treg.get_reduced(NAME) if reduced else treg.get_config(NAME)) \
        == cfg
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ASSIGNED == jreg.ASSIGNED
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert tr._cfg_from_json(want) == cfg
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


# ---------------------------------------------------------------------------
# the token Engine: a whisper request fails in both packages
# ---------------------------------------------------------------------------


def test_engine_fails_a_whisper_request_and_serves_on():
    """The token Engine prefills without frames, so a whisper request
    ends FAILED in both packages (the port's error names the frames),
    the engine's loop returns and fails the next one the same way; then
    both packages' engines serve a qwen request to the same tokens."""
    jparams, tparams = _float_params()
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    jeng = JEngine(JCFG, jparams, max_batch=2, max_len=MAX_LEN,
                   dispatch=off)
    teng = TEngine(TCFG, tparams, max_batch=2, max_len=MAX_LEN)
    reqs = {}
    for tag, eng in (("jax", jeng), ("port", teng)):
        with _off():
            reqs[tag] = []
            for _ in range(2):
                reqs[tag].append(eng.submit(np.arange(1, 5),
                                            max_new_tokens=3))
                eng.run()
    for tag in reqs:
        assert [r.handle.state for r in reqs[tag]] == ["FAILED"] * 2
    assert "frames" in str(reqs["port"][0].handle.exception())
    assert stats_fields(teng.stats) == stats_fields(jeng.stats)
    jq_, tq_ = lm_engines()
    prompt = lm_prompts(TREDUCED["qwen1.5-0.5b"].vocab_size, 1, seed=3)[0]
    qreqs = {}
    for tag, eng in (("jax", jq_), ("port", tq_)):
        with _off():
            qreqs[tag] = [eng.submit(prompt, max_new_tokens=4)]
            eng.run()
    assert done_tokens(qreqs["port"]) == done_tokens(qreqs["jax"])
    assert len(done_tokens(qreqs["port"])) == 1


# ---------------------------------------------------------------------------
# chip_smoke's phase 13, rehearsed at REDUCED width on the CPU
# ---------------------------------------------------------------------------


def test_phase_13_case_at_reduced_width():
    """``chip_smoke.whisper_case`` on the CPU at REDUCED width: ``init``,
    ``quantize(..., release=True)`` (every leaf 4-bit), the artifact round
    trip, 2 greedy prompts of 5 tokens and 6 decode steps, eager and
    "graphed" (eagerly again on the CPU) to the same tokens, none >=
    vocab, no kernel and no plain call, the decode logits within the
    bound of the teacher-forced forward's."""
    with tempfile.TemporaryDirectory() as d:
        res, problems = chip_smoke.whisper_case(
            torch, TCFG, device="cpu", batch=2, prompt_len=5, steps=6,
            max_len=16, artifacts=Path(d))
    assert problems == []
    assert res["served_tokens_max"] < TCFG.vocab_size
    assert res["graph_max_abs_diff"] == 0.0
    assert res["forward_max_abs_diff"] <= res["forward_bound"]
    assert res["quantized_bytes"] == chip_smoke.tree_bytes(
        tr.abstract_quantize(TCFG, recipe="w4-weights-only"))

"""Whisper-large-v3 backbone, encoder-decoder (twin of
``repro.models.whisper``).

The conv / mel frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings (B, n_audio_ctx, d_model), the output
the two stride-2 convs would give.  Everything after it is here:
sinusoidal encoder positions, ``n_enc_layers`` encoder and ``n_layers``
decoder layers (pre-layer-norm blocks with biases, a tanh-GELU MLP),
cross attention over the encoder memory, learned decoder positions
(extended to 32768, as in JAX) and the head tied to the embedding.

Layer parameters are stacked along a leading L axis (``enc_layers``,
``dec_layers``) and run by a Python loop over ``dense_lm.layer_params``
slices.  The cache holds the decoder's self-attention rows and the cross
attention's K and V of the ``n_audio_ctx`` memory rows, computed once by
:func:`prefill` and read by every :func:`decode_step`; there is no int8
variant (JAX's ``init_cache`` ignores ``kv_cache_dtype``) and no ragged
prefill.  As in ``dense_lm``, the port writes the rows of the cache it is
given in place and returns it with the new ``lengths``; a decode write
past ``max_len`` is dropped.  A decode step reads nothing back to the
host, so it captures in a CUDA graph.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import nn
from ..core import policy as pol
from .config import ArchConfig
from .dense_lm import (_layer_cache, _write_rows, decode_rows, layer_params,
                       layer_stack)

QUANT_RULES = [
    (r"embed", pol.KIND_EMBEDDING),
    (r"pos", pol.KIND_SKIP),
    (r"lm_head", pol.KIND_HEAD),
    (r"(ln|norm|gamma|b_|bias)", pol.KIND_SKIP),
    (r"(self|cross)/w[qkvo]$", pol.KIND_DENSE),
    (r"mlp/w\d$", pol.KIND_DENSE),
]

MAX_TARGET_POSITIONS = 32768  # extended from whisper's 448, as in JAX


def _sinusoid(n_pos: int, d: int) -> np.ndarray:
    """The encoder's position table, computed in float64 and cast to f32
    (the JAX package's numbers exactly)."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Float parameters from a torch generator seeded with ``seed``: the
    JAX package's tree, shapes and laws (lecun-normal matrices, zero
    biases, unit layer-norm gains, truncated-normal embedding and decoder
    positions), other numbers.  The head is the embedding (tied).  On
    ``device="meta"`` every leaf is shape-only."""
    device = torch.device(device)
    g = nn.generator(seed, device)
    D, F = cfg.d_model, cfg.d_ff

    def stacked(L, shape):
        return nn.stacked(L, shape, nn.lecun_normal, g, device)

    def fill(L, value, width):
        return torch.full((L, width), value, dtype=torch.float32,
                          device=device)

    def attn(L):
        return {"wq": stacked(L, (D, cfg.q_dim)),
                "wk": stacked(L, (D, cfg.kv_dim)),
                "wv": stacked(L, (D, cfg.kv_dim)),
                "wo": stacked(L, (cfg.q_dim, D)),
                "b_q": fill(L, 0.0, cfg.q_dim),
                "b_v": fill(L, 0.0, cfg.kv_dim),
                "b_o": fill(L, 0.0, D)}

    def mlp(L):
        return {"w1": stacked(L, (D, F)), "b_1": fill(L, 0.0, F),
                "w2": stacked(L, (F, D)), "b_2": fill(L, 0.0, D)}

    def norms(L, *names):
        out = {}
        for n in names:
            out[f"{n}_g"] = fill(L, 1.0, D)
            out[f"{n}_b"] = fill(L, 0.0, D)
        return out

    n_enc = cfg.n_enc_layers or cfg.n_layers
    enc = {**norms(n_enc, "ln1", "ln2"), "self": attn(n_enc),
           "mlp": mlp(n_enc)}
    L = cfg.n_layers
    dec = {**norms(L, "ln1", "lnx", "ln2"), "self": attn(L),
           "cross": attn(L), "mlp": mlp(L)}
    return {
        "embed": nn.trunc_normal((cfg.padded_vocab, D), g, device),
        "pos_dec": nn.trunc_normal((MAX_TARGET_POSITIONS, D), g, device,
                                   std=0.01),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_ln_g": torch.ones((D,), device=device),
        "enc_ln_b": torch.zeros((D,), device=device),
        "dec_ln_g": torch.ones((D,), device=device),
        "dec_ln_b": torch.zeros((D,), device=device),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _heads(cfg: ArchConfig, t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], n, cfg.head_dim)


def _q(cfg: ArchConfig, ap, x):
    return _heads(cfg, nn.dense(x, ap["wq"], ap["b_q"]), cfg.n_heads)


def _kv(cfg: ArchConfig, ap, x):
    """K (no bias, as in whisper) and V of ``x``, split into heads."""
    return (_heads(cfg, nn.dense(x, ap["wk"]), cfg.n_kv_heads),
            _heads(cfg, nn.dense(x, ap["wv"], ap["b_v"]), cfg.n_kv_heads))


def _out(cfg: ArchConfig, ap, o):
    return nn.dense(o.reshape(o.shape[0], o.shape[1], cfg.q_dim), ap["wo"],
                    ap["b_o"])


def _mha(cfg: ArchConfig, ap, xq, xkv, causal: bool, kv=None):
    """Attention of ``xq`` over ``xkv`` (or over the precomputed ``kv``)
    through the projections of ``ap``."""
    k, v = _kv(cfg, ap, xkv) if kv is None else kv
    return _out(cfg, ap, nn.flash_attention(_q(cfg, ap, xq), k, v,
                                            causal=causal))


def _mlp(mp, x):
    return nn.dense(nn.gelu(nn.dense(x, mp["w1"], mp["b_1"])), mp["w2"],
                    mp["b_2"])


def _ln(x, lp, name):
    return nn.layer_norm(x, lp[f"{name}_g"], lp[f"{name}_b"])


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d_model), the stub frontend's output -> the encoder
    memory (B, T, d_model) in ``cfg.dtype``."""
    if frames is None:
        raise ValueError("whisper needs frames: the encoder's input "
                         "(B, n_audio_ctx, d_model) was not given")
    dtype = getattr(torch, cfg.dtype)
    pos = torch.from_numpy(_sinusoid(frames.shape[1], cfg.d_model))
    x = frames.to(dtype) + pos.to(device=frames.device, dtype=dtype)[None]
    for lp in layer_stack(params["enc_layers"], cfg.n_enc_layers
                          or cfg.n_layers):
        h = _ln(x, lp, "ln1")
        x = x + _mha(cfg, lp["self"], h, h, causal=False)
        x = x + _mlp(lp["mlp"], _ln(x, lp, "ln2"))
    return nn.layer_norm(x, params["enc_ln_g"], params["enc_ln_b"])


def _embed(cfg: ArchConfig, params, tokens, positions):
    """Token embeddings plus the learned positions at ``positions``
    (a tensor: gathered on the device), in ``cfg.dtype``."""
    dtype = getattr(torch, cfg.dtype)
    x = nn.embed(tokens, params["embed"]).to(dtype)
    return x + params["pos_dec"][positions].to(dtype)


def _head(params, x):
    x = nn.layer_norm(x, params["dec_ln_g"], params["dec_ln_b"])
    return nn.tied_head(x, params["embed"])


# ---------------------------------------------------------------------------
# forward / cache / prefill / decode
# ---------------------------------------------------------------------------


def _dec_layer(cfg: ArchConfig, lp, x, memory):
    h = _ln(x, lp, "ln1")
    x = x + _mha(cfg, lp["self"], h, h, causal=True)
    x = x + _mha(cfg, lp["cross"], _ln(x, lp, "lnx"), memory, causal=False)
    return x + _mlp(lp["mlp"], _ln(x, lp, "ln2"))


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, frames=None,
            memory=None, remat: bool = True) -> torch.Tensor:
    """Teacher-forced decode over the whole target: tokens (B, S) and
    ``frames`` (or the encoder ``memory``) -> logits (B, S,
    padded_vocab) in ``cfg.dtype``.  While autograd records, each decoder
    layer is rematerialised in the backward (``nn.remat``), as JAX
    checkpoints its decoder scan; a plain loop under ``torch.no_grad()``."""
    if memory is None:
        memory = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens, torch.arange(S, device=tokens.device))
    layer = partial(_dec_layer, cfg)
    for lp in layer_stack(params["dec_layers"], cfg.n_layers):
        x = nn.remat(layer, lp, x, memory) if remat else layer(lp, x, memory)
    return _head(params, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty cache: the decoder's self-attention rows (L, B, max_len,
    Hkv, D) and the cross attention's K / V (L, B, n_audio_ctx, Hkv, D),
    all of ``dtype``."""
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(rows):
        return torch.zeros((L, batch, rows, Hkv, hd), dtype=dtype,
                           device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.n_audio_ctx), "xv": zeros(cfg.n_audio_ctx),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def prefill(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor,
            frames=None):
    """Encode ``frames``, fill the cross K / V of every decoder layer and
    the self-attention rows of the (B, S) prompts; returns (the last
    position's logits (B, 1, padded_vocab), cache)."""
    memory = encode(cfg, params, frames)
    B, S = tokens.shape
    if memory.shape[1] != cache["xk"].shape[2]:
        raise ValueError(f"frames of {memory.shape[1]} rows, a cache of "
                         f"{cache['xk'].shape[2]} cross rows")
    x = _embed(cfg, params, tokens, torch.arange(S, device=tokens.device))
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        kv = _layer_cache(cache, i)
        h = _ln(x, lp, "ln1")
        q = _q(cfg, lp["self"], h)
        k, v = _kv(cfg, lp["self"], h)
        kv["k"][:, :S] = k.to(kv["k"].dtype)
        kv["v"][:, :S] = v.to(kv["v"].dtype)
        x = x + _out(cfg, lp["self"], nn.flash_attention(q, k, v,
                                                         causal=True))
        xk, xv = _kv(cfg, lp["cross"], memory)
        kv["xk"].copy_(xk)
        kv["xv"].copy_(xv)
        x = x + _mha(cfg, lp["cross"], _ln(x, lp, "lnx"), None,
                     causal=False, kv=(xk, xv))
        x = x + _mlp(lp["mlp"], _ln(x, lp, "ln2"))
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return _head(params, x[:, -1:]), {**cache, "lengths": lengths}


def decode_step(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, padded_vocab), the cache with each
    token's self-attention K / V written at row ``lengths`` and
    ``lengths + 1``); cross attention reads all ``n_audio_ctx`` memory
    rows."""
    lengths = cache["lengths"] + 1  # include the new token
    rows = decode_rows(lengths, cache["k"].shape[2])
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens, (lengths - 1).to(torch.int64)[:, None])
    full = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        kv = _layer_cache(cache, i)
        h = _ln(x, lp, "ln1")
        q = _q(cfg, lp["self"], h)
        k, v = _kv(cfg, lp["self"], h)
        _write_rows(kv["k"], k[:, 0], rows)
        _write_rows(kv["v"], v[:, 0], rows)
        o = nn.decode_attention(q, kv["k"], kv["v"], lengths)
        x = x + _out(cfg, lp["self"], o)
        qx = _q(cfg, lp["cross"], _ln(x, lp, "lnx"))
        ox = nn.decode_attention(qx, kv["xk"], kv["xv"], full)
        x = x + _out(cfg, lp["cross"], ox)
        x = x + _mlp(lp["mlp"], _ln(x, lp, "ln2"))
    return _head(params, x), {**cache, "lengths": lengths}

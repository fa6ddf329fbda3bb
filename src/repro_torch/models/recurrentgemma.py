"""RecurrentGemma / Griffin hybrid (twin of ``repro.models.recurrentgemma``):
RG-LRU recurrent blocks and local attention, layer i attention iff
``i % 3 == 2`` (rec, rec, attn groups; 38 = 12 x 3 + 2 leaves two
recurrent layers at the tail): recurrentgemma-9b.

The recurrent layers' parameters are one stack (``rec``, in layer order)
and the attention layers' another (``attn``), each run by slices
(``dense_lm.layer_stack``).  Local attention keeps a ring-buffer KV
cache of ``W = min(window, max_len)`` rows, RoPE applied at write time,
row ``(len - 1) % W`` written by each decode step, attention over
``min(len, W)`` rows; the RG-LRU state (f32) and the temporal conv's last
``conv1d_width - 1`` inputs carry the recurrence.  The ring write and the
valid-row count are tensor operations with no host read, so a CUDA graph
captures the decode step; where JAX returns a new cache, the port writes
the given one in place.  JAX's recurrentgemma never reads
``kv_cache_dtype``: the ring is a float cache.  Prefill takes unpadded
prompts of one length (no ``RAGGED_PREFILL``).
"""
from __future__ import annotations

from functools import partial

import torch

from .. import nn
from ..core import policy as pol
from .config import ArchConfig
from .dense_lm import layer_stack

FFN_FOLD_GROUPS = [
    (r"rec/mlp/w1$", r"rec/mlp/w3$", r"rec/mlp/w2$"),
    (r"attn/mlp/w1$", r"attn/mlp/w3$", r"attn/mlp/w2$"),
]

QUANT_RULES = [
    (r"embed", pol.KIND_EMBEDDING),
    (r"lm_head", pol.KIND_HEAD),
    (r"(ln|norm|gamma|lam|conv_b|b_)", pol.KIND_SKIP),
    (r"conv_w", pol.KIND_SKIP),  # (4, R) temporal conv: tiny, bf16
    (r"(wa|wx|w_in1|w_in2|w_out)$", pol.KIND_DENSE),
    (r"attn/w[qkvo]$", pol.KIND_DENSE),
    (r"mlp/w\d$", pol.KIND_DENSE),
]


def n_attn_layers(cfg: ArchConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if i % 3 == 2)


def n_rec_layers(cfg: ArchConfig) -> int:
    return cfg.n_layers - n_attn_layers(cfg)


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.lru_width or cfg.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Float parameters from a torch generator seeded with ``seed``: the
    JAX package's tree, shapes and laws (lecun-normal matrices per layer,
    a truncated-normal conv filter (std 0.1) and embedding, zero biases,
    ``lam`` a linspace from 0.5 to 4, unit norms), other numbers.  On
    ``device="meta"`` every leaf is shape-only."""
    device = torch.device(device)
    g = nn.generator(seed, device)
    D, R, F = cfg.d_model, _lru_width(cfg), cfg.d_ff
    nr, na = n_rec_layers(cfg), n_attn_layers(cfg)

    def stacked(n, shape, draw=nn.lecun_normal):
        return nn.stacked(n, shape, draw, g, device)

    def fill(n, value, shape):
        return torch.full((n,) + shape, value, dtype=torch.float32,
                          device=device)

    def mlp(n):
        return {"w1": stacked(n, (D, F)), "w3": stacked(n, (D, F)),
                "w2": stacked(n, (F, D))}

    lam = torch.linspace(0.5, 4.0, R, dtype=torch.float32, device=device)
    rec = {
        "ln1": fill(nr, 1.0, (D,)), "ln2": fill(nr, 1.0, (D,)),
        "mix": {
            "w_in1": stacked(nr, (D, R)), "w_in2": stacked(nr, (D, R)),
            "w_out": stacked(nr, (R, D)),
            "conv_w": stacked(nr, (cfg.conv1d_width, R),
                              partial(nn.trunc_normal, std=0.1)),
            "conv_b": fill(nr, 0.0, (R,)),
            "wa": stacked(nr, (R, R)), "wx": stacked(nr, (R, R)),
            "ba": fill(nr, 0.0, (R,)), "bx": fill(nr, 0.0, (R,)),
            # so that a ~ U(0.9, 0.999) at r = 1 (Griffin's appendix)
            "lam": lam.expand(nr, R).clone(),
        },
        "mlp": mlp(nr),
    }
    attn = {
        "ln1": fill(na, 1.0, (D,)), "ln2": fill(na, 1.0, (D,)),
        "attn": {"wq": stacked(na, (D, cfg.q_dim)),
                 "wk": stacked(na, (D, cfg.kv_dim)),
                 "wv": stacked(na, (D, cfg.kv_dim)),
                 "wo": stacked(na, (cfg.q_dim, D))},
        "mlp": mlp(na),
    }
    return {
        "embed": nn.trunc_normal((cfg.padded_vocab, D), g, device),
        "rec": rec,
        "attn": attn,
        "final_norm": torch.ones((D,), device=device),
        "lm_head": nn.lecun_normal((D, cfg.padded_vocab), g, device),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _mlp(lp, x):
    m = lp["mlp"]
    return nn.swiglu(nn.rms_norm(x, lp["ln2"]), m["w1"], m["w3"], m["w2"])


def _rec_mix(cfg: ArchConfig, mp, x, h0, conv0):
    """The Griffin recurrent mixer over x (B, T, D) from state (h0,
    conv0); returns (y, h_T, conv state)."""
    u = nn.dense(x, mp["w_in1"])
    gate = nn.gelu(nn.dense(x, mp["w_in2"]))
    u, conv_state = nn.temporal_conv1d(u, mp["conv_w"], mp["conv_b"],
                                       state=conv0)
    h_final, h = nn.rg_lru(u, h0, mp)
    return nn.dense(h * gate, mp["w_out"]), h_final, conv_state


def _rec_layer(cfg: ArchConfig, lp, x, h0, conv0):
    y, h, cs = _rec_mix(cfg, lp["mix"], nn.rms_norm(x, lp["ln1"]), h0, conv0)
    x = x + y
    return x + _mlp(lp, x), h, cs


def _qkv(cfg: ArchConfig, lp, x, positions):
    a = lp["attn"]
    h = nn.rms_norm(x, lp["ln1"])
    B, S = x.shape[0], x.shape[1]
    q = nn.dense(h, a["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = nn.dense(h, a["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = nn.dense(h, a["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(cfg: ArchConfig, lp, x, o):
    B, S = x.shape[0], x.shape[1]
    x = x + nn.dense(o.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
    return x + _mlp(lp, x)


def _attn_layer(cfg: ArchConfig, lp, x, positions):
    q, k, v = _qkv(cfg, lp, x, positions)
    o = nn.flash_attention(q, k, v, causal=True, window=cfg.window)
    return _attn_out(cfg, lp, x, o)


def _layers(cfg: ArchConfig, params):
    """(is attention, the layer's parameters, its index in its stack), in
    layer order (``dense_lm.layer_stack`` views of the two stacks)."""
    stacks = {True: layer_stack(params["attn"], n_attn_layers(cfg)),
              False: layer_stack(params["rec"], n_rec_layers(cfg))}
    taken = {True: 0, False: 0}
    for i in range(cfg.n_layers):
        is_attn = i % 3 == 2
        j = taken[is_attn]
        taken[is_attn] += 1
        yield is_attn, stacks[is_attn][j], j


# ---------------------------------------------------------------------------
# forward (train / prefill shape)
# ---------------------------------------------------------------------------


def _rec_out(cfg: ArchConfig, lp, x, h0, conv0):
    return _rec_layer(cfg, lp, x, h0, conv0)[0]


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            remat: bool = True) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) in ``cfg.dtype``, from
    zero states, the attention windowed.  While autograd records, each
    layer is rematerialised in the backward (``nn.remat``; JAX
    checkpoints each (rec, rec, attn) group of its scan); a plain loop
    under ``torch.no_grad()``."""
    dtype = getattr(torch, cfg.dtype)
    x = nn.embed(tokens, params["embed"]).to(dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    R = _lru_width(cfg)
    for is_attn, lp, _ in _layers(cfg, params):
        if is_attn:
            fn, args = partial(_attn_layer, cfg), (lp, x, positions)
        else:
            h0 = torch.zeros((B, R), device=x.device)
            c0 = torch.zeros((B, cfg.conv1d_width - 1, R), dtype=dtype,
                             device=x.device)
            fn, args = partial(_rec_out, cfg), (lp, x, h0, c0)
        x = nn.remat(fn, *args) if remat else fn(*args)
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"])


# ---------------------------------------------------------------------------
# decode (ring-buffer local attention + carried LRU/conv state)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero states: ``h`` (nr, B, R) f32, ``conv`` (nr, B, conv1d_width -
    1, R) and the rings ``k`` / ``v`` (na, B, W, Hkv, hd) in ``dtype``,
    ``W = min(window, max_len)``."""
    R = _lru_width(cfg)
    W = min(cfg.window or max_len, max_len)
    nr, na = n_rec_layers(cfg), n_attn_layers(cfg)
    ring = (na, batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {
        "h": torch.zeros((nr, batch, R), device=device),
        "conv": torch.zeros((nr, batch, cfg.conv1d_width - 1, R),
                            dtype=dtype, device=device),
        "k": torch.zeros(ring, dtype=dtype, device=device),
        "v": torch.zeros(ring, dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _attn_decode(cfg: ArchConfig, lp, x, kc, vc, lengths):
    """Ring-buffer windowed decode over kc / vc (B, W, Hkv, hd), written in
    place at slot ``(lengths - 1) % W``."""
    B, W = x.shape[0], kc.shape[1]
    q, k, v = _qkv(cfg, lp, x, (lengths - 1)[:, None])  # rope at write time
    slot = ((lengths - 1) % W).to(torch.int64)
    bidx = torch.arange(B, device=x.device)
    kc[bidx, slot] = k[:, 0].to(kc.dtype)
    vc[bidx, slot] = v[:, 0].to(vc.dtype)
    # ring semantics: min(length, W) valid slots, their order irrelevant
    o = nn.decode_attention(q, kc, vc, torch.clamp(lengths, max=W))
    return _attn_out(cfg, lp, x, o)


def _rec_decode(cfg: ArchConfig, lp, x, h0, conv0):
    mp = lp["mix"]
    hx = nn.rms_norm(x, lp["ln1"])
    u = nn.dense(hx, mp["w_in1"])
    gate = nn.gelu(nn.dense(hx, mp["w_in2"]))
    u, conv_state = nn.temporal_conv1d(u, mp["conv_w"], mp["conv_b"],
                                       state=conv0)
    h_new, y = nn.rg_lru_step(u[:, 0], h0, mp)
    x = x + nn.dense(y[:, None] * gate, mp["w_out"])
    return x + _mlp(lp, x), h_new, conv_state


def _ring_fill(kc: torch.Tensor, k: torch.Tensor) -> None:
    """Write the last ``min(S, W)`` rows of k (B, S, ...) into ring slots
    ``position % W``, in place."""
    S, W = k.shape[1], kc.shape[1]
    take = torch.arange(max(S - W, 0), S, device=k.device)
    kc[:, take % W] = k[:, take].to(kc.dtype)


def prefill(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """(B, S) prompts of one length from the cache's states; returns
    (last-token logits (B, 1, padded_vocab), the cache with the LRU and
    conv states and the rings written in place and ``lengths + S``)."""
    x = nn.embed(tokens, params["embed"]).to(getattr(torch, cfg.dtype))
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    for is_attn, lp, j in _layers(cfg, params):
        if is_attn:
            q, k, v = _qkv(cfg, lp, x, positions)
            _ring_fill(cache["k"][j], k)
            _ring_fill(cache["v"][j], v)
            o = nn.flash_attention(q, k, v, causal=True, window=cfg.window)
            x = _attn_out(cfg, lp, x, o)
        else:
            x, h, cs = _rec_layer(cfg, lp, x, cache["h"][j],
                                  cache["conv"][j])
            cache["h"][j] = h
            cache["conv"][j] = cs
    x = nn.rms_norm(x[:, -1:], params["final_norm"])
    return nn.dense(x, params["lm_head"]), {**cache,
                                            "lengths": cache["lengths"] + S}


def decode_step(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, padded_vocab), the cache advanced in
    place with ``lengths + 1``).  Every slot advances, idle ones too."""
    lengths = cache["lengths"] + 1
    x = nn.embed(tokens, params["embed"]).to(getattr(torch, cfg.dtype))
    for is_attn, lp, j in _layers(cfg, params):
        if is_attn:
            x = _attn_decode(cfg, lp, x, cache["k"][j], cache["v"][j],
                             lengths)
        else:
            x, h, cs = _rec_decode(cfg, lp, x, cache["h"][j],
                                   cache["conv"][j])
            cache["h"][j] = h
            cache["conv"][j] = cs
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"]), {**cache, "lengths": lengths}


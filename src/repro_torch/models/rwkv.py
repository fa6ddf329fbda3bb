"""RWKV6 (Finch), an attention-free LM with data-dependent decay (twin of
``repro.models.rwkv``): rwkv6-3b.

Every projection (time-mix r/k/v/g/o, channel-mix r/k/v) is a
quantizable weight; the recurrence itself is activation-side.  Layer
parameters are stacked along a leading L axis and run by a Python loop
over ``dense_lm.layer_params`` slices, as ``models.dense_lm`` does.

The decode state is O(1) in the sequence: per layer the last token of
the time mix and of the channel mix (``tm_prev``, ``cm_prev``, (L, B, D)
f32) and the WKV state ((L, B, H, d, d) f32).  Where JAX returns a new
cache, :func:`prefill` and :func:`decode_step` write the given cache in
place and return it with the new ``lengths`` (S more at prefill, one
more a step), so a CUDA graph can capture the decode step.  A prefill
takes unpadded prompts of one length (no ``RAGGED_PREFILL``: the state
must not see padding); the token Engine groups prompts by exact length.
"""
from __future__ import annotations

from functools import partial

import torch

from .. import nn
from ..core import policy as pol
from .config import ArchConfig
from .dense_lm import layer_params, layer_stack

FFN_FOLD_GROUPS = [(r"cm/cw_k$", None, r"cm/cw_v$")]

QUANT_RULES = [
    (r"embed", pol.KIND_EMBEDDING),
    (r"lm_head", pol.KIND_HEAD),
    (r"(ln|norm|gamma|mu_|w0|w_lora|u$|gn)", pol.KIND_SKIP),
    (r"tm/w[rkvgo]$", pol.KIND_DENSE),
    (r"cm/cw_[rkv]$", pol.KIND_DENSE),
]

_LORA_DIM = 64


def _uniform(shape, g, device):
    return torch.rand(shape, generator=g, device=device, dtype=torch.float32)


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Float parameters from a torch generator seeded with ``seed``: the
    JAX package's tree, shapes and laws (uniform token-shift mixes,
    lecun-normal projections, truncated-normal LoRA, bonus and
    embedding, decay bias -3, unit norms), other numbers.  On
    ``device="meta"`` every leaf is shape-only."""
    device = torch.device(device)
    g = nn.generator(seed, device)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H = D // cfg.rwkv_head_dim

    def stacked(shape, draw=nn.lecun_normal):
        return nn.stacked(L, shape, draw, g, device)

    def fill(value, shape):
        return torch.full((L,) + shape, value, dtype=torch.float32,
                          device=device)

    lora = partial(nn.trunc_normal, std=0.01)
    tm = {"mu_r": stacked((D,), _uniform), "mu_k": stacked((D,), _uniform),
          "mu_v": stacked((D,), _uniform), "mu_g": stacked((D,), _uniform),
          "mu_w": stacked((D,), _uniform),
          "wr": stacked((D, D)), "wk": stacked((D, D)),
          "wv": stacked((D, D)), "wg": stacked((D, D)),
          "wo": stacked((D, D)),
          "w_lora_a": stacked((D, _LORA_DIM), lora),
          "w_lora_b": stacked((_LORA_DIM, D), lora),
          "w0": fill(-3.0, (D,)),  # slow decay
          "u": stacked((H, cfg.rwkv_head_dim),
                       partial(nn.trunc_normal, std=0.02)),
          "gn": fill(1.0, (D,))}
    cm = {"mu_cr": stacked((D,), _uniform), "mu_ck": stacked((D,), _uniform),
          "cw_r": stacked((D, D)), "cw_k": stacked((D, F)),
          "cw_v": stacked((F, D))}
    return {
        "embed": nn.trunc_normal((cfg.padded_vocab, D), g, device),
        "ln0": torch.ones((D,), device=device),
        "layers": {"ln1": fill(1.0, (D,)), "ln2": fill(1.0, (D,)),
                   "tm": tm, "cm": cm},
        "final_norm": torch.ones((D,), device=device),
        "lm_head": nn.lecun_normal((D, cfg.padded_vocab), g, device),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _head_norm(out: torch.Tensor, gamma: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    """Per-head RMS group norm of the recurrence output, in f32, cast back
    to ``out``'s dtype."""
    B, T, D = out.shape
    x = out.reshape(B, T, n_heads, D // n_heads).to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + 1e-6)
    return (x.reshape(B, T, D) * gamma.to(torch.float32)).to(out.dtype)


def _shifted(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x shifted one token right, ``prev`` (B, D) entering first."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _timemix(cfg: ArchConfig, lp, x, prev, state):
    """x (B, T, D); prev (B, D), the token before this segment; state
    (B, H, d, d).  Returns (y, new prev, new state)."""
    H = cfg.d_model // cfg.rwkv_head_dim
    r, k, v, g, w = nn.rwkv6_timemix_inputs(x, _shifted(x, prev), lp, H)
    state, out = nn.rwkv6_attend(state, r, k, v, w, lp["u"])
    B, T = x.shape[0], x.shape[1]
    out = _head_norm(out.reshape(B, T, cfg.d_model).to(x.dtype), lp["gn"], H)
    return nn.dense(out * g, lp["wo"]), x[:, -1], state


def _channelmix(cfg: ArchConfig, lp, x, prev):
    return nn.rwkv6_channelmix(x, _shifted(x, prev), lp), x[:, -1]


def _layer(cfg: ArchConfig, lp, x, tm_prev, cm_prev, state):
    h = nn.rms_norm(x, lp["ln1"])
    y, tm_prev, state = _timemix(cfg, lp["tm"], h, tm_prev, state)
    x = x + y
    h = nn.rms_norm(x, lp["ln2"])
    y, cm_prev = _channelmix(cfg, lp["cm"], h, cm_prev)
    return x + y, tm_prev, cm_prev, state


# ---------------------------------------------------------------------------
# forward / cache / decode / prefill
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens):
    x = nn.embed(tokens, params["embed"]).to(getattr(torch, cfg.dtype))
    return nn.rms_norm(x, params["ln0"])


def _layer_out(cfg: ArchConfig, lp, x, tm_prev, cm_prev, state):
    return _layer(cfg, lp, x, tm_prev, cm_prev, state)[0]


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            remat: bool = True) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) in ``cfg.dtype``, from
    zero states; each layer rematerialised in the backward while autograd
    records (``nn.remat``), a plain loop under ``torch.no_grad()``."""
    x = _embed(cfg, params, tokens)
    st = init_cache(cfg, x.shape[0], 0, device=x.device)
    layer = partial(_layer_out, cfg)
    for i, lp in enumerate(layer_stack(params["layers"], cfg.n_layers)):
        args = (lp, x, st["tm_prev"][i], st["cm_prev"][i], st["state"][i])
        x = nn.remat(layer, *args) if remat else layer(*args)
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero states: ``tm_prev`` / ``cm_prev`` (L, B, D) and ``state`` (L, B,
    H, d, d), all f32 whatever ``dtype`` (and ``max_len``) say, as in
    JAX."""
    H, d = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    L, D = cfg.n_layers, cfg.d_model
    return {
        "tm_prev": torch.zeros((L, batch, D), device=device),
        "cm_prev": torch.zeros((L, batch, D), device=device),
        "state": torch.zeros((L, batch, H, d, d), device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _run(cfg: ArchConfig, params, cache: dict, x):
    """Every layer over x, from the cache's states, written back in place
    (the carried tokens as f32 from x's dtype)."""
    for i in range(cfg.n_layers):
        x, tm, cm, st = _layer(cfg, layer_params(params["layers"], i), x,
                               cache["tm_prev"][i], cache["cm_prev"][i],
                               cache["state"][i])
        cache["tm_prev"][i] = tm.to(torch.float32)
        cache["cm_prev"][i] = cm.to(torch.float32)
        cache["state"][i] = st
    return x


def decode_step(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, padded_vocab), the cache with its
    states advanced in place and ``lengths + 1``).  O(1) in the
    history."""
    x = _run(cfg, params, cache, _embed(cfg, params, tokens))
    x = nn.rms_norm(x, params["final_norm"])
    return nn.dense(x, params["lm_head"]), {**cache,
                                            "lengths": cache["lengths"] + 1}


def prefill(cfg: ArchConfig, params, cache: dict, tokens: torch.Tensor):
    """(B, S) prompts of one length through every layer from the cache's
    states; returns (last-token logits (B, 1, padded_vocab), the cache
    with the states written in place and ``lengths + S``)."""
    x = _run(cfg, params, cache, _embed(cfg, params, tokens))
    x = nn.rms_norm(x[:, -1:], params["final_norm"])
    S = tokens.shape[1]
    return nn.dense(x, params["lm_head"]), {**cache,
                                            "lengths": cache["lengths"] + S}

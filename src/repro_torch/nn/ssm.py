"""Attention-free sequence mixers (twin of ``repro.nn.ssm``): RWKV6
(Finch) and RG-LRU (Griffin / RecurrentGemma).

Both are first-order linear recurrences.  RWKV6 carries a matrix state
(dk x dv per head) updated by a rank-1 term each token; JAX scans it in
checkpointed chunks, the port runs :func:`rwkv6_attend_step` once per
token, the same function (JAX's pad steps decay by 1 and add 0).  RG-LRU
has a diagonal state; JAX runs ``jax.lax.associative_scan`` over T, the
port the doubling (Hillis-Steele) scan over the same combine: log2(T)
whole-tensor steps, the float products in another order.

Casts are JAX's: the RWKV decay is rounded to the activation dtype before
the f32 recurrence, the RG-LRU gates and state run in f32 and the output
is cast back, and the temporal conv sums its taps in the activation dtype
in tap order.  Decode uses the ``*_step`` functions with carried state.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .layers import dense, silu

# ---------------------------------------------------------------------------
# RWKV6 time mix (Finch: data-dependent decay via a small LoRA)
# ---------------------------------------------------------------------------


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def rwkv6_decay(x_mixed: torch.Tensor, params) -> torch.Tensor:
    """w_t in (0, 1): ``exp(-exp(w0 + tanh(x @ A) @ B))`` in f32."""
    lora = torch.tanh(x_mixed @ params["w_lora_a"].to(x_mixed.dtype))
    logw = params["w0"].to(torch.float32) + (
        lora @ params["w_lora_b"].to(lora.dtype)).to(torch.float32)
    return torch.exp(-torch.exp(logw))


def rwkv6_timemix_inputs(x: torch.Tensor, x_prev: torch.Tensor, params,
                         n_heads: int):
    """Project a (..., D) slice into per-head r, k, v, w (..., H, d) and
    the gate g (..., D); ``x_prev`` is the token-shifted x (the previous
    token, or the carried decode state)."""
    D = x.shape[-1]
    hd = D // n_heads
    r = dense(_lerp(x, x_prev, params["mu_r"]), params["wr"])
    k = dense(_lerp(x, x_prev, params["mu_k"]), params["wk"])
    v = dense(_lerp(x, x_prev, params["mu_v"]), params["wv"])
    g = silu(dense(_lerp(x, x_prev, params["mu_g"]), params["wg"]))
    w = rwkv6_decay(_lerp(x, x_prev, params["mu_w"]), params)

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, hd)

    return heads(r), heads(k), heads(v), g, heads(w.to(x.dtype))


def rwkv6_attend_step(state: torch.Tensor, r, k, v, w, u):
    """One recurrence step.  state (B, H, dk, dv) f32; r, k, v, w (B, H,
    d); u (H, d) bonus.  ``out = r . (S + (u k) (x) v)``, ``S' = diag(w)
    S + k (x) v``; returns (new state, out (B, H, dv) f32)."""
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    rf = r.to(torch.float32)
    kv = kf[..., :, None] * vf[..., None, :]  # (B, H, dk, dv)
    out = torch.einsum("bhk,bhkv->bhv", rf * u[None].to(torch.float32), kv) \
        + torch.einsum("bhk,bhkv->bhv", rf, state)
    new_state = state * w.to(torch.float32)[..., :, None] + kv
    return new_state, out


def rwkv6_attend(state: torch.Tensor, r, k, v, w, u):
    """The recurrence over a sequence: r, k, v, w (B, T, H, d); returns
    (final state (B, H, d, d) f32, out (B, T, H, d) f32)."""
    st = state.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        st, o = rwkv6_attend_step(st, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(o)
    return st, torch.stack(outs, dim=1)


def rwkv6_channelmix(x: torch.Tensor, x_prev: torch.Tensor,
                     params) -> torch.Tensor:
    xr = _lerp(x, x_prev, params["mu_cr"])
    xk = _lerp(x, x_prev, params["mu_ck"])
    r = torch.sigmoid(dense(xr, params["cw_r"]))
    k = torch.square(torch.relu(dense(xk, params["cw_k"])))
    return r * dense(k, params["cw_v"])


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rg_lru_gates(x: torch.Tensor, params):
    """f32 ``a_t`` (decay) and gated input for ``h_t = a h_{t-1} +
    sqrt(1 - a^2) (i * x)``."""
    rgate = torch.sigmoid(dense(x, params["wa"], params.get("ba")))
    igate = torch.sigmoid(dense(x, params["wx"], params.get("bx")))
    log_a = -_RGLRU_C * torch.nn.functional.softplus(
        params["lam"].to(torch.float32)) * rgate.to(torch.float32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * igate.to(torch.float32) * x.to(torch.float32)
    return a, gated


def rg_lru(x: torch.Tensor, h0: torch.Tensor, params):
    """x (B, T, R); h0 (B, R).  Returns (h_T (B, R) f32, y (B, T, R) in
    x's dtype): ``h0`` folded into the first step, then the doubling scan
    of ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, b_r + a_r b_l)``."""
    a, b = rg_lru_gates(x, params)  # (B, T, R) f32
    b = b.clone()
    b[:, 0] = b[:, 0] + a[:, 0] * h0.to(torch.float32)
    T, off = x.shape[1], 1
    while off < T:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b[:, -1], b.to(x.dtype)


def rg_lru_step(x: torch.Tensor, h: torch.Tensor, params):
    """One decode step: x (B, R); h (B, R) f32 -> (h', y in x's dtype)."""
    a, b = rg_lru_gates(x[:, None], params)
    h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return h_new, h_new.to(x.dtype)


def temporal_conv1d(x: torch.Tensor, w: torch.Tensor, b=None,
                    state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise temporal conv of width W: x (B, T, R), w (W, R).
    Returns (y, new state), the state being the last W - 1 inputs (the
    decode carry); ``state`` None pads with zeros."""
    W = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + T] * w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else x[:, :0]
    return y, new_state

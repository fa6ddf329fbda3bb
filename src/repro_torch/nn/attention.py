"""Attention primitives (twin of ``repro.nn.attention``): RoPE, causal GQA
attention for prefill, decode attention over float and int8 KV caches,
the int8 cache-row quantizer, and EfficientViT's ReLU linear attention.

Masks are finite (``-1e30``), as in the JAX package, so a fully masked row
softmaxes to a uniform average instead of NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.quant import div
from ..kernels import ops
from ..kernels.decode_attn_int8 import decode_attn_int8_plain

NEG_INF = -1.0e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.full((), theta, device=device),
                     div(-2.0 * i, float(head_dim)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) int -> x rotated by split
    halves, computed in f32 and cast back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------------


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``exp(s - max) / sum`` over the last axis (jax.nn.softmax)."""
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with the JAX package's masks, in f32 torch ops:
    q (B, S, Hq, D), k/v (B, T, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    JAX chunks this into an online softmax so 32k-token prefills never
    hold an (S, T) score matrix; the port computes the same function (up
    to f32 summation order) in one pass over the whole f32 score matrix
    (B, Hkv, G, S, T), as large as the caller's shapes make it: a token
    prefill's at most ``max_len`` x ``max_len`` a head, whisper's encoder
    1500 x 1500 a head (1.44 GB a layer at batch 8 and 20 heads), its
    cross attention S x 1500."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, S, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bshgd,bthd->bhgst", qh, k.to(torch.float32)) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    t_valid = T if kv_len is None else kv_len
    valid = k_pos < t_valid
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window is not None:
        valid = valid & ((q_pos - k_pos) < window)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    out = torch.einsum("bhgst,bthd->bshgd", _softmax(s),
                       v.to(torch.float32))
    return out.reshape(B, S, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention over a KV cache (one new token per sequence)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Float-cache decode: q (B, 1, Hq, D); caches (B, T, Hkv, D); lengths
    (B,) valid rows per sequence, the new token included."""
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qh,
                     k_cache.to(torch.float32)) * scale
    pos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.reshape(-1, 1).to(torch.int64)
    valid = pos < lens
    if window is not None:
        valid = valid & (pos >= lens - window)
    s = torch.where(valid[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    out = torch.einsum("bhgt,bthd->bhgd", _softmax(s),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def decode_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                          v_q: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Fully integer decode over the int8 cache (int8 QK^T with q
    quantized per row, per-row k scales folded into the scores, softmax
    weights requantized to int8 with the v scales folded in, int8 PV):
    the ``decode_attn_int8`` kernel through ``kernels.ops`` where the attn
    axis is on, the plain chain (``decode_attn_int8_plain``) where it is
    off."""
    if ops.attn_dispatch_enabled(q.device):
        return ops.decode_attn_int8_op(q, k_q, v_q, k_scale, v_scale,
                                       lengths, window=window, scale=scale)
    B, _, Hq, D = q.shape
    Hkv = k_q.shape[2]
    out = decode_attn_int8_plain(
        q.reshape(B, Hkv, Hq // Hkv, D), k_q, v_q, k_scale, v_scale,
        lengths.to(torch.int32),
        scale if scale is not None else 1.0 / math.sqrt(D), window)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def quantize_kv_rows(x: torch.Tensor):
    """(..., Hkv, D) -> (int8 rows, (..., Hkv) f32 scales), one scale per
    (row, head): ``s = max|x|/127 + 1e-9``, ``clip(rne(x/s), +-127)``."""
    xf = x.to(torch.float32)
    s = div(torch.amax(torch.abs(xf), dim=-1), 127.0) + 1e-9
    q = torch.clamp(torch.round(div(xf, s[..., None])), -127, 127)
    return q.to(torch.int8), s


# ---------------------------------------------------------------------------
# EfficientViT ReLU linear attention
# ---------------------------------------------------------------------------


def relu_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          attn: str, eps: float = 1e-6) -> torch.Tensor:
    """Softmax-free global attention, linear in N; q/k/v (B, N, H, D).

    ``attn="f32"``: ``(q' (k'^T v)) / (q' sum(k'))`` in f32 einsums with
    q' = relu(q), k' = relu(k).  ``attn="int8"``: the fused int8 kernel
    (``kernels.relu_attn``, after ``kernels.relu_attn_scales``), which
    quantizes q/k/v and stores q's dtype -- numerics move by int8
    quantization error."""
    if attn == ops.ATTN_INT8:
        return ops.relu_attn_op(q, k, v, eps=eps)
    if attn != ops.ATTN_F32:
        raise ValueError(f"attn must be {ops.ATTN_INT8!r} or "
                         f"{ops.ATTN_F32!r}, got {attn!r}")
    qr = torch.relu(q).to(torch.float32)
    kr = torch.relu(k).to(torch.float32)
    vf = v.to(torch.float32)
    kv = torch.einsum("bnhd,bnhe->bhde", kr, vf)
    num = torch.einsum("bnhd,bhde->bnhe", qr, kv)
    ksum = torch.sum(kr, dim=1)
    den = torch.einsum("bnhd,bhd->bnh", qr, ksum)[..., None]
    return (num / (den + eps)).to(q.dtype)

"""EfficientViT ReLU linear attention (twin of
``repro.nn.attention.relu_linear_attention``)."""
from __future__ import annotations

import torch

from ..kernels import ops


def relu_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          attn: str, eps: float = 1e-6) -> torch.Tensor:
    """Softmax-free global attention, linear in N; q/k/v (B, N, H, D).

    ``attn="f32"``: ``(q' (k'^T v)) / (q' sum(k'))`` in f32 einsums with
    q' = relu(q), k' = relu(k).  ``attn="int8"``: the fused int8 kernel
    (``kernels.relu_attn``), which quantizes q/k/v -- numerics move by
    int8 quantization error."""
    if attn == ops.ATTN_INT8:
        return ops.relu_attn_op(q, k, v, eps=eps).to(q.dtype)
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

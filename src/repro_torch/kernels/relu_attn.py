"""Int8 ReLU linear attention (EfficientViT's MSA token mixer).

Per (b, h): ``q8,k8 = quant(relu(.))``, ``v8 = quant(v)``; ``kv = k8^T v8``
and ``ksum`` in int32; kv requantized to int8 with
``skv = max(max|kv*sk*sv| / 127, 1e-8)``; ``num = q8 @ kv8``,
``den = q8 . ksum``; ``out = num*sq*skv / (den*sq*sk + eps)``.

The tensor-wide scales come from :func:`attn_scales` (post-ReLU max for
q and k, max-abs for v, over the whole batch -- one image's output depends
on its batchmates, as in the JAX package).  :func:`relu_attn` launches the
CUDA kernel (``csrc/relu_attn.cu``) for CUDA tensors and takes
:func:`relu_attn_plain` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.quant import act_scale_from_stats, div, int_einsum, quantize_act
from . import build

launches = 0
plain_calls = 0
MAX_D = 64


def attn_scales(q, k, v) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sq, sk, sv) 0-d f32 act scales, computed as ``ops._relu_attn_core``
    does: post-ReLU max for q and k, max-abs for v."""
    sq = act_scale_from_stats(torch.clamp(q.max().to(torch.float32), min=0.0))
    sk = act_scale_from_stats(torch.clamp(k.max().to(torch.float32), min=0.0))
    sv = act_scale_from_stats(v.abs().max().to(torch.float32))
    return sq, sk, sv


def relu_attn_plain(q, k, v, sq, sk, sv, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.relu_attn_ref``):
    q/k/v (B, N, H, D) float -> (B, N, H, D) f32."""
    global plain_calls
    plain_calls += 1
    q8 = quantize_act(torch.relu(q.to(torch.float32)), sq).to(torch.int32)
    k8 = quantize_act(torch.relu(k.to(torch.float32)), sk).to(torch.int32)
    v8 = quantize_act(v.to(torch.float32), sv).to(torch.int32)
    kv_f = int_einsum("bnhd,bnhe->bhde", k8, v8) * (sk * sv)
    ksum = k8.sum(dim=1, dtype=torch.int32)                       # (B,H,D)
    skv = torch.clamp(div(torch.amax(torch.abs(kv_f), dim=(-2, -1),
                                     keepdim=True), 127.0), min=1e-8)
    kv8 = torch.clamp(torch.round(div(kv_f, skv)), -127, 127).to(torch.int32)
    num = int_einsum("bnhd,bhde->bnhe", q8, kv8)
    den = int_einsum("bnhd,bhd->bnh", q8, ksum)[..., None]
    num_f = num * (sq * skv.permute(0, 2, 1, 3))
    den_f = den * (sq * sk)
    return num_f / (den_f + eps)


def _check_operand(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    D = ref.shape[3]
    if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"relu_attn: {name} must match q in shape, dtype "
                         "and device")
    if t.dtype not in (torch.float32, torch.bfloat16) \
            or t.stride(3) != 1 or t.stride(2) != D:
        raise ValueError(f"relu_attn: {name} must be float32/bfloat16 with "
                         f"unit stride over D and stride D over heads, got "
                         f"strides {t.stride()}")


def _launch(q, k, v, sq, sk, sv, eps) -> torch.Tensor:
    B, N, H, D = q.shape
    if D > MAX_D:
        raise ValueError(f"relu_attn: head dim {D} > {MAX_D} unsupported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    for name, s in (("sq", sq), ("sk", sk), ("sv", sv)):
        if s.numel() != 1 or s.dtype != torch.float32 or s.device != q.device:
            raise ValueError(f"relu_attn: {name} must be a 0-d f32 tensor "
                             f"on {q.device}")
    out = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device)
    fn = build.load("relu_attn").relu_attn
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1),
             sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), out.data_ptr(),
             B, N, H, D, eps, int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "relu_attn")
    return out


def relu_attn(q, k, v, sq, sk, sv, eps: float = 1e-6) -> torch.Tensor:
    """q/k/v (B, N, H, D) float; sq/sk/sv 0-d f32 -> (B, N, H, D) f32."""
    global launches
    if q.device.type == "cpu":
        return relu_attn_plain(q, k, v, sq, sk, sv, eps)
    if q.device.type != "cuda":
        raise ValueError(f"relu_attn: unsupported device {q.device}")
    out = _launch(q, k, v, sq, sk, sv, eps)
    launches += 1
    return out

"""The three tensor-wide act scales of the int8 ReLU linear attention.

``sq = max(max(max q, 0) / 127, 1e-8)``, ``sk`` the same over k,
``sv = max(max|v| / 127, 1e-8)``, each over the whole batch, as
``ops._relu_attn_core`` computes them in the JAX package (where XLA fuses
the three reductions).  :func:`relu_attn_scales` launches the CUDA kernel
(the ``relu_attn_scales`` entry point of ``csrc/relu_attn.cu``: one
cluster reads q, k and v once and writes the three scales) for CUDA
tensors and takes :func:`relu_attn_scales_plain` only for CPU tensors.
NaN anywhere in q (k, v) makes sq (sk, sv) NaN; +inf makes it inf.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.quant import act_scale_from_stats
from . import build
from .relu_attn import check_operands

launches = 0
plain_calls = 0
CTAS = (1, 2, 4, 8, 16)       # CTAs of the one cluster
THREADS = 512                 # a CTA's threads (SCALE_NT in the kernel)
LOADS_PER_THREAD = 2          # 16-byte loads of each tensor a thread takes

Scales = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def relu_attn_scales_plain(q, k, v) -> Scales:
    """(sq, sk, sv) 0-d f32, the plain chain: post-ReLU max for q and k,
    max-abs for v."""
    global plain_calls
    plain_calls += 1
    sq = act_scale_from_stats(torch.clamp(q.max().to(torch.float32), min=0.0))
    sk = act_scale_from_stats(torch.clamp(k.max().to(torch.float32), min=0.0))
    sv = act_scale_from_stats(v.abs().max().to(torch.float32))
    return sq, sk, sv


def launch_plan(B: int, N: int, C: int, bf16: bool) -> dict:
    """The one cluster's CTAs: the fewest (a power of two, at most 16)
    that leave each thread no more than ``LOADS_PER_THREAD`` 16-byte loads
    of each tensor.  Sweep: ``tools/m2q_tune.py --kernel
    relu_attn_scales``."""
    loads = -(-B * N * C // (8 if bf16 else 4))
    ctas = 1
    while ctas < CTAS[-1] and ctas * THREADS * LOADS_PER_THREAD < loads:
        ctas *= 2
    return {"ctas": ctas}


def _launch(q, k, v, plan=None) -> torch.Tensor:
    """Launch the kernel; returns the (3,) f32 tensor (sq, sk, sv).
    ``plan`` (``ctas``) overrides :func:`launch_plan`."""
    check_operands("relu_attn_scales", q, k, v)
    B, N, H, D = q.shape
    if q.numel() == 0:
        raise ValueError("relu_attn_scales: empty q/k/v")
    if q.numel() >= 2 ** 31:
        raise ValueError("relu_attn_scales: q/k/v hold 2^31 elements or "
                         "more")
    plan = plan or launch_plan(B, N, H * D, q.dtype == torch.bfloat16)
    out = torch.empty(3, dtype=torch.float32, device=q.device)
    fn = build.load("relu_attn").relu_attn_scales
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), out.data_ptr(), B, N, H * D,
             int(q.dtype == torch.bfloat16), plan["ctas"],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "relu_attn_scales")
    return out


def relu_attn_scales(q, k, v) -> Scales:
    """q/k/v (B, N, H, D) float -> (sq, sk, sv), 0-d f32 on q's device
    (on the card, views of one 3-element tensor the kernel wrote)."""
    global launches
    if q.device.type == "cpu":
        return relu_attn_scales_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"relu_attn_scales: unsupported device {q.device}")
    out = _launch(q, k, v)
    launches += 1
    return out[0], out[1], out[2]

"""Int8 ReLU linear attention (EfficientViT's MSA token mixer).

Per (b, h): ``q8,k8 = quant(relu(.))``, ``v8 = quant(v)``; ``kv = k8^T v8``
and ``ksum`` in int32; kv requantized to int8 with
``skv = max(max|kv*sk*sv| / 127, 1e-8)``; ``num = q8 @ kv8``,
``den = q8 . ksum``; ``out = num*sq*skv / (den*sq*sk + eps)``.

The tensor-wide scales come from :mod:`.relu_attn_scales` (post-ReLU max
for q and k, max-abs for v, over the whole batch -- one image's output
depends on its batchmates, as in the JAX package).  :func:`relu_attn`
launches the CUDA kernel (``csrc/relu_attn.cu``) for CUDA tensors and takes
:func:`relu_attn_plain` only for CPU tensors.  Both return f32 (the JAX
contract) or, with ``out_dtype``, the f32 result rounded once to that
dtype: the kernel stores bf16 itself, so no cast follows it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.quant import div, int_einsum, quantize_act
from . import build

launches = 0
plain_calls = 0
MAX_D = 64
MAX_N = (1 << 24) // 127   # tokens: ksum (<= 127 N) in three bytes
SPLITS = (1, 2, 4, 8)      # CTAs of one cluster, each a slice of tokens
SPLIT = 4                  # the slices of a split (b, h)
TARGET_CTAS = 128          # about one CTA on each of the H100's 132 SMs
SHORT_SLICE = 64           # tokens one CTA takes without splitting


def launch_plan(B: int, N: int, H: int, D: int) -> dict:
    """The launch of one call, as ``tools/m2q_tune.py --kernel relu_attn``
    swept it on the H100 (PERF.md): one CTA of 512 threads per (batch,
    head), split into ``SPLIT`` cluster CTAs over token slices only where
    the run is longer than ``SHORT_SLICE`` tokens and the split keeps the
    card at ``TARGET_CTAS`` CTAs or fewer.  The cluster's exchange costs a
    barrier that waits for the slowest CTA, so more CTAs win only where
    one CTA's chain of items is long and the SMs are otherwise idle."""
    split = N > SHORT_SLICE and B * H * SPLIT <= TARGET_CTAS
    splits = SPLIT if split else 1
    return {"splits": splits, "ctas": B * H * splits,
            "tokens": -(-N // splits)}


def candidate_plans(B: int, N: int, H: int, D: int) -> list:
    """The plans the autotuner times for one call, :func:`launch_plan`'s
    first: every cluster size of ``SPLITS`` that leaves each CTA a
    token."""
    first = {"splits": launch_plan(B, N, H, D)["splits"]}
    return [first] + [{"splits": s} for s in SPLITS
                      if s <= N and s != first["splits"]]


def relu_attn_plain(q, k, v, sq, sk, sv, eps: float = 1e-6,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.relu_attn_ref``):
    q/k/v (B, N, H, D) float -> (B, N, H, D) f32, cast once to
    ``out_dtype``."""
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
    return (num_f / (den_f + eps)).to(out_dtype)


def check_operands(name: str, q, k, v) -> None:
    """The launch contract of both kernels of ``csrc/relu_attn.cu``: q, k
    and v (B, N, H, D) float32/bfloat16 alike in shape, dtype and device,
    with unit stride over D and stride D over heads (column slices of one
    (B, N, 3C) tensor qualify).  Raises ValueError otherwise."""
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be (B, N, H, D), got {q.shape}")
    D = q.shape[3]
    for field, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name}: {field} must match q in shape, dtype "
                             "and device")
        if t.dtype not in (torch.float32, torch.bfloat16) \
                or t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name}: {field} must be float32/bfloat16 "
                             "with unit stride over D and stride D over "
                             f"heads, got {t.dtype} strides {t.stride()}")


def _launch(q, k, v, sq, sk, sv, eps, out_dtype=torch.float32,
            plan=None) -> torch.Tensor:
    """Launch the kernel; ``plan`` (``splits``) overrides
    :func:`launch_plan`."""
    B, N, H, D = q.shape
    if D > MAX_D:
        raise ValueError(f"relu_attn: head dim {D} > {MAX_D} unsupported")
    if N > MAX_N:
        raise ValueError(f"relu_attn: {N} tokens > {MAX_N} unsupported")
    check_operands("relu_attn", q, k, v)
    for name, s in (("sq", sq), ("sk", sk), ("sv", sv)):
        if s.numel() != 1 or s.dtype != torch.float32 or s.device != q.device:
            raise ValueError(f"relu_attn: {name} must be a 0-d f32 tensor "
                             f"on {q.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("relu_attn: out_dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    plan = plan or launch_plan(B, N, H, D)
    out = torch.empty((B, N, H, D), dtype=out_dtype, device=q.device)
    fn = build.load("relu_attn").relu_attn
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1),
             sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), out.data_ptr(),
             B, N, H, D, eps, int(q.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), plan["splits"],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "relu_attn")
    return out


def relu_attn(q, k, v, sq, sk, sv, eps: float = 1e-6,
              out_dtype: torch.dtype = torch.float32,
              plan: dict = None) -> torch.Tensor:
    """q/k/v (B, N, H, D) float; sq/sk/sv 0-d f32 -> (B, N, H, D) in
    ``out_dtype`` (float32 or bfloat16).  ``plan``: the launch on CUDA
    (:func:`launch_plan`'s when None)."""
    global launches
    if q.device.type == "cpu":
        return relu_attn_plain(q, k, v, sq, sk, sv, eps, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"relu_attn: unsupported device {q.device}")
    out = _launch(q, k, v, sq, sk, sv, eps, out_dtype, plan)
    launches += 1
    return out

"""Fused two-level mixed-quantization matmul (the M2-ViT flagship op).

``y = [((xq@P)_i32 - rowsum(xq)*u_zp)*u_scale + (xq@apot(P))*a_scale]*sa``
with ``xq = clip(rne(x/sa), +-127)``: P is the merged (K, N) int8 payload in
original filter order -- each column holds either an offset-folded uniform
byte or an APoT code byte -- and the zero-masked per-column scales cancel
each engine's contribution on the columns it does not own.

:func:`m2q_matmul` launches the CUDA kernel (``csrc/m2q_matmul.cu``) for a
CUDA tensor and takes :func:`m2q_matmul_plain` only for a CPU tensor;
:func:`launch_plan` picks the kernel's tile and K split for each shape.
"""
from __future__ import annotations

import torch

from ..core.packing import apot_decode_units
from ..core.quant import int_einsum, quantize_act
from . import build

launches = 0     # kernel launches (the main path's proof of use)
plain_calls = 0  # calls of the plain version


def m2q_matmul_plain(x: torch.Tensor, act_scale: torch.Tensor,
                     payload: torch.Tensor, u_scale: torch.Tensor,
                     u_zp: torch.Tensor,
                     a_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.m2q_merged_ref``): x (M, K)
    float, payload (K, N) int8, scales (N,) f32 -> (M, N) f32.

    The two integer dot products are exact: int32 on the CPU; float64 on
    CUDA, where torch has no integer matmul (|sums| stay far below 2^53).
    The APoT half accumulates in units of 2^-7, which equals the
    reference's f32 dot wherever that dot is exact (|sum| < 2^17)."""
    global plain_calls
    plain_calls += 1
    xq = quantize_act(x, act_scale)
    acc = int_einsum("mk,kn->mn", xq, payload)
    acc_a = int_einsum("mk,kn->mn", xq,
                       apot_decode_units(payload.view(torch.uint8)))
    xsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    yu = (acc - xsum.to(torch.float32) * u_zp) * u_scale
    ya = (acc_a * 0.0078125) * a_scale
    return (yu + ya) * act_scale


# the output tiles (rows, columns) csrc/m2q_matmul.cu instantiates
TILES = ((128, 16), (64, 32), (64, 64), (32, 32), (32, 64))
MAX_SPLIT = 8   # blocks of one thread block cluster (the portable limit)
SMS = 132       # streaming multiprocessors of an H100 SXM
BK = 32         # K per step of the kernel


def launch_plan(M: int, K: int, N: int) -> dict:
    """The kernel's launch shape for an (M, K) x (K, N) product: the
    output tile ``bm`` x ``bn``, the ``splits`` blocks of one cluster that
    share a tile's K, and the ``blocks`` launched.

    ``bn`` is the narrowest tile width that covers N (64 beyond), so N = 16
    and N = 32 waste no columns.  ``bm`` is 64 rows (256 threads at
    bn = 64), 128 at bn = 16 (the same thread count) and 32 where M is no
    taller.  Where the tiles leave SMs idle (late stages, the head) and K
    spans at least 8 steps of 32, K is split in powers of two up to 8
    while each split keeps at least four steps.  A step is a chain of
    shared-memory round trips (~1.2 us on the H100), so shorter splits
    win while the card has room for their blocks; at K <= 128 the
    cluster's reduction costs more than the steps it saves."""
    bn = 16 if N <= 16 else 32 if N <= 32 else 64
    bm = 128 if bn == 16 else 32 if M <= 32 else 64
    tiles = -(-M // bm) * -(-N // bn)
    steps = -(-K // BK)
    splits = 1
    while splits < MAX_SPLIT and tiles * splits < SMS and steps >= 8 \
            and steps >= 4 * splits:
        splits *= 2
    return {"bm": bm, "bn": bn, "splits": splits, "blocks": tiles * splits}


PLAN_KEYS = ("bm", "bn", "splits")  # what _launch reads of a plan


def matmul_candidates(first: dict, K: int) -> list:
    """``first`` (a plan's ``PLAN_KEYS``), then every other tile of
    ``TILES`` under every power-of-two K split up to ``MAX_SPLIT`` that
    leaves each split at least one step of ``BK``: the launch shapes
    ``csrc/m2q_matmul.cu`` builds for both of its entry points."""
    steps = -(-K // BK)
    out = [first]
    for bm, bn in TILES:
        for splits in (1, 2, 4, 8):
            p = {"bm": bm, "bn": bn, "splits": splits}
            if splits <= min(steps, MAX_SPLIT) and p != first:
                out.append(p)
    return out


def candidate_plans(M: int, K: int, N: int) -> list:
    """The plans the autotuner times for one shape, :func:`launch_plan`'s
    first."""
    p = launch_plan(M, K, N)
    return matmul_candidates({k: p[k] for k in PLAN_KEYS}, K)


def _launch(x, act_scale, payload, u_scale, u_zp, a_scale,
            plan: dict = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``plan``: a launch shape other
    than :func:`launch_plan`'s (same keys, a tile of ``TILES``), for
    tests and tuning."""
    K = x.shape[-1]
    N = payload.shape[1]
    if payload.shape[0] != K or u_scale.numel() != N or u_zp.numel() != N \
            or a_scale.numel() != N or act_scale.numel() != 1:
        raise ValueError(f"m2q_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"payload {tuple(payload.shape)}")
    p = plan or launch_plan(x.shape[0], K, N)
    return build.launch_matmul(
        "m2q_matmul", "m2q_matmul", x, N,
        ("act_scale", act_scale, torch.float32),
        ("payload", payload, torch.int8), ("u_scale", u_scale, torch.float32),
        ("u_zp", u_zp, torch.float32), ("a_scale", a_scale, torch.float32),
        ints=(p["bm"], p["bn"], p["splits"]))


def m2q_matmul(x: torch.Tensor, act_scale: torch.Tensor, payload: torch.Tensor,
               u_scale: torch.Tensor, u_zp: torch.Tensor,
               a_scale: torch.Tensor, plan: dict = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16; act_scale 0-d f32; payload (K, N) int8;
    u_scale/u_zp/a_scale (N,) f32 -> y (M, N) f32.  ``plan``: the launch
    shape on CUDA (:func:`launch_plan`'s when None)."""
    global launches
    if x.device.type == "cpu":
        return m2q_matmul_plain(x, act_scale, payload, u_scale, u_zp, a_scale)
    if x.device.type != "cuda":
        raise ValueError(f"m2q_matmul: unsupported device {x.device}")
    y = _launch(x, act_scale, payload, u_scale, u_zp, a_scale, plan)
    launches += 1
    return y

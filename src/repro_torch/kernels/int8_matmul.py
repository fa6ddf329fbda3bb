"""W8A8 uniform integer matmul (the int8 path of ``uniform8`` recipes and
the opt-in int8 im2col stem).

``y = ((xq@Wq)_i32 - rowsum(xq)*zp) * (sa*scale)`` with
``xq = clip(rne(x/sa), +-127)``: Wq is the (K, N) int8 payload stored as
``q - 128`` with the offset folded into the zero point.  y is f32 (the JAX
kernel's contract), or bf16 (the f32 result rounded to nearest even) on
request.

:func:`int8_matmul` launches the CUDA kernel (``int8_matmul`` in
``csrc/m2q_matmul.cu``, the uniform-only instance of ``m2q_matmul``'s
template) for a CUDA tensor and takes :func:`int8_matmul_plain` only for a
CPU tensor; :func:`launch_plan` picks the kernel's tile and K split for
each shape.
"""
from __future__ import annotations

import torch

from ..core.quant import int_einsum, quantize_act
from . import build
from .m2q_matmul import PLAN_KEYS, SMS, matmul_candidates
from .m2q_matmul import launch_plan as m2q_launch_plan

launches = 0     # kernel launches (the main path's proof of use)
plain_calls = 0  # calls of the plain version


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      act_scale: torch.Tensor, scale: torch.Tensor,
                      zero_point: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.int8_matmul_ref`` with the
    activation quantization in front): x (M, K) float, wq (K, N) int8,
    act_scale 0-d f32, scale/zero_point (N,) f32 -> (M, N) f32, cast to
    ``out_dtype``.  The integer dot is exact (int32 on the CPU, float64 on
    CUDA)."""
    global plain_calls
    plain_calls += 1
    xq = quantize_act(x, act_scale)
    acc = int_einsum("mk,kn->mn", xq, wq)
    xsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    y = acc - xsum.to(torch.float32) * zero_point
    return (y * (act_scale * scale)).to(out_dtype)


def launch_plan(M: int, K: int, N: int) -> dict:
    """The kernel's launch shape for an (M, K) x (K, N) product: the
    output tile ``bm`` x ``bn`` (one of ``m2q_matmul.TILES``), the
    ``splits`` blocks of one cluster that share a tile's K, and the
    ``blocks`` launched.

    ``m2q_matmul.launch_plan``'s tiles and K splits, except that K is
    split only where the unsplit tiles leave at least half the SMs idle.
    A K step without the APoT planes is cheaper, so where the tiles fill
    more of the card the cluster's reduction costs more than the steps it
    saves (``tools/m2q_tune.py --kernel int8_matmul --all`` on the H100:
    the uniform8 forward's 98-, 84- and 112-tile shapes at K = 256 ran
    6-9% faster unsplit)."""
    p = m2q_launch_plan(M, K, N)
    tiles = p["blocks"] // p["splits"]
    if 2 * tiles > SMS:
        p = dict(p, splits=1, blocks=tiles)
    return p


def candidate_plans(M: int, K: int, N: int) -> list:
    """The plans the autotuner times for one shape, :func:`launch_plan`'s
    first: ``m2q_matmul``'s tiles and K splits (one template)."""
    p = launch_plan(M, K, N)
    return matmul_candidates({k: p[k] for k in PLAN_KEYS}, K)


def _launch(x, wq, act_scale, scale, zero_point,
            out_dtype: torch.dtype = torch.float32,
            plan: dict = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``plan``: a launch shape other
    than :func:`launch_plan`'s (keys bm, bn, splits; a tile of
    ``m2q_matmul.TILES``), for tests and tuning."""
    K = x.shape[-1]
    N = wq.shape[-1]
    if tuple(wq.shape) != (K, N) or scale.numel() != N \
            or zero_point.numel() != N or act_scale.numel() != 1:
        raise ValueError(f"int8_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    p = plan or launch_plan(x.shape[0], K, N)
    return build.launch_matmul(
        "m2q_matmul", "int8_matmul", x, N, ("wq", wq, torch.int8),
        ("act_scale", act_scale, torch.float32),
        ("scale", scale, torch.float32),
        ("zero_point", zero_point, torch.float32),
        ints=(p["bm"], p["bn"], p["splits"]), out_dtype=out_dtype)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, act_scale: torch.Tensor,
                scale: torch.Tensor, zero_point: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                plan: dict = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16; wq (K, N) int8; act_scale 0-d f32;
    scale/zero_point (N,) f32 -> y (M, N) in ``out_dtype`` (f32, the JAX
    kernel's contract, or bf16: the f32 result rounded to nearest even).
    ``plan``: the launch shape on CUDA (:func:`launch_plan`'s when
    None)."""
    global launches
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, act_scale, scale, zero_point,
                                 out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    y = _launch(x, wq, act_scale, scale, zero_point, out_dtype, plan)
    launches += 1
    return y

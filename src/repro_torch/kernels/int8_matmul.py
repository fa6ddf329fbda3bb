"""W8A8 uniform integer matmul (the int8 path of ``uniform8`` recipes and
the opt-in int8 im2col stem).

``y = ((xq@Wq)_i32 - rowsum(xq)*zp) * (sa*scale)`` with
``xq = clip(rne(x/sa), +-127)``: Wq is the (K, N) int8 payload stored as
``q - 128`` with the offset folded into the zero point.

:func:`int8_matmul` launches the CUDA kernel (``csrc/int8_matmul.cu``) for a
CUDA tensor and takes :func:`int8_matmul_plain` only for a CPU tensor.
"""
from __future__ import annotations

import torch

from ..core.quant import int_einsum, quantize_act
from . import build

launches = 0     # kernel launches (the main path's proof of use)
plain_calls = 0  # calls of the plain version


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      act_scale: torch.Tensor, scale: torch.Tensor,
                      zero_point: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.int8_matmul_ref`` with the
    activation quantization in front): x (M, K) float, wq (K, N) int8,
    act_scale 0-d f32, scale/zero_point (N,) f32 -> (M, N) f32.  The
    integer dot is exact (int32 on the CPU, float64 on CUDA)."""
    global plain_calls
    plain_calls += 1
    xq = quantize_act(x, act_scale)
    acc = int_einsum("mk,kn->mn", xq, wq)
    xsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
    y = acc - xsum.to(torch.float32) * zero_point
    return y * (act_scale * scale)


def _launch(x, wq, act_scale, scale, zero_point) -> torch.Tensor:
    K = x.shape[-1]
    N = wq.shape[-1]
    if tuple(wq.shape) != (K, N) or scale.numel() != N \
            or zero_point.numel() != N or act_scale.numel() != 1:
        raise ValueError(f"int8_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    return build.launch_matmul(
        "int8_matmul", "int8_matmul", x, N, ("wq", wq, torch.int8),
        ("act_scale", act_scale, torch.float32),
        ("scale", scale, torch.float32),
        ("zero_point", zero_point, torch.float32))


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, act_scale: torch.Tensor,
                scale: torch.Tensor, zero_point: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32/bfloat16; wq (K, N) int8; act_scale 0-d f32;
    scale/zero_point (N,) f32 -> y (M, N) f32."""
    global launches
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, act_scale, scale, zero_point)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    y = _launch(x, wq, act_scale, scale, zero_point)
    launches += 1
    return y

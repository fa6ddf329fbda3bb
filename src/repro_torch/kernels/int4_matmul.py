"""Weights-only 4-bit matmul (the ``w4-weights-only`` recipe's PWConvs).

``y = x @ ((unpack(P) - zp) * scale)`` as an f32 dot on float
activations: P is the (K, N/2) uint8 payload, two 4-bit codes a byte, the
low nibble the even column.

:func:`int4_matmul` launches the CUDA kernel (``int4_matmul`` in
``csrc/weights_only_matmul.cu``, which shares its f32-dot kernel with
``apot_matmul``) for a CUDA tensor and takes :func:`int4_matmul_plain` only
for a CPU tensor.  The two sum in different orders: they agree to the f32
summation bound ``K * 2^-23 * (|x| @ |W|)``, not bit for bit.
"""
from __future__ import annotations

import torch

from ..core.packing import unpack_int4
from . import build

launches = 0
plain_calls = 0


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor,
                      zero_point: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.int4_matmul_ref``): x (M, K)
    float, packed (K, N/2) uint8, scale/zero_point (N,) f32 -> (M, N)
    f32."""
    global plain_calls
    plain_calls += 1
    w = (unpack_int4(packed).to(torch.float32) - zero_point) * scale
    return x.to(torch.float32) @ w


def _launch(x, packed, scale, zero_point) -> torch.Tensor:
    K = x.shape[-1]
    N = 2 * packed.shape[-1]
    if tuple(packed.shape) != (K, N // 2) or scale.numel() != N \
            or zero_point.numel() != N:
        raise ValueError(f"int4_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}")
    return build.launch_matmul(
        "weights_only_matmul", "int4_matmul", x, N,
        ("packed", packed, torch.uint8), ("scale", scale, torch.float32),
        ("zero_point", zero_point, torch.float32))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero_point: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32/bfloat16; packed (K, N/2) uint8; scale/zero_point
    (N,) f32 -> y (M, N) f32."""
    global launches
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, zero_point)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    y = _launch(x, packed, scale, zero_point)
    launches += 1
    return y

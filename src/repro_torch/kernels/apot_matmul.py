"""Weights-only APoT-coded matmul (QAPoT leaves without an activation
scale).

``y = (x @ decode(codes)) * scale`` as an f32 dot on float activations: a
code byte decodes to ``s*(2^-e1 + 2^-e2)`` (bit6 sign, bits5..3 e1,
bits2..0 e2) and to 0 when bit7 is set.

:func:`apot_matmul` launches the CUDA kernel (``apot_matmul`` in
``csrc/weights_only_matmul.cu``, a template it shares with
``int4_matmul``, under the same :func:`~.int4_matmul.launch_plan`) for a
CUDA tensor and takes :func:`apot_matmul_plain` only for a CPU tensor.
bf16 x runs on bf16 tensor cores (every decoded value is exact in bf16),
f32 x on f32 FMAs.  The two sum in different orders: they agree to the
f32 summation bound, not bit for bit.
"""
from __future__ import annotations

import torch

from ..core.packing import apot_decode_values
from . import build
from .int4_matmul import launch_plan

launches = 0
plain_calls = 0


def apot_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.apot_matmul_ref``): x (M, K)
    float, codes (K, N) uint8, scale (N,) f32 -> (M, N) f32."""
    global plain_calls
    plain_calls += 1
    return (x.to(torch.float32) @ apot_decode_values(codes)) * scale


def _launch(x, codes, scale, plan: dict = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``plan`` as for
    ``int4_matmul._launch``."""
    M, K = x.shape
    N = codes.shape[-1]
    if tuple(codes.shape) != (K, N) or scale.numel() != N:
        raise ValueError(f"apot_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"codes {tuple(codes.shape)}")
    p = plan or launch_plan(M, K, N, x.dtype == torch.bfloat16)
    return build.launch_matmul(
        "weights_only_matmul", "apot_matmul", x, N,
        ("codes", codes, torch.uint8), ("scale", scale, torch.float32),
        ints=(p["bm"], p["bn"], p["splits"]))


def apot_matmul(x: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor, plan: dict = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16; codes (K, N) uint8; scale (N,) f32 ->
    y (M, N) f32.  ``plan``: the launch shape on CUDA (``launch_plan``'s
    when None)."""
    global launches
    if x.device.type == "cpu":
        return apot_matmul_plain(x, codes, scale)
    if x.device.type != "cuda":
        raise ValueError(f"apot_matmul: unsupported device {x.device}")
    y = _launch(x, codes, scale, plan)
    launches += 1
    return y

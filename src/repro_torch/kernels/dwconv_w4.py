"""4-bit depthwise conv (the paper's memory-intensive DWConv class).

x (B, H, W, C) NHWC; packed (kh*kw, C/2) uint8 nibbles (low nibble = even
channel); scale/zero_point (C,) f32.  Weights decode as ``(q - zp)*scale``;
taps are summed in i-major, j-minor order; padding is XLA SAME
(``lo = total // 2``, asymmetric for stride 2 on even maps).

:func:`dwconv_w4` launches the CUDA kernel (``csrc/dwconv_w4.cu``) for a
CUDA tensor and takes :func:`dwconv_w4_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.packing import unpack_int4
from . import build

launches = 0
plain_calls = 0


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA SAME padding (lo, hi) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo = total // 2
    return lo, total - lo


def dwconv_w4_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    zero_point: torch.Tensor, kh: int = 3, kw: int = 3,
                    stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.dwconv_w4_ref``) -> f32."""
    global plain_calls
    plain_calls += 1
    q = unpack_int4(packed.reshape(kh * kw, -1)).to(torch.float32)
    w = ((q - zero_point) * scale).reshape(kh, kw, -1)
    H, W = x.shape[1], x.shape[2]
    ph, pw = same_padding(H, kh, stride), same_padding(W, kw, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    HO, WO = -(-H // stride), -(-W // stride)
    out = torch.zeros((x.shape[0], HO, WO, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    s = stride
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + (HO - 1) * s + 1:s, j:j + (WO - 1) * s + 1:s]
            out = out + tap.to(torch.float32) * w[i, j]
    return out


def _launch(x, packed, scale, zero_point, kh, kw, stride) -> torch.Tensor:
    B, H, W, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("dwconv_w4: x must be contiguous float32 or bfloat16")
    if C % 2 or tuple(packed.shape) != (kh * kw, C // 2) \
            or packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError(f"dwconv_w4: packed must be contiguous uint8 "
                         f"({kh * kw}, {C // 2}), got {tuple(packed.shape)}")
    for name, t in (("scale", scale), ("zero_point", zero_point)):
        if t.numel() != C or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"dwconv_w4: {name} must be ({C},) f32 on "
                             f"{x.device}")
    HO, WO = -(-H // stride), -(-W // stride)
    ph, pw = same_padding(H, kh, stride)[0], same_padding(W, kw, stride)[0]
    y = torch.empty((B, HO, WO, C), dtype=torch.float32, device=x.device)
    fn = build.load("dwconv_w4").dwconv_w4
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
             zero_point.data_ptr(), y.data_ptr(), B, H, W, C, HO, WO, kh, kw,
             stride, ph, pw, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dwconv_w4")
    return y


def dwconv_w4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              zero_point: torch.Tensor, kh: int = 3, kw: int = 3,
              stride: int = 1) -> torch.Tensor:
    """Depthwise kh x kw conv, SAME padding, stride >= 1 -> (B,HO,WO,C) f32."""
    global launches
    if x.device.type == "cpu":
        return dwconv_w4_plain(x, packed, scale, zero_point, kh, kw, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv_w4: unsupported device {x.device}")
    y = _launch(x, packed, scale, zero_point, kh, kw, stride)
    launches += 1
    return y

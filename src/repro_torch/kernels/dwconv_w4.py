"""4-bit depthwise conv (the paper's memory-intensive DWConv class).

x (B, H, W, C) NHWC; packed (kh*kw, C/2) uint8 nibbles (low nibble = even
channel); scale/zero_point (C,) f32.  Weights decode as ``(q - zp)*scale``;
taps are summed in i-major, j-minor order; padding is XLA SAME
(``lo = total // 2``, asymmetric for stride 2 on even maps).  The output
is f32, or bf16 (the f32 sum rounded to nearest even) on request.

:func:`dwconv_w4` launches the CUDA kernel (``csrc/dwconv_w4.cu``) for a
CUDA tensor and takes :func:`dwconv_w4_plain` only for a CPU tensor;
:func:`launch_plan` picks the kernel's tile for each shape.
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
                    stride: int = 1,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version (twin of ``ref.dwconv_w4_ref``): the f32 sum,
    cast to ``out_dtype``."""
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
    return out.to(out_dtype)


# what csrc/dwconv_w4.cu instantiates: square windows (k, stride) and the
# output columns R a thread computes; a thread owns 8 channels
WINDOWS = ((3, 1), (3, 2), (5, 1), (5, 2))
RS = (1, 2, 4, 8)
CPT = 8
MAX_THREADS = 256   # cv * sw * th
MAX_SMEM = 232448   # 227 KB, a block's shared-memory cap on the H100
SMS = 132           # streaming multiprocessors of an H100 SXM


def plan_shape(plan: dict, B: int, H: int, W: int, C: int, k: int,
               stride: int, itemsize: int = 2) -> dict:
    """What a plan launches at one conv shape: the grid (channel tiles,
    row tiles * column tiles, images), the blocks, the threads a block and
    its shared memory (the decoded weights and the x halo, x of
    ``itemsize`` bytes)."""
    cv, sw, th, r = plan["cv"], plan["sw"], plan["th"], plan["r"]
    HO, WO = -(-H // stride), -(-W // stride)
    cs, tw = CPT * cv, sw * r
    grid = (-(-C // cs), -(-HO // th) * -(-WO // tw), B)
    hin, win = (th - 1) * stride + k, (tw - 1) * stride + k
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "threads": cv * sw * th,
            "smem": k * k * cs * 4 + hin * win * cs * itemsize}


def launch_plan(B: int, H: int, W: int, C: int, k: int, stride: int) -> dict:
    """The kernel's launch shape for one conv: ``cv`` channel vectors of 8
    (the block's channel slice is 8 * cv), ``sw`` column strips of ``r``
    output columns each, ``th`` output rows; ``blocks`` launched.

    The rule comes from sweeping every plan at the 11 depthwise shapes of
    a B1 R224 batch-8 forward on the H100 (``tools/m2q_tune.py --kernel
    dwconv_w4 --all``; within 2% of the best plan per forward): a block
    takes up to 64 channels (128 bytes of bf16 a pixel), 2 strips and up
    to 8 rows, a near-square tile whose halo adds least; ``r`` is 4 at
    stride 1 from 28 output columns (else 2), and at stride 2 4 from 56,
    2 from 28, else 1.  Where that leaves SMs without a block (small maps
    at batch 1-4), the rows halve down to 2, then the channel slice down
    to 8 channels, then the rows to 1, until every SM has one."""
    HO, WO = -(-H // stride), -(-W // stride)
    if stride == 1:
        r = 4 if WO >= 28 else 2
    else:
        r = 4 if WO >= 56 else 2 if WO >= 28 else 1
    th = 8
    while th > max(HO, 1):
        th //= 2
    plan = {"cv": min(8, -(-C // CPT)), "sw": 2, "th": th, "r": r}
    while plan_shape(plan, B, H, W, C, k, stride)["blocks"] < SMS:
        if plan["th"] > 2:
            plan["th"] //= 2
        elif plan["cv"] > 1:
            plan["cv"] //= 2
        elif plan["th"] > 1:
            plan["th"] = 1
        else:
            break
    return dict(plan, blocks=plan_shape(plan, B, H, W, C, k, stride)["blocks"])


PLAN_KEYS = ("cv", "sw", "th", "r")  # what _launch reads of a plan


def candidate_plans(B: int, H: int, W: int, C: int, k: int, stride: int,
                    itemsize: int = 2) -> list:
    """The plans the autotuner times for one conv, :func:`launch_plan`'s
    first, then every other plan the kernel takes: r in ``RS``; the
    strips of a row split into 1, 2, 4, ... even tiles of at most 16
    strips; 1-8 channel vectors (no more than C has); 1-16 rows (no more
    than the map has); 32-``MAX_THREADS`` threads; shared memory within
    ``MAX_SMEM`` (x of ``itemsize`` bytes)."""
    p = launch_plan(B, H, W, C, k, stride)
    first = {key: p[key] for key in PLAN_KEYS}
    out = [first]
    HO, WO = -(-H // stride), -(-W // stride)
    for r in RS:
        strips = -(-WO // r)
        sws = sorted({-(-strips // n) for n in (1, 2, 4, 8, 16, 32)
                      if -(-strips // n) <= 16})
        for sw in sws:
            for cv in (1, 2, 4, 8):
                if cv > -(-C // CPT):
                    continue
                for th in (1, 2, 4, 8, 16):
                    q = {"cv": cv, "sw": sw, "th": th, "r": r}
                    shape = plan_shape(q, B, H, W, C, k, stride, itemsize)
                    if th <= HO and 32 <= shape["threads"] <= MAX_THREADS \
                            and shape["smem"] <= MAX_SMEM and q != first:
                        out.append(q)
    return out


def _launch(x, packed, scale, zero_point, kh, kw, stride,
            out_dtype=torch.float32, plan: dict = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``plan``: a launch shape other
    than :func:`launch_plan`'s (keys cv, sw, th, r; ``r`` one of ``RS``),
    for tests and tuning."""
    B, H, W, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("dwconv_w4: x must be contiguous float32 or bfloat16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dwconv_w4: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if kh != kw or (kh, stride) not in WINDOWS:
        raise ValueError(f"dwconv_w4: the kernel builds square windows "
                         f"(k, stride) in {WINDOWS}, got {kh}x{kw} stride "
                         f"{stride}")
    if C % 2 or tuple(packed.shape) != (kh * kw, C // 2) \
            or packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError(f"dwconv_w4: packed must be contiguous uint8 "
                         f"({kh * kw}, {C // 2}), got {tuple(packed.shape)}")
    for name, t in (("scale", scale), ("zero_point", zero_point)):
        if t.numel() != C or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"dwconv_w4: {name} must be ({C},) f32 on "
                             f"{x.device}")
    if H * W * C >= 2 ** 31:
        raise ValueError("dwconv_w4: one image must hold fewer than 2^31 "
                         "elements (32-bit offsets)")
    HO, WO = -(-H // stride), -(-W // stride)
    ph, pw = same_padding(H, kh, stride)[0], same_padding(W, kw, stride)[0]
    p = plan or launch_plan(B, H, W, C, kh, stride)
    y = torch.empty((B, HO, WO, C), dtype=out_dtype, device=x.device)
    fn = build.load("dwconv_w4").dwconv_w4
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
             zero_point.data_ptr(), y.data_ptr(), B, H, W, C, HO, WO, kh, kw,
             stride, ph, pw, int(x.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), p["cv"], p["sw"], p["th"],
             p["r"], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dwconv_w4")
    return y


def dwconv_w4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              zero_point: torch.Tensor, kh: int = 3, kw: int = 3,
              stride: int = 1,
              out_dtype: torch.dtype = torch.float32,
              plan: dict = None) -> torch.Tensor:
    """Depthwise kh x kw conv, SAME padding, stride >= 1 -> (B,HO,WO,C) in
    ``out_dtype`` (f32, the JAX kernel's contract, or bf16: the f32 sum
    rounded to nearest even).  ``plan``: the launch shape on CUDA
    (:func:`launch_plan`'s when None)."""
    global launches
    if x.device.type == "cpu":
        return dwconv_w4_plain(x, packed, scale, zero_point, kh, kw, stride,
                               out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv_w4: unsupported device {x.device}")
    y = _launch(x, packed, scale, zero_point, kh, kw, stride, out_dtype, plan)
    launches += 1
    return y

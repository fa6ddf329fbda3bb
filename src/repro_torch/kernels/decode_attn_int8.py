"""GQA decode attention over the int8 KV cache (the token engine's
per-step attention when ``kv_cache_dtype == "int8"``).

Per (b, kv-head) and query g: ``q8 = clip(rne(q / q_s))`` with
``q_s = max|q|/127 + 1e-9``; scores ``((q8.k8)_i32 * q_s * scale) *
k_scale`` on valid rows (``t < length``, and ``t >= length - window`` when
windowed), ``-1e30`` elsewhere; ``p = softmax`` in f32; ``pv = p *
v_scale`` requantized with ``p_s = max|pv|/127 + 1e-12``; ``out =
(p8.v8)_i32 * p_s``.

:func:`decode_attn_int8` launches the CUDA kernel
(``csrc/decode_attn_int8.cu``) for a CUDA tensor and takes
:func:`decode_attn_int8_plain` only for a CPU tensor.  The two agree to
``2 * p_s * max|v8|`` per (b, h, g) row -- the exp and the softmax sum
order can move p by an ulp and flip one p8 code -- not bit for bit.  The
kernel stores f32 or, with ``out_dtype=torch.bfloat16``, the f32 result
rounded once to bf16 (what a cast of its f32 store gives); the plain
version returns f32 and the CPU path casts it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.quant import div, int_einsum
from . import build

launches = 0     # kernel launches (the main path's proof of use)
plain_calls = 0  # calls of the plain version
NEG_INF = -1.0e30
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use
THREADS = 256              # threads of a block (``THREADS`` in the source)
ROWS = (32, 64, 128, 256)  # cache rows of a ring slot the sweep tries
DEPTHS = (1, 2, 4, 8)      # ring slots the sweep tries (the source: 1-16)
# tools/m2q_tune.py --kernel decode_attn_int8 put this plan within 2% of
# the best at every served row (PERF.md)
PLAN = {"rows": 256, "depth": 2}


def _quant_rows(x: torch.Tensor, eps: float):
    """(clip(rne(x / s), +-127) as int32, s) with ``s = max|x|/127 + eps``
    over the last axis (keepdims).  Cast through int8 as JAX casts it, so
    NaN gives 0 on every device (a direct f32 -> int32 cast gives INT_MIN
    on the CPU)."""
    s = div(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0) + eps
    q = torch.clamp(torch.round(div(x, s)), -127, 127)
    return q.to(torch.int8).to(torch.int32), s


def _plain(q, k, v, k_scale, v_scale, lengths, scale, window):
    """(out, p_s): the plain version's output and its (B, Hkv, G, 1) p
    scales."""
    T = k.shape[1]
    q8, q_s = _quant_rows(q.to(torch.float32), 1e-9)
    acc = int_einsum("bhgd,bthd->bhgt", q8, k)
    s = acc * q_s * scale * k_scale.permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.reshape(-1, 1).to(torch.int64)
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    s = torch.where(valid[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pv = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    p8, p_s = _quant_rows(pv, 1e-12)
    return int_einsum("bhgt,bthd->bhgd", p8, v) * p_s, p_s


def decode_attn_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version (twin of the dispatch-off XLA chain in
    ``nn.attention.decode_attention_int8``): q (B, Hkv, G, D) float; k/v
    (B, T, Hkv, D) int8; k_scale/v_scale (B, T, Hkv) f32; lengths (B,)
    int -> (B, Hkv, G, D) f32.  The integer dots are exact (int32 on the
    CPU, float64 on CUDA, where |PV| sums pass 2^24 once T > 1040)."""
    global plain_calls
    plain_calls += 1
    return _plain(q, k, v, k_scale, v_scale, lengths, scale, window)[0]


def error_bound(q, k, v, k_scale, v_scale, lengths, scale: float,
                window: Optional[int] = None) -> torch.Tensor:
    """The stated limit between two computations of this function that
    differ only in exp rounding and softmax summation order: two flipped
    p8 codes per (b, h, g) row, ``2 * p_s * max|v8|`` (max over the
    (b, h) slice of v), as a (B, Hkv, G, 1) tensor."""
    p_s = _plain(q, k, v, k_scale, v_scale, lengths, scale, window)[1]
    v_max = torch.amax(torch.abs(v.to(torch.float32)), dim=(1, 3))
    return 2.0 * p_s * v_max[:, :, None, None]


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(T: int, G: int, D: int, plan: dict) -> int:
    """Dynamic shared memory of one block under ``plan`` (``smem_layout``
    in the source): the ring of ``depth`` slots of ``rows`` cache rows
    and their k scales; the G x T f32 scores, whose space the PV partials
    (one int32 per column, query row and stream of row quads) take later;
    the G x T int8 codes; q8 and q_s; two per-warp reduction rows."""
    rows, depth = plan["rows"], plan["depth"]
    splits = THREADS // _pow2_ceil(D // 4)
    s = max(G * T, splits * G * D)
    p8 = depth * rows * (D + 4) + 4 * s
    q8 = _round_up(p8 + G * _round_up(T, 4), 16)
    return q8 + G * D + 4 * G + 8 * G * (THREADS // 32)


def fit_plan(T: int, G: int, D: int, plan: dict) -> dict:
    """``plan`` with its ring shrunk until the block fits the card's shared
    memory: fewer slots first, then fewer rows a slot (down to one quad
    of 4).  Raises ValueError when even one slot of 4 rows does not fit
    (the G x T scores and codes alone are too large)."""
    plan = dict(plan)
    while smem_bytes(T, G, D, plan) > SMEM_LIMIT:
        if plan["depth"] > 1:
            plan["depth"] //= 2
        elif plan["rows"] > 4:
            plan["rows"] //= 2
        else:
            raise ValueError(
                f"decode_attn_int8: G*T = {G}*{T} needs "
                f"{smem_bytes(T, G, D, plan)} bytes of shared memory per "
                f"block, above the card's {SMEM_LIMIT}")
    return plan


def launch_plan(B: int, T: int, H: int, G: int, D: int) -> dict:
    """The launch of one call: ``PLAN``, fitted to the card's shared
    memory (:func:`fit_plan`), with its shared memory and block count."""
    plan = fit_plan(T, G, D, PLAN)
    return dict(plan, smem=smem_bytes(T, G, D, plan), ctas=B * H)


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"decode_attn_int8: {name} must be a contiguous "
            f"{'/'.join(str(d) for d in dtypes)} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _launch(q, k, v, k_scale, v_scale, lengths, scale, window,
            out_dtype=torch.float32, plan=None):
    """Launch the kernel; ``plan`` (``rows``, ``depth``: powers of two)
    overrides :func:`launch_plan`."""
    B, H, G, D = q.shape
    T = k.shape[1]
    if D % 16 or D > 128 or G < 1 or T < 1:
        raise ValueError(f"decode_attn_int8: head dim {D} (a multiple of 16 "
                         f"up to 128), group {G} and cache length {T} "
                         "unsupported")
    dev = q.device
    _check("q", q, (B, H, G, D), (torch.float32, torch.bfloat16), dev)
    for name, t in (("k", k), ("v", v)):
        _check(name, t, (B, T, H, D), (torch.int8,), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attn_int8: {name} must be 16-byte "
                             "aligned")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, t, (B, T, H), (torch.float32,), dev)
    _check("lengths", lengths, (B,), (torch.int32,), dev)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("decode_attn_int8: out_dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    plan = fit_plan(T, G, D, plan or PLAN)
    out = torch.empty((B, H, G, D), dtype=out_dtype, device=dev)
    fn = build.load("decode_attn_int8").decode_attn_int8
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
             v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, T, H, G, D, scale, -1 if window is None else int(window),
             int(q.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), plan["rows"], plan["depth"],
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attn_int8")
    return out


def decode_attn_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     lengths: torch.Tensor, scale: float,
                     window: Optional[int] = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (B, Hkv, G, D) float32/bfloat16; k/v (B, T, Hkv, D) int8;
    k_scale/v_scale (B, T, Hkv) f32; lengths (B,) int32 -> (B, Hkv, G, D)
    in ``out_dtype`` (float32 or bfloat16)."""
    global launches
    if q.device.type == "cpu":
        return decode_attn_int8_plain(q, k, v, k_scale, v_scale, lengths,
                                      scale, window).to(out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn_int8: unsupported device {q.device}")
    out = _launch(q, k, v, k_scale, v_scale, lengths, scale, window,
                  out_dtype)
    launches += 1
    return out

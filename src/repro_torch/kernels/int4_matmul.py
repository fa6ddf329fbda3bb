"""Weights-only 4-bit matmul (the ``w4-weights-only`` recipe's PWConvs, the
token path's lm_head).

``y = x @ ((unpack(P) - zp) * scale)`` as an f32 dot on float
activations: P is the (K, N/2) uint8 payload, two 4-bit codes a byte, the
low nibble the even column.

:func:`int4_matmul` launches the CUDA kernel (``int4_matmul`` in
``csrc/weights_only_matmul.cu``, a template it shares with
``apot_matmul``) for a CUDA tensor and takes :func:`int4_matmul_plain` only
for a CPU tensor; :func:`launch_plan` picks the kernel's launch shape for
both.  bf16 x runs on bf16 tensor cores with the scale in the epilogue
(``q - zp`` is an integer in [-15, 15], exact in bf16), f32 x on f32 FMAs.
The two sum in different orders: they agree to the f32 summation bound
``(K + 1) * 2^-23 * (|x| @ |W|)``, not bit for bit.
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


# the launch shapes csrc/weights_only_matmul.cu instantiates for bf16 x:
# (rows, columns) tiles for M > 16 and (tokens, columns) tiles of the
# narrow plan, where the operands swap (y^T = W^T x^T) and each warp owns
# 64 columns
TILES = tuple((bm, bn) for bn in (16, 32, 64) for bm in (128, 64, 32))
NARROW_TILES = ((8, 64), (8, 128), (8, 256), (16, 64), (16, 128), (16, 256))
FMA_TILE = (64, 64)  # f32 x: the FMA kernel's one launch shape
MAX_SPLIT = 8   # blocks of one thread block cluster (the portable limit)
SMS = 132       # streaming multiprocessors of an H100 SXM
BK = 64         # K per ring stage of the tensor-core kernel


def launch_plan(M: int, K: int, N: int, bf16: bool = True) -> dict:
    """The weights-only kernels' launch shape for an (M, K) x (K, N)
    product: ``kernel`` ("mma", bf16 tensor cores, or "fma", f32 FMAs for
    f32 x), the tile ``bm`` x ``bn`` (``bm`` <= 16: the narrow plan,
    ``bm`` tokens), the ``splits`` blocks of one cluster that share a
    tile's K, and the ``blocks`` launched.

    M <= 16 takes the narrow plan, at the widest tile (256, 128, 64
    columns) that still gives every SM a block.  Otherwise ``bn`` is the
    narrowest width that covers N (64 beyond) and ``bm`` the tallest of
    128, 64 and 32 rows whose tiles still give every SM a block (32 where
    none does): a taller tile spreads each warp's weight decode over more
    MMAs.  Where the tiles leave SMs idle and K spans at least 4 steps of
    64, K is split in powers of two up to 8 while each split keeps at
    least two steps.  (Derived from ``tools/m2q_tune.py --all`` on the
    H100 at the served shapes; see PERF.md.)"""
    if not bf16:
        bm, bn = FMA_TILE
        blocks = -(-M // bm) * -(-N // bn)
        return {"kernel": "fma", "bm": bm, "bn": bn, "splits": 1,
                "blocks": blocks}
    if M <= 16:
        bm = 8 if M <= 8 else 16
        bn = next((w for w in (256, 128) if -(-N // w) >= SMS), 64)
    else:
        bn = 16 if N <= 16 else 32 if N <= 32 else 64
        bm = next((h for h in (128, 64) if -(-M // h) * -(-N // bn) >= SMS),
                  32)
    tiles = -(-M // bm) * -(-N // bn)
    steps = -(-K // BK)
    splits = 1
    while splits < MAX_SPLIT and tiles * splits < SMS \
            and steps >= 4 * splits:
        splits *= 2
    return {"kernel": "mma", "bm": bm, "bn": bn, "splits": splits,
            "blocks": tiles * splits}


PLAN_KEYS = ("bm", "bn", "splits")  # what _launch reads of a plan


def candidate_plans(M: int, K: int, N: int, bf16: bool = True) -> list:
    """The plans the autotuner times for one shape (``apot_matmul``'s
    too), :func:`launch_plan`'s first: for bf16 x, every narrow tile that
    holds M tokens (M <= 16) or every ``TILES`` tile (M > 16) under every
    power-of-two K split up to ``MAX_SPLIT`` that leaves each split at
    least one step of ``BK``; f32 x has the one FMA plan."""
    p = launch_plan(M, K, N, bf16)
    first = {k: p[k] for k in PLAN_KEYS}
    if not bf16:
        return [first]
    tiles = [t for t in NARROW_TILES if t[0] >= M] if M <= 16 else TILES
    steps = -(-K // BK)
    out = [first]
    for bm, bn in tiles:
        for splits in (1, 2, 4, 8):
            q = {"bm": bm, "bn": bn, "splits": splits}
            if splits <= min(steps, MAX_SPLIT) and q != first:
                out.append(q)
    return out


def f32_dot_bound(x: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """Per-element limit for two f32 dots of x (M, K) and W (K, N) summed
    in different orders: each is within K * 2^-24 * (|x| @ |W|) of the
    exact dot, so they differ by at most K * 2^-23 * (|x| @ |W|); one more
    2^-23 covers an epilogue scale multiply rounded on each side."""
    K = x.shape[1]
    return ((K + 1) * 2.0 ** -23) * (x.abs().double() @ w_hat.abs().double())


def _launch(x, packed, scale, zero_point, plan: dict = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``plan``: a launch shape other
    than :func:`launch_plan`'s (same keys; a tile of ``TILES`` or
    ``NARROW_TILES`` for bf16 x), for tests and tuning."""
    M, K = x.shape
    N = 2 * packed.shape[-1]
    if tuple(packed.shape) != (K, N // 2) or scale.numel() != N \
            or zero_point.numel() != N:
        raise ValueError(f"int4_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}")
    p = plan or launch_plan(M, K, N, x.dtype == torch.bfloat16)
    return build.launch_matmul(
        "weights_only_matmul", "int4_matmul", x, N,
        ("packed", packed, torch.uint8), ("scale", scale, torch.float32),
        ("zero_point", zero_point, torch.float32),
        ints=(p["bm"], p["bn"], p["splits"]))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero_point: torch.Tensor, plan: dict = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16; packed (K, N/2) uint8; scale/zero_point
    (N,) f32, the zero points integral (as ``uniform_quantize`` makes
    them) -> y (M, N) f32.  ``plan``: the launch shape on CUDA
    (:func:`launch_plan`'s when None)."""
    global launches
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, zero_point)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    y = _launch(x, packed, scale, zero_point, plan)
    launches += 1
    return y

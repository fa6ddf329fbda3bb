"""M2Q quantizers: uniform (Eq. 1-2), PoT (Eq. 3) and APoT (Eq. 5), plus
the int8 activation quantizer.  Twin of ``repro.core.quant``; every
payload it produces is bit-identical to the JAX package's on the same
float weights.

``axis`` is the output-channel (filter) axis; statistics reduce over all
other axes unless ``reduce_axes`` says otherwise, and ``axis=None`` is
tensor-wise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE ``a / b``.

    On CUDA, PyTorch turns a division by a Python number (or a CPU 0-d
    tensor) into a multiplication by its reciprocal, which can round
    differently from the true quotient that XLA and the CUDA kernels use.
    A divisor on ``a``'s device keeps the true quotient on every device.
    """
    if not isinstance(b, torch.Tensor):
        # a fill, not a host-to-device copy: safe inside CUDA graph capture
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    elif b.device != a.device:
        b = b.to(a.device)
    return a / b


def int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction of integer tensors, returned as float32
    (the conversion JAX's ``acc.astype(f32)`` makes).  int32 on the CPU;
    float64 on CUDA, where torch has no integer matmul -- exact while the
    sums stay below 2^53, far above any int8 x int8 layer here."""
    if a.device.type == "cpu":
        return torch.einsum(eq, a.to(torch.int32),
                            b.to(torch.int32)).to(torch.float32)
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


@dataclasses.dataclass
class UniformQ:
    """Asymmetric uniform-quantized tensor (pre-packing)."""

    q: torch.Tensor           # int32 payload in [0, 2^bits - 1]
    scale: torch.Tensor       # keepdims per-channel f32
    zero_point: torch.Tensor  # keepdims per-channel f32 (integer-valued)
    bits: int
    axis: Optional[int]


def _reduction_axes(ndim: int, axis: Optional[int],
                    reduce_axes: Optional[tuple]) -> Optional[tuple]:
    if reduce_axes is not None:
        return tuple(a % ndim for a in reduce_axes)
    if axis is None:
        return None
    axis = axis % ndim
    return tuple(i for i in range(ndim) if i != axis)


def _minmax(w: torch.Tensor, axis, reduce_axes):
    red = _reduction_axes(w.ndim, axis, reduce_axes)
    if red is None:
        return w.min(), w.max()
    return (torch.amin(w, dim=red, keepdim=True),
            torch.amax(w, dim=red, keepdim=True))


def uniform_quantize(w: torch.Tensor, bits: int = 8, axis: Optional[int] = -1,
                     eps: float = 1e-8,
                     reduce_axes: Optional[tuple] = None) -> UniformQ:
    """Paper Eq. (1)-(2); zero is always representable."""
    lo, hi = _minmax(w, axis, reduce_axes)
    lo = torch.clamp(lo, max=0.0)
    hi = torch.clamp(hi, min=0.0)
    qmax = float(2 ** bits - 1)
    scale = torch.clamp(div(hi - lo, qmax), min=eps)
    zp = torch.clamp(torch.round(div(-lo, scale)), 0.0, qmax)
    q = torch.clamp(torch.round(div(w, scale)) + zp, 0.0, qmax)
    return UniformQ(q=q.to(torch.int32), scale=scale, zero_point=zp,
                    bits=bits, axis=None if axis is None else axis % w.ndim)


def uniform_dequantize(u: UniformQ) -> torch.Tensor:
    return (u.q.to(torch.float32) - u.zero_point) * u.scale


def fake_quant_uniform(w: torch.Tensor, bits: int = 8,
                       axis: Optional[int] = -1) -> torch.Tensor:
    return uniform_dequantize(uniform_quantize(w, bits=bits, axis=axis))


# ---------------------------------------------------------------------------
# activations: 8-bit symmetric, layer-wise
# ---------------------------------------------------------------------------


def act_scale_from_stats(max_abs: torch.Tensor, bits: int = 8) -> torch.Tensor:
    qmax = float(2 ** (bits - 1) - 1)
    return torch.clamp(div(max_abs.to(torch.float32), qmax), min=1e-8)


def quantize_act(x: torch.Tensor, scale: torch.Tensor,
                 bits: int = 8) -> torch.Tensor:
    """``clip(round_half_even(x / scale), +-qmax)`` as int8.

    ``x`` is promoted to float32 first: JAX promotes ``bf16 / f32`` to f32,
    torch would keep bf16 against a 0-d scale."""
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.round(div(x.to(torch.float32), scale))
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def fake_quant_act(x: torch.Tensor, scale: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    return quantize_act(x, scale, bits).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# PoT (paper Eq. 3): w_q = s * 2^p * S, p in [pmin, 0]
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoTQ:
    sign: torch.Tensor     # {-1, 0, +1} int8 (sign(w))
    p: torch.Tensor        # int8 exponent in [pmin, 0]
    is_zero: torch.Tensor  # bool: |w| / S below 2^(pmin - 1)
    scale: torch.Tensor    # keepdims per-channel f32 (S = max - min)
    bits: int
    axis: Optional[int]


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log(x) / log(2)`` in f32, the quotient ``jnp.log2`` computes (a
    native log2 rounds differently, and ``round(log2(.))`` would then
    differ from the reference's near every half-integer)."""
    return div(torch.log(x), torch.log(torch.full((), 2.0,
                                                  device=x.device)))


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal f32 replaced by a zero of its sign: the
    flush-to-zero the reference's CPU backend applies to the operands and
    results of its float arithmetic (torch keeps subnormals on both
    devices).  PoT meets subnormals at bits 8, whose exponents reach
    2^-127."""
    return torch.where(torch.abs(x) < torch.finfo(torch.float32).tiny,
                       x * 0, x)


def pot_log2(w: torch.Tensor, bits: int, axis: Optional[int], eps: float,
             reduce_axes):
    """PoT's exponents before rounding: (scale S, pmin, the zero mask,
    log2(|w| / S) with 0 where the mask is set)."""
    lo, hi = _minmax(w, axis, reduce_axes)
    scale = torch.clamp(hi - lo, min=eps)
    a = flush(div(flush(torch.abs(w)), scale))
    pmin = max(-(2 ** bits) + 1, -127)
    is_zero = a < flush(torch.full((), 2.0 ** (pmin - 1), device=w.device))
    return scale, pmin, is_zero, log2(torch.where(is_zero,
                                                  torch.ones_like(a), a))


def pot_quantize(w: torch.Tensor, bits: int = 8, axis: Optional[int] = -1,
                 eps: float = 1e-8, reduce_axes=None) -> PoTQ:
    """Paper Eq. (3), the reference's exactly: S = max(hi - lo, eps);
    exponents ``round_half_even(log2(|w| / S))`` clipped to [pmin, 0],
    where pmin = max(1 - 2^bits, -127) keeps every exponent in int8; an
    element below 2^(pmin - 1) of S is a zero.  Subnormals are flushed
    where the reference flushes them (:func:`flush`): a subnormal weight
    has sign 0, and at bits 8 the threshold 2^-128 is itself flushed, so
    nothing is a zero and a vanishing |w| / S clips to p = -127."""
    scale, pmin, is_zero, lg = pot_log2(w, bits, axis, eps, reduce_axes)
    p = torch.clamp(torch.round(lg), pmin, 0)
    return PoTQ(sign=torch.sign(flush(w)).to(torch.int8), p=p.to(torch.int8),
                is_zero=is_zero, scale=scale, bits=bits,
                axis=None if axis is None else axis % w.ndim)


def _pot_magnitudes() -> np.ndarray:
    """2^p for p = 0, -1, ..., -127 as the reference computes it:
    ``jnp.exp2`` is ``exp(f32(ln 2) * p)``, correctly rounded on its CPU
    backend and flushed, which is not 2^p from p = -13 down.  Taken from
    float64 here, so the table is the same on every device."""
    p = -np.arange(128, dtype=np.float32)
    mag = np.exp((np.float32(np.log(2.0)) * p).astype(np.float64))
    mag = mag.astype(np.float32)
    return np.where(mag < np.finfo(np.float32).tiny, 0, mag).astype(
        np.float32)


def pot_dequantize(t: PoTQ) -> torch.Tensor:
    mag = torch.from_numpy(_pot_magnitudes()).to(t.p.device)[
        -t.p.to(torch.int64)]
    val = flush(t.sign.to(torch.float32) * mag * t.scale)
    return torch.where(t.is_zero, torch.zeros_like(val), val)


def fake_quant_pot(w: torch.Tensor, bits: int = 8,
                   axis: Optional[int] = -1) -> torch.Tensor:
    return pot_dequantize(pot_quantize(w, bits=bits, axis=axis))


# ---------------------------------------------------------------------------
# APoT (paper Eq. 5): w_q = s * (2^-e1 + 2^-e2) * S, e in [0, EMAX]
# ---------------------------------------------------------------------------

APOT_EMAX = 7  # 3-bit exponent field per component


def apot_codebook(emax: int = APOT_EMAX) -> np.ndarray:
    """Every representable magnitude 2^-a + 2^-b (a <= b in [0, emax]),
    and 0, sorted ascending as float32: 37 values at emax 7."""
    vals = {0.0}
    for a in range(emax + 1):
        for b in range(a, emax + 1):
            vals.add(2.0 ** -a + 2.0 ** -b)
    return np.array(sorted(vals), dtype=np.float32)


def _apot_code_pairs(emax: int = APOT_EMAX):
    """Sorted magnitudes 2^-a + 2^-b (a <= b) and their exponent pairs."""
    pairs = {}
    for a in range(emax + 1):
        for b in range(a, emax + 1):
            pairs.setdefault(2.0 ** -a + 2.0 ** -b, (a, b))
    mags = sorted(pairs)
    e1 = np.array([pairs[m][0] for m in mags], dtype=np.int8)
    e2 = np.array([pairs[m][1] for m in mags], dtype=np.int8)
    return np.array(mags, dtype=np.float32), e1, e2


@dataclasses.dataclass
class APoTQ:
    sign: torch.Tensor     # {-1, +1} int8
    e1: torch.Tensor       # int8 in [0, emax]
    e2: torch.Tensor       # int8 in [0, emax]
    is_zero: torch.Tensor  # bool
    scale: torch.Tensor    # keepdims per-channel f32
    emax: int
    axis: int


# weights per step of apot_quantize's nearest-codebook search: each step
# holds two (chunk, 36) f32 intermediates, ~1.2 GB at this size
APOT_CHUNK = 1 << 22


def apot_quantize(w: torch.Tensor, axis: int = -1, emax: int = APOT_EMAX,
                  eps: float = 1e-8, reduce_axes=None) -> APoTQ:
    """Nearest-codebook APoT quantization.

    The index-to-exponent lookup is the reference's exactly: the codebook
    holds no zero entry, index 0 (the smallest magnitude) is flagged zero,
    and index i > 0 takes the exponents of entry i - 1.  Keeping it so is
    what makes the code bytes equal the JAX package's.

    The per-filter scale comes from the whole tensor; the search then
    runs over ``APOT_CHUNK`` weights at a time (in memory order), so its
    intermediates stay bounded on a (1024, 151936) lm_head.  Every step
    is elementwise, so the codes do not depend on ``APOT_CHUNK``."""
    lo, hi = _minmax(w, axis, reduce_axes)
    scale = torch.clamp(hi - lo, min=eps)
    a = div(torch.abs(w), scale).reshape(-1)
    mags, ce1, ce2 = _apot_code_pairs(emax)
    mags_t = torch.from_numpy(mags).to(w.device)
    idx = torch.empty(a.shape, dtype=torch.int64, device=w.device)
    for s in range(0, a.numel(), APOT_CHUNK):
        idx[s:s + APOT_CHUNK] = torch.argmin(
            torch.abs(a[s:s + APOT_CHUNK, None] - mags_t), dim=-1)
    idx = idx.reshape(w.shape)
    is_zero = idx == 0
    e1 = torch.from_numpy(np.concatenate([[emax], ce1]).astype(np.int8))
    e2 = torch.from_numpy(np.concatenate([[emax], ce2]).astype(np.int8))
    sign = torch.where(w < 0, -1, 1).to(torch.int8)
    return APoTQ(sign=sign, e1=e1.to(w.device)[idx], e2=e2.to(w.device)[idx],
                 is_zero=is_zero, scale=scale, emax=emax, axis=axis % w.ndim)


def apot_dequantize(t: APoTQ) -> torch.Tensor:
    mag = (torch.exp2(-t.e1.to(torch.float32))
           + torch.exp2(-t.e2.to(torch.float32)))
    val = t.sign.to(torch.float32) * mag * t.scale
    return torch.where(t.is_zero, torch.zeros_like(val), val)


def fake_quant_apot(w: torch.Tensor, axis: int = -1,
                    emax: int = APOT_EMAX) -> torch.Tensor:
    return apot_dequantize(apot_quantize(w, axis=axis, emax=emax))


def filterwise_mse(w: torch.Tensor, w_hat: torch.Tensor,
                   axis: int = -1) -> torch.Tensor:
    """Per-filter mean squared quantization error (drives Eq. 6)."""
    axis = axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    return torch.mean((w - w_hat) ** 2, dim=red)

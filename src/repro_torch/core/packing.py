"""Bit-packing for the M2Q storage formats (twin of ``repro.core.packing``).

* int4: two 4-bit unsigned codes per uint8, low nibble = even index,
  packed along the last axis.
* APoT codes: one byte per weight -- bit7 = zero flag, bit6 = sign
  (1 = negative), bits5..3 = e1, bits2..0 = e2.
"""
from __future__ import annotations

import torch

from .quant import APoTQ, UniformQ

ZERO_BIT = 0x80
SIGN_BIT = 0x40


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack codes 0..15 pairwise along the last axis (even length)."""
    if q.shape[-1] % 2:
        raise ValueError(f"last dim must be even to pack int4, got "
                         f"{tuple(q.shape)}")
    q = q.to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; uint8 values in 0..15."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def apot_encode(t: APoTQ) -> torch.Tensor:
    """One code byte per weight (see module docstring)."""
    e1 = t.e1.to(torch.uint8) & 0x07
    e2 = t.e2.to(torch.uint8) & 0x07
    neg = (t.sign < 0).to(torch.uint8) * SIGN_BIT
    zero = t.is_zero.to(torch.uint8) * ZERO_BIT
    return zero | neg | (e1 << 3) | e2


def apot_decode_values(codes: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Unscaled values s*(2^-e1 + 2^-e2), zero where bit7 is set."""
    e1 = ((codes >> 3) & 0x07).to(torch.float32)
    e2 = (codes & 0x07).to(torch.float32)
    mag = torch.exp2(-e1) + torch.exp2(-e2)
    val = torch.where((codes & SIGN_BIT) != 0, -mag, mag)
    val = torch.where((codes & ZERO_BIT) != 0, torch.zeros_like(val), val)
    return val.to(dtype)


def apot_decode_units(codes: torch.Tensor) -> torch.Tensor:
    """The same decode as integers in units of 2^-7:
    s*(2^(7-e1) + 2^(7-e2)), 0 where bit7 is set (int32).  Every value
    and every dot product of it with int8 activations is exact."""
    c = codes.to(torch.int32)
    mag = (1 << (7 - ((c >> 3) & 7))) + (1 << (7 - (c & 7)))
    val = torch.where((c & SIGN_BIT) != 0, -mag, mag)
    return torch.where((c & ZERO_BIT) != 0, torch.zeros_like(val), val)


def store_uniform(u: UniformQ) -> torch.Tensor:
    """The integer payload at its storage width: 4-bit packed two to a
    byte along the last axis, any other width one uint8 per weight."""
    if u.bits == 4:
        return pack_int4(u.q)
    return u.q.to(torch.uint8)


def load_uniform(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`store_uniform`: int32 codes."""
    if bits == 4:
        return unpack_int4(payload).to(torch.int32)
    return payload.to(torch.int32)

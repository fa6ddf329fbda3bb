"""QTensor leaves: quantized weights and their plain execution paths
(twin of ``repro.core.qtensor``).

* :class:`QUniform` -- b-bit uniform weights; 8-bit payloads are stored as
  int8 ``q - 128`` with the offset folded into the zero point, 4-bit
  payloads are nibble-packed along the last axis.
* :class:`QAPoT` -- one APoT code byte per weight.
* :class:`QM2Q` -- a mixed-scheme layer in the merged layout: one byte per
  weight in ORIGINAL filter order (uniform byte or APoT code per column)
  with zero-masked per-column scales.

Each leaf keeps the JAX leaf's fields under the same names; ``shape`` is
the original float weight's (HWIO for a conv filter whose payload was
flattened to ``(kh*kw*cin, cout)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import packing
from .quant import (act_scale_from_stats, apot_quantize, fake_quant_act,
                    uniform_quantize)

I8_OFFSET = 128


def _act_scale(act_max_abs) -> Optional[torch.Tensor]:
    if act_max_abs is None:
        return None
    return act_scale_from_stats(torch.as_tensor(act_max_abs,
                                                dtype=torch.float32))


@dataclasses.dataclass
class QUniform:
    payload: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor            # stored domain (offset folded, 8-bit)
    act_scale: Optional[torch.Tensor]
    bits: int
    axis: int
    shape: tuple

    @classmethod
    def quantize(cls, w: torch.Tensor, bits: int = 8, axis: int = -1,
                 act_max_abs=None, reduce_axes=None) -> "QUniform":
        u = uniform_quantize(w, bits=bits, axis=axis, reduce_axes=reduce_axes)
        zp = u.zero_point
        if bits == 8:
            payload = (u.q - I8_OFFSET).to(torch.int8)
            zp = zp - I8_OFFSET
        elif bits == 4:
            payload = packing.pack_int4(u.q)
        else:
            payload = u.q.to(torch.uint8)
        act = _act_scale(act_max_abs)
        return cls(payload, u.scale, zp,
                   None if act is None else act.to(w.device), bits,
                   axis % w.ndim, tuple(w.shape))

    def _int_payload(self) -> torch.Tensor:
        if self.bits == 4:
            return packing.unpack_int4(self.payload).to(torch.int32)
        return self.payload.to(torch.int32)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        q = self._int_payload().to(torch.float32)
        return ((q - self.zero_point) * self.scale).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """y = x @ W; the W8A8 integer path when calibrated 8-bit."""
        if self.bits == 8 and self.act_scale is not None:
            from ..kernels.int8_matmul import int8_matmul_plain
            y = int8_matmul_plain(x.reshape(-1, x.shape[-1]), self.payload,
                                  self.act_scale, self.scale.reshape(-1),
                                  self.zero_point.reshape(-1))
            return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
        return x @ self.dequant(x.dtype)

    def take(self, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """Quantized embedding gather (axis-0, per-row quantization): the
        integer rows are gathered -- 4-bit rows still packed -- and only
        the gathered slice is dequantized."""
        if self.axis != 0:
            raise ValueError("take() needs per-row quantization (axis=0)")
        rows = self.payload[ids]
        q = (packing.unpack_int4(rows) if self.bits == 4 else rows)
        q = q.to(torch.float32)
        return ((q - self.zero_point[ids]) * self.scale[ids]).to(dtype)


@dataclasses.dataclass
class QAPoT:
    codes: torch.Tensor                 # (K, N) uint8
    scale: torch.Tensor                 # (1, N) f32
    act_scale: Optional[torch.Tensor]
    shape: tuple

    @classmethod
    def quantize(cls, w: torch.Tensor, act_max_abs=None,
                 reduce_axes=None) -> "QAPoT":
        t = apot_quantize(w, axis=-1, reduce_axes=reduce_axes)
        act = _act_scale(act_max_abs)
        return cls(packing.apot_encode(t), t.scale,
                   None if act is None else act.to(w.device), tuple(w.shape))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return (packing.apot_decode_values(self.codes) * self.scale).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_scale is not None:
            x = fake_quant_act(x, self.act_scale.to(x.dtype))
        y = x @ packing.apot_decode_values(self.codes, dtype=x.dtype)
        return y * self.scale.reshape(-1).to(x.dtype)


def _merge_halves(up, uscale, uzp, codes, ascale, inv_perm):
    """[uniform | apot] columns -> one int8 array in original filter order
    with zero-masked scales (the offline inverse permutation)."""
    zeros_u = torch.zeros((1, codes.shape[-1]), dtype=torch.float32,
                          device=up.device)
    zeros_a = torch.zeros((1, up.shape[-1]), dtype=torch.float32,
                          device=up.device)
    payload = torch.cat([up, codes.view(torch.int8)], dim=-1)
    u_scale = torch.cat([uscale, zeros_u], dim=-1)
    u_zp = torch.cat([uzp, zeros_u], dim=-1)
    a_scale = torch.cat([zeros_a, ascale], dim=-1)
    return (payload[:, inv_perm].contiguous(), u_scale[:, inv_perm],
            u_zp[:, inv_perm], a_scale[:, inv_perm])


@dataclasses.dataclass
class QM2Q:
    payload: torch.Tensor               # (K, N) int8 merged bytes
    u_scale: torch.Tensor               # (1, N) f32, 0 on APoT columns
    u_zp: torch.Tensor                  # (1, N) f32, 0 on APoT columns
    a_scale: torch.Tensor               # (1, N) f32, 0 on uniform columns
    act_scale: Optional[torch.Tensor]
    shape: tuple
    n_uniform: int
    n_apot: int

    @classmethod
    def quantize(cls, w: torch.Tensor, apot_idx, uniform_idx,
                 act_max_abs=None) -> "QM2Q":
        w2 = w.reshape(-1, w.shape[-1])
        ui = torch.as_tensor(uniform_idx, dtype=torch.long, device=w.device)
        ai = torch.as_tensor(apot_idx, dtype=torch.long, device=w.device)
        u = uniform_quantize(w2[:, ui], bits=8, axis=-1)
        t = apot_quantize(w2[:, ai], axis=-1)
        inv_perm = torch.argsort(torch.cat([ui, ai]))
        payload, u_scale, u_zp, a_scale = _merge_halves(
            (u.q - I8_OFFSET).to(torch.int8), u.scale,
            u.zero_point - I8_OFFSET, packing.apot_encode(t), t.scale,
            inv_perm)
        act = _act_scale(act_max_abs)
        return cls(payload, u_scale, u_zp, a_scale,
                   None if act is None else act.to(w.device), tuple(w.shape),
                   int(ui.numel()), int(ai.numel()))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        qi = self.payload.to(torch.float32)
        wu = (qi - self.u_zp) * self.u_scale
        wa = (packing.apot_decode_values(self.payload.view(torch.uint8))
              * self.a_scale)
        return (wu + wa).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """The plain merged matmul (twin of ``QM2Q.matmul``); x (..., K)."""
        if self.act_scale is None:
            return x @ self.dequant(x.dtype)
        from ..kernels.m2q_matmul import m2q_matmul_plain
        y = m2q_matmul_plain(x.reshape(-1, x.shape[-1]), self.act_scale,
                             self.payload, self.u_scale.reshape(-1),
                             self.u_zp.reshape(-1), self.a_scale.reshape(-1))
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


QLeaf = (QUniform, QAPoT, QM2Q)

# each leaf's array fields in the order the JAX leaf's pytree flattens
# them (its children; the other fields are its static aux data): a
# checkpoint keys child i of the leaf at ``path`` as ``path/i`` and writes
# nothing for a None child
CHILDREN = {QUniform: ("payload", "scale", "zero_point", "act_scale"),
            QAPoT: ("codes", "scale", "act_scale"),
            QM2Q: ("payload", "u_scale", "u_zp", "a_scale", "act_scale")}


def slice_layer(leaf, i: int):
    """Layer ``i`` of a stacked leaf, as ``lax.scan`` slices the JAX
    pytree: every tensor field loses its leading layer axis, while the
    static fields -- ``axis``, ``shape``, ``bits`` -- stay as they are.  A
    sliced stacked QUniform therefore keeps ``axis == 2``, which
    ``kernels.ops.kernel_supported`` refuses exactly as JAX's does, and
    its matmul takes the plain ``x @ dequant(x.dtype)``."""
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    if isinstance(leaf, QLeaf):
        return dataclasses.replace(leaf, **{
            f.name: getattr(leaf, f.name)[i]
            for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)})
    return leaf[i]  # a CalibTensor: per-layer '<path>@<i>' stats


def is_qtensor(x) -> bool:
    return isinstance(x, QLeaf)


def weight_bits(qt) -> float:
    """Average STORED bits per weight (only 4-bit payloads are packed)."""
    if isinstance(qt, QUniform):
        return 4.0 if qt.bits == 4 else 8.0
    if isinstance(qt, (QAPoT, QM2Q)):
        return 8.0
    raise TypeError(type(qt))

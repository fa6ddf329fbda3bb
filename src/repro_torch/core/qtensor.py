"""QTensor leaves: quantized weights and their plain execution paths
(twin of ``repro.core.qtensor``).

* :class:`QUniform` -- b-bit uniform weights; 8-bit payloads are stored as
  int8 ``q - 128`` with the offset folded into the zero point, 4-bit
  payloads are nibble-packed along the last axis.
* :class:`QAPoT` -- one APoT code byte per weight.
* :class:`QM2Q` -- a mixed-scheme layer in the merged layout: one byte per
  weight in ORIGINAL filter order (uniform byte or APoT code per column)
  with zero-masked per-column scales; perm-folded FFN members keep
  [uniform | apot] order instead.
* :class:`QExpertM2Q` -- the same layout over a stacked (L, K, N) weight
  or an MoE expert weight ((E, K, N); (L, E, K, N) stacked over layers),
  with per-slice Eq. 6 splits.

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
                    int_einsum, quantize_act, uniform_quantize)

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


def _merge_halves(up, uscale, uzp, codes, ascale, inv_perm=None):
    """[uniform | apot] columns -> one int8 array with zero-masked scales.

    ``inv_perm`` restores original filter order once, offline: (N,) for a
    (K, N) payload, or per slice (B, N) for a batched (B, K, N) one.  None
    keeps the [uniform | apot] order (a perm-folded FFN member)."""
    zeros_u = torch.zeros(codes.shape[:-2] + (1, codes.shape[-1]),
                          dtype=torch.float32, device=up.device)
    zeros_a = torch.zeros(up.shape[:-2] + (1, up.shape[-1]),
                          dtype=torch.float32, device=up.device)
    merged = (torch.cat([up, codes.view(torch.int8)], dim=-1),
              torch.cat([uscale, zeros_u], dim=-1),
              torch.cat([uzp, zeros_u], dim=-1),
              torch.cat([zeros_a, ascale], dim=-1))
    if inv_perm is None:
        return merged
    if inv_perm.ndim == 1:
        return tuple(t[..., inv_perm].contiguous() for t in merged)
    ip = inv_perm[..., None, :]
    return tuple(torch.gather(t, -1, ip.expand(t.shape)) for t in merged)


@dataclasses.dataclass
class _Merged:
    """The merged layout's fields and its dequant / plain matmul, shared
    by :class:`QM2Q` and :class:`QExpertM2Q` (JAX's ``_merged_dequant`` /
    ``_merged_matmul``)."""

    payload: torch.Tensor               # (..., K, N) int8 merged bytes
    u_scale: torch.Tensor               # (..., 1, N) f32, 0 on APoT columns
    u_zp: torch.Tensor                  # (..., 1, N) f32, 0 on APoT columns
    a_scale: torch.Tensor               # (..., 1, N) f32, 0 on uniform cols
    act_scale: Optional[torch.Tensor]
    shape: tuple
    n_uniform: int
    n_apot: int

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        qi = self.payload.to(torch.float32)
        wu = (qi - self.u_zp) * self.u_scale
        wa = (packing.apot_decode_values(self.payload.view(torch.uint8))
              * self.a_scale)
        return (wu + wa).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """The plain merged matmul of a 2-D payload (a layer slice of a
        stacked leaf included); x (..., K)."""
        if self.act_scale is None:
            return x @ self.dequant(x.dtype)
        from ..kernels.m2q_matmul import m2q_matmul_plain
        y = m2q_matmul_plain(x.reshape(-1, x.shape[-1]),
                             self.act_scale.reshape(()), self.payload,
                             self.u_scale.reshape(-1),
                             self.u_zp.reshape(-1), self.a_scale.reshape(-1))
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


def _merged_fields(w, ui, ai, reduce_axes, inv_perm):
    """Quantize the uniform columns ``w[..., ui]`` (8-bit) and the APoT
    columns ``w[..., ai]`` and merge them (:func:`_merge_halves`)."""
    wu = w[:, ui] if ui.ndim == 1 else torch.gather(
        w, -1, ui[:, None, :].expand(-1, w.shape[1], -1))
    wa = w[:, ai] if ai.ndim == 1 else torch.gather(
        w, -1, ai[:, None, :].expand(-1, w.shape[1], -1))
    u = uniform_quantize(wu, bits=8, axis=-1, reduce_axes=reduce_axes)
    t = apot_quantize(wa, axis=-1, reduce_axes=reduce_axes)
    return _merge_halves((u.q - I8_OFFSET).to(torch.int8), u.scale,
                         u.zero_point - I8_OFFSET, packing.apot_encode(t),
                         t.scale, inv_perm)


@dataclasses.dataclass
class QM2Q(_Merged):
    """A mixed-scheme (K, N) layer: one byte per weight, columns in
    original filter order -- or, perm-folded, in [uniform | apot] order
    with the consumer's rows permuted to match (stacked (L, K, N) then)."""

    @classmethod
    def quantize(cls, w: torch.Tensor, apot_idx, uniform_idx,
                 act_max_abs=None, fold_perm: bool = False) -> "QM2Q":
        w2 = w.reshape(-1, w.shape[-1])
        ui = torch.as_tensor(uniform_idx, dtype=torch.long, device=w.device)
        ai = torch.as_tensor(apot_idx, dtype=torch.long, device=w.device)
        inv_perm = None if fold_perm else torch.argsort(torch.cat([ui, ai]))
        act = _act_scale(act_max_abs)
        return cls(*_merged_fields(w2, ui, ai, None, inv_perm),
                   None if act is None else act.to(w.device), tuple(w.shape),
                   int(ui.numel()), int(ai.numel()))

    def scheme_mask(self) -> torch.Tensor:
        """(N,) bool: True where the column is uniform-quantized."""
        return self.a_scale.reshape(-1) == 0.0


@dataclasses.dataclass
class QExpertM2Q(_Merged):
    """Merged mixed-scheme quantization of a batched (B, K, N) weight --
    the layers of a stacked dense weight, or the E experts of one MoE
    layer: per-(slice, filter) scales and a per-slice Eq. 6 split of equal
    counts (``n_uniform`` / ``n_apot`` per slice).  A layer slice of a
    stacked dense leaf has a 2-D payload and a (1, 1) activation scale,
    and runs ``m2q_matmul``; an expert leaf stacks the layers' (E, K, N)
    leaves into (L, E, K, N), and its layer slice runs
    :meth:`expert_matmul` (``m2q_matmul`` expert by expert on the
    card)."""

    @classmethod
    def quantize(cls, w: torch.Tensor, apot_idx, uniform_idx,
                 act_max_abs=None) -> "QExpertM2Q":
        """apot_idx / uniform_idx: (B, Na) / (B, Nu) per-slice filters."""
        ui = torch.as_tensor(uniform_idx, dtype=torch.long, device=w.device)
        ai = torch.as_tensor(apot_idx, dtype=torch.long, device=w.device)
        inv_perm = torch.argsort(torch.cat([ui, ai], dim=-1), dim=-1)
        act = _act_scale(act_max_abs)
        return cls(*_merged_fields(w, ui, ai, (1,), inv_perm),
                   None if act is None else act.to(w.device), tuple(w.shape),
                   int(ui.shape[-1]), int(ai.shape[-1]))

    def expert_matmul(self, xe: torch.Tensor) -> torch.Tensor:
        """``y[E, C, N] = xe[E, C, K] @ w[E, K, N]`` for an (E, K, N)
        payload (an expert leaf's layer slice), in xe's dtype: the
        dequantized einsum without an activation scale, else the integer
        path of JAX's ``expert_matmul`` -- int8 x int8 sums exact, the
        APoT half in units of 2^-7 (:func:`m2q_matmul_plain`'s arithmetic
        expert by expert, so bit for bit what ``m2q_matmul`` gives)."""
        if self.act_scale is None:
            return torch.einsum("eck,ekn->ecn", xe, self.dequant(xe.dtype))
        sa = self.act_scale.reshape(())
        xq = quantize_act(xe, sa)
        acc = int_einsum("eck,ekn->ecn", xq, self.payload)
        acc_a = int_einsum("eck,ekn->ecn", xq, packing.apot_decode_units(
            self.payload.view(torch.uint8)))
        xsum = xq.to(torch.int32).sum(dim=-1, keepdim=True)
        yu = (acc - xsum.to(torch.float32) * self.u_zp) * self.u_scale
        ya = (acc_a * 0.0078125) * self.a_scale
        return ((yu + ya) * sa).to(xe.dtype)


QLeaf = (QUniform, QAPoT, QM2Q, QExpertM2Q)

# each leaf's array fields in the order the JAX leaf's pytree flattens
# them (its children; the other fields are its static aux data): a
# checkpoint keys child i of the leaf at ``path`` as ``path/i`` and writes
# nothing for a None child
_MERGED = ("payload", "u_scale", "u_zp", "a_scale", "act_scale")
CHILDREN = {QUniform: ("payload", "scale", "zero_point", "act_scale"),
            QAPoT: ("codes", "scale", "act_scale"),
            QM2Q: _MERGED, QExpertM2Q: _MERGED}


def slice_layer(leaf, i: int):
    """Layer ``i`` of a stacked leaf, as ``lax.scan`` slices the JAX
    pytree: every tensor field loses its leading layer axis, while the
    static fields -- ``axis``, ``shape``, ``bits``, ``n_uniform``,
    ``n_apot`` -- stay as they are.  A sliced stacked QUniform therefore
    keeps ``axis == 2``, which ``kernels.ops.kernel_supported`` refuses
    exactly as JAX's does, and its matmul takes the plain ``x @
    dequant(x.dtype)``; a sliced QExpertM2Q has a 2-D payload and a (1, 1)
    activation scale, which it accepts.  A slice of a stacked (L, E, K, N)
    expert leaf keeps E: an (E, K, N) payload, (E, 1, N) scales, a (1, 1,
    1) activation scale."""
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    if isinstance(leaf, QLeaf):
        return dataclasses.replace(leaf, **{
            f.name: getattr(leaf, f.name)[i]
            for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)})
    return leaf[i]  # a CalibTensor: per-layer '<path>@<i>' stats


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ W`` through the leaf's plain matmul (JAX's entry point for
    ``nn.dense``): what ``kernels.ops.qtensor_matmul`` runs for a leaf no
    kernel takes."""
    return w.matmul(x)


def is_qtensor(x) -> bool:
    return isinstance(x, QLeaf)


def weight_bits(qt) -> float:
    """Average STORED bits per weight (only 4-bit payloads are packed)."""
    if isinstance(qt, QUniform):
        return 4.0 if qt.bits == 4 else 8.0
    if isinstance(qt, (QAPoT, QM2Q, QExpertM2Q)):
        return 8.0
    raise TypeError(type(qt))

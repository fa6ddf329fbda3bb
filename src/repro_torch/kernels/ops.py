"""QTensor-level entry points onto the kernels (twin of the
``kernel_supported`` / ``qtensor_matmul`` / ``qtensor_dwconv`` /
``relu_attn_op`` / ``decode_attn_int8_op`` part of ``repro.kernels.ops``).

:func:`qtensor_matmul` routes exactly the leaves the JAX package's
``kernel_supported`` accepts to a kernel: calibrated 2-D ``QM2Q`` and
layer-sliced ``QExpertM2Q`` -> ``m2q_matmul``; 2-D ``QUniform`` (axis 1)
at 8 bits with an activation scale -> ``int8_matmul``, at 4 bits ->
``int4_matmul``; 2-D ``QAPoT`` without an activation scale ->
``apot_matmul``.  Every other leaf takes its
plain QTensor ``matmul``, as JAX's ``qmatmul`` does.
:func:`qtensor_expert_matmul` runs an MoE expert product: a calibrated
layer slice of a ``QExpertM2Q`` expert leaf goes to ``m2q_matmul`` one
expert at a time (the kernel takes a 2-D payload, as JAX's
``kernel_supported`` says).  Each kernel wrapper
launches the CUDA kernel for CUDA tensors and runs the plain version for
CPU tensors.  Nothing falls back: a kernel that fails to build or launch
raises.  The one switch is :func:`reference_path`, an explicit scope in
which the plain versions run on any device -- the reference a caller
compares the kernels against.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

from ..core.qtensor import QAPoT, QExpertM2Q, QM2Q, QUniform, qmatmul
from . import apot_matmul as _apot
from . import decode_attn_int8 as _dec
from . import dwconv_w4 as _dw
from . import int4_matmul as _int4
from . import int8_matmul as _int8
from . import m2q_matmul as _m2q
from . import relu_attn as _attn
from . import relu_attn_scales as _scales

ATTN_INT8 = "int8"
ATTN_F32 = "f32"

_REFERENCE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_reference_path", default=False)


@contextlib.contextmanager
def reference_path():
    """Run the plain PyTorch versions instead of the kernels, on any
    device, inside this scope."""
    token = _REFERENCE.set(True)
    try:
        yield
    finally:
        _REFERENCE.reset(token)


def default_attn(device: torch.device) -> str:
    """The MSA token mixer's default numerics: the int8 kernel on CUDA (as
    the JAX package defaults to its kernel on a TPU), the f32 einsums
    elsewhere.  int8 changes numerics by quantization error, so
    strict-parity callers pass ``attn`` explicitly."""
    return ATTN_INT8 if torch.device(device).type == "cuda" else ATTN_F32


def kernel_supported(qt) -> bool:
    """True when a kernel computes this leaf's matmul (twin of JAX's
    ``kernel_supported``): a 2-D weight whose activation handling the
    kernel shares -- calibrated int paths quantize activations,
    weights-only paths do not."""
    if isinstance(qt, (QM2Q, QExpertM2Q)):
        return qt.payload.ndim == 2 and qt.act_scale is not None
    if isinstance(qt, QUniform):
        if qt.payload.ndim != 2 or qt.axis != 1:
            return False
        return qt.bits == 4 or (qt.bits == 8 and qt.act_scale is not None)
    if isinstance(qt, QAPoT):
        return qt.codes.ndim == 2 and qt.act_scale is None
    return False


def _kernel_matmul(x2: torch.Tensor, qt) -> torch.Tensor:
    """x2 (M, K) through the leaf's kernel (or its plain version inside
    :func:`reference_path`) -> (M, N): x2's dtype from ``int8_matmul``,
    which stores it itself, f32 from the others."""
    ref = _REFERENCE.get()
    if isinstance(qt, (QM2Q, QExpertM2Q)):
        # a layer slice's (1, 1) activation scale goes in as one element
        fn = _m2q.m2q_matmul_plain if ref else _m2q.m2q_matmul
        return fn(x2, qt.act_scale.reshape(()), qt.payload,
                  qt.u_scale.reshape(-1), qt.u_zp.reshape(-1),
                  qt.a_scale.reshape(-1))
    if isinstance(qt, QAPoT):
        fn = _apot.apot_matmul_plain if ref else _apot.apot_matmul
        return fn(x2, qt.codes, qt.scale.reshape(-1))
    if qt.bits == 8:
        fn = _int8.int8_matmul_plain if ref else _int8.int8_matmul
        return fn(x2, qt.payload, qt.act_scale, qt.scale.reshape(-1),
                  qt.zero_point.reshape(-1), out_dtype=x2.dtype)
    fn = _int4.int4_matmul_plain if ref else _int4.int4_matmul
    return fn(x2, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1))


def expert_kernel_supported(qt) -> bool:
    """True when ``m2q_matmul`` computes this expert product expert by
    expert: a layer slice of a calibrated QExpertM2Q expert leaf (an (E,
    K, N) payload and one activation scale for the layer)."""
    return (isinstance(qt, QExpertM2Q) and qt.payload.ndim == 3
            and qt.act_scale is not None and qt.act_scale.numel() == 1)


def qtensor_expert_matmul(xe: torch.Tensor, qt: QExpertM2Q) -> torch.Tensor:
    """``y[E, C, N] = xe[E, C, K] @ W[E, K, N]`` in xe's dtype for a layer
    slice of a QExpertM2Q expert leaf: E ``m2q_matmul`` calls, expert
    ``e``'s (C, K) rows against its (K, N) payload with the layer's
    activation scale (the plain version inside :func:`reference_path`);
    exactly :meth:`QExpertM2Q.expert_matmul`, which an uncalibrated leaf
    takes."""
    if not expert_kernel_supported(qt):
        return qt.expert_matmul(xe)
    fn = _m2q.m2q_matmul_plain if _REFERENCE.get() else _m2q.m2q_matmul
    sa = qt.act_scale.reshape(())
    xe = xe.contiguous()
    return torch.stack([
        fn(xe[e], sa, qt.payload[e], qt.u_scale[e].reshape(-1),
           qt.u_zp[e].reshape(-1), qt.a_scale[e].reshape(-1))
        for e in range(xe.shape[0])]).to(xe.dtype)


def qtensor_matmul(x: torch.Tensor, qt) -> torch.Tensor:
    """y = x @ W for a 2-D QTensor leaf; x (..., K) -> (..., N) in x.dtype
    (a cast of the kernel's f32 output, except where it stored x.dtype)."""
    if not kernel_supported(qt):
        return qmatmul(x, qt)
    y = _kernel_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qt)
    return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


def dwconv_supported(qt, x: torch.Tensor, stride: int, groups: int,
                     padding: str) -> bool:
    """True when the packed-w4 depthwise kernel computes this conv: a
    weights-only 4-bit QUniform with a depthwise HWIO shape, flattened to
    a (kh*kw, C/2) payload, under SAME padding, at a square window and
    stride the kernel builds (``dwconv_w4.WINDOWS``; JAX's twin likewise
    declines what its kernel cannot plan)."""
    if not isinstance(qt, QUniform) or qt.bits != 4 \
            or qt.act_scale is not None:
        return False
    if qt.payload.ndim != 2 or qt.axis != 1:
        return False
    if len(qt.shape) != 4 or qt.shape[2] != 1:
        return False
    kh, kw, _, c = qt.shape
    return (padding == "SAME" and kh == kw and (kh, stride) in _dw.WINDOWS
            and groups == c and x.shape[-1] == c
            and qt.payload.shape[0] == kh * kw)


def qtensor_dwconv(x: torch.Tensor, qt, stride: int = 1) -> torch.Tensor:
    """Depthwise conv for a 4-bit QUniform leaf; the kernel stores x.dtype
    (the f32 sum rounded once, as a cast of the f32 output would)."""
    kh, kw = int(qt.shape[0]), int(qt.shape[1])
    fn = _dw.dwconv_w4_plain if _REFERENCE.get() else _dw.dwconv_w4
    return fn(x.contiguous(), qt.payload, qt.scale.reshape(-1),
              qt.zero_point.reshape(-1), kh=kh, kw=kw, stride=stride,
              out_dtype=x.dtype)


def relu_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Int8 ReLU linear attention with tensor-wide scales: (B,N,H,D) in
    q's dtype (the kernel stores it; the plain version casts its f32
    result once).  The scales come from their own kernel, or the plain
    chain inside :func:`reference_path`."""
    ref = _REFERENCE.get()
    scales = (_scales.relu_attn_scales_plain if ref
              else _scales.relu_attn_scales)
    fn = _attn.relu_attn_plain if ref else _attn.relu_attn
    return fn(q, k, v, *scales(q, k, v), eps, q.dtype)


def decode_attn_int8_op(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        lengths: torch.Tensor, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the int8 KV cache: q (B, 1, Hq, D) float,
    k_q/v_q (B, T, Hkv, D) int8 + (B, T, Hkv) f32 row scales, lengths
    (B,) -> (B, 1, Hq, D) in q's dtype (the kernel stores it; the plain
    version's f32 result is cast once).  Runs per (batch, kv-head)."""
    B, _, Hq, D = q.shape
    Hkv = k_q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Hkv, Hq // Hkv, D).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    args = (qh, k_q, v_q, k_scale, v_scale, lens, scale, window)
    if _REFERENCE.get():
        out = _dec.decode_attn_int8_plain(*args).to(q.dtype)
    else:
        out = _dec.decode_attn_int8(*args, out_dtype=q.dtype)
    return out.reshape(B, 1, Hq, D)

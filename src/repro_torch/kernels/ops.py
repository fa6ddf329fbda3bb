"""Kernel dispatch and the entry points onto the kernels (twin of
``repro.kernels.ops``).

Dispatch control is LAYERED (see :class:`DispatchConfig`), in JAX's
order:

1. a scoped :func:`dispatch` context (programmatic, nestable -- what tests
   and the serving engines use),
2. the per-axis trip latch (:func:`trip_axis` / :func:`axis_tripped`): a
   tripped axis resolves to the plain path process-wide until
   :func:`reset_trip_latch`; an explicit scope still overrides it.
   Nothing in the port trips an axis on a failure (there is no
   ``FallbackGuard``, ROADMAP A5: a kernel that raises fails its batch);
   only an explicit caller does,
3. the ``REPRO_TORCH_DISPATCH`` / ``REPRO_TORCH_CONV_DISPATCH`` /
   ``REPRO_TORCH_ATTN_DISPATCH`` env vars (process-wide defaults; this
   module is the only place they are read; the JAX package reads its own
   ``REPRO_PALLAS_*``, so a switch meant for one never steers the other),
4. the backend default, by the tensor's device: on CUDA every axis is on
   (as JAX's axes are on a TPU).  On the CPU the dense and conv axes stay
   on -- a kernel wrapper given a CPU tensor runs its plain version, the
   route the CPU tests hold against JAX -- and the attn axis is off: the
   MSA mixer keeps its f32 einsums there, as JAX does on its CPU.

The ``dense`` axis steers QTensor matmuls (``nn.dense``, MoE experts),
``conv`` the quantized conv paths (PWConvs, the depthwise kernel, the
im2col stem), ``attn`` the int8 attention kernels (the MSA mixer's
``relu_attn``, the int8-KV decode attention); conv and attn follow dense
when unset.  An axis off means the plain QTensor path, the twin of JAX's
XLA path: ``qmatmul(x, qt)``, the dequantized depthwise conv, the f32 MSA
einsums, the plain decode chain.  The attn axis changes numerics on the
MSA (int8 quantization), which is why it has its own switch.

:func:`reference_path` is a different thing: the tests' oracle, a scope
in which every wrapper runs its plain version on any device.

The ``*_op`` entry points take a ``plan`` or ask :mod:`.autotune` for one
(cache first, then live tuning at an eager CUDA launch, else the
wrapper's ``launch_plan``), with a bench closure over their own operands;
``decode_attn_int8_op`` only notes its shape.  Each wrapper launches the
CUDA kernel for CUDA tensors and runs its plain version for CPU tensors.
Nothing falls back: a kernel that fails to build or launch raises.
While an op graph is being recorded (``analysis.opgraph``, qlint), each
entry point -- and each of ``relu_attn_op``'s two launches -- is one
kernel node that says which of the two ran.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
import os
import threading
from typing import Optional

import torch

from ..analysis import opgraph
from ..core.qtensor import QAPoT, QExpertM2Q, QM2Q, QUniform, qmatmul
from . import apot_matmul as _apot
from . import autotune
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


# how relu_attn's three tensor-wide scales are combined with the other
# ranks' (None: this rank's batch is the whole batch)
_SCALE_REDUCE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_scale_reduce", default=None)


@contextlib.contextmanager
def batch_scales(reduce):
    """Inside this scope ``relu_attn_op`` passes its (3,) f32 scales
    ``(sq, sk, sv)`` through ``reduce`` before the attention kernel: a
    data-parallel engine's max over the ``data`` ranks, so each rank's
    slice of a batch quantizes with the whole batch's scales, as under
    GSPMD (the scales are tensor-wide over the batch)."""
    token = _SCALE_REDUCE.set(reduce)
    try:
        yield
    finally:
        _SCALE_REDUCE.reset(token)


def _batch_scales(scales):
    reduce = _SCALE_REDUCE.get()
    if reduce is None:
        return scales
    out = reduce(torch.stack([s.reshape(()) for s in scales]))
    return out[0], out[1], out[2]


@contextlib.contextmanager
def reference_path():
    """Run the plain PyTorch versions instead of the kernels, on any
    device, inside this scope."""
    token = _REFERENCE.set(True)
    try:
        yield
    finally:
        _REFERENCE.reset(token)


# ---------------------------------------------------------------------------
# dispatch scopes, the trip latch, the three axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Scoped kernel-dispatch switches; ``None`` inherits the next layer.

    Any scoped field beats the env vars, so a scope with ``dense=True``
    also turns the conv and attn axes on over a ``...=0`` env var (pass
    ``conv=False`` / ``attn=False`` to keep an axis off).  Enter a scope
    with :func:`dispatch`, or hand the config to a serving engine
    (``Engine`` / ``VisionEngine`` / ``QuantizedModel.serve`` take
    ``dispatch=``), which enters it inside every step and graph capture.
    A CUDA graph replays the routing it was captured under; the engines
    key their graphs by the resolved axes (:func:`resolve`)."""

    dense: Optional[bool] = None
    conv: Optional[bool] = None
    attn: Optional[bool] = None

    def layered_over(self, base: "DispatchConfig") -> "DispatchConfig":
        return DispatchConfig(
            dense=self.dense if self.dense is not None else base.dense,
            conv=self.conv if self.conv is not None else base.conv,
            attn=self.attn if self.attn is not None else base.attn)


_DISPATCH_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dispatch_scope", default=DispatchConfig())


def active_dispatch() -> DispatchConfig:
    """The currently scoped DispatchConfig (all-None outside any scope)."""
    return _DISPATCH_SCOPE.get()


@contextlib.contextmanager
def dispatch(config: Optional[DispatchConfig] = None, *,
             dense: Optional[bool] = None, conv: Optional[bool] = None,
             attn: Optional[bool] = None):
    """Scope kernel dispatch (nestable; None inherits).

        with ops.dispatch(dense=True):          # kernels on
            with ops.dispatch(conv=False):      # ...but plain convs here
                ...

    Takes a :class:`DispatchConfig`, the fields directly, or both (the
    fields layer over the config); unset fields fall through to the
    enclosing scope, then the latch, the env vars and the backend
    default."""
    ov = DispatchConfig(dense, conv, attn)
    if config is not None:
        ov = ov.layered_over(config)
    token = _DISPATCH_SCOPE.set(ov.layered_over(_DISPATCH_SCOPE.get()))
    try:
        yield
    finally:
        _DISPATCH_SCOPE.reset(token)


_ENV = {"dense": "REPRO_TORCH_DISPATCH",
        "conv": "REPRO_TORCH_CONV_DISPATCH",
        "attn": "REPRO_TORCH_ATTN_DISPATCH"}


def _env_flag(name: str) -> Optional[bool]:
    env = os.environ.get(name)
    if env is None:
        return None
    return env.strip().lower() not in ("", "0", "false")


_TRIP_AXES = ("dense", "conv", "attn")
_TRIP_LATCH = {ax: 0 for ax in _TRIP_AXES}
_TRIP_LOCK = threading.Lock()


def trip_axis(axis: str) -> None:
    """Latch one dispatch axis onto the plain path (the process-wide
    default; an explicit :func:`dispatch` scope still wins).  Raises
    ``ValueError`` for an unknown axis."""
    if axis not in _TRIP_LATCH:
        raise ValueError(f"unknown dispatch axis {axis!r}; one of "
                         f"{_TRIP_AXES}")
    with _TRIP_LOCK:
        _TRIP_LATCH[axis] += 1


def axis_tripped(axis: str) -> bool:
    return _TRIP_LATCH.get(axis, 0) > 0


def trip_counts() -> dict:
    """Per-axis trip counters (what ``Supervisor.health()`` reports)."""
    with _TRIP_LOCK:
        return dict(_TRIP_LATCH)


def reset_trip_latch() -> None:
    """Clear every axis latch (tests; an operator re-arming kernels)."""
    with _TRIP_LOCK:
        for ax in _TRIP_LATCH:
            _TRIP_LATCH[ax] = 0


def _backend_default(axis: str, device) -> bool:
    if torch.device(device).type == "cuda":
        return True
    return axis != "attn"


def _axis_enabled(axis: str, device) -> bool:
    """Scope ``axis`` -> scope ``dense`` -> the ``axis`` latch and env var
    -> the ``dense`` latch and env var -> the backend default."""
    scope = _DISPATCH_SCOPE.get()
    for scoped in (getattr(scope, axis), scope.dense):
        if scoped is not None:
            return scoped
    for ax in dict.fromkeys((axis, "dense")):
        if axis_tripped(ax):
            return False
        env = _env_flag(_ENV[ax])
        if env is not None:
            return env
    return _backend_default(axis, device)


def dispatch_enabled(device) -> bool:
    """Should QTensor matmuls on ``device`` run the kernels?  Scope
    ``dense`` -> the ``dense`` latch -> ``REPRO_TORCH_DISPATCH`` -> the
    backend default."""
    return _axis_enabled("dense", device)


def conv_dispatch_enabled(device) -> bool:
    """Should quantized convs on ``device`` run the kernels (PWConv and
    the im2col stem -> the matmul kernels, depthwise -> dwconv_w4)?
    Scope ``conv`` -> scope ``dense`` -> the ``conv`` latch ->
    ``REPRO_TORCH_CONV_DISPATCH`` -> the dense axis's latch, env var and
    backend default."""
    return _axis_enabled("conv", device)


def attn_dispatch_enabled(device) -> bool:
    """Should attention on ``device`` run the int8 kernels (the MSA
    mixer's default -> relu_attn, int8-KV decode -> decode_attn_int8)?
    Layered exactly like the conv axis, over ``REPRO_TORCH_ATTN_DISPATCH``.
    The MSA path quantizes activations the f32 einsums do not, so
    strict-parity callers pin ``attn``."""
    return _axis_enabled("attn", device)


def resolve(device) -> DispatchConfig:
    """The three axes as they resolve here for ``device`` (what a CUDA
    graph captured now bakes in)."""
    return DispatchConfig(dispatch_enabled(device),
                          conv_dispatch_enabled(device),
                          attn_dispatch_enabled(device))


@contextlib.contextmanager
def engine_step(config: Optional[DispatchConfig]):
    """What a serving engine enters around every step and capture: its
    dispatch config (if any) and :func:`autotune.no_tuning` -- a step
    resolves plans from the cache or ``launch_plan``, never by timing."""
    with (dispatch(config) if config is not None
          else contextlib.nullcontext()), autotune.no_tuning():
        yield


# ---------------------------------------------------------------------------
# leaf routing
# ---------------------------------------------------------------------------


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


def expert_kernel_supported(qt) -> bool:
    """True when ``m2q_matmul`` computes this expert product expert by
    expert: a layer slice of a calibrated QExpertM2Q expert leaf (an (E,
    K, N) payload and one activation scale for the layer)."""
    return (isinstance(qt, QExpertM2Q) and qt.payload.ndim == 3
            and qt.act_scale is not None and qt.act_scale.numel() == 1)


def dwconv_kernel_supported(qt, x: torch.Tensor, stride: int, groups: int,
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


def dwconv_tile_plan(B: int, H: int, W: int, C: int, k: int, stride: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """The plan ``dwconv_w4`` launches for this conv at an engine step:
    the cache's entry, else ``dwconv_w4.launch_plan``'s (JAX's VMEM
    budget has no twin)."""
    return (autotune.cached_plan("dwconv_w4", (B, H, W, C, k, stride, dtype),
                                 device)
            or _plan_keys(_dw, _dw.launch_plan(B, H, W, C, k, stride)))


# ---------------------------------------------------------------------------
# the autotuned entry points
# ---------------------------------------------------------------------------


def _plan_keys(mod, plan: dict) -> dict:
    return {k: plan[k] for k in mod.PLAN_KEYS}


def _node(name: str, module):
    """The entry point as one kernel node of an op graph being recorded
    (``analysis.opgraph``): its tensor arguments in, its result out, the
    plain version's ops folded in."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if opgraph.active() is None:
                return fn(*args, **kwargs)
            with opgraph.kernel_node(name, module, (args, kwargs)) as node:
                return node.out(fn(*args, **kwargs))
        return op
    return wrap


def _plan(kernel: str, dims: tuple, device, fallback, candidates, launch):
    """Ask the autotuner for one launch's plan; ``launch(plan)`` runs the
    kernel uncounted (a probe, not a launch of the main path)."""
    return autotune.plan_for(
        kernel, dims, device, fallback=fallback, candidates=candidates,
        bench=lambda p: autotune.measure(lambda: launch(p)))


@_node("m2q_matmul", _m2q)
def m2q_matmul_op(x, act_scale, payload, u_scale, u_zp, a_scale,
                  plan: Optional[dict] = None) -> torch.Tensor:
    """Fused permutation-free M2Q matmul: x (M, K) float, payload (K, N)
    merged int8 bytes, u_scale/u_zp/a_scale (N,) zero-masked -> (M, N)
    f32.  ``plan``: the launch shape, else the autotuner's."""
    if _REFERENCE.get():
        return _m2q.m2q_matmul_plain(x, act_scale, payload, u_scale, u_zp,
                                     a_scale)
    M, K = x.shape
    N = payload.shape[1]
    if plan is None:
        plan = _plan(
            "m2q_matmul", (M, K, N, x.dtype), x.device,
            lambda: _plan_keys(_m2q, _m2q.launch_plan(M, K, N)),
            lambda: _m2q.candidate_plans(M, K, N),
            lambda p: _m2q._launch(x, act_scale, payload, u_scale, u_zp,
                                   a_scale, p))
    return _m2q.m2q_matmul(x, act_scale, payload, u_scale, u_zp, a_scale,
                           plan)


@_node("int8_matmul", _int8)
def int8_matmul_op(x, wq, act_scale, scale, zero_point,
                   out_dtype: torch.dtype = torch.float32,
                   plan: Optional[dict] = None) -> torch.Tensor:
    """W8A8 matmul: x (M, K) float, activation quantization fused ->
    (M, N) in ``out_dtype``."""
    if _REFERENCE.get():
        return _int8.int8_matmul_plain(x, wq, act_scale, scale, zero_point,
                                       out_dtype)
    M, K = x.shape
    N = wq.shape[1]
    if plan is None:
        plan = _plan(
            "int8_matmul", (M, K, N, x.dtype), x.device,
            lambda: _plan_keys(_int8, _int8.launch_plan(M, K, N)),
            lambda: _int8.candidate_plans(M, K, N),
            lambda p: _int8._launch(x, wq, act_scale, scale, zero_point,
                                    out_dtype, p))
    return _int8.int8_matmul(x, wq, act_scale, scale, zero_point, out_dtype,
                             plan)


@_node("int4_matmul", _int4)
def int4_matmul_op(x, packed, scale, zero_point,
                   plan: Optional[dict] = None) -> torch.Tensor:
    """Weights-only int4 matmul: x (M, K) float -> (M, N) f32."""
    if _REFERENCE.get():
        return _int4.int4_matmul_plain(x, packed, scale, zero_point)
    M, K = x.shape
    N = 2 * packed.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = _plan(
            "int4_matmul", (M, K, N, x.dtype), x.device,
            lambda: _plan_keys(_int4, _int4.launch_plan(M, K, N, bf16)),
            lambda: _int4.candidate_plans(M, K, N, bf16),
            lambda p: _int4._launch(x, packed, scale, zero_point, p))
    return _int4.int4_matmul(x, packed, scale, zero_point, plan)


@_node("apot_matmul", _apot)
def apot_matmul_op(x, codes, scale,
                   plan: Optional[dict] = None) -> torch.Tensor:
    """Weights-only APoT matmul: x (M, K) float -> (M, N) f32 (int4's
    plans: one template)."""
    if _REFERENCE.get():
        return _apot.apot_matmul_plain(x, codes, scale)
    M, K = x.shape
    N = codes.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = _plan(
            "apot_matmul", (M, K, N, x.dtype), x.device,
            lambda: _plan_keys(_int4, _int4.launch_plan(M, K, N, bf16)),
            lambda: _int4.candidate_plans(M, K, N, bf16),
            lambda p: _apot._launch(x, codes, scale, p))
    return _apot.apot_matmul(x, codes, scale, plan)


@_node("dwconv_w4", _dw)
def dwconv_w4_op(x, packed, scale, zero_point, kh: int = 3, kw: int = 3,
                 stride: int = 1, out_dtype: torch.dtype = torch.float32,
                 plan: Optional[dict] = None) -> torch.Tensor:
    """Depthwise conv, SAME padding: x (B, H, W, C) float, packed
    (kh*kw, C/2) nibbles -> (B, HO, WO, C) in ``out_dtype``."""
    if _REFERENCE.get():
        return _dw.dwconv_w4_plain(x, packed, scale, zero_point, kh, kw,
                                   stride, out_dtype)
    B, H, W, C = x.shape
    if plan is None:
        plan = _plan(
            "dwconv_w4", (B, H, W, C, kh, stride, x.dtype), x.device,
            lambda: _plan_keys(_dw, _dw.launch_plan(B, H, W, C, kh, stride)),
            lambda: _dw.candidate_plans(B, H, W, C, kh, stride,
                                        x.element_size()),
            lambda p: _dw._launch(x, packed, scale, zero_point, kh, kw,
                                  stride, out_dtype, p))
    return _dw.dwconv_w4(x, packed, scale, zero_point, kh, kw, stride,
                         out_dtype, plan)


def relu_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 eps: float = 1e-6,
                 plan: Optional[dict] = None) -> torch.Tensor:
    """Int8 ReLU linear attention with tensor-wide scales: (B,N,H,D) in
    q's dtype (the kernel stores it; the plain version casts its f32
    result once).  The scales come from their own kernel (its
    ``launch_plan``: JAX has no block choice for them), or the plain chain
    inside :func:`reference_path`."""
    ref = _REFERENCE.get()
    with opgraph.kernel_node("relu_attn_scales", _scales, (q, k, v)) as node:
        scales = node.out((_scales.relu_attn_scales_plain if ref
                           else _scales.relu_attn_scales)(q, k, v))
    scales = _batch_scales(scales)
    with opgraph.kernel_node("relu_attn", _attn, (q, k, v, scales)) as node:
        if ref:
            return node.out(_attn.relu_attn_plain(q, k, v, *scales, eps,
                                                  q.dtype))
        B, N, H, D = q.shape
        if plan is None:
            plan = _plan(
                "relu_attn", (B, N, H, D, q.dtype), q.device,
                lambda: {"splits": _attn.launch_plan(B, N, H, D)["splits"]},
                lambda: _attn.candidate_plans(B, N, H, D),
                lambda p: _attn._launch(q, k, v, *scales, eps, q.dtype, p))
        return node.out(_attn.relu_attn(q, k, v, *scales, eps, q.dtype,
                                        plan))


def decode_attn_int8_op(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        lengths: torch.Tensor, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the int8 KV cache: q (B, 1, Hq, D) float,
    k_q/v_q (B, T, Hkv, D) int8 + (B, T, Hkv) f32 row scales, lengths
    (B,) -> (B, 1, Hq, D) in q's dtype (the kernel stores it; the plain
    version's f32 result is cast once).  Runs per (batch, kv-head).  Its
    one plan (``decode_attn_int8.PLAN``) is not tuned, as in JAX: the
    shape is only noted for the sweep."""
    B, _, Hq, D = q.shape
    T, Hkv = k_q.shape[1], k_q.shape[2]
    ref = _REFERENCE.get()
    if not ref:
        autotune.note_shape("decode_attn_int8",
                            (B, Hq, D, Hkv, T, window or 0))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Hkv, Hq // Hkv, D).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    # a model-sharded engine hands in its heads' slice of the replicated
    # (B, T, Hkv_all) scales: a strided view, copied here
    args = (qh, k_q, v_q, k_scale.contiguous(), v_scale.contiguous(), lens,
            scale, window)
    with opgraph.kernel_node("decode_attn_int8", _dec, args) as node:
        if ref:
            out = node.out(_dec.decode_attn_int8_plain(*args).to(q.dtype))
        else:
            out = node.out(_dec.decode_attn_int8(*args, out_dtype=q.dtype))
    return out.reshape(B, 1, Hq, D)


# ---------------------------------------------------------------------------
# QTensor-level entry points
# ---------------------------------------------------------------------------


def _kernel_matmul(x2: torch.Tensor, qt) -> torch.Tensor:
    """x2 (M, K) through the leaf's entry point -> (M, N): x2's dtype
    from ``int8_matmul``, which stores it itself, f32 from the others."""
    if isinstance(qt, (QM2Q, QExpertM2Q)):
        # a layer slice's (1, 1) activation scale goes in as one element
        return m2q_matmul_op(x2, qt.act_scale.reshape(()), qt.payload,
                             qt.u_scale.reshape(-1), qt.u_zp.reshape(-1),
                             qt.a_scale.reshape(-1))
    if isinstance(qt, QAPoT):
        return apot_matmul_op(x2, qt.codes, qt.scale.reshape(-1))
    if qt.bits == 8:
        return int8_matmul_op(x2, qt.payload, qt.act_scale,
                              qt.scale.reshape(-1), qt.zero_point.reshape(-1),
                              out_dtype=x2.dtype)
    return int4_matmul_op(x2, qt.payload, qt.scale.reshape(-1),
                          qt.zero_point.reshape(-1))


def qtensor_expert_matmul(xe: torch.Tensor, qt: QExpertM2Q) -> torch.Tensor:
    """``y[E, C, N] = xe[E, C, K] @ W[E, K, N]`` in xe's dtype for a layer
    slice of a QExpertM2Q expert leaf: E ``m2q_matmul`` calls, expert
    ``e``'s (C, K) rows against its (K, N) payload with the layer's
    activation scale; exactly :meth:`QExpertM2Q.expert_matmul`, which an
    uncalibrated leaf takes."""
    if not expert_kernel_supported(qt):
        return qt.expert_matmul(xe)
    sa = qt.act_scale.reshape(())
    xe = xe.contiguous()
    return torch.stack([
        m2q_matmul_op(xe[e], sa, qt.payload[e], qt.u_scale[e].reshape(-1),
                      qt.u_zp[e].reshape(-1), qt.a_scale[e].reshape(-1))
        for e in range(xe.shape[0])]).to(xe.dtype)


def qtensor_matmul(x: torch.Tensor, qt) -> torch.Tensor:
    """y = x @ W for a 2-D QTensor leaf; x (..., K) -> (..., N) in x.dtype
    (a cast of the kernel's f32 output, except where it stored x.dtype).
    A leaf no kernel takes runs its plain ``qmatmul``, as JAX's does."""
    if not kernel_supported(qt):
        return qmatmul(x, qt)
    y = _kernel_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qt)
    return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


def qtensor_dwconv(x: torch.Tensor, qt, stride: int = 1) -> torch.Tensor:
    """Depthwise conv for a 4-bit QUniform leaf; the kernel stores x.dtype
    (the f32 sum rounded once, as a cast of the f32 output would)."""
    kh, kw = int(qt.shape[0]), int(qt.shape[1])
    return dwconv_w4_op(x.contiguous(), qt.payload, qt.scale.reshape(-1),
                        qt.zero_point.reshape(-1), kh=kh, kw=kw,
                        stride=stride, out_dtype=x.dtype)

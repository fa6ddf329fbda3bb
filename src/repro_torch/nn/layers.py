"""Layer primitives (twin of ``repro.nn.layers``): initializers, dense,
embedding gathers and the tied head, norms, activations, and NHWC
convolutions.

Every weight consumer dispatches on the leaf type: a float tensor runs the
float op, a :class:`CalibTensor` records its input's max-abs first, and a
QTensor leaf runs the quantized path: the kernels via ``kernels.ops`` where
its dispatch axis is on (``dense`` for matmuls, ``conv`` for convs), the
leaf's plain QTensor path where it is off.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..core.calibrate import CalibTensor
from ..core.qtensor import QUniform, is_qtensor, qmatmul
from ..kernels import ops
from ..kernels.dwconv_w4 import same_padding


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``; None on the meta
    device, where torch has none and the draws below make shape-only
    tensors (the port's ``jax.eval_shape`` of an init)."""
    if _meta(device):
        return None
    return torch.Generator(device=device).manual_seed(seed)


def trunc_normal(shape, generator: torch.Generator, device=None,
                 std: float = 0.02) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2] (the JAX
    package's law, drawn by inverting the normal CDF on uniforms from
    ``generator``; other numbers than jax.random's)."""
    if _meta(device):  # shape only: a meta draw costs seconds of set-up
        return torch.empty(shape, dtype=torch.float32, device=device)
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return std * torch.clamp(z, -2.0, 2.0)


def lecun_normal(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """N(0, 1/fan_in) with fan_in = prod(shape[:-1]), the JAX package's
    law (the numbers differ: torch and jax.random are different streams)."""
    if _meta(device):  # shape only, as in trunc_normal
        return torch.empty(shape, dtype=torch.float32, device=device)
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w / math.sqrt(max(fan_in, 1))


def stacked(n: int, shape, draw, generator: torch.Generator,
            device=None) -> torch.Tensor:
    """``n`` draws of ``draw(shape, generator, device)`` stacked along a
    new leading axis, filled one slice at a time (the draws, in the order
    ``torch.stack`` of ``n`` draws would take them) so the tree never
    holds a leaf twice; shape-only on the meta device."""
    out = torch.empty((n,) + tuple(shape), dtype=torch.float32,
                      device=device)
    if not _meta(device):
        for i in range(n):
            out[i] = draw(shape, generator, device)
    return out


# matmuls without batch dims (x @ w over a (B, S, D) x folds to one mm):
# what JAX's ``dots_with_no_batch_dims_saveable`` policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, policy: str = "full"):
    """``fn(*args)`` with its activations recomputed in the backward (the
    port's ``jax.checkpoint``: ``torch.utils.checkpoint``, non-reentrant)
    while autograd records; a plain call under ``torch.no_grad()``, so
    inference never pays for it.  ``policy``: ``"full"`` keeps only the
    inputs; ``"dots"`` also keeps the outputs of matmuls without batch
    dims (``aten.mm`` / ``addmm``: the layer projections, not attention's
    batched einsums), as JAX's ``dots_with_no_batch_dims_saveable``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return _ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat policy {policy!r}: 'full' or 'dots'")


def dense(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """y = x @ w (+ b); w may be float, CalibTensor or a QTensor leaf, or
    a leaf that computes its own product (``local_dense(x, b)``: a rank's
    shard of one, ``dist.spmd.Parallel``)."""
    if hasattr(w, "local_dense"):
        return w.local_dense(x, b)
    if isinstance(w, CalibTensor):
        w.record(x)
        y = x @ w.w.to(x.dtype)
    elif is_qtensor(w):
        y = (ops.qtensor_matmul(x, w) if ops.dispatch_enabled(x.device)
             else qmatmul(x, w))
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def tied_head(x: torch.Tensor, table) -> torch.Tensor:
    """Logits through the embedding table, ``x @ table.T`` (whisper's
    tied head); a quantized table is dequantized to ``x``'s dtype, a
    CalibTensor records ``x`` first."""
    if isinstance(table, CalibTensor):
        table.record(x)
        w = table.w
    elif is_qtensor(table):
        w = table.dequant(x.dtype)
    else:
        w = table
    return x @ w.T.to(x.dtype)


def embed(ids: torch.Tensor, table) -> torch.Tensor:
    """Rows of ``table`` (float, CalibTensor, or an axis-0 QUniform whose
    packed rows are gathered before they are dequantized), or a table
    that gathers its own rows (``local_embed(ids)``: a rank's column
    shard of one, ``dist.spmd.Parallel``)."""
    if hasattr(table, "local_embed"):
        return table.local_embed(ids)
    if isinstance(table, CalibTensor):
        return table.w[ids]
    if isinstance(table, QUniform):
        return table.take(ids, dtype=torch.float32)
    return table[ids]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and (biased) variance over the last axis in f32, cast back to
    ``x``'s dtype after the affine map."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu(x, approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w1, w3, w2, b1=None, b3=None,
           b2=None) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x @ w1) * (x @ w3)) @ w2``."""
    return dense(silu(dense(x, w1, b1)) * dense(x, w3, b3), w2, b2)


def geglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """GeGLU FFN: ``(gelu(x @ w1) * (x @ w3)) @ w2``."""
    return dense(gelu(dense(x, w1)) * dense(x, w3), w2)


def _float_conv(x, w, stride: int, groups: int, padding: str):
    """XLA-semantics NHWC conv with an HWIO filter."""
    kh, kw = w.shape[0], w.shape[1]
    H, W = x.shape[1], x.shape[2]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph, pw = same_padding(H, kh, stride), same_padding(W, kw, stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
            padding: str) -> torch.Tensor:
    """(B,H,W,C) -> (B,HO,WO,kh*kw*C) patches, feature order (i, j, c):
    the row order of a flattened-HWIO payload, so an im2col'd conv is
    exactly ``patches @ payload``."""
    H, W = x.shape[1], x.shape[2]
    if padding == "SAME":
        ph, pw = same_padding(H, kh, stride), same_padding(W, kw, stride)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        HO, WO = -(-H // stride), -(-W // stride)
    elif padding == "VALID":
        HO, WO = (H - kh) // stride + 1, (W - kw) // stride + 1
    else:
        raise ValueError(f"padding {padding!r}")
    s = stride
    taps = [x[:, i:i + (HO - 1) * s + 1:s, j:j + (WO - 1) * s + 1:s]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1)


def _qconv2d(x, w, stride: int, groups: int, padding: str):
    """Quantized-conv hot path: a 1x1 stride-1 PWConv is a matmul over
    B*H*W pixel rows; a 4-bit depthwise filter runs the dwconv_w4 kernel;
    any other un-grouped KxK filter (the opt-in int8 stem) is im2col + the
    same quantized matmul.  ``ops.qtensor_matmul`` picks the leaf's kernel
    where the conv axis is on; off, the matmuls take the leaf's plain
    ``qmatmul`` and a depthwise filter the dequantized-weight conv.  None
    when only the dequantized-weight conv applies (e.g. the 8-bit
    depthwise filters of ``uniform8``)."""
    shape = tuple(w.shape)
    ints = getattr(w, "payload", None)
    if ints is None:
        ints = getattr(w, "codes", None)
    if len(shape) != 4 or ints is None or ints.ndim != 2:
        return None
    kernels = ops.conv_dispatch_enabled(x.device)
    matmul = ops.qtensor_matmul if kernels else qmatmul
    if shape[:2] == (1, 1) and stride == 1 and groups == 1:
        return matmul(x, w)
    if kernels and ops.dwconv_kernel_supported(w, x, stride, groups,
                                               padding):
        return ops.qtensor_dwconv(x, w, stride=stride)
    kh, kw, cin_g, _ = shape
    if groups == 1 and padding in ("SAME", "VALID") \
            and x.shape[-1] == cin_g:
        return matmul(_im2col(x, kh, kw, stride, padding), w)
    return None


def conv2d(x: torch.Tensor, w, b=None, stride: int = 1, groups: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x (B,H,W,Cin); w (kh,kw,Cin//groups,Cout) float, CalibTensor or
    QTensor leaf."""
    if isinstance(w, CalibTensor):
        w.record(x)
        wv = w.w
    elif is_qtensor(w):
        y = _qconv2d(x, w, stride=stride, groups=groups, padding=padding)
        if y is None:
            wv = w.dequant(x.dtype).reshape(w.shape)
        else:
            return y if b is None else y + b.to(y.dtype)
    else:
        wv = w
    y = _float_conv(x, wv.to(x.dtype), stride, groups, padding)
    return y if b is None else y + b.to(y.dtype)


def dwconv2d(x: torch.Tensor, w, b=None, stride: int = 1,
             padding: str = "SAME") -> torch.Tensor:
    """Depthwise conv; w (kh,kw,1,C)."""
    return conv2d(x, w, b=b, stride=stride, groups=x.shape[-1],
                  padding=padding)

"""Carry weights across: numpy parameter trees <-> the port's tree.

The JAX package's trees cross as plain numpy data -- the port never sees
a JAX object.  A float leaf is a numpy array.  A quantized leaf is a dict
with its class under ``"qtensor"`` and its fields by the JAX leaf's names:

* ``{"qtensor": "QM2Q", "payload", "u_scale", "u_zp", "a_scale",
  "act_scale", "shape", "n_uniform", "n_apot"}`` -- a 2-D or flattened
  conv weight (payload (K, N), scales (1, N)) or a stacked perm-folded
  FFN member (payload (L, K, N), scales (L, 1, N), act_scale (L, 1, 1) if
  any); ``"QExpertM2Q"`` has the same fields, stacked (L, K, N) or an
  MoE expert leaf stacked over layers (payload (L, E, K, N), scales
  (L, E, 1, N), act_scale (L, 1, 1, 1))
* ``{"qtensor": "QUniform", "payload", "scale", "zero_point",
  "act_scale", "bits", "axis", "shape"}`` -- a 2-D or flattened conv
  weight (``axis`` 1, payload (K, N), scales (1, N)), a stacked per-layer
  weight (``axis`` 2, payload (L, K, N), scales (L, 1, N), act_scale
  (L, 1, 1)), a stacked expert weight (``axis`` 3, payload (L, E, K, N),
  scales (L, E, 1, N), act_scale (L, 1, 1, 1)) or an embedding table
  (``axis`` 0, payload (V, D), scales (V, 1)); 4-bit payloads are packed
  along the last axis (half as wide)
* ``{"qtensor": "QAPoT", "codes" (K, N) uint8, "scale" (1, N) f32,
  "act_scale", "shape"}``

An optimizer state crosses as ``{"count": int32 0-d array, "m": tree,
"v": tree}`` (or any object with those three attributes, as the JAX
package's ``AdamWState``), the moment trees as float trees
(:func:`opt_state_from_numpy` / :func:`opt_state_to_numpy`).

``act_scale`` may be None.  Anything else, and any field whose dtype or
shape disagrees with the leaf it claims to be, raises.  The whole
dense-LM tree crosses this way (float norms, biases and qk_norm's
``q_gamma`` / ``k_gamma``, QUniform embedding, stacked layers -- a relu2
``mlp`` has no ``w3`` -- and head), and the MoE LM's (a float router,
the expert leaves, a shared expert).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .core.qtensor import QAPoT, QExpertM2Q, QM2Q, QUniform


def _array(d: dict, key: str, dtype, shape, what: str) -> np.ndarray:
    a = d.get(key)
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{what}: {key!r} must be a numpy array, got "
                        f"{type(a).__name__}")
    if a.dtype != dtype:
        raise TypeError(f"{what}: {key!r} must be {np.dtype(dtype)}, got "
                        f"{a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: {key!r} must have shape {tuple(shape)}, "
                         f"got {tuple(a.shape)}")
    return a


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _act(d: dict, what: str, shape=()) -> Optional[np.ndarray]:
    """The activation scale: one float32 (any shape of one element), or
    of ``shape`` exactly when that has a layer axis."""
    a = d.get("act_scale")
    if a is None:
        return None
    a = np.asarray(a)
    if shape:
        ok = a.dtype == np.float32 and tuple(a.shape) == tuple(shape)
    else:
        ok = a.dtype == np.float32 and a.size == 1
    if not ok:
        raise TypeError(f"{what}: act_scale must be float32 of shape "
                        f"{tuple(shape) or 'one element'}, got {a.dtype} of "
                        f"shape {a.shape}")
    return a if shape else a.reshape(())


def _shape(d: dict, what: str) -> tuple:
    shape = d.get("shape")
    if not isinstance(shape, (list, tuple)) or len(shape) < 2:
        raise TypeError(f"{what}: 'shape' must be the float weight's shape "
                        f"(a list of at least 2 ints), got {shape!r}")
    return tuple(int(s) for s in shape)


def _merged(cls):
    """The builder of a merged-layout leaf (QM2Q or QExpertM2Q)."""
    def build(d: dict, path: str, device):
        what = f"{path} ({cls.__name__})"
        shape = _shape(d, what)
        n = shape[-1]
        n_uniform, n_apot = int(d["n_uniform"]), int(d["n_apot"])
        if n_uniform + n_apot != n:
            raise ValueError(f"{what}: n_uniform + n_apot = "
                             f"{n_uniform + n_apot} != {n} filters")
        if len(shape) == 3 or (cls is QExpertM2Q and len(shape) == 4):
            # stacked (L, K, N) layers, or (L, E, K, N) experts
            pshape = shape
            sshape = shape[:-2] + (1, n)
            act_shape = (shape[0],) + (1,) * (len(shape) - 1)
        elif cls is QExpertM2Q:
            raise ValueError(f"{what}: a {len(shape)}-D leaf is neither a "
                             "stacked (L, K, N) weight nor a stacked (L, E, "
                             "K, N) expert weight")
        else:                 # 2-D dense, or a conv filter flattened to 2-D
            pshape, sshape, act_shape = (math.prod(shape[:-1]), n), (1, n), ()
        payload = _array(d, "payload", np.int8, pshape, what)
        scales = [_array(d, name, np.float32, sshape, what)
                  for name in ("u_scale", "u_zp", "a_scale")]
        act = _act(d, what, act_shape)
        return cls(_tensor(payload, device),
                   *(_tensor(s, device) for s in scales),
                   None if act is None else _tensor(act, device), shape,
                   n_uniform, n_apot)
    return build


def _quniform(d: dict, path: str, device) -> QUniform:
    what = f"{path} (QUniform)"
    shape = _shape(d, what)
    bits, axis = int(d["bits"]), int(d["axis"])
    act_shape = ()
    if axis == 1:      # 2-D dense, or a conv filter flattened to 2-D
        pshape = [math.prod(shape[:-1]), shape[-1]]
        sshape = (1, shape[-1])
    elif axis == len(shape) - 1 and len(shape) in (3, 4):
        # stacked (L, K, N) layers, or (L, E, K, N) experts
        pshape = list(shape)
        sshape = shape[:-2] + (1, shape[-1])
        act_shape = (shape[0],) + (1,) * (len(shape) - 1)
    elif axis == 0 and len(shape) == 2:   # embedding rows
        pshape = list(shape)
        sshape = (shape[0], 1)
    else:
        raise ValueError(f"{what}: axis {axis} of a {len(shape)}-D weight "
                         "is none of 1 (filter-wise, 2-D payload), 2 "
                         "(stacked layers), 3 (stacked experts) or 0 "
                         "(embedding rows)")
    if bits == 4:
        pshape[-1] //= 2
    payload = _array(d, "payload", np.int8 if bits == 8 else np.uint8,
                     pshape, what)
    scale = _array(d, "scale", np.float32, sshape, what)
    zp = _array(d, "zero_point", np.float32, sshape, what)
    act = _act(d, what, act_shape)
    return QUniform(_tensor(payload, device), _tensor(scale, device),
                    _tensor(zp, device),
                    None if act is None else _tensor(act, device), bits,
                    axis, shape)


def _qapot(d: dict, path: str, device) -> QAPoT:
    what = f"{path} (QAPoT)"
    shape = _shape(d, what)
    n = shape[-1]
    codes = _array(d, "codes", np.uint8, (math.prod(shape[:-1]), n), what)
    scale = _array(d, "scale", np.float32, (1, n), what)
    act = _act(d, what)
    return QAPoT(_tensor(codes, device), _tensor(scale, device),
                 None if act is None else _tensor(act, device), shape)


_BUILDERS = {"QM2Q": _merged(QM2Q), "QExpertM2Q": _merged(QExpertM2Q),
             "QUniform": _quniform, "QAPoT": _qapot}


def params_from_numpy(tree, device="cuda", _path: str = ""):
    """Numpy tree (float arrays and QTensor dicts) -> the port's tree on
    ``device``."""
    if isinstance(tree, dict) and "qtensor" in tree:
        kind = tree["qtensor"]
        if kind not in _BUILDERS:
            raise TypeError(f"{_path}: unknown qtensor kind {kind!r} "
                            f"(known: {sorted(_BUILDERS)})")
        return _BUILDERS[kind](tree, _path, device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, f"{_path}/{k}".lstrip("/"))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, f"{_path}/{i}".lstrip("/"))
                for i, v in enumerate(tree)]
    if isinstance(tree, np.ndarray):
        if not np.issubdtype(tree.dtype, np.floating):
            raise TypeError(f"{_path}: float leaf must be a floating array, "
                            f"got {tree.dtype}")
        return _tensor(tree, device)
    raise TypeError(f"{_path}: unknown leaf kind {type(tree).__name__}")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`."""
    if isinstance(tree, (QM2Q, QExpertM2Q)):
        return {"qtensor": type(tree).__name__, "payload": _np(tree.payload),
                "u_scale": _np(tree.u_scale), "u_zp": _np(tree.u_zp),
                "a_scale": _np(tree.a_scale),
                "act_scale": None if tree.act_scale is None
                else _np(tree.act_scale),
                "shape": list(tree.shape), "n_uniform": tree.n_uniform,
                "n_apot": tree.n_apot}
    if isinstance(tree, QUniform):
        return {"qtensor": "QUniform", "payload": _np(tree.payload),
                "scale": _np(tree.scale), "zero_point": _np(tree.zero_point),
                "act_scale": None if tree.act_scale is None
                else _np(tree.act_scale),
                "bits": tree.bits, "axis": tree.axis,
                "shape": list(tree.shape)}
    if isinstance(tree, QAPoT):
        return {"qtensor": "QAPoT", "codes": _np(tree.codes),
                "scale": _np(tree.scale),
                "act_scale": None if tree.act_scale is None
                else _np(tree.act_scale),
                "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return _np(tree)
    raise TypeError(f"unknown leaf kind {type(tree).__name__}")


def opt_state_from_numpy(state, device="cuda"):
    """A numpy optimizer state -- ``{"count", "m", "v"}``, or an object
    with those attributes -- -> the port's ``AdamWState`` on ``device``:
    ``count`` an int32 0-d tensor, ``m`` / ``v`` through
    :func:`params_from_numpy`."""
    from .optim.adamw import AdamWState
    get = state.get if isinstance(state, dict) else \
        (lambda k: getattr(state, k))
    count = np.asarray(get("count"))
    if count.dtype != np.int32 or count.shape != ():
        raise TypeError(f"count must be an int32 scalar, got {count.dtype} "
                        f"of shape {count.shape}")
    return AdamWState(
        count=torch.from_numpy(count.copy()).to(device),
        m=params_from_numpy(get("m"), device, "m"),
        v=params_from_numpy(get("v"), device, "v"))


def opt_state_to_numpy(state) -> dict:
    """The inverse of :func:`opt_state_from_numpy`."""
    return {"count": _np(state.count), "m": params_to_numpy(state.m),
            "v": params_to_numpy(state.v)}

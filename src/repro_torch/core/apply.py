"""quantize_model: rewrite a float parameter tree into M2Q QTensor leaves
(twin of ``repro.core.apply`` for 2-D dense, conv, embedding and stacked
per-layer leaves).

Models tag quantizable weights with QUANT_RULES, ordered ``(regex, kind)``
pairs matched against the tree path (first match wins).  The policy, the
deployment ShapeCtx and optional per-path overrides decide mixed-scheme vs
low-bit per leaf; Eq. 6 splits mixed layers' filters between uniform-8 and
APoT.  Conv filters (HWIO) are classified on their 4-D shape but quantized
as the ``(kh*kw*cin, cout)`` flattening, so filter-wise scales land on
Cout; the leaf's ``shape`` keeps the original filter.  A stacked (L, K, N)
dense leaf is classified on its per-layer (K, N) shape and quantized with
per-layer, per-filter statistics (``reduce_axes=(1,)``); an embedding
table is quantized per row (axis 0) for the gather.

Not ported yet, and refused by name: a stacked leaf resolving to the mixed
m2q scheme (``QExpertM2Q``) and perm-folded FFN groups -- the mixed LM
path of a later slice.

:func:`abstract_quantize_model` is the shape-only twin: from a float tree
of ``meta`` tensors it builds the QTensor tree that :func:`quantize_model`
would, fields on the ``meta`` device, static fields equal (the load
template of an artifact).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import policy as pol
from .qtensor import QAPoT, QM2Q, QUniform, weight_bits
from .quant import _reduction_axes
from .scheme_select import select_schemes
from .tree import leaves_with_path, map_with_path

Rule = Tuple[str, str]
Override = Tuple[str, pol.PathOverride]


def match_kind(rules: Sequence[Rule], path: str) -> Optional[str]:
    for pattern, kind in rules:
        if re.search(pattern, path):
            return kind
    return None


def _match_override(overrides, path: str) -> Optional[pol.PathOverride]:
    for pattern, ov in overrides or ():
        if re.search(pattern, path):
            return ov
    return None


def resolve_decision(key: str, kind: str, dec_shape: tuple,
                     shape_ctx: pol.ShapeCtx, p: pol.M2QPolicy,
                     overrides: Optional[Sequence[Override]] = None):
    """(decision, effective policy) for one leaf, honoring overrides."""
    ov = _match_override(overrides, key)
    p_leaf = p
    if ov is not None and (ov.scheme is not None or ov.bits is not None):
        p_leaf = dataclasses.replace(
            p,
            compute_scheme=ov.scheme if ov.scheme is not None
            else p.compute_scheme,
            memory_bits=ov.bits if ov.bits is not None else p.memory_bits)
    decision = pol.decide(kind, dec_shape, shape_ctx, p_leaf)
    if ov is not None and ov.decision is not None:
        if ov.decision == pol.DECISION_MIXED and kind == pol.KIND_EMBEDDING:
            raise ValueError(
                f"override for {key!r}: an embedding cannot be mixed-scheme "
                "(nn.embed gathers integer rows, which needs per-row "
                "uniform quantization)")
        decision = ov.decision
    return decision, p_leaf


def resolve_fold_groups(flat_shapes: Dict[str, tuple],
                        ffn_groups: Optional[Sequence[tuple]],
                        shape_ctx: pol.ShapeCtx, p: pol.M2QPolicy,
                        overrides: Optional[Sequence[Override]] = None
                        ) -> List[Tuple[str, Optional[str], str]]:
    """The FFN groups that WOULD be perm-folded: (up, gate|None, down) key
    triples.  A group folds only when every quantized member (up and
    gate) resolves to (mixed, m2q); the first group whose members all
    exist claims their keys whether or not it folds, so a later fallback
    pattern never folds a subset of a gated group."""
    if not ffn_groups or p.compute_scheme != "m2q":
        return []

    def find(rx):
        if rx is None:
            return None
        hits = [k for k in flat_shapes if re.search(rx, k)]
        return hits[0] if len(hits) == 1 else None

    out: List[Tuple[str, Optional[str], str]] = []
    used_up, used_down = set(), set()
    for up_re, gate_re, down_re in ffn_groups:
        ku, kg, kd = find(up_re), find(gate_re), find(down_re)
        if ku is None or kd is None or (gate_re and kg is None):
            continue
        if ku in used_up or kd in used_down:
            continue  # claimed by an earlier (gated) group
        used_up.add(ku)
        if kg is not None:
            used_up.add(kg)
        used_down.add(kd)
        members_ok = True
        for k in (ku,) if kg is None else (ku, kg):
            dec, pk = resolve_decision(k, pol.KIND_DENSE,
                                       tuple(flat_shapes[k][-2:]),
                                       shape_ctx, p, overrides)
            if dec != pol.DECISION_MIXED or pk.compute_scheme != "m2q":
                members_ok = False
        if members_ok:
            out.append((ku, kg, kd))
    return out


@dataclasses.dataclass
class LayerReport:
    path: str
    kind: str
    decision: str
    shape: tuple
    bits: float  # average stored bits/weight
    n_apot: int = 0
    n_uniform: int = 0
    mse: float = 0.0


def _quantize_leaf(w: torch.Tensor, kind: str, decision: str,
                   p: pol.M2QPolicy, act_max_abs, key: str):
    """w is a (K, N) dense weight, a flattened (kh*kw*cin, cout) filter, a
    (V, D) embedding or a stacked (L, K, N) per-layer weight."""
    ams = act_max_abs if p.quantize_activations else None
    batched = kind in (pol.KIND_DENSE, pol.KIND_HEAD) and w.ndim >= 3
    ra = (w.ndim - 2,) if batched else None
    if decision == pol.DECISION_LOWBIT:
        if kind == pol.KIND_EMBEDDING:
            return QUniform.quantize(w, bits=p.memory_bits, axis=0)
        return QUniform.quantize(w, bits=p.memory_bits, axis=-1,
                                 reduce_axes=ra)
    if p.compute_scheme == "uniform8":
        return QUniform.quantize(w, bits=8, axis=-1, act_max_abs=ams,
                                 reduce_axes=ra)
    if p.compute_scheme == "apot":
        return QAPoT.quantize(w, act_max_abs=ams, reduce_axes=ra)
    if p.compute_scheme == "m2q":
        if w.ndim != 2:
            raise _stacked_m2q(key, tuple(w.shape))
        asn = select_schemes(w, ratio=p.apot_ratio)
        return QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                             act_max_abs=ams)
    raise ValueError(f"unknown compute scheme {p.compute_scheme}")


def _stacked_stats(act_stats: Dict[str, float], key: str, shape: tuple):
    """Per-layer ``'<key>@<i>'`` statistics of a stacked leaf as one
    (L, 1, ..., 1) array broadcasting over its trailing axes, or None
    unless every layer has one."""
    per = [act_stats.get(f"{key}@{i}") for i in range(shape[0])]
    if any(v is None for v in per):
        return None
    return np.asarray(per, np.float32).reshape(
        (shape[0],) + (1,) * (len(shape) - 1))


def _refuse_folded_groups(params, ffn_groups, shape_ctx: pol.ShapeCtx,
                          p: pol.M2QPolicy, overrides) -> None:
    """Perm-folded FFN groups are not ported: raise where one would
    fold."""
    if not ffn_groups or p.compute_scheme != "m2q":
        return
    flat = {k: tuple(leaf.shape) for k, leaf in leaves_with_path(params)
            if isinstance(leaf, torch.Tensor)}
    groups = resolve_fold_groups(flat, ffn_groups, shape_ctx, p, overrides)
    if groups:
        raise NotImplementedError(
            f"FFN groups {groups} resolve to perm-folded mixed "
            "quantization (stacked QM2Q/QExpertM2Q with the down "
            "projection's rows permuted), which is not ported yet")


def _classify(key: str, shape: tuple, rules, shape_ctx: pol.ShapeCtx,
              p: pol.M2QPolicy, overrides):
    """(kind, decision, effective policy, conv, stacked) of a leaf that
    quantization rewrites, or None for one it passes through; raises by
    name on a leaf kind that is not ported."""
    kind = match_kind(rules, key)
    ndim = len(shape)
    if kind is None or kind == pol.KIND_SKIP or ndim < 2:
        return None
    conv = ndim == 4 and kind in (pol.KIND_DENSE, pol.KIND_DWCONV)
    stacked = kind in (pol.KIND_DENSE, pol.KIND_HEAD) and ndim == 3
    if not (conv or stacked or ndim == 2) or kind == pol.KIND_EXPERT:
        raise NotImplementedError(
            f"{key!r}: {kind} leaves of shape {shape} are not ported yet")
    # classify on the per-unit shape (strip the stacked layer axis)
    decision, p_leaf = resolve_decision(key, kind,
                                        shape[1:] if stacked else shape,
                                        shape_ctx, p, overrides)
    if decision == pol.DECISION_SKIP:
        return None
    return kind, decision, p_leaf, conv, stacked


def quantize_model(params, rules: Sequence[Rule], shape_ctx: pol.ShapeCtx,
                   m2q_policy: Optional[pol.M2QPolicy] = None,
                   act_stats: Optional[Dict[str, float]] = None,
                   ffn_groups: Optional[Sequence[tuple]] = None,
                   overrides: Optional[Sequence[Override]] = None):
    """Apply M2Q to ``params``; non-matching leaves pass through.
    Returns (qparams, per-layer reports in tree order).  ``ffn_groups``:
    (up, gate|None, down) path-regex triples for perm-folded FFN
    quantization; a group that would fold raises NotImplementedError."""
    p = m2q_policy or pol.M2QPolicy()
    act_stats = act_stats or {}
    report: List[LayerReport] = []

    _refuse_folded_groups(params, ffn_groups, shape_ctx, p, overrides)

    def visit(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        c = _classify(key, tuple(leaf.shape), rules, shape_ctx, p, overrides)
        if c is None:
            return leaf
        kind, decision, p_leaf, conv, _ = c
        # activation stats: the plain key, or per-layer '@i' keys
        ams = act_stats.get(key)
        if ams is None and leaf.ndim >= 3 and not conv:
            ams = _stacked_stats(act_stats, key, tuple(leaf.shape))
        w = leaf.to(torch.float32)
        if conv:
            w = w.reshape(-1, w.shape[-1])
        qt = _quantize_leaf(w, kind, decision, p_leaf, ams, key)
        if conv:
            qt = dataclasses.replace(qt, shape=tuple(leaf.shape))
        rep = LayerReport(path=key, kind=kind, decision=decision,
                          shape=tuple(leaf.shape), bits=weight_bits(qt))
        if isinstance(qt, QM2Q):
            rep.n_apot, rep.n_uniform = qt.n_apot, qt.n_uniform
        w_hat = qt.dequant()
        rep.mse = float(torch.mean(
            (leaf.to(torch.float32).reshape(w_hat.shape) - w_hat) ** 2))
        report.append(rep)
        return qt

    return map_with_path(visit, params), report


def _stacked_m2q(key: str, shape: tuple):
    return NotImplementedError(
        f"{key!r}: a stacked {shape} leaf resolves to the mixed m2q scheme, "
        "whose leaf (QExpertM2Q, per-layer Eq. 6 splits) is not ported yet")


def abstract_quantize_model(params_abs, rules: Sequence[Rule],
                            shape_ctx: pol.ShapeCtx,
                            m2q_policy: Optional[pol.M2QPolicy] = None,
                            with_act_scales: bool = True,
                            ffn_groups: Optional[Sequence[tuple]] = None,
                            overrides: Optional[Sequence[Override]] = None,
                            m2q_splits: Optional[Dict[str, Tuple[int, int]]]
                            = None):
    """Shape-only twin of :func:`quantize_model` (of JAX's
    ``abstract_quantize_model`` for the leaves the port builds): from a
    float tree whose leaves carry shapes (``meta`` tensors), the QTensor
    tree with ``meta`` fields -- no data, no allocation -- whose classes,
    shapes, dtypes and static fields (``bits``, ``axis``, ``shape``,
    ``n_uniform``, ``n_apot``) equal the concrete leaves'.  Decisions
    depend only on shapes, so the two agree by construction; what the
    concrete path refuses by name, this refuses too.

    ``with_act_scales``: calibrated leaves carry an activation scale (a
    scalar, or ``(L, 1, 1)`` on a stacked leaf).  ``m2q_splits``: path ->
    (n_uniform, n_apot), e.g. from saved LayerReports; required where the
    concrete Eq. 6 split is data-dependent (``apot_ratio=None``)."""
    p = m2q_policy or pol.M2QPolicy()
    _refuse_folded_groups(params_abs, ffn_groups, shape_ctx, p, overrides)

    def meta(shape, dtype=torch.float32):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    def scales(shape, axis, reduce_axes):
        red = _reduction_axes(len(shape), axis, reduce_axes)
        return tuple(1 if i in red else d for i, d in enumerate(shape))

    def act_scale(shape, act, stacked):
        if not act:
            return None
        return meta((shape[0],) + (1,) * (len(shape) - 1) if stacked else ())

    def q_uniform(shape, bits, axis, reduce_axes=None, act=False,
                  stacked=False):
        ks = scales(shape, axis, reduce_axes)
        payload = list(shape)
        if bits == 4:
            payload[-1] //= 2
        return QUniform(meta(payload, torch.int8 if bits == 8
                             else torch.uint8), meta(ks), meta(ks),
                        act_scale(shape, act, stacked), bits,
                        axis % len(shape), tuple(shape))

    def q_apot(shape, reduce_axes=None, act=False, stacked=False):
        ks = scales(shape, -1, reduce_axes)
        return QAPoT(meta(shape, torch.uint8), meta(ks),
                     act_scale(shape, act, stacked), tuple(shape))

    def q_m2q(key, shape, act):
        """A 2-D (or flattened conv) mixed leaf; the split from
        ``m2q_splits`` where given, else the policy ratio's floor rule
        (``select_schemes``)."""
        n = shape[-1]
        if m2q_splits and key in m2q_splits:
            nu, na = (int(v) for v in m2q_splits[key])
            if nu + na != n:
                raise ValueError(f"m2q_splits[{key!r}] = ({nu}, {na}) does "
                                 f"not sum to the filter count {n}")
        elif p.apot_ratio is None:
            raise ValueError(
                f"apot_ratio=None (Eq. 6 argmin) gives a data-dependent "
                f"uniform/APoT split for {key!r} that the shape-only twin "
                "cannot know; pass m2q_splits={path: (n_uniform, n_apot)} "
                "(e.g. from a QuantizedModel artifact's saved LayerReports) "
                "or use a fixed apot_ratio")
        else:
            na = int(n * p.apot_ratio)
            nu = n - na
        ks = (1, n)
        return QM2Q(meta(shape, torch.int8), meta(ks), meta(ks), meta(ks),
                    act_scale(shape, act, False), tuple(shape), nu, na)

    def visit(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape = tuple(leaf.shape)
        c = _classify(key, shape, rules, shape_ctx, p, overrides)
        if c is None:
            return leaf
        kind, decision, p_leaf, conv, stacked = c
        act = with_act_scales and p_leaf.quantize_activations
        w_shape = (math.prod(shape[:-1]), shape[-1]) if conv else shape
        ra = (1,) if stacked else None
        if decision == pol.DECISION_LOWBIT:
            axis = 0 if kind == pol.KIND_EMBEDDING else -1
            qt = q_uniform(w_shape, p_leaf.memory_bits, axis, ra)
        elif p_leaf.compute_scheme == "uniform8":
            qt = q_uniform(w_shape, 8, -1, ra, act=act, stacked=stacked)
        elif p_leaf.compute_scheme == "apot":
            qt = q_apot(w_shape, ra, act=act, stacked=stacked)
        elif p_leaf.compute_scheme == "m2q":
            if stacked:
                raise _stacked_m2q(key, shape)
            qt = q_m2q(key, w_shape, act)
        else:
            raise ValueError(f"unknown compute scheme "
                             f"{p_leaf.compute_scheme}")
        return dataclasses.replace(qt, shape=shape) if conv else qt

    return map_with_path(visit, params_abs)

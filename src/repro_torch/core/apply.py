"""quantize_model: rewrite a float parameter tree into M2Q QTensor leaves
(twin of ``repro.core.apply`` for 2-D dense, conv, embedding, stacked
per-layer and MoE expert leaves).

Models tag quantizable weights with QUANT_RULES, ordered ``(regex, kind)``
pairs matched against the tree path (first match wins).  The policy, the
deployment ShapeCtx and optional per-path overrides decide mixed-scheme vs
low-bit per leaf; Eq. 6 splits mixed layers' filters between uniform-8 and
APoT.  Conv filters (HWIO) are classified on their 4-D shape but quantized
as the ``(kh*kw*cin, cout)`` flattening, so filter-wise scales land on
Cout; the leaf's ``shape`` keeps the original filter.  A stacked (L, K, N)
dense leaf is classified on its per-layer (K, N) shape and quantized with
per-layer, per-filter statistics (``reduce_axes=(1,)``); an embedding
table is quantized per row (axis 0) for the gather.  A stacked leaf that
resolves to the mixed m2q scheme becomes a :class:`QExpertM2Q` with a
per-layer Eq. 6 split; an FFN group whose members all resolve to it is
perm-folded (:func:`_joint_group_quantize`).  An MoE expert leaf --
(E, K, N), or (L, E, K, N) stacked over layers -- is classified on one
expert's (K, N) at the deployment's tokens per expert; low-bit it is a
QUniform with per-(layer, expert, filter) statistics, mixed one
:func:`_batched_m2q` over E per layer, stacked over L (a QExpertM2Q with
an (L, 1, 1, 1) activation scale).

:func:`abstract_quantize_model` is the shape-only twin: from a float tree
of ``meta`` tensors it builds the QTensor tree that :func:`quantize_model`
would, fields on the ``meta`` device, static fields equal (the load
template of an artifact).

:func:`fake_quant_model` is the accuracy tables' whole-tree fake
quantization under one scheme (float leaves in, float leaves out).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import policy as pol
from .qtensor import QAPoT, QExpertM2Q, QM2Q, QUniform, weight_bits
from .quant import (_reduction_axes, act_scale_from_stats, fake_quant_apot,
                    fake_quant_pot, fake_quant_uniform)
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


def _stack_layers(qts, shape, join=torch.stack):
    """One QTensor of per-layer leaves ``qts``: every tensor field stacked
    along a new leading layer axis (``join=torch.cat``: concatenated
    along the existing one), ``shape`` the whole weight's."""
    return dataclasses.replace(qts[0], shape=tuple(shape), **{
        f.name: join([getattr(q, f.name) for q in qts])
        for f in dataclasses.fields(qts[0])
        if isinstance(getattr(qts[0], f.name), torch.Tensor)})


def _concat(qts, shape):
    """One QTensor of leaves ``qts`` that each hold a run of the leading
    axis: every tensor field concatenated along it."""
    return _stack_layers(qts, shape, join=torch.cat)


def _batched_m2q(w: torch.Tensor, ratio) -> QExpertM2Q:
    """Per-slice Eq. 6 selection over the leading axis (layers or
    experts); ratio None becomes the fixed 1:1 split, which keeps the two
    halves stackable.  Each slice is quantized on its own -- every
    statistic is per (slice, filter), so the fields are the whole
    leaf's bit for bit -- which bounds the temporaries by one slice (an
    expert of a whole layer's (E, K, N) weight)."""
    parts = []
    for i in range(w.shape[0]):
        a = select_schemes(w[i], ratio=0.5 if ratio is None else ratio)
        parts.append(QExpertM2Q.quantize(w[i:i + 1], a.apot_idx[None],
                                         a.uniform_idx[None]))
    return _concat(parts, w.shape)


def _quantize_leaf(w: torch.Tensor, kind: str, decision: str,
                   p: pol.M2QPolicy, act_max_abs):
    """w is a (K, N) dense weight, a flattened (kh*kw*cin, cout) filter, a
    (V, D) embedding, a stacked (L, K, N) per-layer weight (its act stats
    (L, 1, 1)), an (E, K, N) expert weight or an (L, E, K, N) stacked
    one (act stats (L, 1, 1, 1))."""
    ams = act_max_abs if p.quantize_activations else None
    batched = (kind in (pol.KIND_DENSE, pol.KIND_HEAD, pol.KIND_EXPERT)
               and w.ndim >= 3)
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
        if w.ndim >= 3:
            # (L, E, K, N): one batched leaf over E per layer, stacked
            qt = _batched_m2q(w, p.apot_ratio) if w.ndim == 3 else \
                _stack_layers([_batched_m2q(w[i], p.apot_ratio)
                               for i in range(w.shape[0])], w.shape)
            if ams is not None:
                qt.act_scale = act_scale_from_stats(
                    torch.as_tensor(ams, device=w.device))
            return qt
        asn = select_schemes(w, ratio=p.apot_ratio)
        return QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                             act_max_abs=ams)
    raise ValueError(f"unknown compute scheme {p.compute_scheme}")


def _quantize_stacked(w: torch.Tensor, kind: str, decision: str,
                      p: pol.M2QPolicy, act_max_abs):
    """:func:`_quantize_leaf` of a stacked (L, K, N) or (L, E, K, N)
    weight, one layer at a time: every quantizer here takes per-(layer,
    [expert,] filter) statistics (``reduce_axes=(ndim - 2,)``) and Eq. 6
    selects per layer [and expert], so the fields equal the whole leaf's
    bit for bit, while the temporaries are one layer's.
    ``act_max_abs``: None or the (L, 1, ..., 1) per-layer stats."""
    return _concat([_quantize_leaf(w[i:i + 1], kind, decision, p,
                                   None if act_max_abs is None
                                   else act_max_abs[i:i + 1])
                    for i in range(w.shape[0])], w.shape)


# weights dequantized at a time by :func:`_mse`
MSE_CHUNK = 1 << 26


def _rows(qt, lo: int, hi: int, n: int):
    """Rows ``lo:hi`` of a QTensor leaf whose payload has ``n`` rows (the
    layers of a stacked leaf; the rows of a 2-D one): every tensor field
    that spans them is sliced, the others (per-filter scales of one row)
    are kept."""
    def part(t):
        spans = isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == n
        return t[lo:hi] if spans else t
    return dataclasses.replace(qt, **{f.name: part(getattr(qt, f.name))
                                      for f in dataclasses.fields(qt)})


def _mse(leaf: torch.Tensor, qt) -> float:
    """``mean((leaf - dequant(qt))^2)`` in f32 through one buffer of the
    leaf's size: dequantized ``MSE_CHUNK`` weights' worth of rows (whole
    layers of a stacked leaf, whole experts of a stacked expert leaf) at
    a time, then the difference and its square written in place -- the
    same values, so the same mean -- with the dequantize temporaries of
    one block."""
    if (qt.codes if isinstance(qt, QAPoT) else qt.payload).ndim == 4:
        # (L, E, K, N): the (L * E) expert slices are the rows; the
        # activation scale plays no part in dequant
        qt = dataclasses.replace(qt, **{
            f.name: getattr(qt, f.name).flatten(0, 1)
            for f in dataclasses.fields(qt)
            if isinstance(getattr(qt, f.name), torch.Tensor)
            and getattr(qt, f.name).ndim == 4 and f.name != "act_scale"})
    n = (qt.codes if isinstance(qt, QAPoT) else qt.payload).shape[0]
    step = max(1, MSE_CHUNK * n // max(leaf.numel(), 1))
    buf = None
    for lo in range(0, n, step):
        part = _rows(qt, lo, lo + step, n).dequant()
        if buf is None:
            buf = torch.empty((n,) + tuple(part.shape[1:]),
                              dtype=torch.float32, device=part.device)
        buf[lo:lo + part.shape[0]] = part
        del part
    torch.sub(leaf.to(torch.float32).reshape(buf.shape), buf, out=buf)
    return float(torch.mean(buf.pow_(2)))


def _release(tree, key: str) -> None:
    """Drop the leaf at ``key`` from ``tree`` (set it to None)."""
    *parents, last = key.split("/")
    for part in parents:
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    tree[int(last) if isinstance(tree, list) else last] = None


def _stacked_stats(act_stats: Dict[str, float], key: str, shape: tuple):
    """Per-layer ``'<key>@<i>'`` statistics of a stacked leaf as one
    (L, 1, ..., 1) array broadcasting over its trailing axes, or None
    unless every layer has one."""
    per = [act_stats.get(f"{key}@{i}") for i in range(shape[0])]
    if any(v is None for v in per):
        return None
    return np.asarray(per, np.float32).reshape(
        (shape[0],) + (1,) * (len(shape) - 1))


def _joint_group_quantize(w_up, w_gate, w_down, ratio):
    """Perm-folded mixed-scheme quantization of an FFN filter group.

    An FFN hidden channel's filter spans ``w_up[:, f]`` (+ ``w_gate[:,
    f]``) and ``w_down[f, :]``: its scheme is selected jointly over up and
    gate, both are stored in [uniform | apot] column order with no
    activation scale, and ``w_down``'s rows are permuted offline to match,
    so no runtime inverse permutation remains.  Weights may be stacked
    (L, K, N); ratio None becomes 1:1.  Returns (up, gate|None, the
    permuted float w_down)."""
    stacked = w_up.ndim == 3
    ups, gates, downs = [], [], []
    for i in range(w_up.shape[0]) if stacked else [None]:
        u = w_up[i] if stacked else w_up
        g = None if w_gate is None else (w_gate[i] if stacked else w_gate)
        d = w_down[i] if stacked else w_down
        asn = select_schemes(u if g is None else torch.cat([u, g], dim=0),
                             ratio=0.5 if ratio is None else ratio)
        perm = torch.from_numpy(np.concatenate([asn.uniform_idx,
                                                asn.apot_idx])).long()
        ups.append(QM2Q.quantize(u, asn.apot_idx, asn.uniform_idx,
                                 fold_perm=True))
        if g is not None:
            gates.append(QM2Q.quantize(g, asn.apot_idx, asn.uniform_idx,
                                       fold_perm=True))
        downs.append(d[perm.to(d.device)])
    if not stacked:
        return ups[0], (gates[0] if gates else None), downs[0]

    return (_stack_layers(ups, w_up.shape),
            _stack_layers(gates, w_gate.shape) if gates else None,
            torch.stack(downs))


def _fold_group_keys(params, ffn_groups, shape_ctx: pol.ShapeCtx,
                     p: pol.M2QPolicy, overrides):
    """:func:`resolve_fold_groups` on the shapes of ``params``' tensor
    leaves (real or ``meta``)."""
    return resolve_fold_groups(
        {k: tuple(leaf.shape) for k, leaf in leaves_with_path(params)
         if isinstance(leaf, torch.Tensor)},
        ffn_groups, shape_ctx, p, overrides)


def _fold_groups(params, ffn_groups, shape_ctx: pol.ShapeCtx,
                 p: pol.M2QPolicy, overrides):
    """The pre-pass over the FFN groups that fold: ({up/gate key: folded
    QM2Q}, {down key: its permuted float weight})."""
    pre, permuted_down = {}, {}
    flat = dict(leaves_with_path(params))
    for ku, kg, kd in _fold_group_keys(params, ffn_groups, shape_ctx, p,
                                       overrides):
        q_up, q_gate, w_down = _joint_group_quantize(
            flat[ku].to(torch.float32),
            None if kg is None else flat[kg].to(torch.float32),
            flat[kd].to(torch.float32), p.apot_ratio)
        pre[ku] = q_up
        if kg is not None:
            pre[kg] = q_gate
        permuted_down[kd] = w_down  # re-enters the normal visit
    return pre, permuted_down


def _classify(key: str, shape: tuple, rules, shape_ctx: pol.ShapeCtx,
              p: pol.M2QPolicy, overrides):
    """(kind, decision, effective policy, conv, stacked) of a leaf that
    quantization rewrites, or None for one it passes through; raises by
    name on a leaf shape that is not ported.  ``stacked``: the leaf
    carries a leading layer axis -- a 3-D dense / head leaf or a 4-D
    expert leaf -- quantized one layer at a time, its activation scale
    per layer."""
    kind = match_kind(rules, key)
    ndim = len(shape)
    if kind is None or kind == pol.KIND_SKIP or ndim < 2:
        return None
    conv = ndim == 4 and kind in (pol.KIND_DENSE, pol.KIND_DWCONV)
    expert = kind == pol.KIND_EXPERT and ndim in (3, 4)
    stacked = (kind in (pol.KIND_DENSE, pol.KIND_HEAD) and ndim == 3) or \
        (kind == pol.KIND_EXPERT and ndim == 4)
    if not (conv or stacked or expert or ndim == 2):
        raise NotImplementedError(
            f"{key!r}: {kind} leaves of shape {shape} are not ported yet")
    # classify on the per-unit shape (strip the layer and expert axes)
    decision, p_leaf = resolve_decision(
        key, kind, shape[-2:] if expert or stacked else shape, shape_ctx, p,
        overrides)
    if decision == pol.DECISION_SKIP:
        return None
    return kind, decision, p_leaf, conv, stacked


def quantize_model(params, rules: Sequence[Rule], shape_ctx: pol.ShapeCtx,
                   m2q_policy: Optional[pol.M2QPolicy] = None,
                   act_stats: Optional[Dict[str, float]] = None,
                   ffn_groups: Optional[Sequence[tuple]] = None,
                   overrides: Optional[Sequence[Override]] = None,
                   release: bool = False):
    """Apply M2Q to ``params``; non-matching leaves pass through.
    Returns (qparams, per-layer reports in tree order).  ``ffn_groups``:
    (up, gate|None, down) path-regex triples for perm-folded FFN
    quantization (:func:`_joint_group_quantize`).  Stacked leaves are
    quantized one layer at a time (:func:`_quantize_stacked`).
    ``release``: each float leaf that becomes a QTensor is dropped from
    ``params`` (set to None) once its quantized twin exists, so the
    device never holds the float tree and the quantized one whole -- what
    lets a model whose float tree fills most of the card quantize there
    (the caller must hold no other reference to the float leaves)."""
    p = m2q_policy or pol.M2QPolicy()
    act_stats = act_stats or {}
    report: List[LayerReport] = []
    pre, permuted_down = _fold_groups(params, ffn_groups, shape_ctx, p,
                                      overrides)
    if release:
        for key in pre:
            _release(params, key)

    def visit(key, leaf):
        if key in pre:  # its float leaf may be released already
            qt = pre.pop(key)
            report.append(LayerReport(
                path=key, kind=pol.KIND_DENSE, decision="mixed(perm-folded)",
                shape=tuple(qt.shape), bits=weight_bits(qt),
                n_apot=qt.n_apot, n_uniform=qt.n_uniform))
            return qt
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = permuted_down.pop(key, leaf)
        c = _classify(key, tuple(leaf.shape), rules, shape_ctx, p, overrides)
        if c is None:
            return leaf
        kind, decision, p_leaf, conv, stacked = c
        # activation stats: the plain key, or per-layer '@i' keys
        ams = act_stats.get(key)
        if ams is None and leaf.ndim >= 3 and not conv:
            ams = _stacked_stats(act_stats, key, tuple(leaf.shape))
        w = leaf.to(torch.float32)
        if conv:
            w = w.reshape(-1, w.shape[-1])
        if stacked:
            qt = _quantize_stacked(w, kind, decision, p_leaf, ams)
        else:
            qt = _quantize_leaf(w, kind, decision, p_leaf, ams)
        del w
        if conv:
            qt = dataclasses.replace(qt, shape=tuple(leaf.shape))
        rep = LayerReport(path=key, kind=kind, decision=decision,
                          shape=tuple(leaf.shape), bits=weight_bits(qt))
        if isinstance(qt, (QM2Q, QExpertM2Q)):
            rep.n_apot, rep.n_uniform = qt.n_apot, qt.n_uniform
        rep.mse = _mse(leaf, qt)
        report.append(rep)
        if release:
            _release(params, key)
        return qt

    return map_with_path(visit, params), report


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
    depend only on shapes, so the two agree by construction (the fold
    groups come from the same :func:`_fold_group_keys`); what the
    concrete path refuses by name, this refuses too.

    ``with_act_scales``: calibrated leaves carry an activation scale (a
    scalar, or ``(L, 1, 1)`` on a stacked leaf, ``(L, 1, 1, 1)`` on a
    stacked expert leaf; a perm-folded member has none).
    ``m2q_splits``: path -> (n_uniform, n_apot), e.g. from saved
    LayerReports; required where the concrete Eq. 6 split is
    data-dependent (``apot_ratio=None`` on a 2-D or conv leaf: stacked,
    expert and folded leaves split 1:1 then)."""
    p = m2q_policy or pol.M2QPolicy()
    fold_keys = {k for ku, kg, _ in _fold_group_keys(
        params_abs, ffn_groups, shape_ctx, p, overrides)
        for k in (ku, kg) if k is not None}

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

    def q_m2q(key, shape, reduce_axes=None, act=False, stacked=False,
              cls=QM2Q):
        """A mixed leaf in the merged layout; the split from
        ``m2q_splits`` where given, else the policy ratio's floor rule
        (``select_schemes``), None meaning 1:1 but on a 2-D leaf."""
        n = shape[-1]
        if m2q_splits and key in m2q_splits:
            nu, na = (int(v) for v in m2q_splits[key])
            if nu + na != n:
                raise ValueError(f"m2q_splits[{key!r}] = ({nu}, {na}) does "
                                 f"not sum to the filter count {n}")
        elif p.apot_ratio is None and len(shape) == 2 \
                and key not in fold_keys:
            raise ValueError(
                f"apot_ratio=None (Eq. 6 argmin) gives a data-dependent "
                f"uniform/APoT split for {key!r} that the shape-only twin "
                "cannot know; pass m2q_splits={path: (n_uniform, n_apot)} "
                "(e.g. from a QuantizedModel artifact's saved LayerReports) "
                "or use a fixed apot_ratio")
        else:
            na = int(n * (0.5 if p.apot_ratio is None else p.apot_ratio))
            nu = n - na
        ks = scales(shape, -1, reduce_axes)
        return cls(meta(shape, torch.int8), meta(ks), meta(ks), meta(ks),
                   act_scale(shape, act, stacked), tuple(shape), nu, na)

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
        batched = not conv and len(shape) >= 3
        ra = (len(shape) - 2,) if batched else None
        if key in fold_keys:  # [uniform | apot] columns, no act scale
            qt = q_m2q(key, shape, ra)
        elif decision == pol.DECISION_LOWBIT:
            axis = 0 if kind == pol.KIND_EMBEDDING else -1
            qt = q_uniform(w_shape, p_leaf.memory_bits, axis, ra)
        elif p_leaf.compute_scheme == "uniform8":
            qt = q_uniform(w_shape, 8, -1, ra, act=act, stacked=stacked)
        elif p_leaf.compute_scheme == "apot":
            qt = q_apot(w_shape, ra, act=act, stacked=stacked)
        elif p_leaf.compute_scheme == "m2q":
            qt = q_m2q(key, w_shape, ra, act, stacked,
                       QExpertM2Q if batched else QM2Q)
        else:
            raise ValueError(f"unknown compute scheme "
                             f"{p_leaf.compute_scheme}")
        return dataclasses.replace(qt, shape=shape) if conv else qt

    return map_with_path(visit, params_abs)


def mixed_fake_quant(w2: torch.Tensor, asn, scheme: str) -> torch.Tensor:
    """A 2-D weight under an Eq. 6 split ``asn``: uniform 8 on its
    ``uniform_idx`` filters, APoT (``scheme="m2q"``) or PoT at 3 bits
    (``"pot_mix"``) on its ``apot_idx`` filters.  Every quantizer is
    filter-wise, so each column is its own quantizer's whatever the
    other columns hold."""
    idx_u = torch.as_tensor(asn.uniform_idx, dtype=torch.int64,
                            device=w2.device)
    idx_a = torch.as_tensor(asn.apot_idx, dtype=torch.int64,
                            device=w2.device)
    out = w2.clone()
    out[:, idx_u] = fake_quant_uniform(w2[:, idx_u], bits=8, axis=-1)
    alt = w2[:, idx_a]
    out[:, idx_a] = (fake_quant_apot(alt, axis=-1) if scheme == "m2q"
                     else fake_quant_pot(alt, bits=3, axis=-1))
    return out


def fake_quant_model(params, rules: Sequence[Rule], scheme: str = "uniform8",
                     bits: int = 8, kinds: Optional[set] = None,
                     path_filter: Optional[str] = None,
                     assignments: Optional[dict] = None):
    """Whole-tree fake quantization under one scheme (twin of JAX's
    ``fake_quant_model``; the Table I-IV accuracy sweeps): a new tree in
    which every quantizable float leaf of ``kinds`` whose path
    ``re.search``-es ``path_filter`` is replaced by its dequantized f32
    self, on its own device; every other leaf is the caller's.

    ``scheme``: ``"uniform"`` at ``bits``; ``"pot"`` at 3 bits (the PoT
    exponent field) whatever ``bits`` says; ``"apot"``; ``"m2q"`` /
    ``"pot_mix"``: Eq. 6 at ratio 0.5 over the leaf flattened to its
    filters, uniform 8 on one half and APoT / PoT-3 on the other
    (:func:`mixed_fake_quant`; ``pot_mix`` is the Auto-ViT-Acc
    analogue).  Anything else raises ``ValueError`` -- the default
    ``"uniform8"`` too, as in the reference.  An embedding is quantized
    per row (axis 0).  ``assignments``: a dict that receives each mixed
    leaf's :class:`~repro_torch.core.scheme_select.SchemeAssignment` by
    path."""

    def visit(key, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
            return leaf
        kind = match_kind(rules, key)
        if kind is None or kind == pol.KIND_SKIP:
            return leaf
        if kinds is not None and kind not in kinds:
            return leaf
        if path_filter is not None and not re.search(path_filter, key):
            return leaf
        w = leaf.to(torch.float32)
        axis = 0 if kind == pol.KIND_EMBEDDING else -1
        if scheme == "uniform":
            return fake_quant_uniform(w, bits=bits, axis=axis)
        if scheme == "pot":
            return fake_quant_pot(w, bits=3, axis=axis)
        if scheme == "apot":
            return fake_quant_apot(w, axis=axis)
        if scheme in ("m2q", "pot_mix"):
            w2 = w.reshape(-1, w.shape[-1])
            asn = select_schemes(w2, ratio=0.5)
            if assignments is not None:
                assignments[key] = asn
            return mixed_fake_quant(w2, asn, scheme).reshape(w.shape)
        raise ValueError(scheme)

    return map_with_path(visit, params)

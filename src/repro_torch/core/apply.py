"""quantize_model: rewrite a float parameter tree into M2Q QTensor leaves
(twin of ``repro.core.apply`` for 2-D dense and conv leaves).

Models tag quantizable weights with QUANT_RULES, ordered ``(regex, kind)``
pairs matched against the tree path (first match wins).  The policy, the
deployment ShapeCtx and optional per-path overrides decide mixed-scheme vs
low-bit per leaf; Eq. 6 splits mixed layers' filters between uniform-8 and
APoT.  Conv filters (HWIO) are classified on their 4-D shape but quantized
as the ``(kh*kw*cin, cout)`` flattening, so filter-wise scales land on
Cout; the leaf's ``shape`` keeps the original filter.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import policy as pol
from .qtensor import QAPoT, QM2Q, QUniform, weight_bits
from .scheme_select import select_schemes
from .tree import map_with_path

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
        decision = ov.decision
    return decision, p_leaf


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


def _quantize_leaf(w: torch.Tensor, decision: str, p: pol.M2QPolicy,
                   act_max_abs):
    """w is a (K, N) dense weight or a flattened (kh*kw*cin, cout) filter."""
    ams = act_max_abs if p.quantize_activations else None
    if decision == pol.DECISION_LOWBIT:
        return QUniform.quantize(w, bits=p.memory_bits, axis=-1)
    if p.compute_scheme == "uniform8":
        return QUniform.quantize(w, bits=8, axis=-1, act_max_abs=ams)
    if p.compute_scheme == "apot":
        return QAPoT.quantize(w, act_max_abs=ams)
    if p.compute_scheme == "m2q":
        asn = select_schemes(w, ratio=p.apot_ratio)
        return QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                             act_max_abs=ams)
    raise ValueError(f"unknown compute scheme {p.compute_scheme}")


def quantize_model(params, rules: Sequence[Rule], shape_ctx: pol.ShapeCtx,
                   m2q_policy: Optional[pol.M2QPolicy] = None,
                   act_stats: Optional[Dict[str, float]] = None,
                   overrides: Optional[Sequence[Override]] = None):
    """Apply M2Q to ``params``; non-matching leaves pass through.
    Returns (qparams, per-layer reports in tree order)."""
    p = m2q_policy or pol.M2QPolicy()
    act_stats = act_stats or {}
    report: List[LayerReport] = []

    def visit(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        kind = match_kind(rules, key)
        if kind is None or kind == pol.KIND_SKIP or leaf.ndim < 2:
            return leaf
        if kind not in (pol.KIND_DENSE, pol.KIND_DWCONV) \
                or leaf.ndim not in (2, 4):
            raise NotImplementedError(
                f"{key!r}: only 2-D dense and conv leaves are quantized "
                f"here (got {kind} of shape {tuple(leaf.shape)})")
        decision, p_leaf = resolve_decision(key, kind, tuple(leaf.shape),
                                            shape_ctx, p, overrides)
        if decision == pol.DECISION_SKIP:
            return leaf
        w = leaf.to(torch.float32)
        w = w.reshape(-1, w.shape[-1])
        qt = _quantize_leaf(w, decision, p_leaf, act_stats.get(key))
        qt = dataclasses.replace(qt, shape=tuple(leaf.shape))
        rep = LayerReport(path=key, kind=kind, decision=decision,
                          shape=tuple(leaf.shape), bits=weight_bits(qt))
        if isinstance(qt, QM2Q):
            rep.n_apot, rep.n_uniform = qt.n_apot, qt.n_uniform
        w_hat = qt.dequant()
        rep.mse = float(torch.mean((w.reshape(w_hat.shape) - w_hat) ** 2))
        report.append(rep)
        return qt

    return map_with_path(visit, params), report

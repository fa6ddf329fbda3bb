"""PTQ activation calibration (twin of ``repro.core.calibrate``).

Quantizable weight leaves are wrapped in :class:`CalibTensor`; running the
model then records the running max-abs of each weight's incoming
activation under the weight's tree path, while the float op runs as usual.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

from . import policy as pol
from .tree import map_with_path


def path_str(path) -> str:
    """Canonical '/'-joined string of a tree path: a sequence of parts
    that are dict keys (``.key``), sequence indices (``.idx``) -- the key
    objects of a JAX tree path -- or plain strings and ints, as the port's
    ``core.tree`` paths are built."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


class CalibTensor:
    """Float weight + max-abs observer."""

    __slots__ = ("w", "key", "store")

    def __init__(self, w: torch.Tensor, key: str, store: Dict[str, float]):
        self.w = w
        self.key = key
        self.store = store

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.w.dtype

    def __getitem__(self, i):
        """One layer of a stacked weight, recording under ``'<path>@<i>'``
        (the unrolled layer loop's per-layer stats keys)."""
        return CalibTensor(self.w[i], f"{self.key}@{i}", self.store)

    def record(self, x: torch.Tensor) -> None:
        """Fold max|x| into the store; a non-finite statistic raises (it
        would bake a NaN scale into every later inference)."""
        m = float(torch.max(torch.abs(x)))
        if not math.isfinite(m):
            raise ValueError(
                f"non-finite activation statistic at {self.key!r}: "
                f"max|x| = {m} over shape {tuple(x.shape)}; calibration "
                "inputs must be finite")
        self.store[self.key] = max(self.store.get(self.key, 0.0), m)


def wrap_for_calibration(params, match: Callable[[str, object], bool]
                         ) -> Tuple[object, Dict[str, float]]:
    """Wrap every tensor leaf with ``match(path, leaf)`` in a CalibTensor;
    returns (wrapped params, the stats store they fill)."""
    store: Dict[str, float] = {}

    def wrap(key, leaf):
        if isinstance(leaf, torch.Tensor) and match(key, leaf):
            return CalibTensor(leaf, key, store)
        return leaf

    return map_with_path(wrap, params), store


def rule_matcher(rules):
    """``match`` for :func:`wrap_for_calibration` from QUANT_RULES: wrap
    exactly the leaves quantize_model would touch."""
    from .apply import match_kind

    def match(key: str, leaf) -> bool:
        kind = match_kind(rules, key)
        return kind is not None and kind != pol.KIND_SKIP and leaf.ndim >= 2

    return match


def run_calibration(apply_fn: Callable, wrapped_params,
                    batches: Iterable) -> None:
    """Drive the model over the calibration batches."""
    with torch.inference_mode():
        for batch in batches:
            apply_fn(wrapped_params, batch)

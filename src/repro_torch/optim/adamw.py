"""AdamW + schedules + clipping (twin of ``repro.optim.adamw``), on plain
tensors under ``torch.no_grad()``.

State is a tree mirroring params (m, v) plus an int32 step count, as a
NamedTuple whose fields checkpoint as ``.count`` / ``.m`` / ``.v``: a
``(params, AdamWState)`` checkpoint written by either package restores in
the other.  :meth:`AdamW.update` returns new trees, as the reference
does, and keeps every scalar (count, learning rate, norm, bias
corrections) a 0-d tensor on the parameters' device, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from ..core.quant import div
from ..core.tree import leaves_with_path, map_with_path, unflatten


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32, 0-d
    m: object            # tree like params, f32
    v: object


def _tensors(tree):
    return [leaf for _, leaf in leaves_with_path(tree)]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments shaped like ``params`` (in f32, as the reference's
        ``zeros_like`` of its f32 parameters), count 0."""
        leaves = _tensors(params)
        device = leaves[0].device

        def zeros(_, p):
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=map_with_path(zeros, params), v=map_with_path(zeros, params))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=count.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: returns (new params, new state, the gradients' global
        norm before clipping)."""
        count = state.count + 1
        gnorm = global_norm(grads)
        gs = _tensors(grads)
        if self.grad_clip is not None:
            scale = torch.clamp(div(torch.full_like(gnorm, self.grad_clip),
                                    gnorm + 1e-9), max=1.0)
            gs = [g * scale for g in gs]
        cf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.full_like(cf, self.b1), cf)
        b2c = 1.0 - torch.pow(torch.full_like(cf, self.b2), cf)
        lr = self._lr(count)

        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(_tensors(params), gs, _tensors(state.m),
                              _tensors(state.v)):
            gf = g.to(torch.float32)
            m2 = self.b1 * m + (1 - self.b1) * gf
            v2 = self.b2 * v + (1 - self.b2) * torch.square(gf)
            step = (m2 / b1c) / (torch.sqrt(v2 / b2c) + self.eps)
            if p.ndim >= 2:  # decoupled decay on matrices only
                step = step + self.weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * step).to(p.dtype))
            new_m.append(m2)
            new_v.append(v2)
        return (unflatten(params, new_p),
                AdamWState(count, unflatten(state.m, new_m),
                           unflatten(state.v, new_v)), gnorm)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, summed leaf by
    leaf in flatten order."""
    total = None
    for leaf in _tensors(tree):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; a function of the int32
    count tensor, computed in f32 on its device."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = div(peak_lr * c, float(max(warmup, 1)))
        prog = torch.clamp(div(c - warmup, float(max(total - warmup, 1))),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)

    return lr

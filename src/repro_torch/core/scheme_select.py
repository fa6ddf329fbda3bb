"""Per-filter scheme selection (paper Eq. 6 + the 1:1 ratio constraint);
twin of ``repro.core.scheme_select``."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .quant import fake_quant_apot, fake_quant_uniform, filterwise_mse


@dataclasses.dataclass
class SchemeAssignment:
    apot_idx: np.ndarray     # filters quantized with APoT
    uniform_idx: np.ndarray  # filters quantized with 8-bit uniform
    mse_uniform: np.ndarray
    mse_apot: np.ndarray


def select_schemes(w: torch.Tensor, ratio: Optional[float] = 0.5,
                   bits_uniform: int = 8) -> SchemeAssignment:
    """Assign {APoT, uniform} per filter (out channels on the last axis).

    ratio=0.5: the ``floor(N*ratio)`` filters with the smallest APoT
    penalty (mse_apot - mse_uniform, stable argsort) go to APoT;
    ratio=None is the unconstrained Eq. 6 argmin."""
    w = w.to(torch.float32)
    mse_u = filterwise_mse(w, fake_quant_uniform(w, bits=bits_uniform), -1)
    mse_a = filterwise_mse(w, fake_quant_apot(w), -1)
    mse_u = mse_u.cpu().numpy()
    mse_a = mse_a.cpu().numpy()
    n = w.shape[-1]
    if ratio is None:
        apot_mask = mse_a < mse_u
        apot_idx = np.nonzero(apot_mask)[0]
        uniform_idx = np.nonzero(~apot_mask)[0]
    else:
        n_apot = int(n * ratio)
        order = np.argsort(mse_a - mse_u, kind="stable")
        apot_idx = np.sort(order[:n_apot])
        uniform_idx = np.sort(order[n_apot:])
    return SchemeAssignment(apot_idx=apot_idx.astype(np.int32),
                            uniform_idx=uniform_idx.astype(np.int32),
                            mse_uniform=mse_u, mse_apot=mse_a)

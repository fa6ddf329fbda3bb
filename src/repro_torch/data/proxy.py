"""The trained proxy model (twin of ``benchmarks.proxy_model`` without its
training loop): the reduced EfficientViT-B1 trained by the JAX package on
the synthetic vision task, whose weights the repo commits.

* :func:`load_proxy` reads ``results/proxy_efficientvit.npz`` (members
  ``leaf_<i>``, the float tree's leaves in JAX flatten order) into the
  port's tree.
* :func:`accuracy` / :func:`predict` / :func:`logits`: top-1, predictions
  and logits over ``n_batches`` x 32 images of
  :class:`~repro_torch.data.pipeline.SyntheticVision` (noise 0.7) from
  step ``seed0`` on, the JAX ``accuracy()``'s images.
* :func:`calib_batches`: the four calibration batches the JAX example
  quantizes the proxy with.
* ``ARTIFACT``: the JAX package's ``m2q-w8a8`` artifact of the proxy
  (``tools/write_proxy_artifact.py``), with its ``expected.json``.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs.registry import REDUCED
from ..core.tree import device_of, leaves_with_path, unflatten
from ..models import efficientvit
from .pipeline import SyntheticVision

ROOT = Path(__file__).resolve().parents[3]
CACHE = ROOT / "results" / "proxy_efficientvit.npz"
ARTIFACT = ROOT / "results" / "artifacts" / "proxy_efficientvit_m2q"

CFG = REDUCED["efficientvit-b1-r224"]
BATCH = 32


def _data() -> SyntheticVision:
    return SyntheticVision(CFG.n_classes, CFG.img_res, noise=0.7)


def load_proxy(device="cuda") -> dict:
    """The trained float proxy on ``device``; a missing cache raises."""
    if not CACHE.exists():
        raise FileNotFoundError(f"{CACHE} is missing: the trained proxy is "
                                "committed with the repo")
    template = efficientvit.init(CFG, device="meta")
    slots = list(leaves_with_path(template))
    with np.load(CACHE) as data:
        if len(data.files) != len(slots):
            raise ValueError(f"{CACHE.name} holds {len(data.files)} leaves, "
                             f"the {CFG.name} tree {len(slots)}")
        leaves = []
        for i, (key, tpl) in enumerate(slots):
            a = data[f"leaf_{i}"]
            if a.dtype != np.float32 or tuple(a.shape) != tuple(tpl.shape):
                raise ValueError(f"{CACHE.name} leaf_{i} ({key}): "
                                 f"{a.dtype} {a.shape}, expected float32 "
                                 f"{tuple(tpl.shape)}")
            leaves.append(torch.from_numpy(a).to(device))
    return unflatten(template, leaves)


def calib_batches(n: int = 4, seed0: int = 20_000) -> List[np.ndarray]:
    """``n`` batches of 32 images from step ``seed0`` on."""
    ds = _data()
    return [ds.batch(seed0 + i, BATCH)[0] for i in range(n)]


def logits(params, n_batches: int = 8, seed0: int = 10_000,
           attn: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(float32 logits, labels) over ``n_batches`` x 32 images, run on the
    device ``params`` live on; ``attn`` the MSA token mixer."""
    ds = _data()
    device = device_of(params)
    out, labels = [], []
    with torch.inference_mode():
        for b in range(n_batches):
            x, y = ds.batch(seed0 + b, BATCH)
            out.append(efficientvit.forward(
                CFG, params, torch.from_numpy(x).to(device), attn=attn)
                .float().cpu().numpy())
            labels.append(y)
    return np.concatenate(out), np.concatenate(labels)


def predict(params, n_batches: int = 8, seed0: int = 10_000,
            attn: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(top-1 predictions, labels) over ``n_batches`` x 32 images."""
    out, labels = logits(params, n_batches, seed0, attn)
    return out.argmax(-1), labels


def accuracy(params, n_batches: int = 8, seed0: int = 10_000,
             attn: Optional[str] = None) -> float:
    """Top-1 over ``n_batches`` x 32 images (the JAX ``accuracy()``)."""
    preds, labels = predict(params, n_batches, seed0, attn)
    return float(np.mean(preds == labels))

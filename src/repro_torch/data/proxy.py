"""The trained proxy model (twin of ``benchmarks.proxy_model``): the
reduced EfficientViT-B1 trained on the synthetic vision task, whose
weights, as the JAX package trained them, the repo commits.

* :func:`load_proxy` reads ``results/proxy_efficientvit.npz`` (members
  ``leaf_<i>``, the float tree's leaves in JAX flatten order), or another
  file in that layout, into the port's tree.
* :func:`train_proxy`: the reference's training run (300 AdamW steps of
  32 images, :func:`train_step`) in the port, written to a file the
  caller names (:func:`save_proxy`).
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
from ..optim.adamw import AdamW, cosine_schedule
from ..train.step import value_and_grad
from .pipeline import SyntheticVision

ROOT = Path(__file__).resolve().parents[3]
CACHE = ROOT / "results" / "proxy_efficientvit.npz"
ARTIFACT = ROOT / "results" / "artifacts" / "proxy_efficientvit_m2q"

CFG = REDUCED["efficientvit-b1-r224"]
BATCH = 32
STEPS = 300  # the reference's training run


def _data() -> SyntheticVision:
    return SyntheticVision(CFG.n_classes, CFG.img_res, noise=0.7)


def load_proxy(device="cuda", path=CACHE) -> dict:
    """The float proxy in ``path`` (the committed trained proxy by
    default) on ``device``; a missing file raises."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing (the trained proxy is "
                                f"committed as {CACHE.name})")
    template = efficientvit.init(CFG, device="meta")
    slots = list(leaves_with_path(template))
    with np.load(path) as data:
        if len(data.files) != len(slots):
            raise ValueError(f"{path.name} holds {len(data.files)} leaves, "
                             f"the {CFG.name} tree {len(slots)}")
        leaves = []
        for i, (key, tpl) in enumerate(slots):
            a = data[f"leaf_{i}"]
            if a.dtype != np.float32 or tuple(a.shape) != tuple(tpl.shape):
                raise ValueError(f"{path.name} leaf_{i} ({key}): "
                                 f"{a.dtype} {a.shape}, expected float32 "
                                 f"{tuple(tpl.shape)}")
            leaves.append(torch.from_numpy(a).to(device))
    return unflatten(template, leaves)


def loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the f32 logits of the float forward (f32
    attention: the reference trains with its attention kernels off)."""
    lg = efficientvit.forward(CFG, params, x, attn="f32").to(torch.float32)
    logp = torch.log_softmax(lg, dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.to(torch.int64)[:, None]))


def optimizer() -> AdamW:
    """The reference's: AdamW under ``cosine_schedule(2e-3, 10, 300)``."""
    return AdamW(lr=cosine_schedule(2e-3, 10, STEPS))


def train_step(opt: AdamW, params, state, x: np.ndarray, y: np.ndarray):
    """One step on a batch (the reference's jitted ``step``): returns
    (params, optimizer state, the loss as a 0-d tensor)."""
    device = device_of(params)
    value, grads = value_and_grad(
        lambda p, b: loss(p, *b), params,
        (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)))
    params, state, _ = opt.update(grads, state, params)
    return params, state, value


def _writable(path) -> Path:
    path = Path(path)
    if path.resolve() == CACHE.resolve():
        raise ValueError(f"{CACHE.name} is the reference's trained proxy: "
                         "write elsewhere")
    return path


def save_proxy(params, path) -> Path:
    """Write a float proxy to ``path`` in the committed layout
    (``leaf_<i>`` in JAX flatten order, :func:`load_proxy`'s); never over
    the committed proxy."""
    path = _writable(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"leaf_{i}": leaf.detach().cpu().numpy()
                      for i, (_, leaf) in enumerate(leaves_with_path(params))})
    return path


def train_proxy(path, device="cuda", seed: int = 0):
    """The reference's proxy training (``benchmarks.proxy_model.
    train_proxy``) in the port: :func:`train_step` on each
    ``SyntheticVision`` batch ``s = 0 .. 299`` of 32 images, from an init
    drawn on ``device`` by a torch generator seeded with ``seed`` (other
    numbers than the reference's ``PRNGKey(0)``); the result written to
    ``path`` by :func:`save_proxy`.  Returns (params, per-step losses)."""
    path = _writable(path)  # refused before any step is paid for
    params = efficientvit.init(CFG, seed=seed, device=device)
    ds = _data()
    opt = optimizer()
    state = opt.init(params)
    losses = []
    for s in range(STEPS):
        params, state, value = train_step(opt, params, state,
                                          *ds.batch(s, BATCH))
        losses.append(value)
    save_proxy(params, path)
    return params, [float(v) for v in losses]


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

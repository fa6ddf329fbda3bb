"""Canonical input/cache spec builders for every (arch x shape) cell (twin
of ``repro.launch.specs``).

Concrete tensors for the smoke tests and the qlint traces; with
``concrete=False`` every tensor is on the ``meta`` device (shapes and
dtypes only, nothing allocated: the twin of ``jax.ShapeDtypeStruct``).

Assigned LM shapes:
  train_4k     seq 4096,  global_batch 256   -> train_step
  prefill_32k  seq 32768, global_batch 32    -> prefill (inference)
  decode_32k   seq 32768, global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288, global_batch 1    -> serve_step, sub-quadratic only

Modality frontends are stubs: whisper gets precomputed frame embeddings
(B, n_audio_ctx, D); internvl2 gets projected patch embeddings (B,
n_patches, D).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models import get_model
from ..models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_is_skipped(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """Returns a reason string if this (arch x shape) cell is skipped."""
    from ..configs.registry import SUBQUADRATIC
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC \
            and cfg.name.split("-reduced")[0] not in SUBQUADRATIC:
        return ("pure full-attention arch: 524k dense-KV decode is the "
                "quadratic regime the paper's efficient-ViT focus avoids")
    return None


def _rng_tokens(shape, vocab, seed=0, device="cpu"):
    """JAX's ``_rng_tokens``: the same numpy draw, as int32."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, size=shape, dtype=np.int32)).to(device)


def train_inputs(cfg: ArchConfig, batch: int, seq: int,
                 concrete: bool = False, device="cpu"):
    """Inputs for train_step / forward: {tokens, labels, [frames |
    prefix_embeds]}."""
    dev = device if concrete else "meta"

    def mk_tok(s):
        return _rng_tokens(s, cfg.vocab_size, device=dev) if concrete \
            else torch.empty(s, dtype=torch.int32, device=dev)

    def mk_f(s):
        return torch.zeros(s, dtype=torch.bfloat16, device=dev)

    out = {}
    if cfg.family == "whisper":
        out["frames"] = mk_f((batch, cfg.n_audio_ctx, cfg.d_model))
        out["tokens"] = mk_tok((batch, seq))
        out["labels"] = mk_tok((batch, seq))
    elif cfg.n_patches:
        text_len = max(seq - cfg.n_patches, 1)
        out["prefix_embeds"] = mk_f((batch, cfg.n_patches, cfg.d_model))
        out["tokens"] = mk_tok((batch, text_len))
        out["labels"] = mk_tok((batch, text_len))
    else:
        out["tokens"] = mk_tok((batch, seq))
        out["labels"] = mk_tok((batch, seq))
    return out


def prefill_inputs(cfg: ArchConfig, batch: int, seq: int,
                   concrete: bool = False, cache_dtype=torch.bfloat16,
                   device="cpu"):
    model = get_model(cfg)
    inp = train_inputs(cfg, batch, seq, concrete=concrete, device=device)
    inp.pop("labels")
    cache = model.init_cache(cfg, batch, seq, dtype=cache_dtype,
                             device=device if concrete else "meta")
    return inp, cache


def decode_inputs(cfg: ArchConfig, batch: int, seq: int,
                  concrete: bool = False, cache_dtype=torch.bfloat16,
                  device="cpu"):
    """serve_step inputs: one new token against a cache of length seq."""
    model = get_model(cfg)
    dev = device if concrete else "meta"
    cache = model.init_cache(cfg, batch, seq, dtype=cache_dtype, device=dev)
    if concrete:
        cache["lengths"] = torch.full((batch,), seq - 1, dtype=torch.int32,
                                      device=dev)
        tokens = _rng_tokens((batch, 1), cfg.vocab_size, device=dev)
    else:
        tokens = torch.empty((batch, 1), dtype=torch.int32, device=dev)
    return cache, tokens

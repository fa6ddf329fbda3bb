"""Architecture config (the vision subset of ``repro.models.config``'s
``ArchConfig``; the language-model fields come with those families)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # efficientvit
    n_layers: int
    d_model: int
    # efficientvit (vision)
    widths: Tuple[int, ...] = ()
    depths: Tuple[int, ...] = ()
    img_res: int = 224
    n_classes: int = 1000
    dim_per_head: int = 16  # EfficientViT MSA head dim
    # numerics: the activation dtype of the forward
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

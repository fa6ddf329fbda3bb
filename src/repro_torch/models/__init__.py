"""Model zoo (EfficientViT so far)."""
from . import efficientvit
from .config import ArchConfig

FAMILIES = {"efficientvit": efficientvit}


def get_model(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet")
    return FAMILIES[cfg.family]

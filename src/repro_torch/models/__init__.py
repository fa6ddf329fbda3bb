"""Model zoo (EfficientViT and the dense decoder-only LM so far)."""
from . import dense_lm, efficientvit
from .config import ArchConfig

FAMILIES = {"efficientvit": efficientvit, "dense_lm": dense_lm}


def get_model(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet")
    return FAMILIES[cfg.family]

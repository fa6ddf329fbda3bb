"""Model zoo (EfficientViT and the decoder-only LM, dense or MoE, so
far)."""
from . import dense_lm, efficientvit
from .config import ArchConfig

# moe_lm shares the dense_lm implementation, as in the JAX package
FAMILIES = {"efficientvit": efficientvit, "dense_lm": dense_lm,
            "moe_lm": dense_lm}


def get_model(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet")
    return FAMILIES[cfg.family]

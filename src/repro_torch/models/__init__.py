"""Model zoo: EfficientViT, the decoder-only LM (dense or MoE), the
recurrent LMs (RWKV6, RecurrentGemma) and the encoder-decoder (Whisper)."""
from . import dense_lm, efficientvit, recurrentgemma, rwkv, whisper
from .config import ArchConfig

# moe_lm shares the dense_lm implementation, as in the JAX package
FAMILIES = {"efficientvit": efficientvit, "dense_lm": dense_lm,
            "moe_lm": dense_lm, "rwkv": rwkv,
            "recurrentgemma": recurrentgemma, "whisper": whisper}


def get_model(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet")
    return FAMILIES[cfg.family]

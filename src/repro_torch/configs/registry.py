"""Architecture registry (twin of ``repro.configs.registry``, name for
name): the EfficientViT, dense-LM, MoE-LM, recurrent (rwkv,
recurrentgemma) and encoder-decoder (whisper) entries."""
from . import (dbrx_132b, efficientvit_b1, efficientvit_b2, granite3_8b,
               internvl2_2b, llama4_scout_17b_a16e, minitron_4b, qwen3_14b,
               qwen15_05b, recurrentgemma_9b, rwkv6_3b, whisper_large_v3)

_MODULES = {
    "qwen1.5-0.5b": qwen15_05b,
    "qwen3-14b": qwen3_14b,
    "granite-3-8b": granite3_8b,
    "minitron-4b": minitron_4b,
    "internvl2-2b": internvl2_2b,
    "rwkv6-3b": rwkv6_3b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "dbrx-132b": dbrx_132b,
    "whisper-large-v3": whisper_large_v3,
    "recurrentgemma-9b": recurrentgemma_9b,
    "efficientvit-b1-r224": efficientvit_b1,
    "efficientvit-b2-r224": efficientvit_b2,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
ARCHS["efficientvit-b1-r256"] = efficientvit_b1.CONFIG_R256
ARCHS["efficientvit-b1-r288"] = efficientvit_b1.CONFIG_R288
REDUCED = {name: mod.REDUCED for name, mod in _MODULES.items()}

# the 10 assigned LM-pool architectures (the JAX package's dry-run grid)
ASSIGNED = [
    "qwen1.5-0.5b", "qwen3-14b", "granite-3-8b", "minitron-4b",
    "internvl2-2b", "rwkv6-3b", "llama4-scout-17b-a16e", "dbrx-132b",
    "whisper-large-v3", "recurrentgemma-9b",
]

# archs with sub-quadratic sequence mixing (the long_500k cell)
SUBQUADRATIC = {"rwkv6-3b", "recurrentgemma-9b"}


def get_config(name: str):
    return ARCHS[name]


def get_reduced(name: str):
    return REDUCED[name]


def list_archs():
    return list(ARCHS)

"""Architecture registry: the EfficientViT and qwen1.5-0.5b entries of
``repro.configs.registry`` (the other families are not ported yet)."""
from . import efficientvit_b1, efficientvit_b2, qwen15_05b

ARCHS = {
    "efficientvit-b1-r224": efficientvit_b1.CONFIG,
    "efficientvit-b2-r224": efficientvit_b2.CONFIG,
    "efficientvit-b1-r256": efficientvit_b1.CONFIG_R256,
    "efficientvit-b1-r288": efficientvit_b1.CONFIG_R288,
    "qwen1.5-0.5b": qwen15_05b.CONFIG,
}
REDUCED = {"efficientvit-b1-r224": efficientvit_b1.REDUCED,
           "efficientvit-b2-r224": efficientvit_b2.REDUCED,
           "qwen1.5-0.5b": qwen15_05b.REDUCED}

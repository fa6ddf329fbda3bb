"""Architecture registry: the EfficientViT entries of
``repro.configs.registry`` (the other families are not ported yet)."""
from . import efficientvit_b1, efficientvit_b2

ARCHS = {
    "efficientvit-b1-r224": efficientvit_b1.CONFIG,
    "efficientvit-b2-r224": efficientvit_b2.CONFIG,
    "efficientvit-b1-r256": efficientvit_b1.CONFIG_R256,
    "efficientvit-b1-r288": efficientvit_b1.CONFIG_R288,
}
REDUCED = {"efficientvit-b1-r224": efficientvit_b1.REDUCED,
           "efficientvit-b2-r224": efficientvit_b2.REDUCED}

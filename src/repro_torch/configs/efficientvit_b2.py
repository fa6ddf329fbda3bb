"""EfficientViT-B2 (the paper's model) at R224."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="efficientvit-b2-r224", family="efficientvit", n_layers=16,
    d_model=384, widths=(24, 48, 96, 192, 384), depths=(1, 3, 4, 4, 6),
    img_res=224, n_classes=1000, dim_per_head=32)

REDUCED = CONFIG.replace(
    name="efficientvit-b2-reduced", widths=(8, 16, 32), depths=(1, 1, 2),
    img_res=32, n_classes=10, dim_per_head=8, dtype="float32")

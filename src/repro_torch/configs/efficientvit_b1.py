"""EfficientViT-B1 (the paper's model) at R224/R256/R288."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="efficientvit-b1-r224", family="efficientvit", n_layers=13,
    d_model=256, widths=(16, 32, 64, 128, 256), depths=(1, 2, 3, 3, 4),
    img_res=224, n_classes=1000, dim_per_head=16)

CONFIG_R256 = CONFIG.replace(name="efficientvit-b1-r256", img_res=256)
CONFIG_R288 = CONFIG.replace(name="efficientvit-b1-r288", img_res=288)

REDUCED = CONFIG.replace(
    name="efficientvit-b1-reduced", widths=(8, 16, 32), depths=(1, 1, 2),
    img_res=32, n_classes=10, dim_per_head=8, dtype="float32")

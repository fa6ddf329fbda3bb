"""internvl2-2b [vlm] -- InternLM2 backbone 24L d2048 16H (GQA kv=8) dff8192
vocab92553; the InternViT frontend is a STUB: the caller passes 256 projected
patch embeddings as ``prefix_embeds``. [arXiv:2404.16821]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="dense_lm", n_layers=24, d_model=2048,
    vocab_size=92553, n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192,
    n_patches=256)

REDUCED = CONFIG.replace(
    name="internvl2-2b-reduced", n_layers=2, d_model=64, vocab_size=493,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, n_patches=8,
    dtype="float32")

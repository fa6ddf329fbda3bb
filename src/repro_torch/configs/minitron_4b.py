"""minitron-4b [dense] -- 32L d3072 24H (GQA kv=8) dff9216 vocab256000,
pruned nemotron (squared-ReLU FFN). [arXiv:2407.14679]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense_lm", n_layers=32, d_model=3072,
    vocab_size=256000, n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216,
    ffn="relu2")

REDUCED = CONFIG.replace(
    name="minitron-4b-reduced", n_layers=2, d_model=96, vocab_size=512,
    n_heads=6, n_kv_heads=2, head_dim=16, d_ff=288, dtype="float32")

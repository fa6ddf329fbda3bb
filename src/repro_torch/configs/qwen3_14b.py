"""qwen3-14b [dense] -- 40L d5120 40H (GQA kv=8) dff17408 vocab151936,
qk_norm. [hf:Qwen/Qwen3 family]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense_lm", n_layers=40, d_model=5120,
    vocab_size=151936, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408,
    qk_norm=True, rope_theta=1_000_000.0)

REDUCED = CONFIG.replace(
    name="qwen3-14b-reduced", n_layers=2, d_model=80, vocab_size=512,
    n_heads=5, n_kv_heads=1, head_dim=16, d_ff=272, dtype="float32")

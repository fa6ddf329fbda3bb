"""qwen1.5-0.5b [dense] -- 24L d1024 16H (MHA kv=16) dff2816 vocab151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense_lm", n_layers=24, d_model=1024,
    vocab_size=151936, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816,
    qkv_bias=True, rope_theta=1_000_000.0)

REDUCED = CONFIG.replace(
    name="qwen1.5-0.5b-reduced", n_layers=2, d_model=64, vocab_size=512,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=176, dtype="float32")

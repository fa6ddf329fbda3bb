"""granite-3-8b [dense] -- 40L d4096 32H (GQA kv=8) dff12800 vocab49155.
[hf:ibm-granite/granite-3.0]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense_lm", n_layers=40, d_model=4096,
    vocab_size=49155, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12800)

REDUCED = CONFIG.replace(
    name="granite-3-8b-reduced", n_layers=2, d_model=64, vocab_size=387,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=200, dtype="float32")

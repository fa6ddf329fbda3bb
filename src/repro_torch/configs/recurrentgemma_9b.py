"""recurrentgemma-9b [hybrid] -- 38L d4096 16H (MQA kv=1, hd256) dff12288
vocab256000, RG-LRU + local attention (window 2048), pattern rec,rec,attn.
[arXiv:2402.19427]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="recurrentgemma", n_layers=38,
    d_model=4096, vocab_size=256000, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, window=2048, lru_width=4096, conv1d_width=4)

REDUCED = CONFIG.replace(
    name="recurrentgemma-9b-reduced", n_layers=5, d_model=64, vocab_size=512,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=192, window=8, lru_width=64,
    dtype="float32")

"""rwkv6-3b [ssm] -- Finch, 32L d2560 (attn-free, 40 heads of 64) dff8960
vocab65536, data-dependent decay. [arXiv:2404.05892]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="rwkv", n_layers=32, d_model=2560,
    vocab_size=65536, d_ff=8960, rwkv_head_dim=64)

REDUCED = CONFIG.replace(
    name="rwkv6-3b-reduced", n_layers=2, d_model=64, vocab_size=512,
    d_ff=224, rwkv_head_dim=16, dtype="float32")

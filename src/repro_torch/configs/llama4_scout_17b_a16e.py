"""llama4-scout-17b-a16e [moe] -- 48L d5120 40H (GQA kv=8) expert dff8192
vocab202048, MoE 16e top-1 + shared expert. [hf:meta-llama/Llama-4-Scout]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe_lm", n_layers=48, d_model=5120,
    vocab_size=202048, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    moe_experts=16, moe_top_k=1, moe_d_ff=8192, moe_shared_expert=True,
    rope_theta=500_000.0)

REDUCED = CONFIG.replace(
    name="llama4-scout-reduced", n_layers=2, d_model=64, vocab_size=512,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, moe_experts=4,
    moe_top_k=1, moe_d_ff=128, moe_capacity_factor=8.0, dtype="float32")

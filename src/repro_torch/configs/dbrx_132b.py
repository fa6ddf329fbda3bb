"""dbrx-132b [moe] -- 40L d6144 48H (GQA kv=8) expert dff10752 vocab100352,
MoE 16e top-4 fine-grained. [hf:databricks/dbrx-base]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe_lm", n_layers=40, d_model=6144,
    vocab_size=100352, n_heads=48, n_kv_heads=8, head_dim=128, d_ff=10752,
    moe_experts=16, moe_top_k=4, moe_d_ff=10752, rope_theta=500_000.0)

REDUCED = CONFIG.replace(
    name="dbrx-132b-reduced", n_layers=2, d_model=64, vocab_size=512,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=112, moe_experts=4,
    moe_top_k=2, moe_d_ff=112, moe_capacity_factor=8.0, dtype="float32")

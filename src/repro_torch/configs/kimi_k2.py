"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert
vocab=163840, MoE 384 experts top-8 + 1 shared expert, first layer dense —
trillion-parameter MoE (paper-table). [arXiv:2501.kimi2]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, n_experts=384,
    top_k=8, n_shared_experts=1, n_dense_layers=1, capacity_factor=1.25,
    rope_theta=50000.0)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=512, n_experts=8, top_k=2,
    n_shared_experts=1, n_dense_layers=1)

"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (the arch's signature). [arXiv:2402.00838; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=50304, norm="nonparam_ln",
    mlp_kind="swiglu", tie_embeddings=True, rope_theta=10000.0)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, norm="nonparam_ln",
    mlp_kind="swiglu", tie_embeddings=True)

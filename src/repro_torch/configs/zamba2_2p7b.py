"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE shared attention+MLP block
invoked every 6th layer (shared weights, per-invocation KV cache).
Sub-quadratic backbone -> runs long_500k. [arXiv:2411.15242; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, ssm_state=64,
    ssm_expand=2, ssm_headdim=64, attn_every=6, subquadratic=True)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, ssm_state=16, ssm_expand=2,
    ssm_headdim=16, attn_every=3, subquadratic=True, remat=False)

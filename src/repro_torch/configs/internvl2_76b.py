"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — the language backbone; the InternViT frontend is a stub
(the caller passes projected patch embeddings (B, 1024, d_model), which
`forward` prepends to the token stream). [arXiv:2404.16821]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    frontend="vision", frontend_len=1024, rope_theta=500000.0)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, frontend="vision", frontend_len=8,
    remat=False)

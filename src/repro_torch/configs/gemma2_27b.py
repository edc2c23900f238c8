"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000. Local/global alternating attention (window 4096), logit
softcaps (attn 50, final 30), sandwich norms, GeGLU, head_dim=128.
[arXiv:2408.00118; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense", n_layers=46, d_model=4608, n_heads=32,
    n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
    local_global=True, sliding_window=4096, softcap_attn=50.0,
    softcap_final=30.0, post_norm=True, mlp_kind="geglu",
    tie_embeddings=True, rope_theta=10000.0)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
    local_global=True, sliding_window=16, softcap_attn=50.0,
    softcap_final=30.0, post_norm=True, mlp_kind="geglu",
    tie_embeddings=True)

"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544,
    rope_theta=1_000_000.0)

SMOKE = ModelConfig(
    name="internlm2-20b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=192, vocab=512)

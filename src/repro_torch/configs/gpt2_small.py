"""GPT-2 small — one of the paper's own LLM benchmarks (Fig 14/15):
12L d_model=768 12H d_ff=3072 vocab=50257, learned positions, LayerNorm."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-small", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=50257, norm="layernorm",
    mlp_kind="gelu", learned_pos=True, max_seq=32_768, tie_embeddings=True)

SMOKE = ModelConfig(
    name="gpt2-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, norm="layernorm", mlp_kind="gelu",
    learned_pos=True, max_seq=128, tie_embeddings=True, remat=False)

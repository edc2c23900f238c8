"""whisper-tiny [audio]: 4+4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
encoder-decoder; the conv frontend is a stub (the caller passes frame
embeddings (B, 1500, d_model)). LayerNorm, GELU MLP, learned decoder
positions (extended to 32k; the real model's 448-token context is a
deployment limit, not a structural one). [arXiv:2212.04356]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab=51865, norm="layernorm", mlp_kind="gelu",
    encoder_layers=4, cross_attention=True, frontend="audio",
    frontend_len=1500, learned_pos=True, max_seq=32_776)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, norm="layernorm", mlp_kind="gelu",
    encoder_layers=2, cross_attention=True, frontend="audio",
    frontend_len=16, learned_pos=True, max_seq=128, remat=False)

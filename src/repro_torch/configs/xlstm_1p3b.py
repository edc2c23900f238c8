"""xlstm-1.3b [ssm]: 48L d_model=2048 4H vocab=50304 — sLSTM + mLSTM blocks
(7:1 ratio, every 8th layer sLSTM), d_ff=0 (blocks carry their own up/down
projections). Attention-free -> runs long_500k. [arXiv:2405.04517]

Deviation: our mLSTM uses DENSE q/k/v projections over d_inner; the published
1.3B config uses block-diagonal per-head projections, so this config lands at
~3.6B params (the reference's config, kept as it is)."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=8, subquadratic=True)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=512, slstm_every=2, subquadratic=True,
    remat=False)


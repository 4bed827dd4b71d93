"""xLSTM-1.3B — sLSTM + mLSTM blocks (recurrent, no KV cache).
[arXiv:2405.04517; unverified]"""
from .base import ModelConfig, XLSTMConfig

FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, chunk=256, qk_dim_factor=0.5),
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
    xlstm=XLSTMConfig(slstm_every=4, chunk=16),
)

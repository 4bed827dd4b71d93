"""StarCoder2-3B — GQA kv=2, RoPE. [arXiv:2402.19173; hf]"""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152, head_dim=128,
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)

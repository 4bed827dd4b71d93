"""Phi-4-mini 3.8B — dense RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064, head_dim=128,
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
)

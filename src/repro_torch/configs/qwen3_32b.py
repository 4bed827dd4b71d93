"""Qwen3-32B — dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128,
    attention=AttentionConfig(qk_norm=True, rope_theta=1_000_000.0),
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    attention=AttentionConfig(qk_norm=True),
)

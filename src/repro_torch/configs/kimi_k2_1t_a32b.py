"""Kimi K2 — trillion-parameter MoE (61L, 384 experts top-8).
[arXiv:2501.kimi2; unverified]"""
from .base import AttentionConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
    moe=MoEConfig(num_experts=384, top_k=8, capacity_factor=1.25),
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=32, vocab=256,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.5),
)

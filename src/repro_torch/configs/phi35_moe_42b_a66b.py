"""Phi-3.5-MoE — 16 experts top-2 (42B total / 6.6B active).
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import AttentionConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064,
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5),
)

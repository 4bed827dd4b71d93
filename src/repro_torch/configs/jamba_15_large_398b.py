"""Jamba-1.5-Large 398B — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from .base import AttentionConfig, MambaConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, every_n_layers=2,
                  capacity_factor=1.25),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    attention=AttentionConfig(attn_every=8),
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    moe=MoEConfig(num_experts=4, top_k=2, every_n_layers=2,
                  capacity_factor=1.5),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
    attention=AttentionConfig(attn_every=4),
)

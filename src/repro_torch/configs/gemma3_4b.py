"""Gemma-3 4B — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256,
    attention=AttentionConfig(sliding_window=1024, global_every=6,
                              rope_theta=1_000_000.0),
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    attention=AttentionConfig(sliding_window=8, global_every=2),
)

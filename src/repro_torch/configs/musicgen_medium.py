"""MusicGen-medium — decoder-only over EnCodec tokens (4 codebooks).
[arXiv:2306.05284; hf] EnCodec frontend is a STUB: input_specs()
provides token codes directly (assignment requirement)."""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, num_codebooks=4,
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=64, num_codebooks=4,
)

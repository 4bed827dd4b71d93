"""InternVL2-1B — InternViT (stub frontend) + 0.5B LM backbone.
[arXiv:2404.16821; hf] Frontend is a STUB: input_specs() provides
precomputed patch embeddings (assignment requirement)."""
from .base import AttentionConfig, ModelConfig

FULL = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151655, head_dim=64,
    num_patches=256,
    attention=AttentionConfig(),
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, num_patches=8,
)

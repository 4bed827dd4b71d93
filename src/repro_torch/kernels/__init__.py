"""Hand-written Hopper kernels, with their plain PyTorch versions."""
from . import ops, ref
from .flash_attention import flash_attention_bhsd

__all__ = ["ops", "ref", "flash_attention_bhsd"]

"""Model-layout wrapper around the attention kernel.

``[B, S, H, hd]`` <-> ``[B, H, S, hd]`` are transposed views, not
copies: the kernel reads and writes through strides and masks the
ragged sequence edge itself, so unlike the JAX package's wrapper this
one neither pads nor un-pads.
"""
from __future__ import annotations

from .flash_attention import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """Model-layout entry point: q [B, S, H, hd], k/v [B, S, Hkv, hd]."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
    return out.transpose(1, 2)

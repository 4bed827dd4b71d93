"""Model-layout wrapper around the attention kernel.

``[B, S, H, hd]`` <-> ``[B, H, S, hd]`` are transposed views, not
copies: the kernel reads and writes through strides and masks the
ragged sequence edge itself, so unlike the JAX package's wrapper this
one does not pad the sequence. A head dim that no kernel takes (kimi-k2's
112) is zero-padded to the next one that a kernel does
(``padded_head_dim``): zero columns add nothing to q . k, the scale
stays ``1/sqrt(hd)``, and the padded output columns are sliced off into
a contiguous tensor (the caller's head merge then is a view, on a
plain tensor and on a rank's local shard alike; DTensor will not view
a strided slice). The padding happens here, outside the operator, so
the memory tracer sees the padded copies as ordinary op outputs.

DTensor inputs (a sharded run) take the operator's sharding rule,
``act_sharding.local_heads``: each rank launches the kernel on its own
batch rows and query heads, with no collective; where the kv heads do
not divide the model axis and k/v are replicated, the rank slices the
kv heads its query heads group over and launches with its local group
size. The kernel sees plain local tensors, so on the card it launches
(and counts) as on one device.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from .flash_attention import flash_attention_bhsd, padded_head_dim


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """Model-layout entry point: q [B, S, H, hd], k/v [B, S, Hkv, hd]."""
    from ..distributed.act_sharding import is_dtensor, local_heads
    if is_dtensor(q):
        return local_heads(lambda q, k, v: flash_attention(
            q, k, v, causal=causal, window=window), q, k, v)
    d = q.shape[-1]
    dp = padded_head_dim(q.dtype, d)
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, scale=1.0 / math.sqrt(d))
    out = out.transpose(1, 2)
    return out if dp == d else out[..., :d].contiguous()

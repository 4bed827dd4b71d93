"""Plain PyTorch oracle for the attention kernel (per-kernel allclose
target, and the kernel's version for tensors on the CPU)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: int | None = None):
    """q: [B, H, Sq, d]; k/v: [B, Hkv, Sk, d] — dense softmax oracle.

    Query and key positions both start at 0. Rows with no attendable key
    come out as 0, like the kernel's ``acc / max(l, 1e-30)``. Nothing is
    padded in the port, so the JAX oracle's ``kv_len`` has no use here."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, G, Sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & ((q_pos - k_pos) < window)
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, d).to(q.dtype)

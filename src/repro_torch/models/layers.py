"""Shared neural-net layers (PyTorch port of ``repro.models.layers``).

Conventions, as in the JAX package:
* activations ``x``: [B, S, D]; attention heads ``q``: [B, S, H, hd];
  GQA k/v: [B, S, Hkv, hd]. Params are plain dicts of tensors.
* matmuls run in the param dtype (bf16); softmax statistics and norms
  accumulate in f32.
* long sequences (> ``dense_threshold``) use chunked online-softmax
  attention (O(S) memory instead of the O(S^2) score matrix);
  ``attention.impl == "flash"`` routes to the hand-written Hopper
  kernel (``repro_torch.kernels``), which replaces the Pallas kernel.

Everything here is forward-only: the port's first slice serves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import AttentionConfig


# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [B, S, H, hd]; positions: [S] or [B, S] absolute indices.
    Rotates in f32 and casts back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # [hd/2]
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, :, None, :]                         # [1, S, 1, hd/2]
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, :, None, :]                            # [B, S, 1, hd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
def _attend_ok(q_pos, kv_pos, *, causal, window, is_global):
    """Boolean [Sq, Sk] mask: True where a query may attend a key.

    ``is_global`` is the per-layer Python flag of gemma3-style stacks:
    global layers ignore ``window``."""
    d = q_pos[:, None] - kv_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None and not is_global:
        ok &= d < window
    return ok


def _grouped_scores(q, k):
    """q: [B, Sq, Hkv, G, hd], k: [B, Sk, Hkv, hd] -> [B, Hkv, G, Sq, Sk]
    without materializing repeated KV heads."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def dense_attention(q, k, v, *, causal=True, window=None, is_global=None):
    """Reference O(S^2) attention (short sequences / oracle)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = _grouped_scores(qg, k) * scale                 # [B,Hkv,G,Sq,Sk]
    q_pos = torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    ok = _attend_ok(q_pos, kv_pos, causal=causal, window=window,
                    is_global=is_global)
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, is_global=None,
                      chunk_q: int = 512, chunk_kv: int = 1024):
    """Online-softmax attention over KV chunks: O(S * chunk) memory.

    The JAX package's two nested scans become two Python loops carrying
    (acc, running max m, denominator l) in f32. Forward only."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk_q):
        qc = q[:, q0:q0 + chunk_q].reshape(B, -1, Hkv, G, hd)
        cq = qc.shape[1]
        q_pos = torch.arange(q0, q0 + cq, device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, G, cq), float("-inf"), device=q.device)
        l = torch.zeros((B, Hkv, G, cq), device=q.device)
        for k0 in range(0, Sk, chunk_kv):
            kc, vc = k[:, k0:k0 + chunk_kv], v[:, k0:k0 + chunk_kv]
            kv_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
            s = _grouped_scores(qc, kc) * scale           # [B,Hkv,G,cq,ckv]
            ok = _attend_ok(q_pos, kv_pos, causal=causal, window=window,
                            is_global=is_global)
            s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (exp(-inf - -inf))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + cq] = o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hd)
    return out


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window=None, is_global=None):
    """One new query token vs a cache of ``cache_len`` valid positions.
    q: [B, 1, H, hd]; caches: [B, Smax, Hkv, hd]. O(S) — no S x S."""
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, 1, Hkv, G, hd)
    s = _grouped_scores(qg, k_cache)[..., 0, :] * scale  # [B,Hkv,G,Sk]
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    ok = kv_pos < cache_len
    if window is not None and not is_global:
        ok &= kv_pos >= (cache_len - window)
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
def attention_forward(q, k, v, acfg: AttentionConfig, *, causal=True,
                      window=None, is_global=None):
    """Dispatch on sequence length / configured implementation.

    The JAX package's sharding constraints are single-device no-ops and
    are dropped. Unlike the JAX ``"pallas"`` branch, the ``"flash"``
    branch honours ``is_global``: a global layer gets no window."""
    if acfg.repeat_kv_for_tp and k.shape[2] != q.shape[2]:
        G = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    S = q.shape[1]
    impl = acfg.impl
    if impl == "flash":
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal,
                                    window=None if is_global else window)
    if impl == "dense" or (impl == "auto" and S <= acfg.dense_threshold):
        return dense_attention(q, k, v, causal=causal, window=window,
                               is_global=is_global)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             is_global=is_global, chunk_q=acfg.chunk_q,
                             chunk_kv=acfg.chunk_kv)


# ---------------------------------------------------------------------------
def normal_init(gen, shape, scale, dtype, device):
    """N(0, scale^2) drawn straight in ``dtype`` on ``device``; on the
    ``meta`` device an empty stand-in (no generator, no memory)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def attention_block_params(gen, d_model, n_heads, n_kv_heads, hd, dtype,
                           qk_norm=False, *, device, lead=()):
    """Attention weights with leading stack dims ``lead`` (``(L,)`` for
    the stacked layers the JAX package builds with ``vmap``)."""
    s = 1.0 / math.sqrt(d_model)
    lead = tuple(lead)
    p = {
        "wq": normal_init(gen, lead + (d_model, n_heads * hd), s, dtype,
                          device),
        "wk": normal_init(gen, lead + (d_model, n_kv_heads * hd), s, dtype,
                          device),
        "wv": normal_init(gen, lead + (d_model, n_kv_heads * hd), s, dtype,
                          device),
        "wo": normal_init(gen, lead + (n_heads * hd, d_model), s, dtype,
                          device),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return p


def attention_block(x, params, acfg: AttentionConfig, n_heads, n_kv_heads,
                    hd, *, positions=None, is_global=None, window=None):
    B, S, D = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, hd)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, acfg.rope_theta)
    k = apply_rope(k, positions, acfg.rope_theta)
    o = attention_forward(q, k, v, acfg, causal=True, window=window,
                          is_global=is_global)
    return o.reshape(B, S, n_heads * hd) @ params["wo"], (k, v)


def attention_decode_block(x, params, acfg: AttentionConfig, n_heads,
                           n_kv_heads, hd, k_cache, v_cache, cache_len: int,
                           *, window=None, is_global=None):
    """Decode one token; returns output + the caches.

    The new key/value are written into ``k_cache``/``v_cache`` IN PLACE
    (the JAX package's ``dynamic_update_slice`` returns new caches).
    That saves one full cache copy per step, so the port's decode
    estimate is lower than the JAX package's by design."""
    B, S, D = x.shape  # S == 1
    q = (x @ params["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, hd)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    pos = torch.full((S,), cache_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, acfg.rope_theta)
    k = apply_rope(k, pos, acfg.rope_theta)
    k_cache[:, cache_len:cache_len + S].copy_(k)
    v_cache[:, cache_len:cache_len + S].copy_(v)
    o = decode_attention(q, k_cache, v_cache, cache_len + 1, window=window,
                         is_global=is_global)
    return (o.reshape(B, S, n_heads * hd) @ params["wo"],
            k_cache, v_cache)


def mlp_params(gen, d_model, d_ff, dtype, *, device, lead=()):
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    lead = tuple(lead)
    return {
        "w_gate": normal_init(gen, lead + (d_model, d_ff), s_in, dtype,
                              device),
        "w_up": normal_init(gen, lead + (d_model, d_ff), s_in, dtype,
                            device),
        "w_down": normal_init(gen, lead + (d_ff, d_model), s_out, dtype,
                              device),
    }

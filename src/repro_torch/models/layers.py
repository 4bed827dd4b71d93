"""Shared neural-net layers (PyTorch port of ``repro.models.layers``).

Conventions, as in the JAX package:
* activations ``x``: [B, S, D]; attention heads ``q``: [B, S, H, hd];
  GQA k/v: [B, S, Hkv, hd]. Params are plain dicts of tensors.
* matmuls run in the param dtype (bf16); softmax statistics and norms
  accumulate in f32.
* long sequences (> ``dense_threshold``) use chunked online-softmax
  attention (O(S) memory instead of the O(S^2) score matrix), which
  also trains: each query chunk is checkpointed, as the JAX package's
  ``jax.checkpoint`` over its q-chunk scan;
  ``attention.impl == "flash"`` routes to the hand-written Hopper
  kernel (``repro_torch.kernels``), which replaces the Pallas kernel
  and, like it, is forward-only (serving).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import AttentionConfig
from .steps import cat_steps, step_range


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


def _attend_q_chunk(qc, k, v, q0: int, *, causal, window, is_global,
                    chunk_kv: int):
    """One query chunk ``qc`` [B, cq, Hkv, G, hd] against all KV chunks:
    the inner loop carrying (acc, running max m, denominator l) in f32.
    Returns [B, cq, H, hd] in f32."""
    B, cq, Hkv, G, hd = qc.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(q0, q0 + cq, device=qc.device)
    acc = torch.zeros((B, Hkv, G, cq, hd), dtype=torch.float32,
                      device=qc.device)
    m = torch.full((B, Hkv, G, cq), float("-inf"), device=qc.device)
    l = torch.zeros((B, Hkv, G, cq), device=qc.device)
    for j in step_range(-(-Sk // chunk_kv)):
        k0 = j * chunk_kv
        kc, vc = k[:, k0:k0 + chunk_kv], v[:, k0:k0 + chunk_kv]
        kv_pos = torch.arange(k0, k0 + kc.shape[1], device=qc.device)
        s = _grouped_scores(qc, kc) * scale               # [B,Hkv,G,cq,ckv]
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
    return o.permute(0, 3, 1, 2, 4).reshape(B, cq, Hkv * G, hd)


def chunked_attention(q, k, v, *, causal=True, window=None, is_global=None,
                      chunk_q: int = 512, chunk_kv: int = 1024):
    """Online-softmax attention over KV chunks: O(S * chunk) memory.

    The JAX package's two nested scans become two Python loops. Under
    grad mode each query chunk is checkpointed (non-reentrant), the
    counterpart of ``jax.checkpoint(q_body)``: the backward recomputes
    one chunk's scores at a time instead of keeping every chunk's. The
    chunks are joined with ``torch.cat``, so no output is written in
    place. Both loops are step loops (``models/steps.py``): a trace
    probe runs a few chunks of each (``core/loops.py``)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    n_chunks = -(-S // chunk_q)
    chunks = []
    for j in step_range(n_chunks):
        q0 = j * chunk_q
        qc = q[:, q0:q0 + chunk_q].reshape(B, -1, Hkv, G, hd)
        kw = dict(causal=causal, window=window, is_global=is_global,
                  chunk_kv=chunk_kv)
        if train:
            o = checkpoint(_attend_q_chunk, qc, k, v, q0, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            o = _attend_q_chunk(qc, k, v, q0, **kw)
        chunks.append(o.to(q.dtype))
    return chunks[0] if n_chunks == 1 else cat_steps(chunks, n_chunks, dim=1)


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

    q, k and v carry the reference's head-sharding anchors
    (``constrain``: the identity outside a bound mesh scope). Unlike
    the JAX ``"pallas"`` branch, the ``"flash"`` branch honours
    ``is_global``: a global layer gets no window."""
    from ..distributed.act_sharding import constrain
    if acfg.repeat_kv_for_tp and k.shape[2] != q.shape[2]:
        G = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "heads", None))
    v = constrain(v, ("batch", None, "heads", None))
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


def cross_entropy_loss(logits, labels, ignore_index: int = -1):
    """Mean token cross-entropy in f32; ``labels == ignore_index`` masked.

    The JAX package contracts the logits with a one-hot of the labels
    so that vocab-sharded logits need no gather. On one card the label
    term is ``torch.gather`` along the vocab of the f32 log-softmax:
    the same numbers (lse - logit[label]) without a [B, S, V] f32
    one-hot tensor. ``log_softmax`` keeps only its output for the
    backward, so the f32 copy of the logits dies in the forward. The
    f32 logits carry the reference's vocab-sharding anchor."""
    from ..distributed.act_sharding import constrain
    ldims = ("batch",) + (None,) * (logits.ndim - 2) + ("vocab",)
    logp = torch.log_softmax(constrain(logits.float(), ldims), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])
    mask = (labels != ignore_index).float()
    return -(picked[..., 0] * mask).sum() / mask.sum().clamp(min=1.0)

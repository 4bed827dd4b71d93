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

Under DTensor (a sharded dry run, ``launch/dryrun.py``) the same code
runs on DTensor parameters and inputs. Where DTensor's own rules would
fail or gather, the ops take a sharded path of their own: constants are
replicated DTensors (``act_sharding.replicated``), attention runs on
each rank's heads (``act_sharding.local_heads``), decode attends a
sequence-sharded KV cache by combining each rank's softmax statistics,
and the loss reduces vocab-sharded logits without gathering them. Plain
tensors never reach those paths.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import AttentionConfig
from ..distributed.act_sharding import (constrain, coordinate, from_local,
                                        is_dtensor, linear, local_heads,
                                        replicated, split_last)
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
    ang = replicated(ang, x)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(linear(x, w_gate)) * linear(x, w_up)
    # row-parallel: the partial sums over the model axis made whole
    return constrain(linear(h, w_down), ("batch", None, None))


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
        return local_heads(lambda q, k, v: dense_attention(
            q, k, v, causal=causal, window=window, is_global=is_global),
            q, k, v)
    return local_heads(lambda q, k, v: chunked_attention(
        q, k, v, causal=causal, window=window, is_global=is_global,
        chunk_q=acfg.chunk_q, chunk_kv=acfg.chunk_kv), q, k, v)


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
    q = split_last(linear(x, params["wq"]), (B, S, n_heads, hd))
    k = split_last(linear(x, params["wk"]), (B, S, n_kv_heads, hd))
    v = split_last(linear(x, params["wv"]), (B, S, n_kv_heads, hd))
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, acfg.rope_theta)
    k = apply_rope(k, positions, acfg.rope_theta)
    o = attention_forward(q, k, v, acfg, causal=True, window=window,
                          is_global=is_global)
    return constrain(linear(o.reshape(B, S, n_heads * hd), params["wo"]),
                     ("batch", None, None)), (k, v)


def attention_decode_block(x, params, acfg: AttentionConfig, n_heads,
                           n_kv_heads, hd, k_cache, v_cache, cache_len: int,
                           *, window=None, is_global=None):
    """Decode one token; returns output + the caches.

    The new key/value are written into ``k_cache``/``v_cache`` IN PLACE
    (the JAX package's ``dynamic_update_slice`` returns new caches).
    That saves one full cache copy per step, so the port's decode
    estimate is lower than the JAX package's by design."""
    B, S, D = x.shape  # S == 1
    q = split_last(linear(x, params["wq"]), (B, S, n_heads, hd))
    k = split_last(linear(x, params["wk"]), (B, S, n_kv_heads, hd))
    v = split_last(linear(x, params["wv"]), (B, S, n_kv_heads, hd))
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    pos = torch.full((S,), cache_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, acfg.rope_theta)
    k = apply_rope(k, pos, acfg.rope_theta)
    if is_dtensor(k_cache):
        o = _decode_sharded(q, k, v, k_cache, v_cache, cache_len,
                            window=window, is_global=is_global)
        return (constrain(linear(o.reshape(B, S, n_heads * hd),
                                 params["wo"]), ("batch", None, None)),
                k_cache, v_cache)
    k_cache[:, cache_len:cache_len + S].copy_(k)
    v_cache[:, cache_len:cache_len + S].copy_(v)
    o = decode_attention(q, k_cache, v_cache, cache_len + 1, window=window,
                         is_global=is_global)
    return (o.reshape(B, S, n_heads * hd) @ params["wo"],
            k_cache, v_cache)


def _seq_shard(cache) -> int | None:
    """The mesh dim that shards a DTensor cache [B, S, Hkv, hd] over its
    positions (dim 1), or None."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(cache.placements) if p == Shard(1)]
    if len(dims) > 1:
        raise ValueError("a KV cache sharded over positions on two mesh "
                         "dims")
    return dims[0] if dims else None


def _decode_sharded(q, k, v, k_cache, v_cache, cache_len: int, *,
                    window=None, is_global=None):
    """Decode attention on DTensors: write the new key and value into
    the rank's shard of the caches (in place), then attend.

    A cache sharded over heads runs ``decode_attention`` on each rank's
    heads (``local_heads``). A cache sharded over positions (kv heads
    that do not divide the axis) holds positions ``[r Sl, (r+1) Sl)`` on
    rank ``r``: only the rank that holds ``cache_len`` writes; each
    rank attends every query head to its own positions and keeps the
    softmax's running max, denominator and weighted sum; a max and two
    sums over the axis combine them (flash-decoding). The query heads
    are gathered over that axis first (one token's worth)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = k_cache.device_mesh
    j = _seq_shard(k_cache)
    S = k.shape[1]
    new_pl = [Replicate() if i == j else p
              for i, p in enumerate(k_cache.placements)]
    kc, vc = k_cache.to_local(), v_cache.to_local()
    Sl = kc.shape[1]
    lo = 0 if j is None else coordinate(mesh, j) * Sl
    a, b = max(cache_len, lo), min(cache_len + S, lo + Sl)
    if a < b:
        kl = k.redistribute(mesh, new_pl).to_local()
        vl = v.redistribute(mesh, new_pl).to_local()
        kc[:, a - lo:b - lo].copy_(kl[:, a - cache_len:b - cache_len])
        vc[:, a - lo:b - lo].copy_(vl[:, a - cache_len:b - cache_len])
    if j is None:
        return local_heads(lambda q, kc, vc: decode_attention(
            q, kc, vc, cache_len + 1, window=window, is_global=is_global),
            q, k_cache, v_cache)
    q_pl = [Shard(0) if p == Shard(0) else Replicate()
            for p in k_cache.placements]
    ql = q.redistribute(mesh, q_pl).to_local()
    Bl, _, H, hd = ql.shape
    Hkv = kc.shape[2]
    G = H // Hkv
    qg = ql.reshape(Bl, 1, Hkv, G, hd)
    s = _grouped_scores(qg, kc)[..., 0, :] / math.sqrt(hd)   # [B,Hkv,G,Sl]
    kv_pos = torch.arange(lo, lo + Sl, device=ql.device)
    ok = kv_pos < cache_len + 1
    if window is not None and not is_global:
        ok &= kv_pos >= (cache_len + 1 - window)
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vc.float())
    stat = [Partial(reduce_op="max") if i == j else pl
            for i, pl in enumerate(q_pl)]
    gm = from_local(m_safe, mesh, stat, (q.shape[0],) + m.shape[1:])
    gm = gm.redistribute(mesh, q_pl).to_local()
    corr = torch.exp(m_safe - gm)
    psum = [Partial() if i == j else pl for i, pl in enumerate(q_pl)]
    gl = from_local(l * corr, mesh, psum, (q.shape[0],) + l.shape[1:])
    go = from_local(o * corr[..., None], mesh, psum,
                    (q.shape[0],) + o.shape[1:])
    gl = gl.redistribute(mesh, q_pl).to_local()
    go = go.redistribute(mesh, q_pl).to_local()
    out = (go / torch.clamp(gl[..., None], min=1e-30))
    out = out.reshape(Bl, 1, H, hd).to(ql.dtype)
    return from_local(out, mesh, q_pl, q.shape)


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
    ldims = ("batch",) + (None,) * (logits.ndim - 2) + ("vocab",)
    if is_dtensor(logits):
        return _cross_entropy_sharded(constrain(logits.float(), ldims),
                                      labels, ignore_index)
    logp = torch.log_softmax(constrain(logits.float(), ldims), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])
    mask = (labels != ignore_index).float()
    return -(picked[..., 0] * mask).sum() / mask.sum().clamp(min=1.0)


def _cross_entropy_sharded(logits, labels, ignore_index: int):
    """``cross_entropy_loss`` of f32 DTensor logits sharded over the
    vocab, on each rank's shard: ``lse - logit[label]`` per token, where
    the log-sum-exp takes a max and a sum of each rank's row statistics
    over the vocab axes (no [B, S, V] gather) and each label's logit is
    picked by the rank whose vocab range holds it (a sum over the
    axes). The row statistics are the only tensors that cross ranks.
    The same number as the plain path's log-softmax and gather, and, as
    there, one [B, S, V/m] f32 tensor kept for the backward, which
    becomes the gradient in place (``_VocabParallelNLL``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    pl = [p if p in (Shard(0), Shard(vdim)) else Replicate()
          for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    vocab = [i for i, p in enumerate(pl) if p == Shard(vdim)]
    row_shape = tuple(logits.shape[:-1])

    def reduce(t, op="sum"):
        """A row statistic of this rank's shard, over the vocab axes."""
        part = [Partial(op) if i in vocab else p for i, p in enumerate(rows)]
        return from_local(t, mesh, part, row_shape).redistribute(
            mesh, rows).to_local()
    lab = labels.redistribute(mesh, rows).to_local()
    lo = 0
    for i in vocab:
        lo = lo * mesh.size(i) + coordinate(mesh, i)
    x = logits.to_local()
    nll = _VocabParallelNLL.apply(x, lab, lo * x.shape[-1], reduce)
    mask = (lab != ignore_index).float()
    total = [Partial() if p == Shard(0) else Replicate() for p in rows]
    num = from_local((nll * mask).sum(), mesh, total, ())
    den = from_local(mask.sum(), mesh, total, ())
    return num / den.clamp(min=1.0)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``lse - logit[label]`` of one rank's vocab shard ``x``
    [..., V/m] (f32), its vocab starting at ``lo``; ``reduce(t, op)``
    combines a row statistic over the vocab axes. The backward is
    ``softmax - onehot`` in the forward's ``exp`` buffer: one gradient
    tensor and no sum of two (a dispatch mode makes autograd sum out of
    place, so two paths into ``x`` would cost a third copy)."""

    @staticmethod
    def forward(ctx, x, lab, lo, reduce):
        V = x.shape[-1]
        m = reduce(x.amax(dim=-1), "max")
        e = (x - m[..., None]).exp_()
        se = reduce(e.sum(dim=-1))
        ids = lab.clamp(min=0).long()
        inside = (ids >= lo) & (ids < lo + V)
        idx = torch.where(inside, ids - lo, 0)[..., None]
        picked = reduce(torch.where(inside, torch.gather(x, -1, idx)[..., 0],
                                    0.0))
        ctx.save_for_backward(e, se, idx, inside)
        return se.log() + m - picked

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inside = ctx.saved_tensors
        grad = e.div_(se[..., None])
        grad.scatter_add_(-1, idx, -inside[..., None].to(grad.dtype))
        return grad.mul_(g[..., None]), None, None, None

"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
(PyTorch port of ``repro.models.xlstm``).

mLSTM is the chunkwise-parallel form: inside a chunk of ``ch`` steps a
masked [ch, ch] quadratic form, across chunks a [B, H, dk, dv] matrix
state, a [B, H, dk] normalizer and a [B, H] stabilizer carried with the
paper's exact exponential-gating stabilization. The sequence is padded
to whole chunks with identity steps (no input: ``i = -1e30``; no decay:
``f = +1e30``), so the carried state stays exact. Each chunk is
checkpointed when it trains, as the JAX package's
``jax.checkpoint(chunk_body)``. The heads run in the ``[B, H, S, d]``
layout, so the chunk's products are batched matmuls over ``B * H``.

sLSTM keeps its sequential scalar recurrence: an outer loop over
checkpointed chunks and an inner loop over steps. Its state runs in the
``[H, B, dh]`` layout and each chunk's pre-activations in
``[ch, B, H, 4 dh]``, so
one ``baddbmm`` against the four recurrent matrices stacked once per
block (``[H, dh, 4 dh]``) gives a step's four gates, the reference's
four einsums in one op. Every op of the step loop is paid for once per
step by the CPU trace, so the step is written in as few ops as the
reference's arithmetic allows. The sequence is padded to whole chunks with
zero pre-activations, as the reference pads it: those steps do change
the state it returns.

``log_sigmoid`` is ``-softplus(-x)``, JAX's own definition:
``F.logsigmoid`` takes an extra buffer the input's size under the
CPU's fake tensors, which the CUDA kernel does not. ``torch.cummax``
returns int64 indices beside its values, which ``lax.cummax`` does not;
the card allocates them too.

Decode: the mLSTM is one O(1) recurrent step over the persistent
(C, n, m); the sLSTM is ``slstm_block`` over one step from a state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import XLSTMConfig
from .layers import normal_init, rms_norm

_SLSTM_GATES = ("z", "i", "f", "o")


def _log_sigmoid(x):
    return -F.softplus(-x)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _training(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# mLSTM
def _mlstm_dims(d_model: int, n_heads: int, cfg: XLSTMConfig):
    dv = d_model // n_heads
    return max(int(dv * cfg.qk_dim_factor), 8), dv


def mlstm_params(gen, d_model: int, n_heads: int, cfg: XLSTMConfig, dtype,
                 *, device, lead=()) -> dict:
    dk, _ = _mlstm_dims(d_model, n_heads, cfg)
    s = 1.0 / math.sqrt(d_model)
    lead = tuple(lead)
    D, H = d_model, n_heads
    b_if = torch.zeros(lead + (2 * H,), dtype=dtype, device=device)
    b_if[..., H:] = 3.0
    return {
        "wq": normal_init(gen, lead + (D, H * dk), s, dtype, device),
        "wk": normal_init(gen, lead + (D, H * dk), s, dtype, device),
        "wv": normal_init(gen, lead + (D, D), s, dtype, device),
        "w_if": normal_init(gen, lead + (D, 2 * H), s, dtype, device),
        "b_if": b_if,
        "w_gate": normal_init(gen, lead + (D, D), s, dtype, device),
        "w_out": normal_init(gen, lead + (D, D), s, dtype, device),
        "norm": torch.ones(lead + (D,), dtype=dtype, device=device),
    }


def _mlstm_qkvif(x, p, n_heads: int):
    """q, k [B, S, H, dk], v [B, S, H, dv] and the input and forget
    pre-activations [B, S, H], all f32; q is scaled by 1/sqrt(dk).
    q, k and v are views of head-major ``[B, H, S, d]`` tensors, the
    layout ``mlstm_chunkwise`` runs in, so it copies none of them."""
    B, S, D = x.shape
    dk = p["wq"].shape[-1] // n_heads

    def heads(w, d):
        return (x @ w).reshape(B, S, n_heads, d).transpose(1, 2).to(
            torch.float32, memory_format=torch.contiguous_format, copy=True
        ).transpose(1, 2)
    q = heads(p["wq"], dk)
    k = heads(p["wk"], dk)
    v = heads(p["wv"], D // n_heads)
    q = q / math.sqrt(dk)
    gates = (x @ p["w_if"] + p["b_if"]).float()
    return q, k, v, gates[..., :n_heads], gates[..., n_heads:]


def _mlstm_chunk(C, n, m, qc, kc, vc, ic, fc, causal):
    """One chunk from the state (C, n, m), which is stored scaled by
    e^-m. qc, kc, vc: [B, H, ch, d]; ic, fc: [B, H, ch]. Returns the
    state at the chunk's end and h [B, H, ch, dv]."""
    F_ = torch.cumsum(_log_sigmoid(fc), dim=-1)        # inclusive decay
    s_j = ic - F_                                      # log input / decay
    a = torch.cummax(s_j, dim=-1).values               # running max_j<=i
    Mi = torch.maximum(a, m[..., None])                # [B, H, ch]
    # intra-chunk quadratic form; W[b,h,i,j] = exp(s_j - Mi)
    A = qc @ kc.transpose(-1, -2)                      # [B, H, ch, ch]
    W = torch.exp(s_j[..., None, :] - Mi[..., None])
    W = torch.where(causal, W, 0.0)
    AW = A * W
    y_intra = AW @ vc
    den_intra = AW.sum(-1)                             # [B, H, ch]
    # inter-chunk, from the carried state
    coef = torch.exp(m[..., None] - Mi)                # [B, H, ch]
    y_inter = (qc @ C) * coef[..., None]
    den_inter = (qc @ n[..., None])[..., 0] * coef
    den = den_intra + den_inter
    # the true stabilizer at i is F_i + Mi; num/den are at scale
    # exp(-(F_i + Mi)), so the lower bound max(|den_true|, 1) becomes
    # exp(-(F_i + Mi)) here
    h = (y_intra + y_inter) / torch.maximum(
        den.abs(), torch.exp(-(F_ + Mi)))[..., None]
    # the state at the chunk's end
    Mc = torch.maximum(m, a[..., -1])                  # [B, H]
    wj = torch.exp(s_j - Mc[..., None])                # [B, H, ch]
    decay = torch.exp(m - Mc)
    kw = kc * wj[..., None]
    C_new = C * decay[..., None, None] + kw.transpose(-1, -2) @ vc
    n_new = n * decay[..., None] + kw.sum(-2)
    return C_new, n_new, F_[..., -1] + Mc, h


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state=None, chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM cell.

    q, k: [B, S, H, dk]; v: [B, S, H, dv]; gates: [B, S, H].
    Returns h [B, S, H, dv] and the final (C, n, m) state."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    ch = min(chunk, S)
    Sp = -(-S // ch) * ch

    def heads(t, value=0.0):       # [B, S, H, ...] -> [B, H, Sp, ...]
        t = t.transpose(1, 2)
        if Sp == S:
            return t.contiguous()
        pad = (0, 0) * (t.ndim - 3) + (0, Sp - S)
        return F.pad(t, pad, value=value)

    qp, kp, vp = heads(q), heads(k), heads(v)
    # padded steps are identity: no input (i -> -inf) and no decay
    # (f -> +inf, so log_sigmoid(f) -> 0)
    ip, fp = heads(i_pre, -1e30), heads(f_pre, 1e30)
    if state is None:
        C = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    causal = torch.ones((ch, ch), dtype=torch.bool, device=q.device).tril()
    train = _training(qp, kp, vp, ip, fp, C, n, m)
    hs = []
    for c0 in range(0, Sp, ch):
        args = (C, n, m, qp[:, :, c0:c0 + ch], kp[:, :, c0:c0 + ch],
                vp[:, :, c0:c0 + ch], ip[..., c0:c0 + ch],
                fp[..., c0:c0 + ch], causal)
        C, n, m, h = _ckpt(_mlstm_chunk, *args) if train \
            else _mlstm_chunk(*args)
        hs.append(h)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=2)
    return h.transpose(1, 2)[:, :S], (C, n, m)   # a view


def mlstm_recurrent_reference(q, k, v, i_pre, f_pre):
    """Sequential per-step reference (tests; float32, no chunking)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((B, H, dk, dv), **f32)
    n = torch.zeros((B, H, dk), **f32)
    m = torch.full((B, H), -1e30, **f32)
    hs = []
    for t in range(S):
        h, (C, n, m) = _mlstm_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                   f_pre[:, t], C, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1), (C, n, m)


def _mlstm_step(q, k, v, i_t, f_t, C, n, m):
    """One recurrent step: q, k [B, H, dk], v [B, H, dv], gates [B, H].
    Returns h [B, H, dv] and the new (C, n, m)."""
    logf = _log_sigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    decay = torch.exp(logf + m - m_new)
    inp = torch.exp(i_t - m_new)
    C = C * decay[..., None, None] \
        + inp[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * decay[..., None] + inp[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = (q * n).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def mlstm_block(x, p, n_heads: int, cfg: XLSTMConfig):
    """The mLSTM residual branch: norm -> cell -> gated output."""
    B, S, D = x.shape
    xn = rms_norm(x, p["norm"])
    q, k, v, i_pre, f_pre = _mlstm_qkvif(xn, p, n_heads)
    h, _ = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=cfg.chunk)
    h = h.to(x.dtype).reshape(B, S, D)
    h = h * F.silu(xn @ p["w_gate"])
    return h @ p["w_out"]


def mlstm_decode_step(x, state, p, n_heads: int):
    """O(1) decode: one recurrent step over the persistent (C, n, m).
    x: [B, 1, D]. Returns ``(out, (C, n, m))``; ``state`` is not
    written."""
    B, _, D = x.shape
    xn = rms_norm(x, p["norm"])
    q, k, v, i_pre, f_pre = _mlstm_qkvif(xn, p, n_heads)
    h, state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                           f_pre[:, 0], *state)
    h = h.reshape(B, 1, D).to(x.dtype)
    h = h * F.silu(xn @ p["w_gate"])
    return h @ p["w_out"], state


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     cfg: XLSTMConfig, *, device="cuda"):
    dk, dv = _mlstm_dims(d_model, n_heads, cfg)
    f32 = torch.float32
    return (torch.zeros((batch, n_heads, dk, dv), dtype=f32, device=device),
            torch.zeros((batch, n_heads, dk), dtype=f32, device=device),
            torch.full((batch, n_heads), -1e30, dtype=f32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
def slstm_params(gen, d_model: int, n_heads: int, dtype, *, device,
                 lead=()) -> dict:
    dh = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    sh = 1.0 / math.sqrt(dh)
    lead = tuple(lead)
    p = {"norm": torch.ones(lead + (d_model,), dtype=dtype, device=device)}
    for g in _SLSTM_GATES:
        p[f"w_{g}"] = normal_init(gen, lead + (d_model, d_model), s, dtype,
                                  device)
        p[f"r_{g}"] = normal_init(gen, lead + (n_heads, dh, dh), sh, dtype,
                                  device)
    p["b_f"] = torch.full(lead + (d_model,), 3.0, dtype=dtype, device=device)
    p["w_out"] = normal_init(gen, lead + (d_model, d_model), s, dtype,
                             device)
    return p


def _slstm_chunk(h, c, n, m, xc, W, bias, R, pad: int):
    """Steps of one chunk. State [H, B, dh] each; ``xc`` [ch, B, D] the
    normalized inputs, ``W`` the four input weights (z, i, f, o),
    ``bias`` [H, 4, dh] f32, ``R`` [H, dh, 4 dh]; ``pad`` zero steps
    follow the inputs. Returns the state after the chunk and its
    outputs [ch + pad, H, B, dh]."""
    H, dh = R.shape[0], R.shape[1]
    # the four pre-activations in f32, [ch, B, H, 4 dh]: the forget
    # gate's bias added to its slot, as (xn @ w_f).float() + b_f
    pre = torch.stack([(xc @ w).unflatten(-1, (H, dh)) for w in W],
                      dim=3) + bias
    pre = pre.flatten(-2)
    if pad:                        # zero pre-activations, as the reference
        pre = F.pad(pre, (0, 0, 0, 0, 0, 0, 0, pad))
    hs = []
    for t in range(pre.shape[0]):
        gz, gi, gf, go = torch.baddbmm(pre[t].transpose(0, 1), h, R
                                       ).unflatten(-1, (4, -1)).unbind(-2)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        fm = m - F.softplus(-gf)                   # log_sigmoid(f) + m
        m = torch.maximum(fm, gi)
        decay = torch.exp(fm - m)
        inp = torch.exp(gi - m)
        c = torch.addcmul(inp * z, c, decay)
        n = torch.addcmul(inp, n, decay)
        h = o * c / n.clamp_min(1e-6)
        hs.append(h)
    return h, c, n, m, torch.stack(hs)


def slstm_block(x, p, n_heads: int, chunk: int = 256, state=None):
    """Sequential sLSTM: checkpointed chunks of steps. x: [B, S, D];
    ``state`` (h, c, n, m), each [B, D] f32 (default: h = c = 0,
    n = 1e-6, m = -1e30). Returns ``(out [B, S, D], state)``.

    Each chunk projects its own inputs to the pre-activations, so no
    f32 ``[S, B, 4 D]`` tensor is held for the whole sequence (and a
    training backward recomputes a chunk's with its steps)."""
    B, S, D = x.shape
    H, dh = n_heads, D // n_heads
    xn = rms_norm(x, p["norm"]).transpose(0, 1).contiguous()     # [S, B, D]
    W = [p[f"w_{g}"] for g in _SLSTM_GATES]
    bias = F.pad(p["b_f"].float().reshape(H, 1, dh), (0, 0, 2, 1))
    R = torch.stack([p[f"r_{g}"] for g in _SLSTM_GATES], dim=2).float()
    R = R.flatten(-2)                              # [H, dh, 4 dh]
    if state is None:
        zeros = torch.zeros((H, B, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros + 1e-6, zeros - 1e30)
    else:
        carry = tuple(t.reshape(B, H, dh).transpose(0, 1).contiguous()
                      for t in state)
    ch = min(chunk, S)
    train = _training(xn, bias, R, *W, *carry)
    hs = []
    for c0 in range(0, S, ch):
        xc = xn[c0:c0 + ch]
        args = (*carry, xc, W, bias, R, ch - xc.shape[0])
        *carry, h = _ckpt(_slstm_chunk, *args) if train \
            else _slstm_chunk(*args)
        hs.append(h)
    h = hs[0] if len(hs) == 1 else torch.cat(hs)   # [Sp, H, B, dh]
    h = h[:S].permute(2, 0, 1, 3).to(x.dtype).reshape(B, S, D)
    state = tuple(t.transpose(0, 1).reshape(B, D) for t in carry)
    return h @ p["w_out"], state


def slstm_init_state(batch: int, d_model: int, *, device="cuda"):
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return (z, z, z + 1e-6, z - 1e30)

"""Mamba (S6 selective SSM) block (PyTorch port of
``repro.models.mamba``).

The JAX package's chunked scan becomes two Python loops: an outer loop
over chunks of ``cfg.chunk`` steps, each chunk checkpointed when it
trains (the counterpart of ``jax.checkpoint(chunk_body)``, so the
backward keeps only each chunk's inputs), and an inner loop over steps
carrying the ``[B, d_inner, d_state]`` SSM state in f32. The JAX package
pads the sequence to whole chunks; the padded steps only follow the
last real one and their outputs are sliced away, so here the last chunk
is simply shorter.

Dtypes follow the reference: the causal conv runs in f32 and is cast
back to ``x.dtype``; ``Bm``, ``Cm`` and ``dt`` are f32; ``A_log`` and
``D`` are f32 parameters in a tree of ``dtype``. The depthwise causal
conv is ``d_conv`` shifted multiply-adds in f32, as the decode step
computes it (a grouped ``conv1d`` would go to cuDNN on the card, whose
workspace no trace sees). The decode step keeps its conv window and
``xa`` in f32 and casts ``xa`` only for ``x_proj``, as the reference
does (prefill casts ``xa`` back to ``x.dtype`` after the conv).

Decode is the O(1) one-token recurrence over a persistent state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import MambaConfig
from .layers import normal_init
from .steps import cat_steps, stack_steps, step_range


def mamba_params(gen, d_model: int, cfg: MambaConfig, dtype, *, device,
                 lead=()) -> dict:
    """Weights with leading stack dims ``lead``; ``A_log`` (``log 1..N``
    on every channel) and ``D`` (ones) in f32."""
    d_inner = cfg.expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    s = 1.0 / math.sqrt(d_model)
    si = 1.0 / math.sqrt(d_inner)
    lead = tuple(lead)
    f32 = torch.float32
    a_log = torch.log(torch.arange(1, cfg.d_state + 1, dtype=f32,
                                   device=device))
    return {
        "in_proj": normal_init(gen, lead + (d_model, 2 * d_inner), s, dtype,
                               device),
        "conv_w": normal_init(gen, lead + (cfg.d_conv, d_inner), 0.1, dtype,
                              device),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "x_proj": normal_init(gen, lead + (d_inner, dt_rank + 2 * cfg.d_state),
                              si, dtype, device),
        "dt_proj": normal_init(gen, lead + (dt_rank, d_inner),
                               dt_rank ** -0.5, dtype, device),
        "dt_bias": torch.full(lead + (d_inner,), -4.6, dtype=dtype,
                              device=device),          # softplus ~ 0.01
        "A_log": a_log.expand(lead + (d_inner, cfg.d_state)).clone(),
        "D": torch.ones(lead + (d_inner,), dtype=f32, device=device),
        "out_proj": normal_init(gen, lead + (d_inner, d_model), si, dtype,
                                device),
    }


def _causal_conv1d(x, w, b):
    """x: [B, S, C]; depthwise causal conv with kernel ``w`` [K, C] and
    bias ``b`` [C], in f32, cast back to ``x.dtype``."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)).float()
    wf = w.float()
    out = xp[:, :S] * wf[0]
    for k in range(1, K):
        out.addcmul_(xp[:, k:k + S], wf[k])
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(x, p, cfg: MambaConfig):
    """Shared preamble of the scan: returns (xa, z, dt, A, Bm, Cm)."""
    dt_rank = p["dt_proj"].shape[0]
    N = cfg.d_state
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xa = F.silu(_causal_conv1d(x_in, p["conv_w"], p["conv_b"]))
    proj = xa @ p["x_proj"]
    Bm = proj[..., dt_rank:dt_rank + N].float()
    Cm = proj[..., dt_rank + N:].float()
    dt = F.softplus((proj[..., :dt_rank] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])                   # [d_inner, N]
    return xa, z, dt, A, Bm, Cm


def _scan_chunk(h, A, xc, dtc, Bc, Cc):
    """One chunk of the selective scan from state ``h`` [B, d_inner, N]:
    returns the state after it and the outputs [B, ch, d_inner]."""
    dtc = dtc[..., None]                         # [B, ch, d_inner, 1]
    Bc = Bc[:, :, None, :]                       # [B, ch, 1, N]
    Cc = Cc[:, :, None, :]
    xc = xc.float()[..., None]                   # [B, ch, d_inner, 1]
    T = dtc.shape[1]
    ys = []
    for t in step_range(T):
        dtt = dtc[:, t]
        h = torch.exp(dtt * A) * h + dtt * Bc[:, t] * xc[:, t]
        ys.append((h * Cc[:, t]).sum(-1))
    return h, stack_steps(ys, T, dim=1)


def mamba_block(x, p, cfg: MambaConfig):
    """Training/prefill forward. x: [B, S, D] -> ([B, S, D], None)."""
    B = x.shape[0]
    xa, z, dt, A, Bm, Cm = _ssm_inputs(x, p, cfg)
    d_inner = xa.shape[-1]
    S = xa.shape[1]
    ch = min(cfg.chunk, S)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (A, xa, dt, Bm, Cm))
    h = torch.zeros((B, d_inner, cfg.d_state), dtype=torch.float32,
                    device=x.device)
    n_chunks = -(-S // ch)
    ys = []
    for j in step_range(n_chunks):
        c = slice(j * ch, (j + 1) * ch)
        args = (h, A, xa[:, c], dt[:, c], Bm[:, c], Cm[:, c])
        if train:
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _scan_chunk(*args)
        ys.append(y)
    y = ys[0] if n_chunks == 1 else cat_steps(ys, n_chunks, dim=1)
    y = y + p["D"] * xa.float()
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"], None


def mamba_init_state(batch: int, d_model: int, cfg: MambaConfig, *,
                     device="cuda") -> dict:
    d_inner = cfg.expand * d_model
    f32 = torch.float32
    return {"h": torch.zeros((batch, d_inner, cfg.d_state), dtype=f32,
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=f32,
                                device=device)}


def mamba_decode_step(x, state, p, cfg: MambaConfig):
    """One-token recurrence. x: [B, 1, D]; O(1) in context length.
    Returns ``(out [B, 1, D], new_state)``; ``state`` is not written."""
    dt_rank = p["dt_proj"].shape[0]
    N = cfg.d_state
    x_in, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    # rolling conv window
    win = torch.cat([state["conv"], x_in[:, None, :].float()], dim=1)
    xc = (win * p["conv_w"].float()[None]).sum(1) + p["conv_b"].float()
    xa = F.silu(xc)
    proj = xa.to(x.dtype) @ p["x_proj"]
    dt = F.softplus((proj[..., :dt_rank] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())
    Bm = proj[..., dt_rank:dt_rank + N].float()
    Cm = proj[..., dt_rank + N:].float()
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    h = dA * state["h"] + dt[..., None] * Bm[:, None, :] * xa[..., None]
    y = (h * Cm[:, None, :]).sum(-1) + p["D"] * xa
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out[:, None, :], {"h": h, "conv": win[:, 1:]}

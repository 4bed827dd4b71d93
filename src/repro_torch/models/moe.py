"""Mixture-of-Experts FFN with capacity-based dispatch (PyTorch port of
``repro.models.moe``).

The same static-shape routing as the JAX package: tokens split into
``num_groups`` dispatch groups; in each group the top-k assignments are
sorted by expert id (a stable sort), a token's rank inside its expert
comes from a ``searchsorted`` over the sorted ids, and each expert takes
a fixed ``capacity`` of tokens ``[E, C, D]``. Assignments over capacity
go to a dummy row ``E`` (slot 0) that is sliced away, so they are
dropped, and the combine scatters the weighted expert outputs back.

What each JAX op becomes, and the CUDA op the tracer sees:

* ``jnp.argsort`` (stable) -> ``torch.sort(stable=True)``; torch's
  default sort is not stable, and an unstable sort changes which tokens
  an over-full expert drops;
* ``lax.top_k`` -> ``torch.topk(sorted=True)``;
* the ``.at[ge, gp].set`` maps -> ``index_put_`` (no accumulation) into
  ``[E + 1, C]`` maps; only the dummy row ever takes duplicate indices;
* the gathers ``x_pad[gmap]`` and ``flat_w[order]`` -> ``index_select``,
  whose backward is an ``index_add_`` (atomic adds); an indexing
  ``x[idx]`` would take ``index_put_(accumulate=True)`` as its backward,
  which sorts the indices on the card in buffers of its own;
* the combine's f32 scatter-add -> ``index_add_`` into a fresh zeros
  ``[Tg + 1, D]`` f32 tensor.

The maps are int64 where the JAX package's are int32: torch indexes with
int64, and an int32 index would be converted on the card inside the op.
So the map bytes differ from the JAX package's by design. The expert
products are ``torch.bmm`` on contiguous ``[E, C, D]`` / ``[E, D, F]``
operands, so no permuted copy of the tokens or the weights is made.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from .layers import normal_init


def moe_params(gen, d_model: int, d_ff: int, n_experts: int, dtype, *,
               device, lead=()) -> dict:
    """Router ``[D, E]`` in f32 and experts ``[E, D, F]`` / ``[E, F, D]``
    in ``dtype``, with leading stack dims ``lead``."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    lead = tuple(lead)
    return {
        "router": normal_init(gen, lead + (d_model, n_experts), s_in,
                              torch.float32, device),
        "we_gate": normal_init(gen, lead + (n_experts, d_model, d_ff), s_in,
                               dtype, device),
        "we_up": normal_init(gen, lead + (n_experts, d_model, d_ff), s_in,
                             dtype, device),
        "we_down": normal_init(gen, lead + (n_experts, d_ff, d_model), s_out,
                               dtype, device),
    }


def expert_capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.top_k * tokens_per_group * cfg.capacity_factor
                  / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8 for tiling


def _dispatch_one_group(xg, topi, topv, n_experts: int, capacity: int,
                        lo: int, n: int):
    """xg: [Tg, D]; topi/topv: [Tg, k] -> (xe [n, C, D], gmap [n, C],
    wmap [n, C] f32) for experts ``lo .. lo + n`` of the
    ``n_experts``. ``gmap`` holds token ids, ``Tg`` for an empty slot
    (the zero row appended to ``xg``). The maps are laid out for all
    experts and the dummy row, so an over-full expert drops the same
    tokens whichever experts are taken; only the taken experts' rows
    are gathered."""
    Tg, k = topi.shape
    flat_e = topi.reshape(-1)                      # [Tg*k]
    flat_w = topv.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    arange_e = torch.arange(n_experts, device=xg.device)
    first = torch.searchsorted(sorted_e, arange_e)
    pos = torch.arange(Tg * k, device=xg.device) - first[sorted_e]
    valid = pos < capacity
    ge = torch.where(valid, sorted_e, n_experts)   # overflow -> dummy row
    gp = torch.where(valid, pos, 0)
    tok = torch.div(order, k, rounding_mode="floor")
    gmap = torch.full((n_experts + 1, capacity), Tg, dtype=torch.int64,
                      device=xg.device)
    gmap[ge, gp] = tok
    wmap = torch.zeros((n_experts + 1, capacity), dtype=torch.float32,
                       device=xg.device)
    wmap[ge, gp] = torch.index_select(flat_w, 0, order)
    gmap, wmap = gmap[lo:lo + n], wmap[lo:lo + n]
    x_pad = torch.cat([xg, xg.new_zeros((1, xg.shape[1]))], 0)
    xe = torch.index_select(x_pad, 0, gmap.reshape(-1))
    return xe.reshape(n, capacity, -1), gmap, wmap


def _route(x, router, cfg: MoEConfig, groups: int | None = None):
    """x: [B, S, D] -> (xf [G, Tg, D], topi, topv [G, Tg, k]) for G
    ``groups`` (default ``cfg.num_groups``): f32 router logits,
    softmax, top-k and the renormalized gate weights."""
    B, S, D = x.shape
    G = cfg.num_groups if groups is None else groups
    if B * S % G:
        raise ValueError(f"tokens {B * S} not divisible by groups {G}")
    xf = x.reshape(G, B * S // G, D)
    logits = xf.float() @ router.float()           # [G, Tg, E] f32
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return xf, topi, topv


def moe_experts(x, params, cfg: MoEConfig, groups: int, lo: int):
    """The plain MoE body on (local) tensors: x [B, S, D] in ``groups``
    dispatch groups, routed over all ``cfg.num_experts`` experts, of
    which ``params``' expert stacks hold ``n`` from expert ``lo`` on
    (all of them on one device). Returns the f32 combine [B, S, D]: the
    whole output, or on a rank of an expert-parallel mesh its experts'
    share of it. Groups run one after another (the launcher's G is 1 on
    one card). One group takes reshaped views, whose backward is a view
    too; ``G > 1`` groups are unbound, whose backward stacks the
    groups' gradients."""
    B, S, D = x.shape
    xf, topi, topv = _route(x, params["router"], cfg, groups)
    G, Tg = xf.shape[:2]
    C = expert_capacity(Tg, cfg)
    n = params["we_gate"].shape[0]
    parts = (zip(xf.unbind(0), topi.unbind(0), topv.unbind(0)) if G > 1
             else [(xf.reshape(Tg, D), topi.reshape(Tg, -1),
                    topv.reshape(Tg, -1))])
    ys = []
    for xg, ti, tv in parts:
        xe, gmap, wmap = _dispatch_one_group(xg, ti, tv, cfg.num_experts, C,
                                             lo, n)
        # expert SwiGLU: FLOPs = n*C*D*F*3*2 per group, top_k-scaled
        h = F.silu(torch.bmm(xe, params["we_gate"])) \
            * torch.bmm(xe, params["we_up"])
        out = torch.bmm(h, params["we_down"])       # [n, C, D]
        del xe, h
        # combine: scatter-add the weighted expert outputs, in f32
        y = torch.zeros((Tg + 1, D), dtype=torch.float32, device=x.device)
        y.index_add_(0, gmap.reshape(-1),
                     (out * wmap[..., None]).reshape(-1, D).float())
        ys.append(y[:Tg])
    y = ys[0] if G == 1 else torch.cat(ys, 0)
    return y.reshape(B, S, D)


def moe_ffn(x, params, cfg: MoEConfig):
    """x: [B, S, D] -> [B, S, D]: :func:`moe_experts` cast to ``x``'s
    dtype. DTensor inputs (a sharded run) go through
    ``act_sharding.local_experts``: each rank dispatches its own groups'
    tokens to its own experts, and one f32 all-reduce over the expert
    axis completes the combine."""
    from ..distributed.act_sharding import local_experts
    return local_experts(
        lambda x, p, groups, lo: moe_experts(x, p, cfg, groups, lo),
        x, params, cfg.num_groups)


def aux_load_balance_loss(x, params, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * probability)."""
    D = x.shape[-1]
    logits = x.reshape(-1, D).float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, cfg.num_experts).float().mean(dim=0)
    prob = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac * prob)

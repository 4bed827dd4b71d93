"""Unified decoder LM over all families (PyTorch port of
``repro.models.model``).

Parameters are a plain dict with the JAX pytree's key paths and the
per-layer weights stacked ``[L, ...]`` (per period, for the hybrid and
SSM families), so a JAX parameter tree converts name for name
(``convert.py``) and parameter bytes match byte for byte. The JAX
package's ``lax.scan`` over the stack is a Python loop over layer views
here, each layer (each dense/MoE pair, each period) checkpointed per
``cfg.remat`` when it trains. Training: ``loss_fn``; its gradients keep
the stacked shapes (``_LayerSlice``). Serving: ``init_cache`` +
``decode_step`` decode one token against a state that is updated in
place.

Families and their stacks, as in the reference:

* dense (gemma3's local:global flags included), MoE (every layer, or
  dense/MoE pairs when ``every_n_layers`` is 2), VLM and audio: stacked
  decoder layers and a KV cache. The VLM and audio frontends are stubs:
  precomputed patch embeddings come before the text, and EnCodec codes
  (``K`` codebooks) are embedded as the sum of each codebook's gather,
  with ``K`` output heads;
* hybrid (jamba): periods of ``attn_every`` layers, ``pos0`` an
  attention layer and ``pos1..`` Mamba layers (``mamba.py``), each with
  the dense or MoE FFN its position gives; a KV cache for ``pos0`` and
  Mamba (h, conv) state for the rest;
* ssm (xLSTM): periods of ``slstm_every`` blocks, ``slstm_every - 1``
  mLSTM blocks stacked ``[n_periods, n_m, ...]`` and one sLSTM
  (``xlstm.py``); each mLSTM block is checkpointed inside its period;
  the decode state is mLSTM (C, n, m) and sLSTM (h, c, n, m).
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..distributed.act_sharding import gathered
from . import mamba as mam
from . import moe as moe_mod
from . import xlstm as xl
from .layers import (attention_block, attention_block_params,
                     attention_decode_block, cross_entropy_loss, mlp_params,
                     normal_init, rms_norm, swiglu)


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    return (cfg.moe is not None
            and i % cfg.moe.every_n_layers == cfg.moe.every_n_layers - 1)


def _alternating(cfg: ModelConfig) -> bool:
    """MoE layers alternate with dense ones: the layers are stacked as
    ``"dense"`` and ``"moe"`` halves of ``n_layers // 2`` pairs."""
    return cfg.moe is not None and cfg.moe.every_n_layers > 1


# ---------------------------------------------------------------------------
# parameter init
def _layer_params(cfg: ModelConfig, gen, device, n: int,
                  moe_layer: bool) -> dict:
    """``n`` stacked layers' weights: a MoE layer has ``"moe"`` (f32
    router) and no ``"mlp"``."""
    dt, D = cfg.dtype, cfg.d_model
    p = {
        "ln1": torch.ones((n, D), dtype=dt, device=device),
        "ln2": torch.ones((n, D), dtype=dt, device=device),
        "attn": attention_block_params(
            gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
            qk_norm=cfg.attention.qk_norm, device=device, lead=(n,)),
    }
    if moe_layer:
        p["moe"] = moe_mod.moe_params(gen, D, cfg.d_ff, cfg.moe.num_experts,
                                      dt, device=device, lead=(n,))
    elif cfg.d_ff:
        p["mlp"] = mlp_params(gen, D, cfg.d_ff, dt, device=device,
                              lead=(n,))
    return p


def _mamba_layer_params(cfg: ModelConfig, gen, device, n: int,
                        moe_layer: bool) -> dict:
    """``n`` stacked Mamba layers' weights, with the layer's FFN."""
    dt, D = cfg.dtype, cfg.d_model
    p = {
        "ln1": torch.ones((n, D), dtype=dt, device=device),
        "ln2": torch.ones((n, D), dtype=dt, device=device),
        "mamba": mam.mamba_params(gen, D, cfg.mamba, dt, device=device,
                                  lead=(n,)),
    }
    if moe_layer:
        p["moe"] = moe_mod.moe_params(gen, D, cfg.d_ff, cfg.moe.num_experts,
                                      dt, device=device, lead=(n,))
    elif cfg.d_ff:
        p["mlp"] = mlp_params(gen, D, cfg.d_ff, dt, device=device, lead=(n,))
    return p


def _periods(cfg: ModelConfig) -> tuple[int, int]:
    """(periods, layers in a period) of the hybrid and SSM stacks."""
    period = (cfg.xlstm.slstm_every if cfg.family == "ssm"
              else cfg.attention.attn_every)
    return cfg.n_layers // period, period


def repeat_unit(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(units, layers in a unit, remainder layers)`` of the stack: the
    repeating unit every loop over the layers steps by, and the one
    definition ``core/depth.py`` composes traces by. A plain dense
    stack repeats one layer; gemma3 ``global_every`` layers (the local
    ones and their global one), with the remainder a suffix of local
    layers (gemma3-4b: 34 = 5 x 6 + 4); alternating MoE one dense+MoE
    pair; hybrid and SSM one period. Those three stack whole units
    only, so their remainder layers have no weights and never run."""
    if cfg.family in ("ssm", "hybrid"):
        unit = _periods(cfg)[1]
    elif _alternating(cfg):
        unit = cfg.moe.every_n_layers
    else:
        unit = cfg.attention.global_every or 1
    return cfg.n_layers // unit, unit, cfg.n_layers % unit


#: the depth probes' unit marks (``core/depth.py``): while a probe
#: traces in a thread, ``UNIT_MARKS.fn`` is a callable that thread runs
#: before each repeating unit of a stack and once after its last unit
UNIT_MARKS = threading.local()


def _mark() -> None:
    fn = getattr(UNIT_MARKS, "fn", None)
    if fn is not None:
        fn()


def _build_params(cfg: ModelConfig, gen, device) -> dict:
    dt, D, V, L = cfg.dtype, cfg.d_model, cfg.padded_vocab, cfg.n_layers

    params: dict = {"final_norm": torch.ones((D,), dtype=dt, device=device)}
    K = cfg.num_codebooks
    if K:
        params["embed"] = normal_init(gen, (K, V, D), 0.02, dt, device)
        params["head"] = normal_init(gen, (D, K * V), 0.02, dt, device)
    else:
        params["embed"] = normal_init(gen, (V, D), 0.02, dt, device)
        if not cfg.tie_embeddings:
            params["head"] = normal_init(gen, (D, V), 0.02, dt, device)
    if cfg.family == "ssm":
        n_periods, period = _periods(cfg)
        params["layers"] = {
            "mlstm": xl.mlstm_params(gen, D, cfg.n_heads, cfg.xlstm, dt,
                                     device=device,
                                     lead=(n_periods, period - 1)),
            "slstm": xl.slstm_params(gen, D, cfg.n_heads, dt, device=device,
                                     lead=(n_periods,))}
    elif cfg.family == "hybrid":
        n_periods, period = _periods(cfg)
        params["layers"] = {
            f"pos{pos}": (_layer_params if pos == 0 else _mamba_layer_params)(
                cfg, gen, device, n_periods, _is_moe_layer(cfg, pos))
            for pos in range(period)}
    elif _alternating(cfg):
        n_pairs = L // cfg.moe.every_n_layers
        params["layers"] = {
            "dense": _layer_params(cfg, gen, device, n_pairs, False),
            "moe": _layer_params(cfg, gen, device, n_pairs, True)}
    else:
        params["layers"] = _layer_params(cfg, gen, device, L,
                                         cfg.moe is not None)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """Random weights drawn in ``cfg.dtype`` straight on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (no f32 temporaries). The
    numbers differ from the JAX package's ``init_params``; tests convert
    JAX weights with ``convert.params_from_numpy`` instead."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return _build_params(cfg, gen, device)


def abstract_params(cfg: ModelConfig) -> dict:
    """Parameter stand-ins on the ``meta`` device (no allocation)."""
    return _build_params(cfg, None, "meta")


# ---------------------------------------------------------------------------
# forward
def _global_flags(cfg: ModelConfig) -> list[bool] | None:
    ge = cfg.attention.global_every
    if ge is None:
        return None
    return [(i % ge) == ge - 1 for i in range(cfg.n_layers)]


class _LayerSlice(torch.autograd.Function):
    """Layer ``i``'s view of a stacked ``[L, ...]`` leaf whose backward
    writes the layer's gradient into one stacked gradient, the leaf's
    ``.grad`` (zeros at the first write), and hands autograd nothing.
    ``i`` is an int, or an index tuple such as ``(p, j)`` into a leaf
    stacked two levels deep (``[n_periods, n_m, ...]``): one slice of
    the leaf, never a slice of a slice, whose backward would write the
    ``.grad`` of a non-leaf.

    A plain ``leaf[i]`` under autograd gives each layer a
    ``select_backward``: a zero-filled gradient the size of the whole
    stack, L times a leaf, summed by the engine. The JAX package's
    ``lax.scan`` transpose writes each slice into one stacked buffer
    instead; this does the same, so the port's stacked gradients have
    the JAX shapes and bytes and no L-fold temporaries."""

    @staticmethod
    def forward(ctx, leaf, i):
        ctx.leaf, ctx.i = leaf, i
        return leaf[i]

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        leaf.grad[ctx.i].add_(g)
        return None, None


def layer_params(layers: dict, i) -> dict:
    """Layer ``i``'s weights (``i`` an int or an index tuple): views
    into the stacked tree (through ``_LayerSlice`` for leaves that take
    a gradient)."""
    def take(v):
        if isinstance(v, dict):
            return layer_params(v, i)
        if v.requires_grad and torch.is_grad_enabled():
            return _LayerSlice.apply(v, i)
        return v[i]
    return {k: take(v) for k, v in layers.items()}


def _decoder_layer(x, lp, cfg: ModelConfig, *, is_global=None,
                   positions=None):
    lp = gathered(lp)
    window = cfg.attention.sliding_window
    h, _ = attention_block(
        rms_norm(x, lp["ln1"]), lp["attn"], cfg.attention, cfg.n_heads,
        cfg.n_kv_heads, cfg.hd, positions=positions, is_global=is_global,
        window=window)
    return _ffn(x + h, lp, cfg.moe)


def _mamba_layer(x, lp, cfg: ModelConfig):
    h, _ = mam.mamba_block(rms_norm(x, lp["ln1"]), lp["mamba"], cfg.mamba)
    return _ffn(x + h, lp, cfg.moe)


def _ffn(x, lp, moe_cfg):
    """The layer's residual FFN: MoE, SwiGLU, or none."""
    if "moe" in lp:
        return x + moe_mod.moe_ffn(rms_norm(x, lp["ln2"]), lp["moe"],
                                   moe_cfg)
    if "mlp" in lp:
        return x + swiglu(rms_norm(x, lp["ln2"]), **lp["mlp"])
    return x


_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmul outputs, recompute the rest
    (the counterpart of ``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed per ``cfg.remat`` when it will be
    differentiated (``"full"``: recompute everything in the backward;
    ``"dots"``: recompute all but the matmuls; ``"none"``: keep all)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, fn, **kw)


def backbone(params, x, cfg: ModelConfig, positions=None):
    """x: [B, S, D] embedded inputs -> final hidden states."""
    layers = params["layers"]
    if cfg.family == "ssm":
        n_periods, period = _periods(cfg)
        xcfg = cfg.xlstm

        def m_body(h, mp):
            return h + xl.mlstm_block(h, mp, cfg.n_heads, xcfg)
        m_layer = _remat(m_body, cfg)

        def period_body(h, mlstm_lps, slstm_lp):
            for mp in mlstm_lps:
                h = m_layer(h, mp)
            s_out, _ = xl.slstm_block(h, slstm_lp, cfg.n_heads,
                                      chunk=xcfg.chunk)
            return h + s_out
        body = _remat(period_body, cfg)
        for p in range(n_periods):
            _mark()
            x = body(x, [layer_params(layers["mlstm"], (p, j))
                         for j in range(period - 1)],
                     layer_params(layers["slstm"], p))
        _mark()
        return rms_norm(x, params["final_norm"])
    if cfg.family == "hybrid":
        n_periods, period = _periods(cfg)

        def period_body(h, lps):
            h = _decoder_layer(h, lps[0], cfg, positions=positions)
            for lp in lps[1:]:
                h = _mamba_layer(h, lp, cfg)
            return h
        body = _remat(period_body, cfg)
        for p in range(n_periods):
            _mark()
            x = body(x, [layer_params(layers[f"pos{pos}"], p)
                         for pos in range(period)])
        _mark()
        return rms_norm(x, params["final_norm"])
    if _alternating(cfg):
        def pair(h, dense_lp, moe_lp):
            h = _decoder_layer(h, dense_lp, cfg, positions=positions)
            return _decoder_layer(h, moe_lp, cfg, positions=positions)
        body = _remat(pair, cfg)
        for p in range(cfg.n_layers // cfg.moe.every_n_layers):
            _mark()
            x = body(x, layer_params(layers["dense"], p),
                     layer_params(layers["moe"], p))
        _mark()
        return rms_norm(x, params["final_norm"])
    flags = _global_flags(cfg)
    layer = _remat(_decoder_layer, cfg)
    # a mark before each unit; with a remainder, the one before its
    # first layer ends the units
    _, unit, rem = repeat_unit(cfg)
    for i in range(cfg.n_layers):
        if i % unit == 0:
            _mark()
        x = layer(x, layer_params(layers, i), cfg,
                  is_global=None if flags is None else flags[i],
                  positions=positions)
    if not rem:
        _mark()
    return rms_norm(x, params["final_norm"])


def _gather_rows(table, ids):
    """``table[ids]`` as an ``index_select``: its backward is an
    ``index_add_`` into one zeroed gradient, which sorts nothing on the
    card (``F.embedding``'s CUDA backward sorts the ids in buffers of
    its own, which the tracer does not model)."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[-1])


def embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Family-specific input embedding; the modality frontends are stubs.
    VLM: the patch embeddings (cast to ``cfg.dtype``) come before the
    text's. Audio: the sum over the ``K`` codebooks of each codebook's
    embedding of its codes ``[B, S, K]`` (the delay pattern is applied
    upstream)."""
    if cfg.family == "vlm":
        text = _gather_rows(params["embed"], batch["tokens"])
        return torch.cat([batch["patch_embeds"].to(cfg.dtype), text], dim=1)
    if cfg.family == "audio":
        return _embed_codes(params["embed"], batch["codes"])
    from ..distributed.act_sharding import embedding, is_dtensor
    if is_dtensor(params["embed"]):
        return embedding(batch["tokens"], params["embed"])
    return F.embedding(batch["tokens"], params["embed"])


def _embed_codes(embed, codes):
    """codes [B, S, K] -> the sum of ``embed[k][codes[..., k]]`` over k,
    gathered from the ``[K * V, D]`` view of the table."""
    K, V, D = embed.shape
    flat = embed.reshape(K * V, D)
    x = None
    for k in range(K):
        e = _gather_rows(flat, codes[..., k] + k * V)
        x = e if x is None else x + e
    return x


def logits_fn(params, h, cfg: ModelConfig):
    """h [B, S, D] -> logits [B, S, V], or [B, S, K, V] for audio; the
    [B, S, V] product carries the reference's vocab-sharding anchor."""
    from ..distributed.act_sharding import constrain, linear
    K = cfg.num_codebooks
    params = {k: gathered(params[k]) for k in ("embed", "head")
              if k in params}
    if cfg.tie_embeddings:
        if K:
            return torch.einsum("bsd,kvd->bskv", h, params["embed"])
        return constrain(linear(h, params["embed"].T),
                         ("batch", None, "vocab"))
    out = constrain(linear(h, params["head"]), ("batch", None, "vocab"))
    if K:
        return out.reshape(*h.shape[:2], K, cfg.padded_vocab)
    return out


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Mean next-token cross-entropy of ``batch`` (tokens or codes, and
    labels); a VLM's loss covers its text positions only."""
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    h = backbone(params, x, cfg, positions=positions)
    if cfg.family == "vlm":
        h = h[:, batch["patch_embeds"].shape[1]:]
    return cross_entropy_loss(logits_fn(params, h, cfg), batch["labels"])


# ---------------------------------------------------------------------------
# serving: cache init + one-token decode
#: the value each decode-state leaf starts from (the rest: zeros). The
#: sLSTM state starts all zeros, as the reference's ``init_cache`` has it,
#: not at ``slstm_init_state``'s n = 1e-6, m = -1e30.
_CACHE_FILL = {"mlstm_m": -1e30}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Persistent decode state, by family, with the reference's keys,
    shapes and dtypes: stacked KV caches ``[L, B, max_len, Hkv, hd]`` in
    ``cfg.dtype`` (alternating dense/MoE layers included: layer ``2p``
    is pair ``p``'s dense layer, ``2p + 1`` its MoE layer); hybrid: KV
    ``[n_periods, ...]`` for ``pos0`` and f32 Mamba (h, conv) state
    ``[n_periods, period - 1, B, ...]``; ssm: f32 mLSTM (C, n, m)
    ``[n_periods, n_m, B, H, ...]`` and sLSTM (h, c, n, m) stacked
    ``[n_periods, 4, B, D]``."""
    f32 = torch.float32
    kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.family == "ssm":
        n_periods, period = _periods(cfg)
        dk, dv = xl._mlstm_dims(cfg.d_model, cfg.n_heads, cfg.xlstm)
        lead = (n_periods, period - 1, batch, cfg.n_heads)
        shapes = {"mlstm_C": (lead + (dk, dv), f32),
                  "mlstm_n": (lead + (dk,), f32),
                  "mlstm_m": (lead, f32),
                  "slstm": ((n_periods, 4, batch, cfg.d_model), f32)}
    elif cfg.family == "hybrid":
        n_periods, period = _periods(cfg)
        m = cfg.mamba
        d_inner = m.expand * cfg.d_model
        lead = (n_periods, period - 1, batch)
        shapes = {"k": ((n_periods,) + kv, cfg.dtype),
                  "v": ((n_periods,) + kv, cfg.dtype),
                  "mamba_h": (lead + (d_inner, m.d_state), f32),
                  "mamba_conv": (lead + (m.d_conv - 1, d_inner), f32)}
    else:
        shapes = {"k": ((cfg.n_layers,) + kv, cfg.dtype),
                  "v": ((cfg.n_layers,) + kv, cfg.dtype)}
    return {name: torch.full(shape, _CACHE_FILL.get(name, 0.0), dtype=dt,
                             device=device)
            for name, (shape, dt) in shapes.items()}


def abstract_cache_like(cfg: ModelConfig, cache: dict) -> dict:
    """``init_cache``'s state for ``cfg`` on the ``meta`` device, at the
    batch and context length of ``cache``."""
    if cfg.family == "ssm":
        batch, max_len = cache["slstm"].shape[2], 0
    else:
        batch, max_len = cache["k"].shape[-4], cache["k"].shape[-3]
    return init_cache(cfg, batch, max_len, device="meta")


def reset_cache(cache: dict) -> dict:
    """``cache`` back to ``init_cache``'s values, in place."""
    for name, t in cache.items():
        t.fill_(_CACHE_FILL.get(name, 0.0))
    return cache


def _decode_layers(params, cfg: ModelConfig) -> list[dict]:
    """Every layer's weights in cache order (KV-cache families)."""
    layers = params["layers"]
    if _alternating(cfg):
        return [layer_params(layers["moe" if _is_moe_layer(cfg, i)
                                    else "dense"], i // 2)
                for i in range(cfg.n_layers)]
    return [layer_params(layers, i) for i in range(cfg.n_layers)]


def decode_step(params, cache: dict, batch: dict, cache_len: int,
                cfg: ModelConfig):
    """One new token for every sequence. Returns ``(logits, cache)``;
    the step's state is written into ``cache`` in place (KV position
    ``cache_len``; the recurrent states whole). MoE layers dispatch the
    step's tokens as one group. A VLM decodes text only (its patches
    were consumed at prefill); audio decodes codes ``[B, 1, K]``."""
    if cfg.family == "vlm":
        x = _gather_rows(params["embed"], batch["tokens"])      # [B, 1, D]
    else:
        x = embed_inputs(params, batch, cfg)

    if cfg.family == "ssm":
        x = _decode_ssm(params["layers"], cache, x, cfg)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params["layers"], cache, x, cache_len, cfg)
    else:
        window = cfg.attention.sliding_window
        flags = _global_flags(cfg)
        moe_cfg = _decode_moe(cfg)
        _, unit, rem = repeat_unit(cfg)
        for i, lp in enumerate(_decode_layers(params, cfg)):
            if i % unit == 0:
                _mark()
            lp = gathered(lp)
            a_out, _, _ = attention_decode_block(
                rms_norm(x, lp["ln1"]), lp["attn"], cfg.attention,
                cfg.n_heads, cfg.n_kv_heads, cfg.hd, cache["k"][i],
                cache["v"][i], cache_len, window=window,
                is_global=None if flags is None else flags[i])
            x = _ffn(x + a_out, lp, moe_cfg)
        if not rem:
            _mark()
    h = rms_norm(x, params["final_norm"])
    return logits_fn(params, h, cfg), cache


def _write(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _decode_ssm(layers, cache, x, cfg: ModelConfig):
    n_periods, period = _periods(cfg)
    for p in range(n_periods):
        _mark()
        for j in range(period - 1):
            state = tuple(cache[k][p, j] for k in ("mlstm_C", "mlstm_n",
                                                   "mlstm_m"))
            out, new = xl.mlstm_decode_step(
                x, state, layer_params(layers["mlstm"], (p, j)), cfg.n_heads)
            _write(state, new)
            x = x + out
        state = cache["slstm"][p].unbind(0)
        s_out, new = xl.slstm_block(x, layer_params(layers["slstm"], p),
                                    cfg.n_heads, chunk=1, state=state)
        _write(state, new)
        x = x + s_out
    _mark()
    return x


def _decode_hybrid(layers, cache, x, cache_len: int, cfg: ModelConfig):
    n_periods, period = _periods(cfg)
    moe_cfg = _decode_moe(cfg)
    for p in range(n_periods):
        _mark()
        lp = layer_params(layers["pos0"], p)
        a_out, _, _ = attention_decode_block(
            rms_norm(x, lp["ln1"]), lp["attn"], cfg.attention, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cache["k"][p], cache["v"][p], cache_len,
            window=cfg.attention.sliding_window)
        x = _ffn(x + a_out, lp, moe_cfg)
        for pos in range(1, period):
            lp = layer_params(layers[f"pos{pos}"], p)
            state = {"h": cache["mamba_h"][p, pos - 1],
                     "conv": cache["mamba_conv"][p, pos - 1]}
            m_out, new = mam.mamba_decode_step(rms_norm(x, lp["ln1"]), state,
                                               lp["mamba"], cfg.mamba)
            _write(state.values(), (new["h"], new["conv"]))
            x = _ffn(x + m_out, lp, moe_cfg)
    _mark()
    return x


def _decode_moe(cfg: ModelConfig):
    return (None if cfg.moe is None
            else dataclasses.replace(cfg.moe, num_groups=1))

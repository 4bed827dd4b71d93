"""Decoder LM, dense family (PyTorch port of ``repro.models.model``).

Parameters are a plain dict with the JAX pytree's key paths and the
per-layer weights stacked ``[L, ...]``, so a JAX parameter tree converts
name for name (``convert.py``) and parameter bytes match byte for byte.
The JAX package's ``lax.scan`` over the stack is a Python loop over
layer views here. Serving: ``init_cache`` + ``decode_step`` decode one
token against a KV cache that is updated in place.

Only the dense family is ported (gemma3's local:global flags included).
MoE, hybrid, SSM, VLM and audio raise ``NotImplementedError``: they are
ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import (attention_block, attention_block_params,
                     attention_decode_block, mlp_params, normal_init,
                     rms_norm, swiglu)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP Queue 1 item 11); the port runs the dense family")


# ---------------------------------------------------------------------------
# parameter init
def _build_params(cfg: ModelConfig, gen, device) -> dict:
    _require_dense(cfg)
    dt, D, V, L = cfg.dtype, cfg.d_model, cfg.padded_vocab, cfg.n_layers

    params: dict = {"final_norm": torch.ones((D,), dtype=dt, device=device),
                    "embed": normal_init(gen, (V, D), 0.02, dt, device)}
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (D, V), 0.02, dt, device)
    layers = {
        "ln1": torch.ones((L, D), dtype=dt, device=device),
        "ln2": torch.ones((L, D), dtype=dt, device=device),
        "attn": attention_block_params(
            gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
            qk_norm=cfg.attention.qk_norm, device=device, lead=(L,)),
    }
    if cfg.d_ff:
        layers["mlp"] = mlp_params(gen, D, cfg.d_ff, dt, device=device,
                                   lead=(L,))
    params["layers"] = layers
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


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights: views into the stacked ``[L, ...]`` tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _decoder_layer(x, lp, cfg: ModelConfig, *, is_global=None,
                   positions=None):
    window = cfg.attention.sliding_window
    h, _ = attention_block(
        rms_norm(x, lp["ln1"]), lp["attn"], cfg.attention, cfg.n_heads,
        cfg.n_kv_heads, cfg.hd, positions=positions, is_global=is_global,
        window=window)
    x = x + h
    if "mlp" in lp:
        x = x + swiglu(rms_norm(x, lp["ln2"]), **lp["mlp"])
    return x


def backbone(params, x, cfg: ModelConfig, positions=None):
    """x: [B, S, D] embedded inputs -> final hidden states."""
    _require_dense(cfg)
    flags = _global_flags(cfg)
    for i in range(cfg.n_layers):
        x = _decoder_layer(x, layer_params(params["layers"], i), cfg,
                           is_global=None if flags is None else flags[i],
                           positions=positions)
    return rms_norm(x, params["final_norm"])


def embed_inputs(params, batch: dict, cfg: ModelConfig):
    _require_dense(cfg)
    return F.embedding(batch["tokens"], params["embed"])


def logits_fn(params, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["head"]


# ---------------------------------------------------------------------------
# serving: cache init + one-token decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Persistent decode state: stacked KV caches ``[L, B, max_len, Hkv,
    hd]`` in ``cfg.dtype``."""
    _require_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params, cache: dict, batch: dict, cache_len: int,
                cfg: ModelConfig):
    """One new token for every sequence. Returns ``(logits, cache)``;
    position ``cache_len`` of ``cache`` is written in place."""
    x = embed_inputs(params, batch, cfg)       # [B, 1, D]
    window = cfg.attention.sliding_window
    flags = _global_flags(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a_out, _, _ = attention_decode_block(
            rms_norm(x, lp["ln1"]), lp["attn"], cfg.attention, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cache["k"][i], cache["v"][i], cache_len,
            window=window, is_global=None if flags is None else flags[i])
        x = x + a_out
        if "mlp" in lp:
            x = x + swiglu(rms_norm(x, lp["ln2"]), **lp["mlp"])
    h = rms_norm(x, params["final_norm"])
    return logits_fn(params, h, cfg), cache

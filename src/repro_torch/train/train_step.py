"""Serving step factories (PyTorch port of the serving half of
``repro.train.train_step``). Every step runs under ``torch.no_grad()``:
the port's first slice serves, and training waits for its own slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..models import model as M


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Forward over the full prompt -> last-position logits."""
    @torch.no_grad()
    def prefill_step(params, batch):
        x = M.embed_inputs(params, batch, cfg)
        h = M.backbone(params, x, cfg,
                       positions=torch.arange(x.shape[1], device=x.device))
        return M.logits_fn(params, h[:, -1:], cfg)
    return prefill_step


def make_serve_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """One-token decode against a cache of ``cache_len`` context."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return M.decode_step(params, cache, batch, cache_len, cfg)
    return serve_step

"""Architecture registry: ``--arch <id>`` resolution + input specs.

``input_specs(cfg, shape)`` returns ``meta``-device tensors standing in
for every model input of a given (architecture x shape) cell: shape and
dtype only, zero allocation. Modality frontends are stubs: the VLM
receives precomputed patch embeddings, the audio model receives EnCodec
token codes.
"""
from __future__ import annotations

import importlib

import torch

from .base import ModelConfig, ShapeSpec

_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "qwen3-32b": "qwen3_32b",
    "phi4-mini-3.8b": "phi4_mini_38b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma3-4b": "gemma3_4b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_13b",
    "musicgen-medium": "musicgen_medium",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override: int | None = None) -> dict:
    """Training/prefill batch as meta tensors (no allocation)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if cfg.family == "vlm":
        P = cfg.num_patches
        S_text = max(S - P, 8)
        return {
            "patch_embeds": _meta(B, P, cfg.d_model, dtype=cfg.dtype),
            "tokens": _meta(B, S_text),
            "labels": _meta(B, S_text),
        }
    if cfg.family == "audio":
        return {"codes": _meta(B, S, cfg.num_codebooks),
                "labels": _meta(B, S, cfg.num_codebooks)}
    return {"tokens": _meta(B, S), "labels": _meta(B, S)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                       batch_override: int | None = None) -> dict:
    """Single-token decode batch (serve_step input)."""
    B = batch_override or shape.global_batch
    if cfg.family == "audio":
        return {"codes": _meta(B, 1, cfg.num_codebooks)}
    return {"tokens": _meta(B, 1)}


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec, *,
                   batch_override: int | None = None) -> dict:
    """Decode cache as meta tensors for a given context length."""
    from ..models import model as M
    B = batch_override or shape.global_batch
    return M.init_cache(cfg, B, shape.seq_len, device="meta")


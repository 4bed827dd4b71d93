"""Synthetic data pipeline — deterministic, restart-safe, shardable.

A copy of ``repro.train.data``'s numpy generator, so both packages see
the same tokens for a seed:

* stateless indexing: batch ``i`` is a pure function of (seed, i), so a
  job restarted from a step-k checkpoint regenerates exactly the batches
  it would have seen;
* per-host sharding by process index;
* zipfian token distribution so softmax/loss statistics resemble text.

``device_batch`` returns the batch as torch tensors on a given device
(``to_device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_alpha: float = 1.1


class SyntheticDataset:
    """Deterministic synthetic LM batches."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig(),
                 num_shards: int = 1, shard_index: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.num_shards = num_shards
        self.shard_index = shard_index
        if shape.global_batch % num_shards:
            raise ValueError(f"global batch {shape.global_batch} not "
                             f"divisible by {num_shards} shards")
        self.local_batch = shape.global_batch // num_shards

    def _tokens(self, rng: np.random.Generator, shape):
        # zipf over vocab, clipped
        z = rng.zipf(self.data_cfg.zipf_alpha, size=shape)
        return np.minimum(z - 1, self.cfg.vocab - 1).astype(np.int32)

    def batch(self, step: int) -> dict:
        """Batch for global step ``step`` — pure function of (seed, step,
        shard)."""
        rng = np.random.default_rng(
            (self.data_cfg.seed, step, self.shard_index))
        B, S = self.local_batch, self.shape.seq_len
        cfg = self.cfg
        if cfg.family == "vlm":
            P = cfg.num_patches
            S_text = max(S - P, 8)
            toks = self._tokens(rng, (B, S_text + 1))
            return {
                "patch_embeds": rng.standard_normal(
                    (B, P, cfg.d_model)).astype(np.float32) * 0.02,
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }
        if cfg.family == "audio":
            codes = self._tokens(rng, (B, S + 1, cfg.num_codebooks))
            return {"codes": codes[:, :-1], "labels": codes[:, 1:]}
        toks = self._tokens(rng, (B, S + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def device_batch(self, step: int, device="cuda") -> dict:
        """``batch(step)`` as tensors on ``device``; float arrays take
        the model's dtype."""
        return to_device(self.cfg, self.batch(step), device)


def to_device(cfg: ModelConfig, arrays: dict, device) -> dict:
    """Numpy arrays as tensors on ``device``; float arrays take
    ``cfg.dtype``."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(cfg.dtype)
        out[k] = t.to(device)
    return out

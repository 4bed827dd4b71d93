"""Weights and decode state from the JAX package, name for name.

The JAX package's parameter pytree (nested dicts) with its leaves
turned into numpy arrays — ``jax.tree_util.tree_map(np.asarray, tree)``
on the caller's side — becomes the port's parameter dict. No JAX is
imported here. bf16 leaves arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so they cross as their uint16 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import abstract_params


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])   # torch wants writable
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of tensors (used
    for ``init_cache`` state as well as for weights)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _check_like(got, want, path: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{path or 'params'}: keys {keys} != "
                             f"{sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], f"{path}/{k}")
        return
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise ValueError(f"{path}: {tuple(got.shape)} {got.dtype} != "
                         f"{tuple(want.shape)} {want.dtype}")


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX parameter tree of ``cfg`` as the port's parameters; raises
    if a key, shape or dtype differs from ``abstract_params(cfg)``."""
    params = tree_from_numpy(tree, device)
    _check_like(params, abstract_params(cfg), "")
    return params

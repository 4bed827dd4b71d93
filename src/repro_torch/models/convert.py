"""Weights, decode state and optimizer state from the JAX package.

The JAX package's pytrees (nested dicts) with their leaves turned into
numpy arrays — ``jax.tree_util.tree_map(np.asarray, tree)`` on the
caller's side — become the port's trees. No JAX is imported here. bf16
leaves arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so they cross as their uint16 bits.

Trees are matched by key path against a template of the port's own
structure, never by leaf index: JAX flattens dicts in sorted key order
and ``torch.utils._pytree`` in insertion order, and the port's
optimizers pair parameters, gradients and state leaf by leaf in its
own order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..train.optimizer import Optimizer
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


def _like(tree, want, path: str, device):
    """``tree`` (numpy leaves) converted in the key order of ``want``;
    raises if a key, shape or dtype differs."""
    if isinstance(want, (dict, tuple, list)):
        keys = list(want) if isinstance(want, dict) else range(len(want))
        same = (isinstance(tree, dict) and set(tree) == set(want)
                if isinstance(want, dict)
                else isinstance(tree, (tuple, list))
                and len(tree) == len(want))
        if not same:
            raise ValueError(f"{path or 'tree'}: structure {_keys(tree)} "
                             f"!= {_keys(want)}")
        got = [_like(tree[k], want[k], f"{path}/{k}", device) for k in keys]
        return dict(zip(keys, got)) if isinstance(want, dict) \
            else type(want)(got)
    t = tensor_from_numpy(tree, device)
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} != "
                         f"{tuple(want.shape)} {want.dtype}")
    return t


def _keys(tree):
    return sorted(tree) if isinstance(tree, dict) else type(tree).__name__


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX parameter tree of ``cfg`` as the port's parameters; raises
    if a key, shape or dtype differs from ``abstract_params(cfg)``."""
    return _like(tree, abstract_params(cfg), "", device)


def opt_state_from_numpy(tree, opt: Optimizer, cfg: ModelConfig,
                         device="cuda"):
    """The JAX package's state of optimizer ``opt`` (same name and
    hyperparameters) as the port's, ``count`` scalars included; raises
    if it does not have the structure ``opt.init`` gives."""
    return _like(tree, opt.init(abstract_params(cfg)), "", device)

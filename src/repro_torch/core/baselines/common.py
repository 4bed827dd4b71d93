"""Shared job description consumed by all estimators (xMem + baselines).

A port of ``repro.core.baselines.common``: ``params`` and ``batch`` are
pytrees of tensors (``meta`` ones allocate nothing), and the optimizer
state's bytes come from running ``opt_init_fn`` on ``meta`` copies of
the parameters, where the JAX package uses ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..estimator import _to_meta
from ..events import BlockKind, Trace
from ..tracer import trace_fn


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class JobSpec:
    """One training-job configuration (paper notation: configuration j)."""

    name: str
    fwd_bwd_fn: Callable          # (params, batch) -> (loss, grads)
    params: Any                   # pytree of tensors (meta: no memory)
    batch: Any                    # pytree of tensors (meta: no memory)
    update_fn: Callable | None = None
    opt_init_fn: Callable | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    # meta keys used by feature-based estimators / reporting:
    #   family, optimizer, batch_size, seq_len, d_model, n_layers,
    #   grad_release

    def param_bytes(self) -> int:
        return _nbytes(self.params)

    def batch_bytes(self) -> int:
        return _nbytes(self.batch)

    def opt_state_bytes(self) -> int:
        if self.opt_init_fn is None:
            return 0
        return _nbytes(self.opt_init_fn(_to_meta(self.params)))

    def features(self) -> list[float]:
        """Feature vector for data-driven estimators (SchedTune-style)."""
        m = self.meta
        return [
            self.param_bytes() / 1e6,
            self.batch_bytes() / 1e6,
            float(m.get("batch_size", 1)),
            float(m.get("seq_len", 0)),
            float(m.get("d_model", 0)),
            float(m.get("n_layers", 0)),
            float(m.get("optimizer_states", 0)),  # 0 sgd, 1 rmsprop, 2 adam
            self.param_bytes() / 1e6 * float(m.get("optimizer_states", 0)),
            float(m.get("batch_size", 1)) * float(m.get("seq_len", 1))
            * float(m.get("d_model", 1)) / 1e6,   # activation proxy
        ]


def trace_fwd_bwd(job: JobSpec) -> Trace:
    """The job's forward+backward traced on the CPU under fake tensors
    (grad mode on), parameters kinded ``PARAM`` and the batch ``INPUT``.
    The estimator's cached forward+backward trace of the same job
    (``XMemEstimator.trace_phases``) has the same event stream."""
    flat_p, p_spec = pytree.tree_flatten(job.params)
    flat_b, b_spec = pytree.tree_flatten(job.batch)
    n = len(flat_p)

    def flat_fn(*leaves):
        return job.fwd_bwd_fn(pytree.tree_unflatten(leaves[:n], p_spec),
                              pytree.tree_unflatten(leaves[n:], b_spec))

    kinds = [BlockKind.PARAM] * n + [BlockKind.INPUT] * len(flat_b)
    trace, _, _ = trace_fn(flat_fn, *(flat_p + flat_b), arg_kinds=kinds,
                           grad=True)
    return trace

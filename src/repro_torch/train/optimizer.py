"""Optimizers written by hand (PyTorch port of ``repro.train.optimizer``).

The paper's evaluation sweeps SGD / Adam / AdamW / RMSprop / Adagrad /
Adafactor (§4.1.2): the optimizer changes persistent state from 0x to
2x the parameter bytes, which is what an estimator must capture.

As in the JAX package, optimizer state is f32 whatever the parameter
dtype (``torch.optim`` keeps it in the parameter dtype, which would
halve the state bytes of a bf16 model), ``count`` is a 0-d int32 tensor
and Adafactor keeps factored second moments with the JAX shapes.

Unlike the JAX package the update is in place: ``update(params, grads,
state)`` runs under ``torch.no_grad()`` (a ``with`` block, not a
decorator, so the trace cache can hash the function's content), writes
the parameters and the state where they are and returns the same
tensors. An eager PyTorch job
updates in place, and that is what the paper estimates; a functional
update would hold a second copy of parameters and state on the card,
with no donation to remove it. Each leaf's f32 working copies are
freed before the next leaf's are made.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..distributed.act_sharding import is_dtensor, replicated


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros shaped like ``p`` (a DTensor's with its placements)."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _placements_without(p: torch.Tensor, dim: int) -> list:
    """The DTensor placements of ``p`` with tensor dim ``dim`` dropped:
    a shard of ``dim`` made replicated, later dims' shards shifted."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= p.ndim
    return [Replicate() if isinstance(q, Shard) and q.dim == dim
            else Shard(q.dim - (q.dim > dim)) if isinstance(q, Shard) else q
            for q in p.placements]


def _zeros32_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 zeros of ``p``'s shape with ``dim`` dropped (a factored second
    moment's rows or columns); a DTensor's laid out as ``p`` is
    (:func:`_placements_without`: the local rows or columns of each
    shard are the ones it updates)."""
    dim %= p.ndim
    shape = tuple(p.shape[:dim]) + tuple(p.shape[dim + 1:])
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from ..distributed.act_sharding import from_local
    local = p.to_local()
    zeros = torch.zeros(tuple(local.shape[:dim])
                        + tuple(local.shape[dim + 1:]),
                        dtype=torch.float32, device=local.device)
    return from_local(zeros, p.device_mesh, _placements_without(p, dim),
                      shape)


def _laid_out_as(t: torch.Tensor, like: torch.Tensor,
                 placements=None) -> torch.Tensor:
    """``t`` (a gradient, a parameter or an optimizer state) in the
    layout of ``like`` (or in ``placements`` over its mesh), where both
    are DTensors that differ (the rule engine lays the optimizer state
    out by its shape: an expert stack's on its largest dim, the weight
    on the expert dim): moved once, and not again by each op that mixes
    the two. Plain tensors: ``t``."""
    if not (is_dtensor(t) and is_dtensor(like)):
        return t
    placements = list(like.placements if placements is None
                      else placements)
    if list(t.placements) == placements:
        return t
    return t.redistribute(like.device_mesh, placements)


def _count0(params) -> torch.Tensor:
    """The 0-d int32 step count: replicated over the mesh of DTensor
    parameters."""
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    count = torch.zeros((), dtype=torch.int32, device=device)
    return replicated(count, leaves[0]) if leaves else count


def _leaves(*trees):
    return zip(*(pytree.tree_leaves(t) for t in trees))


def _apply_(p: torch.Tensor, step: torch.Tensor) -> None:
    """``p -= step`` with ``step`` rounded to ``p``'s dtype first, as
    the JAX update's ``p - step.astype(p.dtype)``."""
    p.sub_(step if step.dtype == p.dtype else step.to(p.dtype))


# ---------------------------------------------------------------------------
def sgd(lr: float = 1e-3, momentum: float = 0.0) -> Optimizer:
    if momentum:
        def init(params):
            return pytree.tree_map(_zeros32, params)

        def update(params, grads, state):
            with torch.no_grad():
                for p, g, m in _leaves(params, grads, state):
                    m.mul_(momentum).add_(g.float())
                    _apply_(p, lr * m.to(p.dtype))
                return params, state
        return Optimizer("sgd_momentum", init, update)

    def init(params):
        return ()

    def update(params, grads, state):
        with torch.no_grad():
            for p, g in _leaves(params, grads):
                _apply_(p, lr * g.to(p.dtype))
            return params, state
    return Optimizer("sgd", init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         name: str = "adam") -> Optimizer:
    def init(params):
        return {"m": pytree.tree_map(_zeros32, params),
                "v": pytree.tree_map(_zeros32, params),
                "count": _count0(params)}

    def update(params, grads, state):
        with torch.no_grad():
            count = state["count"].add_(1)
            c = count.float()
            bc1 = 1.0 - b1 ** c
            bc2 = 1.0 - b2 ** c
            for p, g, m, v in _leaves(params, grads, state["m"], state["v"]):
                g = _laid_out_as(g, m).float()
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                del g
                step = (v / bc2).sqrt_().add_(eps)
                step = torch.div(m / bc1, step, out=step).mul_(lr)
                if weight_decay:
                    step.add_(_laid_out_as(p, m).float(),
                              alpha=lr * weight_decay)
                _apply_(p, step)
            return params, state

    return Optimizer(name, init, update)


def adamw(lr: float = 1e-3, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr=lr, weight_decay=weight_decay, name="adamw", **kw)


def rmsprop(lr: float = 1e-3, decay: float = 0.9,
            eps: float = 1e-8) -> Optimizer:
    def init(params):
        return pytree.tree_map(_zeros32, params)

    def update(params, grads, state):
        with torch.no_grad():
            for p, g, v in _leaves(params, grads, state):
                g = g.float()
                v.mul_(decay).addcmul_(g, g, value=1 - decay)
                step = v.sqrt().add_(eps)
                _apply_(p, torch.div(g * lr, step, out=step))
            return params, state
    return Optimizer("rmsprop", init, update)


def adagrad(lr: float = 1e-2, eps: float = 1e-10) -> Optimizer:
    def init(params):
        return pytree.tree_map(_zeros32, params)

    def update(params, grads, state):
        with torch.no_grad():
            for p, g, a in _leaves(params, grads, state):
                g = g.float()
                a.addcmul_(g, g)
                step = a.sqrt().add_(eps)
                _apply_(p, torch.div(g * lr, step, out=step))
            return params, state
    return Optimizer("adagrad", init, update)


def adafactor(lr: float = 1e-3, decay: float = 0.8,
              eps: float = 1e-30) -> Optimizer:
    """Factored second moments: O(rows+cols) state for matrices — the
    memory-frugal choice the paper uses for its largest models (RQ5)."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def st(p):
            if _factored(p):
                return {"vr": _zeros32_without(p, -1),
                        "vc": _zeros32_without(p, -2)}
            return {"v": _zeros32(p)}
        return {"f": pytree.tree_map(st, params), "count": _count0(params)}

    def update(params, grads, state):
        with torch.no_grad():
            count = state["count"].add_(1)
            beta = 1.0 - (count.float() + 1.0) ** (-decay)
            for p, g, s in zip(pytree.tree_leaves(params),
                               pytree.tree_leaves(grads),
                               _factor_states(state["f"])):
                if _factored(p):
                    g = g.float()
                    g2 = g * g + eps
                    vr, vc = s["vr"], s["vc"]
                    if is_dtensor(p):
                        # the moments in the weight's layout, so that
                        # their outer product needs no collective
                        vr, vc = (_laid_out_as(t, p, _placements_without(
                            p, dim)) for t, dim in ((vr, -1), (vc, -2)))
                    vr.mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                    vc.mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                    del g2
                    for k, t in (("vr", vr), ("vc", vc)):
                        if t is not s[k]:
                            s[k].copy_(t)
                    denom = (vr[..., None] * vc[..., None, :]).div_(
                        torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps))
                    del vr, vc
                    step = g * denom.add_(eps).rsqrt_()
                else:
                    v = s["v"]
                    g = _laid_out_as(g, v).float()
                    g2 = g * g + eps
                    v.mul_(beta).add_((1 - beta) * g2)
                    del g2
                    step = g * (v + eps).rsqrt_()
                del g
                # update clipping (RMS <= 1) as in the paper's implementation
                rms = torch.sqrt((step * step).mean() + eps)
                step.div_(torch.clamp(rms, min=1.0)).mul_(lr)
                _apply_(p, step)
            return params, state

    return Optimizer("adafactor", init, update)


def _factor_states(f) -> list[dict]:
    """Adafactor's per-leaf state dicts, in the parameters' leaf order."""
    return pytree.tree_leaves(
        f, is_leaf=lambda x: isinstance(x, dict) and ("v" in x or "vr" in x))


OPTIMIZERS: dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "sgd_momentum": partial(sgd, momentum=0.9),
    "adam": adam,
    "adamw": adamw,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adafactor": adafactor,
}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)


def clip_by_global_norm(update_fn, max_norm: float = 1.0):
    """Wrap an optimizer update with global-norm clipping.

    The gradients are scaled in place by a 0-d f32 ``scale``; a bf16
    gradient goes through f32 first, so it rounds exactly as the JAX
    package's ``(f32(g) * scale).astype(bf16)`` (a 0-d device tensor
    would otherwise be rounded to bf16 before the product)."""
    def wrapped(params, grads, state):
        with torch.no_grad():
            leaves = pytree.tree_leaves(grads)
            gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
            scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
            for g in leaves:
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    g.copy_(g.float().mul_(scale))
            return update_fn(params, grads, state)
    return wrapped

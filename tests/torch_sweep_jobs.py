"""Module-level PyTorch step functions for the sweep tests.

The torch counterparts of ``tests/test_columnar.py``'s small MLP job
(``_loss``, ``_fwd_bwd``, ``_adam_init``, ``_adam``). They live in a
module of their own, which imports neither ``jax`` nor ``repro``, so
that a spawned pool worker can unpickle them (a function pickles by its
module's name) without importing the JAX package.
"""
import torch
from torch.utils import _pytree as pytree

D, H = 48, 64


def loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"])
    return ((h @ params["w2"] - batch["y"]) ** 2).mean()


def fwd_bwd(params, batch):
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    value = loss(pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), pytree.tree_unflatten(list(grads), spec)


def gram_fwd_bwd(params, batch):
    """x @ w, then its Gram matrix: sizes quadratic in the batch."""
    w = params["w"].detach().requires_grad_()
    h = batch["x"] @ w
    g = h @ h.T
    value = (g * g).sum()
    (grad,) = torch.autograd.grad(value, [w])
    return value.detach(), {"w": grad}


def adam_init(params):
    return {k: (torch.zeros_like(p), torch.zeros_like(p))
            for k, p in params.items()}


@torch.no_grad()
def adam(params, grads, state):
    for k, p in params.items():
        m, v = state[k]
        g = grads[k]
        m.mul_(0.9).add_(g, alpha=0.1)
        v.mul_(0.999).addcmul_(g, g, value=0.001)
        p.sub_(1e-3 * m / (v.sqrt() + 1e-8))
    return params, state


def shapes(batch=16):
    params = {"w1": torch.empty((D, H), device="meta"),
              "w2": torch.empty((H, D), device="meta")}
    data = {"x": torch.empty((batch, D), device="meta"),
            "y": torch.empty((batch, D), device="meta")}
    return params, data

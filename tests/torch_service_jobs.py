"""Module-level PyTorch jobs for the admission-service tests.

The torch counterpart of ``tests/test_service.py``'s small job: ``L``
tanh layers of alternating ``(D, H)``/``(H, D)`` weights, a mean-square
loss and an Adam-like update over ``(m, v)`` tuples. ``make_hooks``
re-creates the closures on every call (the gates' identity churn), and
the module imports neither ``jax`` nor ``repro``, so a subprocess can
build the same job and get the same content digest.
"""
import torch
from torch.utils import _pytree as pytree

from repro_torch.service import AdmissionRequest, JobArrival

L, D, H, B = 4, 32, 64, 8


def make_hooks():
    """(fwd_bwd, update, opt_init), fresh closures on every call."""
    def loss(p, b):
        h = b["x"]
        for i in range(L):
            h = torch.tanh(h @ p[f"w{i}"])
        return ((h - b["y"]) ** 2).mean()

    def fwd_bwd(p, b):
        leaves, spec = pytree.tree_flatten(p)
        leaves = [t.detach().requires_grad_() for t in leaves]
        value = loss(pytree.tree_unflatten(leaves, spec), b)
        grads = torch.autograd.grad(value, leaves)
        return value.detach(), pytree.tree_unflatten(list(grads), spec)

    def adam_init(p):
        return {k: (torch.zeros_like(x), torch.zeros_like(x))
                for k, x in p.items()}

    def adam(p, g, s):
        with torch.no_grad():
            for k, x in p.items():
                m, v = s[k]
                m.mul_(0.9).add_(g[k], alpha=0.1)
                v.mul_(0.999).addcmul_(g[k], g[k], value=0.001)
                x.sub_(1e-3 * m / (v.sqrt() + 1e-8))
        return p, s

    return fwd_bwd, adam, adam_init


def shapes(batch=B):
    params = {f"w{i}": torch.empty((D, H) if i % 2 == 0 else (H, D),
                                   device="meta") for i in range(L)}
    data = {"x": torch.empty((batch, D), device="meta"),
            "y": torch.empty((batch, D), device="meta")}
    return params, data


def request(job_id="job", batch=B, capacity=1 << 30, **kw):
    fwd_bwd, adam, adam_init = make_hooks()
    params, data = shapes(batch)
    return AdmissionRequest(job_id, fwd_bwd, params, data,
                            update_fn=adam, opt_init_fn=adam_init,
                            capacity=capacity, **kw)


def arrival(job_id, batch=B, capacity=1 << 30, **kw):
    fwd_bwd, adam, adam_init = make_hooks()
    params, data = shapes(batch)
    return JobArrival(job_id, fwd_bwd, params, data, update_fn=adam,
                      opt_init_fn=adam_init, capacity=capacity, **kw)

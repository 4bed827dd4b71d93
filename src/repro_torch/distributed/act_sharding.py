"""Activation sharding constraints via logical axis names (port of
``repro.distributed.act_sharding``).

A few tensors need explicit layout anchors under tensor parallelism,
above all the [B, S, V] logits: unconstrained, the loss could pull a
replicated copy. Model code calls ``constrain(x, ("batch", None,
"vocab"))`` with *logical* names; a launcher binds them to mesh axes for
the duration of a step (``logical_axis_rules``, a context variable).

``constrain`` returns its argument itself outside a bound scope and for
a plain tensor, so single-device runs and the estimator's traces are
untouched. On a ``DTensor`` inside a scope it redistributes to the
placements the logical dims name, with the reference's divisibility
guard: a dim that does not divide its axes stays unsharded.
"""
from __future__ import annotations

import contextlib
import contextvars

_BINDING: contextvars.ContextVar = contextvars.ContextVar(
    "logical_axis_binding", default=None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, tuple[str, ...] | str]):
    """Bind logical names ('batch', 'vocab', 'model', 'seq') to the axes
    of ``mesh`` (a ``DeviceMesh``).

    Rules values may name axes absent from the mesh: they are filtered,
    so the same rule set serves single-pod and multi-pod meshes.
    """
    names = tuple(mesh.mesh_dim_names or ())
    filtered = {}
    for name, axes in rules.items():
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in names)
        filtered[name] = axes if len(axes) != 1 else axes[0]
    token = _BINDING.set((mesh, filtered))
    try:
        yield
    finally:
        _BINDING.reset(token)


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "model": ("model",),
    "heads": ("model",),
    "seq": (),
}


def constrain(x, logical_dims: tuple):
    """Apply a sharding constraint by logical dim names (None = any)."""
    bound = _BINDING.get()
    if bound is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import P, to_placements
    mesh, rules = bound
    names = tuple(mesh.mesh_dim_names or ())
    spec = []
    for i, d in enumerate(logical_dims):
        if d is None:
            spec.append(None)
            continue
        axes = rules.get(d, ())
        if not axes:
            spec.append(None)
            continue
        # divisibility guard
        total = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            total *= mesh.size(names.index(a))
        spec.append(None if x.shape[i] % total else axes)
    return x.redistribute(mesh, to_placements(P(*spec), mesh))

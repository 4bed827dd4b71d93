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

The rest of this module runs the model's ops on DTensors where
DTensor's own sharding rules would fail or gather: the products as
Megatron runs them (:func:`linear`), fsdp's gather of a layer's weights
(:func:`gathered`), the vocab-sharded embedding (:func:`embedding`), a
projection split into heads (:func:`split_last`), attention on each
rank's own heads (:func:`local_heads`), the MoE dispatch to each rank's
own experts (:func:`local_experts`) and a plain constant beside a
DTensor operand (:func:`replicated`). Each leaves plain tensors to the
plain code path, op for op.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

_BINDING: contextvars.ContextVar = contextvars.ContextVar(
    "logical_axis_binding", default=None)
# every open scope's binding, for threads that do not see the context
# variable: the autograd engine runs a CUDA backward, and so a
# checkpoint's recompute, on a device thread of its own
_SCOPES: list = []
_SCOPES_LOCK = threading.Lock()


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, tuple[str, ...] | str]):
    """Bind logical names ('batch', 'vocab', 'model', 'seq') to the axes
    of ``mesh`` (a ``DeviceMesh``).

    Rules values may name axes absent from the mesh: they are filtered,
    so the same rule set serves single-pod and multi-pod meshes. The
    binding holds in this context and, while the scope is open, in any
    thread that has no binding of its own (the autograd engine's)."""
    binding = (mesh, {name: (axes,) if isinstance(axes, str)
                      else tuple(axes) for name, axes in rules.items()})
    token = _BINDING.set(binding)
    with _SCOPES_LOCK:
        _SCOPES.append(binding)
    try:
        yield
    finally:
        _BINDING.reset(token)
        with _SCOPES_LOCK:
            _SCOPES.remove(binding)


def _bound():
    """The ``(mesh, rules)`` in force here, or None."""
    b = _BINDING.get()
    if b is None and _SCOPES:
        b = _SCOPES[-1]
    return b


def _axes(rules: dict, name: str, mesh) -> tuple:
    """The axes of ``mesh`` that logical ``name`` binds to."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in rules.get(name, ()) if a in names)


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "model": ("model",),
    "heads": ("model",),
    "seq": (),
}


def constrain(x, logical_dims: tuple):
    """Apply a sharding constraint by logical dim names (None = any)."""
    bound = _bound()
    if bound is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import P, to_placements
    mesh, rules = x.device_mesh, bound[1]
    names = tuple(mesh.mesh_dim_names or ())
    spec = []
    for i, d in enumerate(logical_dims):
        axes = _axes(rules, d, mesh) if d is not None else ()
        if not axes:
            spec.append(None)
            continue
        # divisibility guard
        total = 1
        for a in axes:
            total *= mesh.size(names.index(a))
        spec.append(None if x.shape[i] % total
                    else axes if len(axes) > 1 else axes[0])
    return x.redistribute(mesh, to_placements(P(*spec), mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(t, like):
    """``t``, a plain tensor (a constant: rope angles, positions, a
    zero count), as a DTensor replicated over the mesh of ``like``
    when ``like`` is a DTensor; else ``t`` itself."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def coordinate(mesh, dim: int) -> int:
    """This rank's index along mesh dimension ``dim``."""
    return mesh.get_coordinate()[dim]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(d)
    return tuple(reversed(stride))


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) over ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` for attention in the model layout (q [B, S, H,
    hd], k/v [B, S, Hkv, hd]) run by each rank on its own batch rows and
    query heads, with no collective.

    Plain tensors go straight to ``fn``. For DTensors, a mesh dim that
    shards q's batch (dim 0) or heads (dim 2) keeps that placement;
    anything else (a sequence shard, a partial) is made replicated
    first, and k/v follow q. Where q's heads are sharded and k/v's are
    replicated (kv heads that do not divide the axis), rank ``r`` of
    ``m`` holds query heads ``r H/m`` onward, and their kv heads start
    at ``(r H/m) // G``: each rank slices those and calls ``fn`` with
    its local group size. The gradient of that slice is partial over
    the axis (each rank adds its heads' share). The output has q's
    placements."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp, kp, sliced = [], [], None
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        a = a if a in (Shard(0), Shard(2)) else Replicate()
        qp.append(a)
        if a == Shard(2) and b != Shard(2):
            if sliced is not None:
                raise ValueError("query heads sharded over two mesh dims")
            sliced = i
            kp.append(Replicate())
        else:
            kp.append(a)
    q, k, v = (q.redistribute(mesh, qp), k.redistribute(mesh, kp),
               v.redistribute(mesh, kp))
    grad_kp = [Partial() if i == sliced else p for i, p in enumerate(kp)]
    ql = q.to_local()
    kl = k.to_local(grad_placements=grad_kp)
    vl = v.to_local(grad_placements=grad_kp)
    if sliced is not None:
        G = q.shape[2] // k.shape[2]
        hl = ql.shape[2]
        if hl % G and G % hl:
            raise ValueError(f"{hl} local query heads do not group over "
                             f"kv groups of {G}")
        lo, n = coordinate(mesh, sliced) * hl // G, max(hl // G, 1)
        kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
    out = fn(ql, kl, vl)
    return from_local(out, mesh, qp, tuple(q.shape[:3]) + tuple(out.shape[3:]))


def split_last(x, shape):
    """``x.reshape(shape)`` where ``shape`` splits ``x``'s last dim (a
    projection's heads x head dim). A DTensor sharded over that dim
    more ways than the first new dim divides is gathered over those
    mesh dims first (DTensor will not unflatten an uneven shard)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(x.ndim - 1)
        n = shape[x.ndim - 1]
        pl = [Replicate() if p == last and n % x.device_mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


def _batch_dims(mesh) -> set:
    """Mesh dims of the bound scope's batch axes (the data-parallel and
    fsdp axes)."""
    bound = _bound()
    if bound is None:
        return set()
    names = tuple(mesh.mesh_dim_names or ())
    return {names.index(a) for a in _axes(bound[1], "batch", mesh)}


def gathered(tree):
    """``tree`` (a layer's weights) with every DTensor leaf gathered
    over the batch axes, where fsdp shards it: the all-gather FSDP does
    before a layer runs, inside the layer's checkpoint, so the backward
    gathers again and reduce-scatters the gradient. Model-axis shards
    stay. A tree of plain tensors comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves(tree)
    if not leaves or not isinstance(leaves[0], DTensor):
        return tree

    def gather(t):
        dims = _batch_dims(t.device_mesh)
        pl = [Replicate() if i in dims else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else \
            t.redistribute(t.device_mesh, pl)
    return pytree.tree_map(gather, tree)


def embedding(ids, table):
    """``F.embedding(ids, table)`` of a DTensor table sharded over the
    vocab (dim 0): each rank looks up the ids its vocab range holds
    (zeros elsewhere) and a sum over the vocab axes completes the rows.
    The table is gathered over the batch axes first (fsdp), and its
    gradient is partial there (each data rank adds its rows'). The
    output is batch-sharded and replicated over the rest."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    bdims = _batch_dims(mesh)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)
             and i not in bdims]
    tpl = [Shard(0) if i in vocab else Replicate()
           for i in range(mesh.ndim)]
    table = table.redistribute(mesh, tpl)
    idpl = [p if p == Shard(0) and i in bdims else Replicate()
            for i, p in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, idpl)
    grad_pl = [Partial() if i in bdims else p for i, p in enumerate(tpl)]
    local = table.to_local(grad_placements=grad_pl)
    lid = ids.to_local().long()
    Vl = local.shape[0]
    lo = 0
    for i in vocab:
        lo = lo * mesh.size(i) + coordinate(mesh, i)
    lo *= Vl
    inside = (lid >= lo) & (lid < lo + Vl)
    x = F.embedding(torch.where(inside, lid - lo, 0), local)
    x = x * inside[..., None].to(x.dtype)
    out_pl = [Partial() if i in vocab else p for i, p in enumerate(idpl)]
    out = from_local(x, mesh, out_pl, tuple(ids.shape) + (local.shape[1],))
    return out.redistribute(mesh, idpl)


def linear(x, w):
    """``x @ w`` for a 2-D weight ``w`` [K, N], as Megatron runs it on
    DTensors: each rank multiplies its local shards, and the mesh dims
    decide the rest. Where ``w`` is column-parallel (``Shard(1)``) x is
    replicated and the output is sharded on its last dim; where ``w`` is
    row-parallel (``Shard(0)``) x is sharded on its last dim and the
    output is a partial sum (a caller makes it whole with
    :func:`constrain`); where ``w`` is replicated, x keeps a batch
    shard. The gradients are declared on the same terms (x's partial
    over a column-parallel axis, w's partial over the batch axes), so
    the backward needs no sharding rule of DTensor's and gathers no
    activation. Plain tensors: ``x @ w``."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    last = Shard(x.ndim - 1)
    xp, xg, wg, op = [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if b == Shard(1):                  # column-parallel
            xp.append(Replicate())
            xg.append(Partial())
            op.append(last)
        elif b == Shard(0):                # row-parallel
            xp.append(last)
            xg.append(last)
            op.append(Partial())
        else:
            keep = a if a == Shard(0) and x.ndim > 1 else Replicate()
            xp.append(keep)
            xg.append(keep)
            op.append(keep)
        wg.append(Partial() if xp[-1] == Shard(0) else b)
    x = x.redistribute(mesh, xp)
    y = x.to_local(grad_placements=xg) @ w.to_local(grad_placements=wg)
    return from_local(y, mesh, op, tuple(x.shape[:-1]) + (w.shape[-1],))


def local_experts(fn, x, params, groups: int):
    """The MoE FFN on DTensors, expert-parallel without an all-to-all:
    ``fn(x, params, groups, lo)`` (``models/moe.py:moe_experts``, the
    f32 combine) run by each rank on local tensors, then one all-reduce
    over the expert axes. Plain tensors: ``fn(x, params, groups, 0)``
    cast to ``x``'s dtype.

    ``x`` [B, S, D] is laid out batch-sharded over the bound scope's
    batch axes, where they split the ``groups`` dispatch groups whole
    (else replicated, each rank routing every group), and replicated
    over the rest, so every expert-axis rank holds the same tokens. The
    expert stacks ``[E, ...]`` keep their expert-dim shards
    (``Shard(0)``, the rule engine's over ``model``) and are replicated
    elsewhere (fsdp's shards gathered); the router is replicated. Each
    rank routes its groups over all E experts, gathers only its own
    experts' capacity rows ``[E/M, C, D]`` and combines their weighted
    outputs in f32: a partial sum over the expert axes, made whole (in
    f32) by :func:`constrain` to ``("batch", None, None)`` and then
    cast to ``x``'s dtype. The gradients are declared on the same
    terms: ``x``'s and the router's partial over the expert axes (each
    rank adds its experts' share) and the router's and the stacks'
    partial over the batch axes that shard ``x`` (each rank adds its
    tokens' share)."""
    if not is_dtensor(x):
        return fn(x, params, groups, 0).to(x.dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    bdims = _batch_dims(mesh)
    nb = 1
    for i in bdims:
        nb *= mesh.size(i)
    split = groups % nb == 0 and x.shape[0] % nb == 0
    xp = [Shard(0) if split and i in bdims else Replicate()
          for i in range(mesh.ndim)]
    ep = [i for i, p in enumerate(params["we_gate"].placements)
          if p == Shard(0)]
    wp = [Shard(0) if i in ep else Replicate() for i in range(mesh.ndim)]
    x = x.redistribute(mesh, xp)
    batch_partial = [Partial() if p == Shard(0) else Replicate() for p in xp]
    local = {"router": params["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=[
            Partial() if i in ep else p for i, p in enumerate(batch_partial)])}
    for name in ("we_gate", "we_up", "we_down"):
        w = params[name].redistribute(mesh, wp)
        local[name] = w.to_local(grad_placements=[
            Partial() if xp[i] == Shard(0) else p for i, p in enumerate(wp)])
    lo = 0
    for i in ep:
        lo = lo * mesh.size(i) + coordinate(mesh, i)
    lo *= local["we_gate"].shape[0]
    xl = x.to_local(grad_placements=[Partial() if i in ep else p
                                     for i, p in enumerate(xp)])
    y = fn(xl, local, groups // nb if split else groups, lo)
    out = from_local(y, mesh, [Partial() if i in ep else p
                               for i, p in enumerate(xp)], tuple(x.shape))
    return constrain(out, ("batch", None, None)).to(x.dtype)

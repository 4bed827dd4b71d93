"""Sharding rule engine: per-tensor partition specs with divisibility-aware
fallback (port of ``repro.distributed.sharding``).

Layout strategy (Megatron-style TP + DP/FSDP + EP):
* attention qkv: column-parallel on ``model``; output proj row-parallel;
* MLP gate/up column-parallel, down row-parallel;
* MoE expert stacks sharded on the expert dim over ``model`` (EP);
* embedding sharded on vocab over ``model`` (falls back to d_model when
  vocab isn't divisible, e.g. internvl2's 151655); LM head sharded on
  vocab (keeps the [B,S,V] logits tensor vocab-sharded);
* Mamba/xLSTM inner dims column/row-parallel like MLPs;
* batch dims of activations/inputs sharded over ``(pod, data)``;
* FSDP (``fsdp=True``): the largest remaining unsharded weight dim is
  additionally sharded over the fsdp axes (ZeRO-3-style parameter
  sharding);
* every rule checks divisibility: if a dim doesn't divide the axis size
  the axis is dropped for that dim (replicated) rather than failing.

The same rules produce the xMem estimator's per-block ``shard_factor``
(paper §6.2 distributed extension).

Differences from the JAX package:

* a spec is :class:`PartitionSpec`, a tuple subclass of this module (one
  entry per tensor dim: an axis name, a tuple of axis names, or None),
  so ``tuple(spec)`` compares with the reference's
  ``jax.sharding.PartitionSpec``;
* a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
  ``mesh_dim_names`` and ``size(i)``) or an ``{axis: size}`` dict. The
  ``*_shardings`` functions return, for a ``DeviceMesh``, each leaf's
  DTensor placements (``Shard(dim)`` or ``Replicate()`` per mesh
  dimension, :func:`to_placements`) and, for a dict, each leaf's spec;
* pytrees are ``torch.utils._pytree`` trees; a ``None`` leaf is skipped
  (JAX flattens None to no leaf), and ``keystr`` paths equal
  ``jax.tree_util.keystr``'s, so the ``_RULES`` regexes are the
  reference's.
"""
from __future__ import annotations

import dataclasses
import re

from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of axis names
    (the dim split over all of them, major first), or None
    (replicated). Trailing dims without an entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = False                  # ZeRO-3 param sharding over data
    fsdp_axes: tuple[str, ...] = ("data",)
    batch_axes: tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"


# (path regex, spec template for the LAST n dims of the tensor)
# "M" = model axis, None = replicated
_RULES: list[tuple[str, tuple]] = [
    # templates bind to TRAILING dims, so ("M", None) covers both the
    # [V, D] text embedding and the [K, V, D] audio codebook stack
    (r"\['embed'\]$", ("M", None)),        # vocab-sharded embedding
    (r"\['head'\]$", (None, "M")),         # [D, V] vocab-sharded logits
    (r"\['attn'\]\['wq'\]", (None, "M")),
    (r"\['attn'\]\['wk'\]", (None, "M")),
    (r"\['attn'\]\['wv'\]", (None, "M")),
    (r"\['attn'\]\['wo'\]", ("M", None)),
    (r"\['mlp'\]\['w_gate'\]", (None, "M")),
    (r"\['mlp'\]\['w_up'\]", (None, "M")),
    (r"\['mlp'\]\['w_down'\]", ("M", None)),
    (r"\['moe'\]\['router'\]", (None, None)),        # replicated router
    (r"\['moe'\]\['we_gate'\]", ("M", None, None)),  # EP on expert dim
    (r"\['moe'\]\['we_up'\]", ("M", None, None)),
    (r"\['moe'\]\['we_down'\]", ("M", None, None)),
    (r"\['mamba'\]\['in_proj'\]", (None, "M")),
    (r"\['mamba'\]\['out_proj'\]", ("M", None)),
    (r"\['mamba'\]\['conv_w'\]", (None, "M")),
    (r"\['mamba'\]\['conv_b'\]", ("M",)),
    (r"\['mamba'\]\['x_proj'\]", ("M", None)),
    (r"\['mamba'\]\['dt_proj'\]", (None, "M")),
    (r"\['mamba'\]\['dt_bias'\]", ("M",)),
    (r"\['mamba'\]\['A_log'\]", ("M", None)),
    (r"\['mamba'\]\['D'\]", ("M",)),
    (r"\['(wq|wk)'\]", (None, "M")),       # xlstm mLSTM projections
    (r"\['wv'\]", (None, "M")),
    (r"\['w_gate'\]", (None, "M")),
    (r"\['w_out'\]", ("M", None)),
    (r"\['w_(z|i|f|o)'\]", (None, "M")),   # sLSTM input mats
    (r"\['r_(z|i|f|o)'\]", (None, None, None)),  # block-diag recurrent
]


def _axis_size(mesh, name: str) -> int:
    if isinstance(mesh, dict):     # {axis: size}: estimator-side use
        return mesh.get(name, 1)
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _axis_names(mesh) -> tuple:
    """Axis names of a ``DeviceMesh`` or an {axis: size} dict
    (estimator-side meshes need no devices)."""
    if isinstance(mesh, dict):
        return tuple(mesh.keys())
    return tuple(mesh.mesh_dim_names or ())


def _fits(dim: int, mesh, axes) -> bool:
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= _axis_size(mesh, a)
    return dim % total == 0 and dim >= total


def _leaves_with_path(tree) -> list:
    """``(keystr path, leaf)`` pairs, None leaves dropped (JAX has none)."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(kp), leaf) for kp, leaf in flat
            if leaf is not None]


def _shape(leaf) -> tuple:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def spec_for_path(path: str, shape: tuple, mesh,
                  policy: ShardingPolicy) -> PartitionSpec:
    """Resolve the spec for one parameter leaf. ``mesh`` may be a
    ``DeviceMesh`` or an {axis: size} dict (spec-driven estimation
    needs no devices)."""
    axis_names = _axis_names(mesh)
    template = None
    for pat, tmpl in _RULES:
        if re.search(pat, path):
            template = tmpl
            break
    nd = len(shape)
    spec: list = [None] * nd
    if template is not None:
        # template binds to the trailing dims (stacked layer dims lead)
        k = min(len(template), nd)
        for i in range(k):
            t = template[len(template) - k + i]
            dim_idx = nd - k + i
            if t == "M" and policy.model_axis in axis_names \
                    and _fits(shape[dim_idx], mesh, policy.model_axis):
                spec[dim_idx] = policy.model_axis
        # vocab-shard fallback: embed [V, D] with V not divisible by the
        # model axis (internvl2's 151655) -> shard d_model instead
        if re.search(r"\['embed'\]$", path) and nd >= 2 \
                and spec[nd - 2] is None and template[-2] == "M" \
                and _fits(shape[nd - 1], mesh, policy.model_axis):
            spec[nd - 1] = policy.model_axis
    if policy.fsdp:
        axes = tuple(a for a in policy.fsdp_axes if a in axis_names)
        if axes:
            # shard the largest remaining unsharded dim over fsdp axes
            cands = [(shape[i], i) for i in range(nd)
                     if spec[i] is None and _fits(shape[i], mesh, axes)]
            if cands:
                _, idx = max(cands)
                spec[idx] = axes if len(axes) > 1 else axes[0]
    return P(*spec)


class Placements(tuple):
    """One DTensor placement per mesh dimension. A tuple subclass, so a
    tree of them keeps each as one leaf (``torch.utils._pytree``
    flattens a plain tuple)."""


def to_placements(spec: PartitionSpec, mesh) -> Placements:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: per mesh
    dimension, ``Shard(d)`` for the tensor dim ``d`` whose entry names
    it, else ``Replicate()``. A dim split over several axes gets a
    ``Shard`` on each of them (mesh order, major first)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            where[a] = d
    return Placements(Shard(where[a]) if a in where else Replicate()
                      for a in _axis_names(mesh))


def _shardings(tree, mesh, spec_fn):
    """``tree`` with each leaf replaced by its spec (dict mesh) or its
    placements (``DeviceMesh``); ``spec_fn(path, leaf) -> spec``."""
    flat, treedef = pytree.tree_flatten_with_path(tree)
    out = []
    for kp, leaf in flat:
        if leaf is None:
            out.append(None)
            continue
        spec = spec_fn(pytree.keystr(kp), leaf)
        out.append(spec if isinstance(mesh, dict)
                   else to_placements(spec, mesh))
    return pytree.tree_unflatten(out, treedef)


def param_shardings(abstract_params, cfg: ModelConfig, mesh,
                    policy: ShardingPolicy | None = None):
    """Tree of specs (dict mesh) or placements (``DeviceMesh``) aligned
    with the abstract param tree."""
    policy = policy or ShardingPolicy()
    return _shardings(abstract_params, mesh, lambda path, leaf:
                      spec_for_path(path, _shape(leaf), mesh, policy))


def batch_spec_for_shape(shape: tuple, mesh,
                         policy: ShardingPolicy | None = None
                         ) -> PartitionSpec:
    """Input rule as a pure shape function: batch (leading) dim over the
    batch axes, replicated when it does not divide."""
    policy = policy or ShardingPolicy()
    axes = tuple(a for a in policy.batch_axes if a in _axis_names(mesh))
    nd = len(shape)
    if nd == 0 or not axes or not _fits(shape[0], mesh, axes):
        return P()
    s = [axes if len(axes) > 1 else axes[0]] + [None] * (nd - 1)
    return P(*s)


def batch_shardings(batch_specs, mesh,
                    policy: ShardingPolicy | None = None):
    """Inputs: batch dim sharded over (pod, data)."""
    policy = policy or ShardingPolicy()
    return _shardings(batch_specs, mesh, lambda _path, leaf:
                      batch_spec_for_shape(_shape(leaf), mesh, policy))


def opt_spec_for_shape(shape: tuple, mesh,
                       policy: ShardingPolicy | None = None
                       ) -> PartitionSpec:
    """Optimizer-state rule as a pure shape function: the largest
    divisible dim goes on the model axis and (with fsdp) the next
    largest on the fsdp axes; scalars and non-divisible dims degrade
    gracefully to replication."""
    policy = policy or ShardingPolicy()
    axis_names = _axis_names(mesh)
    fsdp_axes = tuple(a for a in policy.fsdp_axes if a in axis_names)
    nd = len(shape)
    if nd == 0:
        return P()
    s: list = [None] * nd
    order = sorted(range(nd), key=lambda i: -shape[i])
    for i in order:
        if policy.model_axis in axis_names \
                and _fits(shape[i], mesh, policy.model_axis):
            s[i] = policy.model_axis
            break
    if fsdp_axes:
        for i in order:
            if s[i] is None and _fits(shape[i], mesh, fsdp_axes):
                s[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
    return P(*s)


def opt_state_shardings(abstract_opt_state, mesh,
                        policy: ShardingPolicy | None = None):
    """Optimizer state sharding: m/v mirror their parameter's
    dominant-dim layout; factored rows/cols and scalar counters degrade
    gracefully to replication (see :func:`opt_spec_for_shape`)."""
    policy = policy or ShardingPolicy()
    return _shardings(abstract_opt_state, mesh, lambda _path, leaf:
                      opt_spec_for_shape(_shape(leaf), mesh, policy))


# decode-state layouts by cache key: (batch_dim, model_dim_candidates)
# model_dim_candidates are tried in order with divisibility checks;
# for k/v the sequence dim (context parallelism) is the fallback when
# GQA kv-head counts (2-24) don't divide the 16-way model axis.
_CACHE_LAYOUTS = {
    "k": (1, (3, 2)),            # [L, B, S, Hkv, hd]: B; Hkv else S
    "v": (1, (3, 2)),
    "mamba_h": (2, (3,)),        # [P, n, B, d_inner, N]: B; d_inner
    "mamba_conv": (2, (4,)),     # [P, n, B, K, d_inner]: B; d_inner
    "mlstm_C": (2, (5, 4)),      # [P, n, B, H, dk, dv]: B; dv else dk
    "mlstm_n": (2, (4,)),        # [P, n, B, H, dk]: B; dk
    "mlstm_m": (2, ()),          # [P, n, B, H]: B
    "slstm": (2, (3,)),          # [P, 4, B, D]: B; D
}


def cache_spec_for(path: str, shape: tuple, mesh,
                   policy: ShardingPolicy | None = None) -> PartitionSpec:
    """Spec for one decode-state leaf (layouts above): batch over (pod,
    data); the widest feature dim over model; KV caches fall back to
    sequence (context-parallel) sharding when kv-heads don't divide."""
    policy = policy or ShardingPolicy()
    axis_names = _axis_names(mesh)
    baxes = tuple(a for a in policy.batch_axes if a in axis_names)
    bspec = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    nd = len(shape)
    s: list = [None] * nd
    layout = None
    for name, lay in _CACHE_LAYOUTS.items():
        if f"'{name}'" in path:
            layout = lay
            break
    if layout is not None:
        bdim, mdims = layout
        if bdim < nd and bspec is not None \
                and _fits(shape[bdim], mesh, baxes):
            s[bdim] = bspec
        if policy.model_axis in axis_names:
            for md in mdims:
                if md < nd and s[md] is None \
                        and _fits(shape[md], mesh, policy.model_axis):
                    s[md] = policy.model_axis
                    break
    return P(*s)


def cache_shardings(abstract_cache, mesh,
                    policy: ShardingPolicy | None = None):
    """Specs or placements for a decode-state tree (see
    :func:`cache_spec_for`)."""
    policy = policy or ShardingPolicy()
    return _shardings(abstract_cache, mesh, lambda path, leaf:
                      cache_spec_for(path, _shape(leaf), mesh, policy))


# ---------------------------------------------------------------------------
# spec-driven per-device factors (paper §6.2)
def spec_factor(spec, shape: tuple, mesh) -> float:
    """Division factor a spec implies for a tensor's bytes.

    Per-device elements are ``prod(ceil(dim / axes))``; the factor is
    ``global / per_device``. Because every rule above drops an axis that
    does not divide its dim, the ceil is exact in practice; it is kept
    so a hand-written non-divisible spec *under*-counts the factor
    (over-estimates per-device bytes) instead of the reverse: the safe
    direction for the paper's OOM-threshold guarantee."""
    if not shape:
        return 1.0
    glob = 1
    per_dev = 1
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, assigned in zip(shape, entries):
        dim = int(dim)
        glob *= dim
        if assigned is None:
            per_dev *= dim
            continue
        axes = assigned if isinstance(assigned, tuple) else (assigned,)
        total = 1
        for a in axes:
            total *= _axis_size(mesh, a)
        per_dev *= -(-dim // total) if total else dim
    if per_dev <= 0:
        return 1.0
    return glob / per_dev


class SpecShardFactors:
    """xMem hook: BlockLifecycle -> division factor, resolved from the
    specs the sharding engine would place.

    * PARAM / GRAD / OUTPUT / ``grad_upcast`` temps: matched by shape
      against the resolved per-leaf param specs (gradients and fresh
      params mirror their parameter's sharding). Ambiguous shapes take
      the **least-sharded** matching leaf: replication is the
      conservative direction for a safe OOM threshold.
    * OPT_STATE: :func:`opt_spec_for_shape` on the block's shape.
    * INPUT: :func:`batch_spec_for_shape`.
    * CACHE: matched against the decode-state tree's resolved
      :func:`cache_spec_for` specs when a cache tree is supplied.
    * ACTIVATION / TEMP: batch-dim sharding when the leading dim divides
      the batch axes AND is a multiple of the traced global batch, plus
      propagation from producing weights: an activation whose trailing
      dim equals the *output width* of a column-parallel
      (model-axis-on-last-dim) weight inherits that model sharding, iff
      the width divides the axis.
    * COLLECTIVE: 1.0 (injected buffers are already per-device).

    Blocks without shape metadata resolve by exact byte-size match
    against the param leaves, else replicate: never a blanket divisor,
    so the divisibility fallbacks cannot be bypassed.
    """

    def __init__(self, mesh, policy: ShardingPolicy | None = None, *,
                 params=None, opt_state=None, batch=None, cache=None):
        from ..core.events import BlockKind
        self._BK = BlockKind            # bound once: __call__ is per-block
        policy = policy or ShardingPolicy()
        self.mesh = dict(mesh) if isinstance(mesh, dict) else {
            a: _axis_size(mesh, a) for a in _axis_names(mesh)}
        self.policy = policy
        self.model = _axis_size(mesh, policy.model_axis)
        self.data_total = 1
        for a in policy.batch_axes:
            self.data_total *= _axis_size(mesh, a)

        # resolved param specs -> factor per shape (min = least sharded)
        self.param_factor_by_shape: dict[tuple, float] = {}
        self.param_factor_by_size: dict[int, float] = {}
        self.model_widths: set[int] = set()
        if params is not None:
            for path, leaf in _leaves_with_path(params):
                shape = _shape(leaf)
                spec = spec_for_path(path, shape, self.mesh, policy)
                f = spec_factor(spec, shape, self.mesh)
                prev = self.param_factor_by_shape.get(shape)
                self.param_factor_by_shape[shape] = \
                    f if prev is None else min(prev, f)
                nbytes = _leaf_bytes(leaf)
                if nbytes:
                    prevs = self.param_factor_by_size.get(nbytes)
                    self.param_factor_by_size[nbytes] = \
                        f if prevs is None else min(prevs, f)
                # column-parallel output widths: model axis on last dim
                entries = tuple(spec)
                if shape and len(entries) == len(shape):
                    last = entries[-1]
                    axes = last if isinstance(last, tuple) else (last,)
                    if last is not None and policy.model_axis in axes:
                        self.model_widths.add(shape[-1])
        self.opt_factor_by_shape: dict[tuple, float] = {}
        if opt_state is not None:
            for _path, leaf in _leaves_with_path(opt_state):
                shape = _shape(leaf)
                self.opt_factor_by_shape.setdefault(
                    shape, self._opt_factor(shape))
        # traced global batch extents (leading dims of the batch leaves)
        self.batch_extents: set[int] = set()
        if batch is not None:
            for _path, leaf in _leaves_with_path(batch):
                shape = getattr(leaf, "shape", ())
                if len(shape):
                    self.batch_extents.add(int(shape[0]))
        self.cache_factor_by_shape: dict[tuple, float] = {}
        if cache is not None:
            for path, leaf in _leaves_with_path(cache):
                shape = _shape(leaf)
                spec = cache_spec_for(path, shape, self.mesh, policy)
                f = spec_factor(spec, shape, self.mesh)
                prev = self.cache_factor_by_shape.get(shape)
                self.cache_factor_by_shape[shape] = \
                    f if prev is None else min(prev, f)

    # -- per-kind resolution -------------------------------------------------
    def _opt_factor(self, shape: tuple) -> float:
        return spec_factor(
            opt_spec_for_shape(shape, self.mesh, self.policy), shape,
            self.mesh)

    def _param_like(self, block) -> float:
        shape = block.shape
        if shape is not None:
            f = self.param_factor_by_shape.get(tuple(shape))
            if f is not None:
                return f
            return 1.0
        return self.param_factor_by_size.get(block.size, 1.0)

    def _activation(self, block) -> float:
        shape = block.shape
        if shape is None:
            return 1.0
        f = 1.0
        nd = len(shape)
        if nd and self.data_total > 1 and shape[0] % self.data_total == 0 \
                and (not self.batch_extents
                     or any(b and shape[0] % b == 0
                            for b in self.batch_extents)):
            f *= self.data_total
        if nd >= 2 and self.model > 1 and shape[-1] in self.model_widths \
                and shape[-1] % self.model == 0:
            f *= self.model
        return f

    def __call__(self, block) -> float:
        BlockKind = self._BK
        k = block.block_kind
        if k is BlockKind.PARAM or k is BlockKind.GRAD:
            return self._param_like(block)
        if k is BlockKind.OUTPUT:
            shape = block.shape
            if shape is not None:
                f = self.param_factor_by_shape.get(tuple(shape))
                if f is not None:
                    return f
                of = self.opt_factor_by_shape.get(tuple(shape))
                return of if of is not None else 1.0
            return self.param_factor_by_size.get(block.size, 1.0)
        if k is BlockKind.OPT_STATE:
            shape = block.shape
            if shape is not None:
                shape = tuple(shape)
                f = self.opt_factor_by_shape.get(shape)
                return f if f is not None else self._opt_factor(shape)
            return self.param_factor_by_size.get(block.size, 1.0)
        if k is BlockKind.INPUT:
            shape = block.shape
            if shape is None:
                return 1.0
            return spec_factor(
                batch_spec_for_shape(tuple(shape), self.mesh, self.policy),
                tuple(shape), self.mesh)
        if k is BlockKind.CACHE:
            shape = block.shape
            if shape is not None:
                return self.cache_factor_by_shape.get(tuple(shape), 1.0)
            return 1.0
        if k is BlockKind.ACTIVATION or k is BlockKind.TEMP:
            if block.op == "grad_upcast":     # f32 grad copies shard as grads
                return self._param_like(block)
            return self._activation(block)
        return 1.0


def _leaf_bytes(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _heuristic_factor_fn(cfg: ModelConfig, mesh,
                         policy: ShardingPolicy | None = None):
    """The pre-spec scalar heuristic, kept as an explicit opt-in
    (``mode="heuristic"``). It assumes perfect divisibility and applies
    model*fsdp uniformly: an *underestimate* whenever a vocab / kv-head
    / expert dim does not divide an axis; kept only for comparisons."""
    from ..core.events import BlockKind
    policy = policy or ShardingPolicy()
    model = _axis_size(mesh, policy.model_axis)
    data = 1
    for a in policy.batch_axes:
        data *= _axis_size(mesh, a)
    fsdp = 1
    if policy.fsdp:
        for a in policy.fsdp_axes:
            fsdp *= _axis_size(mesh, a)

    # Large intermediates (FFN/expert projections, logits) inherit the
    # model-axis sharding of the weights that produce them; small ones
    # (norms, gates) stay data-sharded only. 64 MiB global is the
    # reference's crossover.
    big_activation = 64 * 2**20

    def factor(block) -> float:
        k = block.block_kind
        if k in (BlockKind.PARAM, BlockKind.GRAD, BlockKind.OPT_STATE,
                 BlockKind.OUTPUT):
            return float(model * fsdp)
        if k in (BlockKind.ACTIVATION, BlockKind.TEMP, BlockKind.CACHE):
            if block.size >= big_activation:
                return float(data * model)
            return float(data)
        if k is BlockKind.INPUT:
            return float(data)
        return 1.0

    return factor


def shard_factor_fn(cfg: ModelConfig, mesh,
                    policy: ShardingPolicy | None = None, *,
                    mode: str = "spec", params=None, opt_state=None,
                    batch=None, cache=None):
    """xMem hook: BlockLifecycle -> division factor for per-device sizes.

    ``mode="spec"`` (default) resolves each block's factor from the spec
    the rule engine would place, honoring every divisibility fallback.
    ``params``/``opt_state``/``batch``/``cache`` are abstract trees
    (``meta`` tensors) used to resolve leaf specs; ``params`` defaults
    to the port's ``abstract_params(cfg)``.

    ``mode="heuristic"`` is the pre-spec scalar path (explicit opt-in).
    """
    if mode == "heuristic":
        return _heuristic_factor_fn(cfg, mesh, policy)
    if mode != "spec":
        raise ValueError(f"unknown shard_factors mode {mode!r}")
    if params is None and cfg is not None:
        from ..models import model as M
        params = M.abstract_params(cfg)
    return SpecShardFactors(mesh, policy, params=params,
                            opt_state=opt_state, batch=batch, cache=cache)


def mesh_collective_specs(mesh, policy: ShardingPolicy | None = None):
    """Per-mesh-axis staging buffers for the orchestrator's collective
    injection, sized from the sharded tensors (the dynamic ``source``
    field is resolved by ``MemoryOrchestrator.inject_collectives``
    against the composition's per-device block sizes):

    * every data/batch axis: gradient all-reduce staging (largest
      per-device gradient block) at the end of fwd/bwd; skipped on axes
      that are also fsdp axes, where ZeRO's reduce-scatter replaces the
      all-reduce;
    * every fsdp axis (ZeRO-3): parameter all-gather working buffer
      (largest per-device param, unsharded along the axis: scale = axis
      size) spanning fwd/bwd, plus a gradient reduce-scatter staging
      buffer at its end;
    * the model axis: TP activation all-gather temporary (largest
      per-device activation, unsharded along the axis).
    """
    from ..core.events import Phase
    from ..core.orchestrator import CollectiveSpec
    policy = policy or ShardingPolicy()
    axis_names = _axis_names(mesh)
    specs: list[CollectiveSpec] = []
    fsdp_axes = set(policy.fsdp_axes) if policy.fsdp else set()
    for a in policy.batch_axes:
        if a in axis_names and _axis_size(mesh, a) > 1 \
                and a not in fsdp_axes:
            specs.append(CollectiveSpec(
                f"grad_allreduce[{a}]", 0, Phase.FORWARD_BACKWARD,
                at="phase_end", axis=a, collective="all_reduce",
                source="grads"))
    if policy.fsdp:
        for a in policy.fsdp_axes:
            if a in axis_names and _axis_size(mesh, a) > 1:
                n = _axis_size(mesh, a)
                specs.append(CollectiveSpec(
                    f"param_allgather[{a}]", 0, Phase.FORWARD_BACKWARD,
                    at="phase_start", axis=a, collective="all_gather",
                    source="params", scale=float(n)))
                specs.append(CollectiveSpec(
                    f"grad_reducescatter[{a}]", 0, Phase.FORWARD_BACKWARD,
                    at="phase_end", axis=a, collective="reduce_scatter",
                    source="grads"))
    m = policy.model_axis
    if m in axis_names and _axis_size(mesh, m) > 1:
        specs.append(CollectiveSpec(
            f"tp_allgather[{m}]", 0, Phase.FORWARD_BACKWARD,
            at="phase_start", axis=m, collective="all_gather",
            source="activations", scale=float(_axis_size(mesh, m))))
    return tuple(specs)

"""Dynamic memory tracing of PyTorch programs on the CPU (paper stage 1).

The paper profiles the first iterations of a job with the PyTorch
profiler and rebuilds the memory-event stream from it. Here the real
eager step runs under ``FakeTensorMode``, so every tensor has its shape,
dtype and strides but no memory, and a ``TorchDispatchMode`` records the
stream as the ops run:

* an **alloc** when an op's output owns a storage the tracer has not
  seen, sized by the storage's bytes;
* a **free** when that storage dies: a ``weakref.finalize`` on the fake
  storage fires when the last tensor using it goes away, which is when
  the CUDA caching allocator would get the block back;
* views (``view``, ``t``, ``transpose``, ``select``, ``slice``,
  ``detach``) and in-place ops (``copy_``, ``index_put_``, ``add_``)
  return a storage the tracer already knows, and allocate nothing;
* the buffers some CUDA kernels allocate and free inside one op, which
  the fake kernels do not (``_KERNEL_TEMPS``), as short-lived blocks
  after the op's outputs, or before them and freed after them where the
  op stages its work in them (``_KERNEL_STAGING``).

The inputs (params, cache, batch, grads, optimizer state) are
registered before the step runs, pinned and kinded; the step's outputs
are pinned afterwards, as the JAX package's tracer does, and both are
kept as the phase's input and output blocks, which the estimator's
N-iteration composition places by. The columns are the same
``ColumnarTrace`` columns, so the rest of the pipeline (lifecycles,
orchestrator, allocator replay) is shared code.

Training steps trace with grad mode on (``trace_fn(grad=True)``). The
autograd engine runs the backward under the same mode stack, so the
backward's ops (recomputed checkpointed forwards included) are recorded
too; blocks allocated while the engine runs
(``torch._C._current_graph_task_id() != -1``) get the scope
``backward``, which ``analyzer.classify_blocks`` reads as the JAX
package's ``transpose(...)`` scopes. Saved activations are freed when
``torch.autograd.grad`` releases the graph, which gives them their
backward lifetimes.

A sharded step (DTensor parameters and inputs, ``distributed/
program.py``) is traced as rank 0's local program: the tracer lets
DTensor dispatch every op that has a DTensor argument
(``NotImplemented``) and records the ops DTensor then runs on the local
shards, collectives included. A collective's output (the
``_c10d_functional`` op's) is a new storage, so an allocation; its
``wait_tensor`` returns the same storage, so it allocates nothing. The
ops DTensor's sharding propagation runs at global shapes to learn an
output's shape (``ShardingPropagator``'s tensor-meta pass) are run and
not recorded (``_PROPAGATING``). A shard moved from one tensor dim to
another over a mesh dim (the expert stacks' gradients into their
optimizer state's layout) is traced as the card runs it, one
``_dtensor::shard_dim_alltoall`` with its staging buffers, not as the
all-gather and chunk DTensor falls back to on a CPU mesh. A
trace with no DTensor in it is recorded exactly as before.

Nothing is allocated and no device is touched: a full-width step traces
in seconds on a machine with no GPU. The fake tensors live on the CPU
device; the ops the port's step runs are the same on either device, and
the attention kernel is one custom op whose fake implementation
allocates only its output.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .events import (KIND_CODE, PHASE_CODE, BlockKind, BlockLifecycle,
                     ColumnarTrace, Phase, StringInterner, Trace)


def _softmax_backward_temps(grad, output, dim, input_dtype):
    """CUDA's softmax backward computes ``tmp = grad * output`` (laid out
    like ``grad``) and makes ``tmp`` contiguous when it is not."""
    n = output.numel() * torch.promote_types(grad.dtype,
                                             output.dtype).itemsize
    return [n] if grad.is_contiguous() else [n, n]


def _bool_sum_temps(x, *args, **kwargs):
    """CUDA's sum of a bool tensor casts it to int64 first."""
    return [x.numel() * 8] if x.dtype == torch.bool else []


def _alltoall_staging(x, gather_dim, shard_dim, group_name):
    """The shard-dim all-to-all (``_dtensor::shard_dim_alltoall``) stages
    its input in two buffers of the input's size (the chunks laid out
    for the exchange, and the exchange's receive buffer) before its
    output, and frees them after it, the second first: read off the
    card's allocator requests (torch 2.11, one 1,258,291,200 B f32 move
    over a group of 4). Returns (sizes in allocation order, the order
    they are freed in)."""
    size = x.numel() * x.element_size()
    return [size, size], [1, 0]


def _sort_temps(x, *args, **kwargs):
    """CUDA's sort (stable or not: one kernel) of the 1-D int64 keys the
    MoE dispatch sorts: an int64 identity permutation (``8 n`` B), and,
    past 4096 elements (shorter ones sort in place in shared memory),
    cub's radix-sort temp storage: an alternate key and value buffer
    (``8 n`` B each, 256-B aligned), 1 KiB of look-back state for each
    tile of 4608 elements, 16 KiB of digit bins, 256 B of counters and
    255 B of alignment slack."""
    n = x.numel()
    if x.ndim != 1 or x.dtype != torch.int64:
        return []
    if n <= 4096:
        return [8 * n]
    alt = -(-8 * n // 256) * 256
    return [8 * n, 2 * alt + 1024 * -(-n // 4608) + 16384 + 256 + 255]


# Device buffers that torch's CUDA kernels allocate inside an op and free
# before it returns: the fake kernels allocate only the outputs, so the
# tracer adds these after them. Each rule gives the buffers' bytes from
# the op's arguments. Read off the card's allocator history (torch
# 2.11); not modeled: the staging buffers of split reductions, which
# depend on the launch configuration, and the embedding backward's.
_KERNEL_TEMPS = {
    torch.ops.aten._softmax_backward_data.default: _softmax_backward_temps,
    torch.ops.aten.sum.default: _bool_sum_temps,
    torch.ops.aten.sum.dim_IntList: _bool_sum_temps,
    torch.ops.aten.sort.stable: _sort_temps,
    torch.ops.aten.sort.default: _sort_temps,
}
# Device buffers an op's CUDA kernel stages its work in: made before its
# output and freed after it. Each rule gives (the buffers' bytes in the
# order they are made, the order they are freed in) from the op's
# arguments.
_KERNEL_STAGING = {}
try:
    _KERNEL_STAGING[torch.ops._dtensor.shard_dim_alltoall.default] = \
        _alltoall_staging
except (AttributeError, RuntimeError):     # no distributed build
    pass


try:
    _WAIT_TENSOR = torch.ops._c10d_functional.wait_tensor.default
except (AttributeError, RuntimeError):     # no distributed build
    _WAIT_TENSOR = None

#: depth of DTensor's tensor-meta propagation on this thread: its ops
#: run at global shapes and are not the rank's (see ``_watch_dtensor``)
_PROPAGATING = threading.local()
_DTENSOR_TYPES: frozenset | None = None


def _propagating() -> bool:
    return getattr(_PROPAGATING, "n", 0) > 0


def _watch_dtensor() -> frozenset:
    """The DTensor type (to hand its ops back to DTensor) and, once per
    process, a wrapper around ``ShardingPropagator``'s uncached
    tensor-meta pass that marks the thread while it runs, and one around
    DTensor's shard-dim all-to-all that runs the card's op on fake
    tensors (``_card_alltoall``)."""
    global _DTENSOR_TYPES
    if _DTENSOR_TYPES is None:
        try:
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
        except ImportError:        # a torch built without distributed
            _DTENSOR_TYPES = frozenset()
            return _DTENSOR_TYPES
        inner = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(self, *args, **kwargs):
            _PROPAGATING.n = getattr(_PROPAGATING, "n", 0) + 1
            try:
                return inner(self, *args, **kwargs)
            finally:
                _PROPAGATING.n -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        _card_alltoall()
        _DTENSOR_TYPES = frozenset({DTensor})
    return _DTENSOR_TYPES


@dataclasses.dataclass
class _Block:
    bid: int
    size: int
    pinned: bool = False
    kind: BlockKind = BlockKind.ACTIVATION
    alloc_t: int = 0
    free_t: int | None = None
    op: str = ""
    scope: str = ""
    shape: tuple | None = None
    refs: int = 1                  # live storages that hold the block


def _card_alltoall() -> None:
    """DTensor moves a shard from one tensor dim to another over a mesh
    dim with the op ``_dtensor::shard_dim_alltoall`` on a card's mesh and
    with an all-gather and a chunk on a CPU mesh (gloo has no
    all-to-all), which holds the whole gathered tensor. A traced rank
    runs on a CPU mesh and fake tensors: there it runs the card's op
    (whose fake kernel gives the output; ``_KERNEL_STAGING`` its
    staging buffers). Real tensors keep DTensor's own path."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types
    on_cpu = placement_types.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if not isinstance(input, FakeTensor):
            return on_cpu(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    placement_types.shard_dim_alltoall = shard_dim_alltoall


class TorchMemoryTracer(TorchDispatchMode):
    """Records the alloc/free stream of the ops dispatched under it."""

    def __init__(self, phase: Phase = Phase.FORWARD_BACKWARD,
                 iteration: int = 0):
        super().__init__()
        self.phase = phase
        self.iteration = iteration
        self._ev_kind: list[int] = []    # 1 = alloc, 0 = free
        self._ev_bid: list[int] = []
        self._ev_size: list[int] = []
        self._ev_t: list[int] = []
        self._ev_op: list[int] = []
        self._ev_scope: list[int] = []
        self._ev_bkind: list[int] = []
        self._ev_shape: list[int] = []
        self._ops = StringInterner()
        self._scopes = StringInterner()
        self._shapes = StringInterner([None])
        self.t = 0
        self.blocks: dict[int, _Block] = {}
        self.input_blocks: list[_Block] = []
        self.output_blocks: list[_Block] = []
        # storage identity (StorageImpl address) -> live block
        self._live: dict[int, _Block] = {}
        self._finalizers: dict[int, weakref.finalize] = {}
        self._op = ""
        self._closed = False
        # a depth probe's unit of each event (``core/depth.py``): called
        # once an event, its values kept in ``labels``
        self.labeller: Callable[[], int] | None = None
        self.labels: list[int] = []
        # a step probe's step of each event (``core/loops.py``)
        self.step_labeller: Callable[[], int] | None = None
        self.step_labels: list[int] = []
        self._dtensor = _watch_dtensor()

    @property
    def num_events(self) -> int:
        return len(self._ev_kind)

    # ---- event columns ----------------------------------------------------
    def _emit(self, alloc: bool, b: _Block, op: str) -> None:
        self._ev_kind.append(1 if alloc else 0)
        self._ev_bid.append(b.bid)
        self._ev_size.append(b.size)
        self._ev_t.append(self.t)
        self._ev_op.append(self._ops.intern(op))
        self._ev_scope.append(self._scopes.intern(b.scope))
        self._ev_bkind.append(KIND_CODE[b.kind])
        self._ev_shape.append(self._shapes.intern(b.shape))
        if self.labeller is not None:
            self.labels.append(self.labeller())
        if self.step_labeller is not None:
            self.step_labels.append(self.step_labeller())
        self.t += 1

    def _new_block(self, t: torch.Tensor, op: str, kind: BlockKind,
                   scope: str = "", pinned: bool = False) -> _Block:
        st = t.untyped_storage()
        b = _Block(len(self.blocks), int(st.nbytes()), pinned, kind,
                   alloc_t=self.t, op=op, scope=scope,
                   shape=tuple(int(d) for d in t.shape))
        self.blocks[b.bid] = b
        self._live[st._cdata] = b
        self._emit(True, b, op)
        return b

    def _on_free(self, key: int) -> None:
        if self._closed:
            return
        self._finalizers.pop(key, None)
        b = self._live.pop(key, None)
        if b is None or b.pinned:
            return
        b.refs -= 1
        if b.refs:
            return                 # another storage still holds it
        b.free_t = self.t
        self._emit(False, b, self._op)

    # ---- registration -----------------------------------------------------
    def register(self, t: torch.Tensor, kind: BlockKind, scope: str) -> None:
        """A step input: pinned, kinded, alive before the step starts."""
        if t.untyped_storage()._cdata in self._live:
            return   # a second view of an input already registered
        self.input_blocks.append(
            self._new_block(t, "input", kind, scope, pinned=True))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._dtensor and not self._dtensor.isdisjoint(types):
            return NotImplemented       # DTensor runs it on the shards
        if _propagating():
            return func(*args, **(kwargs or {}))
        self._op = func._schema.name
        out = func(*args, **(kwargs or {}))
        if func is _WAIT_TENSOR:
            self._alias(out, args[0])
            return out
        scope = ("backward" if torch._C._current_graph_task_id() != -1
                 else "")
        staging = _KERNEL_STAGING.get(func)
        if staging is not None:
            sizes, free_order = staging(*args)
            staged = [self._temp(size, scope) for size in sizes]
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or st.nbytes() == 0:
                continue   # a view, an in-place result, or nothing
            self._new_block(t, self._op, BlockKind.ACTIVATION, scope)
            self._finalizers[key] = weakref.finalize(st, self._on_free, key)
        if staging is not None:
            for i in free_order:
                staged[i].free_t = self.t
                self._emit(False, staged[i], self._op)
        rule = _KERNEL_TEMPS.get(func)
        if rule is not None:
            temps = [_Block(len(self.blocks) + i, size, kind=BlockKind.TEMP,
                            alloc_t=self.t, op=self._op, scope=scope)
                     for i, size in enumerate(rule(*args))]
            for b in temps:
                self.blocks[b.bid] = b
                self._emit(True, b, self._op)
            for b in temps:
                b.free_t = self.t
                self._emit(False, b, self._op)
        return out

    def _temp(self, size: int, scope: str) -> _Block:
        """A kernel's staging buffer of ``size`` bytes, allocated now."""
        b = _Block(len(self.blocks), size, kind=BlockKind.TEMP,
                   alloc_t=self.t, op=self._op, scope=scope)
        self.blocks[b.bid] = b
        self._emit(True, b, self._op)
        return b

    def _alias(self, out, src) -> None:
        """``out`` holds ``src``'s block: a collective's wait returns its
        input (on the card the same storage; a fake wait may make a new
        one, which allocates nothing)."""
        key = out.untyped_storage()._cdata
        b = self._live.get(src.untyped_storage()._cdata)
        if key in self._live or b is None:
            return
        b.refs += 1
        self._live[key] = b
        self._finalizers[key] = weakref.finalize(out.untyped_storage(),
                                                 self._on_free, key)

    def finish(self, out,
               out_kinds: Sequence[BlockKind] | None = None) -> Trace:
        """Pin the step's outputs and close the stream. ``out_kinds``
        gives the kind of each tensor leaf of ``out`` (default
        ``OUTPUT``)."""
        leaves = [t for t in pytree.tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
        for i, t in enumerate(leaves):
            b = self._live.get(t.untyped_storage()._cdata)
            if b is None or b.pinned:
                continue   # an input (e.g. the cache updated in place)
            b.pinned = True
            b.kind = out_kinds[i] if out_kinds is not None \
                else BlockKind.OUTPUT
            self.output_blocks.append(b)
        self._closed = True
        for fin in self._finalizers.values():
            fin.detach()
        self._finalizers.clear()
        # rewrite the kind column of the pinned outputs' alloc events
        kinds = np.asarray(self._ev_bkind, dtype=np.uint8)
        bids = np.asarray(self._ev_bid, dtype=np.int64)
        for b in self.output_blocks:
            kinds[bids == b.bid] = KIND_CODE[b.kind]
        n = self.num_events
        columns = ColumnarTrace.from_columns(
            self._ev_kind, self._ev_bid, self._ev_size, self._ev_t,
            np.full(n, self.iteration, dtype=np.int64),
            np.full(n, PHASE_CODE[self.phase], dtype=np.uint8),
            self._ev_op, self._ev_scope, kinds,
            self._ops.table, self._scopes.table,
            self._ev_shape, self._shapes.table,
            np.zeros(n, dtype=np.uint8))
        return Trace.from_columnar(columns, num_iterations=1,
                                   meta={"phase": self.phase.value})

    def lifecycles(self) -> list[BlockLifecycle]:
        """BlockLifecycle records straight from the tracer's blocks
        (pinned and unfreed blocks are persistent)."""
        return [BlockLifecycle(b.bid, b.size, b.alloc_t, b.free_t,
                               self.iteration, self.phase, b.op, b.scope,
                               b.kind, 1.0, b.shape)
                for b in self.blocks.values()]


def _fake_like(t: torch.Tensor, device="cpu") -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device=device)


def aval_bytes(t: torch.Tensor) -> int:
    """Bytes of the block ``trace_fn`` registers for the input ``t``:
    the storage of a fresh tensor of its shape and strides."""
    return int(_fake_like(t, "meta").untyped_storage().nbytes())


def trace_fn(fn: Callable, *args, arg_kinds: Sequence[BlockKind] | None = None,
             arg_scopes: Sequence[str] | None = None,
             phase: Phase = Phase.FORWARD_BACKWARD, iteration: int = 0,
             grad: bool = False,
             out_kind_fn: Callable | None = None,
             labeller: Callable[[], int] | None = None,
             step_labeller: Callable[[], int] | None = None
             ) -> tuple[Trace, TorchMemoryTracer, object]:
    """Trace ``fn(*args)`` into a memory-event stream without running it.

    ``args`` are pytrees of tensors (real, ``meta`` or any device: only
    shape, strides and dtype are read). ``arg_kinds``/``arg_scopes`` are
    flat lists aligned with the flattened arguments (see
    ``estimator.flatten_kinds``). ``grad`` runs the step with grad mode
    on (a training step that calls ``torch.autograd.grad``); serving
    steps run under ``torch.no_grad()``. ``out_kind_fn(out)`` gives the
    kinds of the output's tensor leaves. ``labeller()`` labels each
    event with its unit (``tracer.labels``), ``step_labeller()`` with its
    step (``tracer.step_labels``). Returns ``(trace, tracer, out)`` where
    ``out`` holds the step's outputs as fake tensors."""
    leaves, spec = pytree.tree_flatten(args)
    mode = FakeTensorMode()
    tr = TorchMemoryTracer(phase=phase, iteration=iteration)
    tr.labeller = labeller
    tr.step_labeller = step_labeller
    with mode:
        fakes = [_fake_like(t) if isinstance(t, torch.Tensor) else t
                 for t in leaves]
    for i, t in enumerate(fakes):
        if isinstance(t, torch.Tensor):
            kind = arg_kinds[i] if arg_kinds is not None else BlockKind.INPUT
            scope = arg_scopes[i] if arg_scopes is not None else f"arg{i}"
            tr.register(t, kind, scope)
    fake_args = pytree.tree_unflatten(fakes, spec)
    del fakes
    with torch.set_grad_enabled(grad), mode, tr:
        out = fn(*fake_args)
    trace = tr.finish(out, out_kind_fn(out) if out_kind_fn else None)
    return trace, tr, out

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
* views (``view``, ``t``, ``transpose``, ``select``, ``slice``) and
  in-place ops (``copy_``, ``index_put_``, ``add_``) return a storage
  the tracer already knows, and allocate nothing.

The inputs (params, cache, batch) are registered before the step runs,
pinned and kinded (PARAM / CACHE / INPUT); the step's outputs are pinned
afterwards, as the JAX package's tracer does. The columns are the same
``ColumnarTrace`` columns, so the rest of the pipeline (lifecycles,
orchestrator, allocator replay) is shared code.

Nothing is allocated and no device is touched: a full-width step traces
in seconds on a machine with no GPU. The fake tensors live on the CPU
device; the ops the port's step runs are the same on either device, and
the attention kernel is one custom op whose fake implementation
allocates only its output.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .events import (KIND_CODE, PHASE_CODE, BlockKind, BlockLifecycle,
                     ColumnarTrace, Phase, StringInterner, Trace)


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
        self.output_blocks: list[_Block] = []
        # storage identity (StorageImpl address) -> live block
        self._live: dict[int, _Block] = {}
        self._finalizers: dict[int, weakref.finalize] = {}
        self._op = ""
        self._closed = False

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
        b.free_t = self.t
        self._emit(False, b, self._op)

    # ---- registration -----------------------------------------------------
    def register(self, t: torch.Tensor, kind: BlockKind, scope: str) -> None:
        """A step input: pinned, kinded, alive before the step starts."""
        if t.untyped_storage()._cdata in self._live:
            return   # a second view of an input already registered
        self._new_block(t, "input", kind, scope, pinned=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._schema.name
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or st.nbytes() == 0:
                continue   # a view, an in-place result, or nothing
            self._new_block(t, self._op, BlockKind.ACTIVATION)
            self._finalizers[key] = weakref.finalize(st, self._on_free, key)
        return out

    def finish(self, out) -> Trace:
        """Pin the step's outputs and close the stream."""
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            b = self._live.get(t.untyped_storage()._cdata)
            if b is None or b.pinned:
                continue   # an input (e.g. the cache updated in place)
            b.pinned = True
            b.kind = BlockKind.OUTPUT
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


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device="cpu")


def trace_fn(fn: Callable, *args, arg_kinds: Sequence[BlockKind] | None = None,
             arg_scopes: Sequence[str] | None = None,
             phase: Phase = Phase.FORWARD_BACKWARD, iteration: int = 0
             ) -> tuple[Trace, TorchMemoryTracer, object]:
    """Trace ``fn(*args)`` into a memory-event stream without running it.

    ``args`` are pytrees of tensors (real, ``meta`` or any device: only
    shape, strides and dtype are read). ``arg_kinds``/``arg_scopes`` are
    flat lists aligned with the flattened arguments (see
    ``estimator.flatten_kinds``). Returns ``(trace, tracer, out)`` where
    ``out`` holds the step's outputs as fake tensors."""
    leaves, spec = pytree.tree_flatten(args)
    mode = FakeTensorMode()
    tr = TorchMemoryTracer(phase=phase, iteration=iteration)
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
    with torch.no_grad(), mode, tr:
        out = fn(*fake_args)
    trace = tr.finish(out)
    return trace, tr, out

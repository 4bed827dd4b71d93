"""Memory-event and lifecycle data structures for the xMem pipeline.

These mirror the entities in the paper (§2.2, §3.2):

* ``MemoryEvent`` — one allocation or deallocation, in *execution order*.
  The paper reconstructs these from PyTorch-profiler ``cpu_instant_event``
  rows; we emit them directly from the jaxpr interpreter (``tracer.py``)
  or reconstruct them from an external JSON trace (``analyzer.py``).
* ``BlockLifecycle`` — a reconstructed memory block: size + alloc/free
  position + attribution to the operator / layer scope that produced it.
  "Memory block" throughout this codebase refers to these entities,
  exactly as in the paper.
* ``Trace`` — an ordered event stream plus metadata (iteration boundaries,
  phases), the unit of data handed between pipeline stages.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Iterable, Sequence

import numpy as np

#: On-disk trace schema. v1 = seed format (no version field, object event
#: list). v2 adds the version field, columnar payloads and phase/iteration
#: metadata for columnar traces. v3 adds per-block shape metadata (the
#: spec-driven per-device estimation input); v2 dumps load with shapes
#: unknown. v4 adds the memory-space column (host-offload semantics);
#: v3 dumps load with every event in DEVICE_HBM. v5 marks the
#: request-driven composition era (``ComposedBlocks`` workloads: periodic
#: training iterations AND continuous-batching request timelines compile
#: to the same replay currency); per-event payloads are unchanged, so v4
#: and v3 dumps load bit-identically. Loaders accept <= current, reject
#: newer.
TRACE_SCHEMA_VERSION = 5


class MemorySpace(enum.Enum):
    """Which physical memory a block resides in (multi-space model).

    DEVICE_HBM is the accelerator memory every pre-v4 trace implicitly
    assumed; the host spaces exist for offload semantics (optimizer
    state / activations parked on the host between uses, staged back
    via ``fetch_in`` transfer blocks). HOST_PINNED is page-locked
    memory (DMA-able, the space real offload implementations use);
    HOST_PAGEABLE models plain malloc-backed host memory.
    """

    DEVICE_HBM = "device_hbm"
    HOST_PINNED = "host_pinned"
    HOST_PAGEABLE = "host_pageable"


class BlockKind(enum.Enum):
    """Semantic class of a memory block (drives Orchestrator policy)."""

    PARAM = "param"
    GRAD = "grad"
    OPT_STATE = "opt_state"
    ACTIVATION = "activation"
    INPUT = "input"           # batch data
    OUTPUT = "output"         # step outputs (loss, metrics, new params)
    TEMP = "temp"             # operator-internal scratch
    COLLECTIVE = "collective"  # injected communication buffers (distributed)
    CACHE = "cache"           # KV / recurrent state (serving)


class Phase(enum.Enum):
    """Training-loop phase an event belongs to (paper: user_annotation)."""

    INIT = "init"                 # model/optimizer materialization
    FORWARD_BACKWARD = "fwd_bwd"  # loss + gradient computation
    OPTIMIZER = "optimizer"       # parameter/optimizer-state update
    DECODE = "decode"             # serving decode step
    DATA = "data"                 # host->device batch transfer


# Stable enum <-> small-int code tables for the columnar representation.
# Order is append-only: new members must be added at the end so codes in
# saved columnar dumps stay valid across versions.
PHASE_TABLE: tuple[Phase, ...] = tuple(Phase)
PHASE_CODE: dict[Phase, int] = {p: i for i, p in enumerate(PHASE_TABLE)}
KIND_TABLE: tuple[BlockKind, ...] = tuple(BlockKind)
KIND_CODE: dict[BlockKind, int] = {k: i for i, k in enumerate(KIND_TABLE)}
SPACE_TABLE: tuple[MemorySpace, ...] = tuple(MemorySpace)
SPACE_CODE: dict[MemorySpace, int] = {s: i for i, s in
                                      enumerate(SPACE_TABLE)}
#: Code 0 == DEVICE_HBM by construction — a missing v3 space column
#: loads as ``zeros`` and means "everything on device", bit-identically.
assert SPACE_TABLE[0] is MemorySpace.DEVICE_HBM


class StringInterner:
    """Append-only value table: intern() -> small int, table[i] -> value.

    Works for any hashable value — strings (op/scope tables) and shape
    tuples / ``None`` (shape tables) share the implementation."""

    __slots__ = ("table", "_index")

    def __init__(self, table: Sequence = ()):
        self.table: list = list(table)
        self._index: dict = {s: i for i, s in enumerate(self.table)}

    def intern(self, s) -> int:
        i = self._index.get(s)
        if i is None:
            i = self._index[s] = len(self.table)
            self.table.append(s)
        return i


def _shape_table_to_json(table: Sequence) -> list:
    return [None if s is None else list(s) for s in table]


def _shape_table_from_json(table: Sequence | None) -> list:
    if table is None:          # v2 dump: shapes unknown
        return [None]
    return [None if s is None else tuple(int(d) for d in s) for s in table]


@dataclasses.dataclass(slots=True)
class MemoryEvent:
    """One alloc/free in execution order.

    ``t`` is the event's position in the stream (a logical clock — the
    paper uses wall-clock CPU timestamps; execution order is what matters
    for the Simulator, so a logical clock loses nothing).
    """

    kind: str              # "alloc" | "free"
    block_id: int
    size: int              # bytes (pre-rounding; the allocator sim rounds)
    t: int
    iteration: int = 0
    phase: Phase = Phase.FORWARD_BACKWARD
    op: str = ""           # primitive name, e.g. "dot_general"
    scope: str = ""        # layer scope, e.g. "decoder/layers/attn/q_proj"
    block_kind: BlockKind = BlockKind.TEMP
    shape: tuple | None = None   # aval dims (spec-driven sharding input)
    space: MemorySpace = MemorySpace.DEVICE_HBM

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["phase"] = self.phase.value
        d["block_kind"] = self.block_kind.value
        d["shape"] = None if self.shape is None else list(self.shape)
        d["space"] = self.space.value
        return d

    @staticmethod
    def from_json(d: dict) -> "MemoryEvent":
        d = dict(d)
        d["phase"] = Phase(d["phase"])
        d["block_kind"] = BlockKind(d["block_kind"])
        shape = d.get("shape")   # absent in v1/v2 dumps
        d["shape"] = None if shape is None else tuple(shape)
        # absent in v1-v3 dumps: everything lived on device
        d["space"] = MemorySpace(d.get("space", "device_hbm"))
        return MemoryEvent(**d)


@dataclasses.dataclass(slots=True)
class BlockLifecycle:
    """A reconstructed memory block (paper §3.2).

    ``free_t is None`` → persistent for the rest of the trace (paper:
    "blocks lacking a deallocation event are considered persistent").
    ``shard_factor`` divides the size for per-device estimation in the
    distributed extension (paper §6.2); 1 on a single device. ``shape``
    carries the producing aval's dims so the spec-driven sharding engine
    can resolve a true PartitionSpec factor; ``None`` = unknown (external
    traces, synthetic blocks) and resolves to replicated.
    """

    block_id: int
    size: int
    alloc_t: int
    free_t: int | None
    iteration: int = 0
    phase: Phase = Phase.FORWARD_BACKWARD
    op: str = ""
    scope: str = ""
    block_kind: BlockKind = BlockKind.TEMP
    shard_factor: float = 1.0
    shape: tuple | None = None
    space: MemorySpace = MemorySpace.DEVICE_HBM

    @property
    def persistent(self) -> bool:
        return self.free_t is None

    @property
    def sharded_size(self) -> int:
        return max(int(self.size / self.shard_factor), 1) if self.size else 0

    def overlaps(self, t: int) -> bool:
        end = self.free_t if self.free_t is not None else float("inf")
        return self.alloc_t <= t < end


# -- columnar (structure-of-arrays) representations -------------------------
@dataclasses.dataclass
class ColumnarTrace:
    """Event stream as parallel numpy columns (the hot-path format).

    One row per event; ``kind`` is 1 for alloc / 0 for free, ``phase`` and
    ``block_kind`` are codes into :data:`PHASE_TABLE` / :data:`KIND_TABLE`,
    ``op``/``scope`` index the interned string tables and ``shape`` the
    interned shape-tuple table (entry ``None`` = unknown). Conversion to
    and from ``MemoryEvent`` lists is lossless (``test_columnar.py``).
    """

    kind: np.ndarray          # uint8: 1 = alloc, 0 = free
    block_id: np.ndarray      # int64
    size: np.ndarray          # int64, bytes (pre-rounding)
    t: np.ndarray             # int64 logical clock
    iteration: np.ndarray     # int64
    phase: np.ndarray         # uint8 codes -> PHASE_TABLE
    op: np.ndarray            # int32 -> op_table
    scope: np.ndarray         # int32 -> scope_table
    block_kind: np.ndarray    # uint8 codes -> KIND_TABLE
    op_table: list[str]
    scope_table: list[str]
    shape: np.ndarray | None = None     # int32 -> shape_table
    shape_table: list = dataclasses.field(default_factory=lambda: [None])
    space: np.ndarray | None = None     # uint8 codes -> SPACE_TABLE

    def __post_init__(self):
        if self.shape is None:
            self.shape = np.zeros(len(self.kind), dtype=np.int32)
        if self.space is None:   # pre-v4 trace: everything on device
            self.space = np.zeros(len(self.kind), dtype=np.uint8)

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    @staticmethod
    def from_events(events: Sequence[MemoryEvent]) -> "ColumnarTrace":
        n = len(events)
        kind = np.empty(n, dtype=np.uint8)
        bid = np.empty(n, dtype=np.int64)
        size = np.empty(n, dtype=np.int64)
        t = np.empty(n, dtype=np.int64)
        it = np.empty(n, dtype=np.int64)
        phase = np.empty(n, dtype=np.uint8)
        op = np.empty(n, dtype=np.int32)
        scope = np.empty(n, dtype=np.int32)
        bkind = np.empty(n, dtype=np.uint8)
        shp = np.empty(n, dtype=np.int32)
        spc = np.empty(n, dtype=np.uint8)
        ops = StringInterner()
        scopes = StringInterner()
        shapes = StringInterner([None])
        for i, e in enumerate(events):
            kind[i] = 1 if e.kind == "alloc" else 0
            bid[i] = e.block_id
            size[i] = e.size
            t[i] = e.t
            it[i] = e.iteration
            phase[i] = PHASE_CODE[e.phase]
            op[i] = ops.intern(e.op)
            scope[i] = scopes.intern(e.scope)
            bkind[i] = KIND_CODE[e.block_kind]
            shp[i] = shapes.intern(e.shape)
            spc[i] = SPACE_CODE[e.space]
        return ColumnarTrace(kind, bid, size, t, it, phase, op, scope,
                             bkind, ops.table, scopes.table,
                             shp, shapes.table, spc)

    @staticmethod
    def from_columns(kind, bid, size, t, iteration, phase, op, scope,
                     bkind, op_table, scope_table,
                     shape=None, shape_table=None,
                     space=None) -> "ColumnarTrace":
        """Build from raw python lists (the tracer's direct-emission path:
        no ``MemoryEvent`` objects are ever constructed)."""
        return ColumnarTrace(
            np.asarray(kind, dtype=np.uint8),
            np.asarray(bid, dtype=np.int64),
            np.asarray(size, dtype=np.int64),
            np.asarray(t, dtype=np.int64),
            np.asarray(iteration, dtype=np.int64),
            np.asarray(phase, dtype=np.uint8),
            np.asarray(op, dtype=np.int32),
            np.asarray(scope, dtype=np.int32),
            np.asarray(bkind, dtype=np.uint8),
            list(op_table), list(scope_table),
            None if shape is None else np.asarray(shape, dtype=np.int32),
            [None] if shape_table is None else list(shape_table),
            None if space is None else np.asarray(space, dtype=np.uint8))

    def event_at(self, i: int) -> MemoryEvent:
        return MemoryEvent(
            "alloc" if self.kind[i] else "free", int(self.block_id[i]),
            int(self.size[i]), int(self.t[i]), int(self.iteration[i]),
            PHASE_TABLE[self.phase[i]], self.op_table[self.op[i]],
            self.scope_table[self.scope[i]], KIND_TABLE[self.block_kind[i]],
            self.shape_table[self.shape[i]], SPACE_TABLE[self.space[i]])

    def to_events(self) -> list[MemoryEvent]:
        return [self.event_at(i) for i in range(len(self))]

    def with_sizes(self, sizes: np.ndarray) -> "ColumnarTrace":
        """Same structure, new size column (sweep-point synthesis)."""
        return dataclasses.replace(
            self, size=np.asarray(sizes, dtype=np.int64))

    def to_json(self) -> dict:
        return {
            "kind": self.kind.tolist(),
            "block_id": self.block_id.tolist(),
            "size": self.size.tolist(),
            "t": self.t.tolist(),
            "iteration": self.iteration.tolist(),
            "phase": self.phase.tolist(),
            "op": self.op.tolist(),
            "scope": self.scope.tolist(),
            "block_kind": self.block_kind.tolist(),
            "op_table": self.op_table,
            "scope_table": self.scope_table,
            "shape": self.shape.tolist(),
            "shape_table": _shape_table_to_json(self.shape_table),
            "space": self.space.tolist(),
        }

    @staticmethod
    def from_json(d: dict) -> "ColumnarTrace":
        return ColumnarTrace.from_columns(
            d["kind"], d["block_id"], d["size"], d["t"], d["iteration"],
            d["phase"], d["op"], d["scope"], d["block_kind"],
            d["op_table"], d["scope_table"],
            d.get("shape"),                    # absent in v2 dumps
            _shape_table_from_json(d.get("shape_table")),
            d.get("space"))                    # absent in v2/v3 dumps


class LazyEvents(Sequence):
    """List-compatible view over a ``ColumnarTrace`` that materializes
    ``MemoryEvent`` objects only on first element access. ``len()`` (the
    dominant consumer on the fast path) never materializes."""

    def __init__(self, columns: ColumnarTrace):
        self.columns = columns
        self._mat: list[MemoryEvent] | None = None

    def _materialized(self) -> list[MemoryEvent]:
        if self._mat is None:
            self._mat = self.columns.to_events()
        return self._mat

    def __len__(self) -> int:
        return len(self.columns)

    def __getitem__(self, i):
        return self._materialized()[i]

    def __iter__(self):
        return iter(self._materialized())

    def __reduce__(self):
        # pickle only the columns (pool payloads stay lean); the
        # materialized object cache rebuilds on demand
        return (LazyEvents, (self.columns,))


@dataclasses.dataclass
class ColumnarBlocks:
    """Lifecycles as parallel numpy columns. ``free_t`` uses -1 as the
    persistent sentinel (``BlockLifecycle.free_t is None``)."""

    block_id: np.ndarray      # int64
    size: np.ndarray          # int64
    alloc_t: np.ndarray       # int64
    free_t: np.ndarray        # int64, -1 = persistent
    iteration: np.ndarray     # int64
    phase: np.ndarray         # uint8 codes
    op: np.ndarray            # int32 -> op_table
    scope: np.ndarray         # int32 -> scope_table
    block_kind: np.ndarray    # uint8 codes
    shard_factor: np.ndarray  # float64
    op_table: list[str]
    scope_table: list[str]
    shape: np.ndarray | None = None     # int32 -> shape_table
    shape_table: list = dataclasses.field(default_factory=lambda: [None])
    space: np.ndarray | None = None     # uint8 codes -> SPACE_TABLE

    def __post_init__(self):
        if self.shape is None:
            self.shape = np.zeros(len(self.block_id), dtype=np.int32)
        if self.space is None:   # pre-v4 payload: everything on device
            self.space = np.zeros(len(self.block_id), dtype=np.uint8)

    def __len__(self) -> int:
        return int(self.block_id.shape[0])

    @staticmethod
    def from_lifecycles(blocks: Sequence[BlockLifecycle]) -> "ColumnarBlocks":
        n = len(blocks)
        bid = np.empty(n, dtype=np.int64)
        size = np.empty(n, dtype=np.int64)
        at = np.empty(n, dtype=np.int64)
        ft = np.empty(n, dtype=np.int64)
        it = np.empty(n, dtype=np.int64)
        phase = np.empty(n, dtype=np.uint8)
        op = np.empty(n, dtype=np.int32)
        scope = np.empty(n, dtype=np.int32)
        bkind = np.empty(n, dtype=np.uint8)
        shard = np.empty(n, dtype=np.float64)
        shp = np.empty(n, dtype=np.int32)
        spc = np.empty(n, dtype=np.uint8)
        ops = StringInterner()
        scopes = StringInterner()
        shapes = StringInterner([None])
        for i, b in enumerate(blocks):
            bid[i] = b.block_id
            size[i] = b.size
            at[i] = b.alloc_t
            ft[i] = -1 if b.free_t is None else b.free_t
            it[i] = b.iteration
            phase[i] = PHASE_CODE[b.phase]
            op[i] = ops.intern(b.op)
            scope[i] = scopes.intern(b.scope)
            bkind[i] = KIND_CODE[b.block_kind]
            shard[i] = b.shard_factor
            shp[i] = shapes.intern(b.shape)
            spc[i] = SPACE_CODE[b.space]
        return ColumnarBlocks(bid, size, at, ft, it, phase, op, scope,
                              bkind, shard, ops.table, scopes.table,
                              shp, shapes.table, spc)

    def to_lifecycles(self) -> list[BlockLifecycle]:
        ft = self.free_t
        return [BlockLifecycle(
            int(self.block_id[i]), int(self.size[i]), int(self.alloc_t[i]),
            None if ft[i] < 0 else int(ft[i]), int(self.iteration[i]),
            PHASE_TABLE[self.phase[i]], self.op_table[self.op[i]],
            self.scope_table[self.scope[i]], KIND_TABLE[self.block_kind[i]],
            float(self.shard_factor[i]),
            self.shape_table[self.shape[i]],
            SPACE_TABLE[self.space[i]]) for i in range(len(self))]

    def sharded_sizes(self) -> np.ndarray:
        return sharded_sizes_array(self.size, self.shard_factor)

    def with_sizes(self, sizes: np.ndarray) -> "ColumnarBlocks":
        return dataclasses.replace(
            self, size=np.asarray(sizes, dtype=np.int64))

    def to_json(self) -> dict:
        """Schema-v4 columnar payload (shape + space columns included)
        — the persistent trace store's lifecycle format."""
        return {
            "block_id": self.block_id.tolist(),
            "size": self.size.tolist(),
            "alloc_t": self.alloc_t.tolist(),
            "free_t": self.free_t.tolist(),
            "iteration": self.iteration.tolist(),
            "phase": self.phase.tolist(),
            "op": self.op.tolist(),
            "scope": self.scope.tolist(),
            "block_kind": self.block_kind.tolist(),
            "shard_factor": self.shard_factor.tolist(),
            "op_table": self.op_table,
            "scope_table": self.scope_table,
            "shape": self.shape.tolist(),
            "shape_table": _shape_table_to_json(self.shape_table),
            "space": self.space.tolist(),
        }

    @staticmethod
    def from_json(d: dict) -> "ColumnarBlocks":
        space = d.get("space")                 # absent in v3 payloads
        return ColumnarBlocks(
            np.asarray(d["block_id"], dtype=np.int64),
            np.asarray(d["size"], dtype=np.int64),
            np.asarray(d["alloc_t"], dtype=np.int64),
            np.asarray(d["free_t"], dtype=np.int64),
            np.asarray(d["iteration"], dtype=np.int64),
            np.asarray(d["phase"], dtype=np.uint8),
            np.asarray(d["op"], dtype=np.int32),
            np.asarray(d["scope"], dtype=np.int32),
            np.asarray(d["block_kind"], dtype=np.uint8),
            np.asarray(d["shard_factor"], dtype=np.float64),
            list(d["op_table"]), list(d["scope_table"]),
            np.asarray(d["shape"], dtype=np.int32),
            _shape_table_from_json(d.get("shape_table")),
            None if space is None else np.asarray(space, dtype=np.uint8))


def sharded_sizes_array(size: np.ndarray, shard: np.ndarray) -> np.ndarray:
    """Vectorized ``BlockLifecycle.sharded_size`` — the one place the
    truncation semantics live for array code (exact: float division
    truncated toward zero, floor of 1, zero-size blocks stay 0)."""
    out = np.where(shard == 1.0, size,
                   np.maximum((size / shard).astype(np.int64), 1))
    return np.where(size == 0, 0, out).astype(np.int64)


class TraceSchemaError(ValueError):
    """A persisted trace file is incompatible with this code version."""


@dataclasses.dataclass
class Trace:
    """Ordered event stream + metadata — the inter-stage currency.

    ``events`` may be a plain list or a :class:`LazyEvents` view over a
    ``ColumnarTrace`` (hot-path traces are columnar-backed; objects
    materialize only if a consumer iterates). ``columnar()`` returns the
    SoA form, building and caching it on first use for object-backed
    traces. Mutating ``events`` after ``columnar()`` has been called is
    a contract violation (the two views would diverge).
    """

    events: list[MemoryEvent]
    num_iterations: int = 1
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    def columnar(self) -> ColumnarTrace:
        if isinstance(self.events, LazyEvents):
            return self.events.columns
        cols = self.meta.get("_columns")
        if cols is None:
            cols = ColumnarTrace.from_events(self.events)
            self.meta["_columns"] = cols
        return cols

    @staticmethod
    def from_columnar(columns: ColumnarTrace, num_iterations: int = 1,
                      meta: dict | None = None) -> "Trace":
        return Trace(LazyEvents(columns), num_iterations, meta or {})

    def iteration_slice(self, it: int) -> list[MemoryEvent]:
        return [e for e in self.events if e.iteration == it]

    def save(self, path: str, columnar: bool = False) -> None:
        """Persist as versioned JSON. ``columnar=True`` writes the SoA
        payload (phase/iteration carried as full per-event columns plus
        the trace-level metadata, so nothing is lost round-tripping)."""
        meta = {k: v for k, v in self.meta.items() if k != "_columns"}
        d: dict = {
            "schema_version": TRACE_SCHEMA_VERSION,
            "num_iterations": self.num_iterations,
            "meta": meta,
        }
        if columnar:
            d["format"] = "columnar"
            d["columns"] = self.columnar().to_json()
        else:
            d["format"] = "events"
            d["events"] = [e.to_json() for e in self.events]
        with open(path, "w") as f:
            json.dump(d, f)

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            d = json.load(f)
        version = d.get("schema_version", 1)   # v1: seed dumps, no field
        if not isinstance(version, int) or version < 1 \
                or version > TRACE_SCHEMA_VERSION:
            raise TraceSchemaError(
                f"{path}: trace schema version {version!r} is not supported "
                f"by this build (max {TRACE_SCHEMA_VERSION}); re-dump the "
                f"trace with a matching version of the tracer")
        fmt = d.get("format", "events")
        if fmt == "columnar":
            return Trace.from_columnar(
                ColumnarTrace.from_json(d["columns"]),
                num_iterations=d["num_iterations"], meta=d.get("meta", {}))
        if fmt != "events" or "events" not in d:
            raise TraceSchemaError(
                f"{path}: unknown trace payload format {fmt!r}")
        return Trace(
            events=[MemoryEvent.from_json(e) for e in d["events"]],
            num_iterations=d["num_iterations"],
            meta=d.get("meta", {}),
        )


def lifecycles_to_events(blocks: Sequence[BlockLifecycle]) -> list[MemoryEvent]:
    """Expand lifecycles back into an ordered alloc/free event stream.

    Free events at the same logical time sort *before* alloc events — a
    block freed at t must be reusable by a block allocated at t (this is
    the paper's Fig-3 sensitivity: dealloc/alloc interleaving decides the
    peak; ties resolve in favor of reuse, matching allocator behavior
    where the framework frees an input before allocating the output of
    the next op at the same trace position).
    """
    evs: list[tuple[int, int, MemoryEvent]] = []
    horizon = 0
    for b in blocks:
        horizon = max(horizon, b.alloc_t + 1, (b.free_t or 0) + 1)
    for b in blocks:
        evs.append(
            (b.alloc_t, 1, MemoryEvent(
                "alloc", b.block_id, b.sharded_size, b.alloc_t, b.iteration,
                b.phase, b.op, b.scope, b.block_kind, b.shape, b.space))
        )
        if b.free_t is not None:
            evs.append(
                (b.free_t, 0, MemoryEvent(
                    "free", b.block_id, b.sharded_size, b.free_t, b.iteration,
                    b.phase, b.op, b.scope, b.block_kind, b.shape, b.space))
            )
    evs.sort(key=lambda x: (x[0], x[1]))
    return [e for _, _, e in evs]


# -- composed workloads (estimation fast path) ------------------------------
class ComposedBlocks:
    """Base class for composed allocation workloads.

    A composed workload is anything that compiles down to a flat
    :class:`BlockLifecycle` list — the replay currency both simulator
    engines consume. Two specializations exist:

    * :class:`PeriodicBlocks` — N training iterations in O(blocks)
      space (prefix / replicated cycle / suffix). The simulator keeps
      its dedicated fast paths (steady-state skipping, tiled columnar
      expansion) for this shape, so the training pipeline is
      byte-identical to the pre-``ComposedBlocks`` engine.
    * :class:`RequestBlocks` — a request-driven allocation stream
      (continuous-batching serving timeline: per-request join/leave,
      paged KV blocks, prefix-shared pages, speculative scratch). No
      periodic structure to exploit; replays through the ordinary flat
      paths of both engines.

    Subclasses provide ``materialize()``, ``num_blocks``,
    ``iter_groups()`` and a ``meta`` dict.
    """

    meta: dict

    @property
    def num_blocks(self) -> int:  # pragma: no cover — abstract
        raise NotImplementedError

    def materialize(self) -> list:  # pragma: no cover — abstract
        raise NotImplementedError

    def iter_groups(self):  # pragma: no cover — abstract
        raise NotImplementedError


@dataclasses.dataclass
class RequestBlocks(ComposedBlocks):
    """Flat request-driven allocation stream (serving workloads).

    Produced by the continuous-batching scheduler
    (``core.orchestrator.ContinuousBatchingScheduler.lower``): one
    lifecycle per KV page / scratch / per-request state block, at the
    exact tick it joins and leaves. ``meta`` carries the timeline
    accounting (ticks, occupancy, evictions, knobs).
    """

    blocks: list
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def materialize(self) -> list:
        return list(self.blocks)

    def iter_groups(self):
        yield from self.blocks


# -- periodic composition (estimation fast path) ----------------------------
#: Block-id namespace stride for replicated cycle instances. Instance k of
#: a PeriodicBlocks cycle re-ids block ``b`` as ``b + (k + 1) * STRIDE`` so
#: replicas never collide with prefix/suffix ids (small positive ints) or
#: synthetic orchestrator ids (small negative ints).
CYCLE_ID_STRIDE = 1 << 40


def shift_cycle_bid(bid: int, instance: int) -> int:
    return bid + (instance + 1) * CYCLE_ID_STRIDE


def split_cycle_bid(bid: int) -> tuple[int, int]:
    """Inverse of ``shift_cycle_bid``: (instance, raw_id). Instance is -1
    for prefix/suffix ids (small magnitudes, including the orchestrator's
    negative synthetic ids), which never carry a stride offset."""
    inst_plus1 = (bid + (CYCLE_ID_STRIDE >> 1)) // CYCLE_ID_STRIDE
    return inst_plus1 - 1, bid - inst_plus1 * CYCLE_ID_STRIDE


@dataclasses.dataclass
class PeriodicBlocks(ComposedBlocks):
    """N-iteration composition in O(blocks) space (fast path).

    ``prefix`` holds iteration 0 (params + optimizer-init included),
    ``cycle`` holds iteration 1 at its absolute times, replicated
    implicitly ``n_cycles`` times with a constant ``period`` offset
    (iterations 1..N-2), and ``suffix`` holds the final iteration at its
    true absolute times. The last iteration is kept concrete because
    grad-release policies treat it differently (no next iteration to
    free into); every middle iteration is an exact shifted copy of
    iteration 1 by construction, which is what makes steady-state replay
    and the periodic peak computations below *exact*, not approximate.
    """

    prefix: list[BlockLifecycle]
    cycle: list[BlockLifecycle]
    n_cycles: int                 # replica count of ``cycle`` (>= 0)
    period: int
    suffix: list[BlockLifecycle]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_blocks(self) -> int:
        return (len(self.prefix) + self.n_cycles * len(self.cycle)
                + len(self.suffix))

    def materialize(self) -> list[BlockLifecycle]:
        """Expand to the flat lifecycle list the slow path would build."""
        out = list(self.prefix)
        for k in range(self.n_cycles):
            dt = k * self.period
            for b in self.cycle:
                out.append(BlockLifecycle(
                    shift_cycle_bid(b.block_id, k), b.size, b.alloc_t + dt,
                    None if b.free_t is None else b.free_t + dt,
                    b.iteration + k, b.phase, b.op, b.scope, b.block_kind,
                    b.shard_factor, b.shape, b.space))
        out.extend(self.suffix)
        return out

    def iter_groups(self):
        yield from self.prefix
        yield from self.cycle
        yield from self.suffix


def reduced_for_breakdown(pb: PeriodicBlocks,
                          max_cycles: int = 4) -> PeriodicBlocks:
    """Shrink a periodic composition to a bounded replica count without
    changing any liveness maximum (total or per-phase).

    Valid when every cycle block is freed (zero net bytes per replica) —
    then every middle window's liveness profile is an exact copy with an
    identical entering level, so deleting repeated windows preserves all
    peaks. The suffix (and nothing else) is shifted left to follow the
    kept replicas. Falls back to the original composition when a cycle
    block persists (per-replica drift) or when prefix events reach past
    the kept windows."""
    if pb.n_cycles <= max_cycles or max_cycles < 2:
        return pb
    if any(b.free_t is None for b in pb.cycle):
        return pb
    cycle_start = pb.meta.get("cycle_start")
    if cycle_start is None:
        return pb
    horizon = cycle_start + 2 * pb.period
    for b in pb.prefix:
        if b.alloc_t >= horizon or (b.free_t is not None
                                    and b.free_t > horizon):
            return pb
    dt = (pb.n_cycles - max_cycles) * pb.period
    suffix = [dataclasses.replace(
        b, alloc_t=b.alloc_t - dt,
        free_t=None if b.free_t is None else b.free_t - dt)
        for b in pb.suffix]
    return PeriodicBlocks(pb.prefix, pb.cycle, max_cycles, pb.period,
                          suffix, meta=pb.meta)


def periodic_peak_live(pb: PeriodicBlocks, pred=None) -> int:
    """Exact peak of live bytes over the full expansion, computed with
    integer deltas only (no lifecycle copies)."""
    deltas: dict[int, int] = {}

    def add(b: BlockLifecycle, dt: int) -> None:
        if pred is not None and not pred(b):
            return
        s = b.sharded_size
        deltas[b.alloc_t + dt] = deltas.get(b.alloc_t + dt, 0) + s
        if b.free_t is not None:
            deltas[b.free_t + dt] = deltas.get(b.free_t + dt, 0) - s

    for b in pb.prefix:
        add(b, 0)
    for k in range(pb.n_cycles):
        dt = k * pb.period
        for b in pb.cycle:
            add(b, dt)
    for b in pb.suffix:
        add(b, 0)
    peak, live = 0, 0
    for t in sorted(deltas):
        live += deltas[t]
        peak = max(peak, live)
    return peak


def periodic_phase_peaks(pb: PeriodicBlocks) -> dict:
    """Per-phase peak live bytes over the full expansion (exact)."""
    return periodic_breakdown_peaks(pb)[1]


def periodic_breakdown_peaks(pb: PeriodicBlocks) -> tuple[int, dict]:
    """(total peak live, per-phase peaks) in a single delta pass — the
    estimator's breakdown without lifecycle copies."""
    total: dict[int, int] = {}
    per: dict = {}

    def add(b: BlockLifecycle, dt: int) -> None:
        s = b.sharded_size
        at = b.alloc_t + dt
        d = per.get(b.phase)
        if d is None:
            d = per[b.phase] = {}
        total[at] = total.get(at, 0) + s
        d[at] = d.get(at, 0) + s
        ft = b.free_t
        if ft is not None:
            ft += dt
            total[ft] = total.get(ft, 0) - s
            d[ft] = d.get(ft, 0) - s

    for b in pb.prefix:
        add(b, 0)
    for k in range(pb.n_cycles):
        dt = k * pb.period
        for b in pb.cycle:
            add(b, dt)
    for b in pb.suffix:
        add(b, 0)

    def sweep(deltas: dict[int, int]) -> int:
        peak, live = 0, 0
        for t in sorted(deltas):
            live += deltas[t]
            if live > peak:
                peak = live
        return peak

    return sweep(total), {ph.value: sweep(d) for ph, d in
                          sorted(per.items(), key=lambda kv: kv[0].value)}


def periodic_breakdown_peaks_fast(pb: PeriodicBlocks) -> tuple[int, dict]:
    """Vectorized ``periodic_breakdown_peaks``: the delta sweep becomes
    argsort + cumsum, with liveness evaluated at the last event of each
    timestamp (equivalent to summing all deltas at equal t first).
    Output is identical to the dict-based sweep (tests/test_columnar.py).
    """
    def cols(blocks, reps=1, period=0):
        if not blocks:
            return None
        s, at, ft, ph = zip(*((b.sharded_size, b.alloc_t,
                               -1 if b.free_t is None else b.free_t,
                               PHASE_CODE[b.phase]) for b in blocks))
        s = np.array(s, np.int64)
        at = np.array(at, np.int64)
        ft = np.array(ft, np.int64)
        ph = np.array(ph, np.uint8)
        if reps > 1:
            dt = (np.arange(reps, dtype=np.int64) * period)[:, None]
            at = (at[None, :] + dt).ravel()
            ft = np.where(ft[None, :] < 0, np.int64(-1),
                          ft[None, :] + dt).ravel()
            s = np.broadcast_to(s, (reps, s.shape[0])).ravel()
            ph = np.broadcast_to(ph, (reps, ph.shape[0])).ravel()
        return s, at, ft, ph

    parts = [p for p in (
        cols(pb.prefix),
        cols(pb.cycle, max(pb.n_cycles, 0) or 1, pb.period)
        if pb.n_cycles > 0 else None,
        cols(pb.suffix)) if p is not None]
    if not parts:
        return 0, {}
    s = np.concatenate([p[0] for p in parts])
    at = np.concatenate([p[1] for p in parts])
    ft = np.concatenate([p[2] for p in parts])
    ph = np.concatenate([p[3] for p in parts])
    has_free = ft >= 0
    times = np.concatenate([at, ft[has_free]])
    deltas = np.concatenate([s, -s[has_free]])
    phases = np.concatenate([ph, ph[has_free]])

    def sweep(t, d):
        if t.size == 0:
            return 0
        order = np.argsort(t, kind="stable")
        t = t[order]
        cs = np.cumsum(d[order])
        last = np.empty(t.shape, bool)
        last[:-1] = t[1:] != t[:-1]
        last[-1] = True
        return max(int(cs[last].max()), 0)

    total = sweep(times, deltas)
    per = {}
    for code in np.unique(ph):
        mask = phases == code
        per[PHASE_TABLE[code].value] = sweep(times[mask], deltas[mask])
    per = {k: per[k] for k in sorted(per)}
    return total, per


def liveness_curve(blocks: Iterable[BlockLifecycle]) -> list[tuple[int, int]]:
    """(t, live_bytes) curve from lifecycles — the 'Tensor memory' series
    of the paper's Fig 1/6 (segment series comes from the Simulator)."""
    deltas: dict[int, int] = {}
    for b in blocks:
        deltas[b.alloc_t] = deltas.get(b.alloc_t, 0) + b.sharded_size
        if b.free_t is not None:
            deltas[b.free_t] = deltas.get(b.free_t, 0) - b.sharded_size
    curve, live = [], 0
    for t in sorted(deltas):
        live += deltas[t]
        curve.append((t, live))
    return curve


def peak_live_bytes(blocks: Iterable[BlockLifecycle]) -> int:
    curve = liveness_curve(blocks)
    return max((v for _, v in curve), default=0)

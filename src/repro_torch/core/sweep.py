"""Sweep service: batched estimation over many related jobs (port of
``repro.core.sweep``).

A batch-size search runs ``estimate_training`` once a point although the
points differ in one scalar, the batch. ``estimate_many`` removes that
redundancy in three layers:

1. **Trace-cache dedup**: points sharing input shapes (and the
   batch-independent optimizer phases of every point) are traced once.
   The cache key is content-addressed (``cache.fn_identity``), so traces
   made earlier through other but identical hooks (a gate's) are hits.
2. **Columnar trace interpolation**: for a 1-D sweep (the batch), the
   forward+backward phase is traced at three probe points (min, median,
   max). If the three columnar traces are structurally identical (the
   same events, ids, times, ops, scopes: everything but the size and
   shape columns) and the per-event sizes and shapes fit an integer
   affine model ``size = s0 + s1 * b`` that reproduces the middle probe
   *exactly*, the other points' traces are synthesized by array
   arithmetic: no tracing. Every synthesized point is also checked
   against the input bytes a real trace would record for it, and any
   failed check traces the point for real: the model is an
   exact-or-bust shortcut, never an approximation. Composition,
   orchestration and replay run per point, so the reports equal
   sequential ``estimate_training``'s.
3. **Parallel fan-out**: with ``processes > 0`` a ``SweepService``
   ships work to a persistent pool of spawned workers: stages 2-5 of
   synthesized points (array arithmetic and replay), and the full
   estimates of probes and of sweeps that cannot be modeled, whose
   traces run under fake tensors on the worker's CPU. Workers import
   torch and this package, touch no device, and their reports carry
   no usage curve and no composition (lean IPC).

Differences from the JAX package:

* pytrees are ``torch.utils._pytree`` trees, and a synthesized phase's
  abstract outputs are ``meta`` tensors of the modeled shapes;
* the port's ``TracedPhase`` holds no jaxpr, so there is no coupling
  verdict to resolve before shipping a phase: the port's estimator
  resolves ``grad_release="auto"`` to ``after_update`` itself (an eager
  step has no fusion of per-leaf updates into the backward);
* each row's shape is fitted (and the synthesized rows interned again,
  in order, as the tracer interns them), not each entry of the interned
  shape table: two shapes that coincide at one batch share one entry
  there, which changes the index column, and the JAX package refuses
  such a trio;
* a probe that diverged structurally at the edge of the range (batch 1:
  size-1 dims make some copies no-ops) is repaired by its nearest
  neighbour, which keeps the widest range; the JAX package traces its
  repair probe between the two consistent ones;
* ``MeshSweepResult.admitted``/``best`` admit a topology by the
  admission service's rule (its replay did not run out of memory, its
  peak fits): a sweep replayed at a capacity stops at it. The JAX
  package compares the peak alone, the same verdict on an unbounded
  replay.

``estimate_mesh_sweep`` is the mesh-topology sweep: per-device estimates
for a grid of (pod, data, model, fsdp) topologies (``topology_grid``)
from ONE set of phase traces, each topology's shard factors and
collective staging from ``distributed.sharding``. A sweep point may
carry its own shard factors and collectives; such points are estimated
in this process (the factor functions need not pickle), and a
synthesized phase carries each block's shape at its batch, so spec
factors resolve on it as on a traced one. On the CPU:
``python -m repro_torch.launch.hillclimb --xmem-mesh qwen3-32b --smoke
--device cpu --hbm-gib 0.089 --devices 2,4`` sweeps a smoke job;
``chip_smoke.py``'s ``dense_sharded`` holds a full-width sweep's
tensor-parallel rows against rank 0 of the sharded program run on the
card.

Use ``SweepService`` when sweeping repeatedly (the pool and trace cache
stay warm across calls); ``estimate_many`` is the one-shot convenience.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .cache import BlockInfo, TracedPhase, trace_key
from .estimator import EstimateReport, XMemEstimator, flatten_kinds
from .events import BlockKind, ColumnarBlocks, Phase, StringInterner, Trace
from .simulator import SimResult
from .tracer import aval_bytes


@dataclasses.dataclass
class SweepPoint:
    """One job of a sweep: the ``estimate_training`` arguments."""

    fwd_bwd_fn: Callable
    params: Any
    batch: Any
    update_fn: Callable | None = None
    opt_init_fn: Callable | None = None
    shard_factor_fn: Callable | None = None
    collective_specs: Sequence = ()
    capacity: int | None = None


@dataclasses.dataclass
class SweepResult:
    reports: list[EstimateReport]       # one per point, input order
    stats: dict                         # traced/interpolated/pooled counts
    sources: list[str] = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter(self.reports)

    def __len__(self):
        return len(self.reports)


# -- mesh-topology sweep -----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """One (pod, data, model, fsdp) cell of a topology grid."""

    pod: int = 1
    data: int = 1
    model: int = 1
    fsdp: bool = False

    @property
    def n_devices(self) -> int:
        return self.pod * self.data * self.model

    @property
    def axis_sizes(self) -> dict:
        return {"pod": self.pod, "data": self.data, "model": self.model}

    @property
    def label(self) -> str:
        tag = f"{self.pod}x{self.data}x{self.model}"
        return tag + ("+fsdp" if self.fsdp else "")

    def sharding_policy(self):
        from ..distributed.sharding import ShardingPolicy
        fsdp_axes = (("data", "pod") if self.pod > 1 else ("data",))
        return ShardingPolicy(fsdp=self.fsdp, fsdp_axes=fsdp_axes,
                              batch_axes=("pod", "data"))


def topology_grid(n_devices: int, *, pods: Sequence[int] = (1,),
                  fsdp: Sequence[bool] = (False, True)
                  ) -> list[MeshTopology]:
    """All (pod, data, model, fsdp) cells whose device product equals
    ``n_devices``. fsdp=True cells are skipped when every fsdp axis has
    size 1 (they would duplicate the fsdp=False estimate while claiming
    ZeRO-3 was modeled)."""
    out = []
    for pod in pods:
        if pod <= 0 or n_devices % pod:
            continue
        per_pod = n_devices // pod
        for model in range(1, per_pod + 1):
            if per_pod % model:
                continue
            data = per_pod // model
            for f in fsdp:
                if f and data * pod == 1:
                    continue
                out.append(MeshTopology(pod=pod, data=data,
                                        model=model, fsdp=f))
    return out


@dataclasses.dataclass
class MeshSweepResult:
    """Per-topology estimates from one set of phase traces."""

    topologies: list[MeshTopology]
    reports: list[EstimateReport]
    stats: dict

    def __iter__(self):
        return iter(zip(self.topologies, self.reports))

    def __len__(self):
        return len(self.reports)

    def admitted(self, capacity: int) -> list[MeshTopology]:
        """Topologies whose per-device estimate fits ``capacity``: its
        replay did not run out of memory (a sweep replayed at a capacity
        stops there) and its peak fits, the admission service's rule."""
        return [t for t, r in zip(self.topologies, self.reports)
                if not r.oom and r.fits(capacity)]

    def best(self, capacity: int
             ) -> tuple[MeshTopology, EstimateReport] | None:
        """Cheapest admitted topology: fewest devices, then lowest
        per-device peak."""
        fits = [(t, r) for t, r in zip(self.topologies, self.reports)
                if not r.oom and r.fits(capacity)]
        if not fits:
            return None
        return min(fits, key=lambda tr: (tr[0].n_devices,
                                         tr[1].peak_bytes))


@dataclasses.dataclass
class ServingSweepResult:
    """Per-knob serving estimates from one cached decode trace."""

    knobs: list            # ServingKnobs grid, aligned with estimates
    estimates: list        # ServingEstimate per knob point
    stats: dict

    def __iter__(self):
        return iter(zip(self.knobs, self.estimates))

    def __len__(self):
        return len(self.estimates)

    def admitted(self, capacity: int) -> list:
        return [k for k, e in zip(self.knobs, self.estimates)
                if e.fits(capacity)]


# -- affine trace model ------------------------------------------------------
def _fit_affine(y_lo, y_hi, b_lo: int, b_hi: int):
    """Integer affine fit through two probes, or None if non-integral."""
    y_lo = np.asarray(y_lo, dtype=np.int64)
    y_hi = np.asarray(y_hi, dtype=np.int64)
    db = b_hi - b_lo
    num = y_hi - y_lo
    if np.any(num % db):
        return None
    slope = num // db
    return y_lo - slope * b_lo, slope


def _eval_affine(model, b: int) -> np.ndarray:
    s0, s1 = model
    return s0 + s1 * b


class _PhaseModel:
    """Exact-or-bust affine model of one phase's trace over a scalar.

    Built from three structurally identical probe traces; synthesizes a
    ``TracedPhase`` for any scalar by rewriting the size columns (and the
    batch-varying output shape dims). The middle probe must be
    reproduced bit-exactly by the two-point fit or the model rejects
    itself.
    """

    def __init__(self, probes: list[tuple[int, TracedPhase]]):
        (b_lo, p_lo), (b_mid, p_mid), (b_hi, p_hi) = \
            sorted(probes, key=lambda x: x[0])
        self.template = p_lo
        # trusted scalar range: interpolation never extrapolates past the
        # outer probes (structure changes lurk at range boundaries, e.g.
        # size-1 dims at batch 1)
        self.b_lo, self.b_hi = b_lo, b_hi
        self.ok = False
        cols = [p.trace.columnar() for p in (p_lo, p_mid, p_hi)]
        if len({len(c) for c in cols}) != 1:
            return
        ref = cols[0]
        for c in cols[1:]:
            if not (np.array_equal(ref.kind, c.kind)
                    and np.array_equal(ref.block_id, c.block_id)
                    and np.array_equal(ref.t, c.t)
                    and np.array_equal(ref.phase, c.phase)
                    and np.array_equal(ref.block_kind, c.block_kind)
                    and np.array_equal(ref.op, c.op)
                    and np.array_equal(ref.scope, c.scope)
                    and np.array_equal(ref.space, c.space)
                    and ref.op_table == c.op_table
                    and ref.scope_table == c.scope_table):
                return
        lcs = [ColumnarBlocks.from_lifecycles(p.lifecycles)
               for p in (p_lo, p_mid, p_hi)]
        lref = lcs[0]
        for c in lcs[1:]:
            if not (len(lref) == len(c)
                    and np.array_equal(lref.block_id, c.block_id)
                    and np.array_equal(lref.alloc_t, c.alloc_t)
                    and np.array_equal(lref.free_t, c.free_t)
                    and np.array_equal(lref.block_kind, c.block_kind)
                    and np.array_equal(lref.space, c.space)
                    and np.array_equal(lref.shard_factor, c.shard_factor)):
                return

        def fit3(lo, mid, hi):
            m = _fit_affine(lo, hi, b_lo, b_hi)
            if m is None or not np.array_equal(
                    _eval_affine(m, b_mid), np.asarray(mid, np.int64)):
                return None
            return m

        def fit_shape_table(tables):
            """Affine model per shape-table entry (None entries must be
            None in every probe; dims fit like sizes)."""
            lo, mid, hi = tables
            if not (len(lo) == len(mid) == len(hi)):
                return None
            models: list = []
            for a, bb, c in zip(lo, mid, hi):
                if a is None or bb is None or c is None:
                    if not (a is None and bb is None and c is None):
                        return None
                    models.append(None)
                    continue
                if not (len(a) == len(bb) == len(c)):
                    return None
                m = fit3(a, bb, c)
                if m is None:
                    return None
                models.append(m)
            return models

        def fit_block_shapes(block_lists):
            """Affine per-block shape model over input/output BlockInfos."""
            lo, mid, hi = block_lists
            return fit_shape_table((tuple(b.shape for b in lo),
                                    tuple(b.shape for b in mid),
                                    tuple(b.shape for b in hi)))

        def fit_row_shapes(columns):
            """Affine shape model of each row of an interned shape
            column: one model per distinct (lo, mid, hi) triple of row
            shapes, and each row's triple."""
            rows = [[c.shape_table[k] for k in c.shape] for c in columns]
            triples = list(zip(*rows))
            uniq = list(dict.fromkeys(triples))
            models = fit_shape_table(tuple(zip(*uniq)) if uniq
                                     else ((), (), ()))
            if models is None:
                return None
            pos = {tr: k for k, tr in enumerate(uniq)}
            return models, np.asarray([pos[tr] for tr in triples],
                                      dtype=np.int64)

        self.ev_sizes = fit3(cols[0].size, cols[1].size, cols[2].size)
        self.lc_sizes = fit3(lcs[0].size, lcs[1].size, lcs[2].size)
        self.in_sizes = fit3(*[[b.size for b in p.input_blocks]
                               for p in (p_lo, p_mid, p_hi)])
        self.out_sizes = fit3(*[[b.size for b in p.output_blocks]
                                for p in (p_lo, p_mid, p_hi)])
        self.ev_shapes = fit_row_shapes(cols)
        self.lc_shapes = fit_row_shapes(lcs)
        self.in_shapes = fit_block_shapes([p.input_blocks
                                           for p in (p_lo, p_mid, p_hi)])
        self.out_shapes = fit_block_shapes([p.output_blocks
                                            for p in (p_lo, p_mid, p_hi)])
        if None in (self.ev_sizes, self.lc_sizes, self.in_sizes,
                    self.out_sizes, self.ev_shapes, self.lc_shapes,
                    self.in_shapes, self.out_shapes):
            return
        if len({(b.bid, b.kind) for b in p_lo.input_blocks}
               ^ {(b.bid, b.kind) for b in p_hi.input_blocks}):
            return
        # out_shape: identical pytrees of tensors, per-leaf dims affine in b
        flat = [pytree.tree_flatten(p.out_shape)
                for p in (p_lo, p_mid, p_hi)]
        if not flat[0][1] == flat[1][1] == flat[2][1]:
            return
        if not all(isinstance(leaf, torch.Tensor)
                   for leaves, _ in flat for leaf in leaves):
            return
        shapes = [[(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
                  for leaves, _ in flat]
        dims = []
        for i in range(len(shapes[0])):
            if len({len(s[i][0]) for s in shapes}) != 1 \
                    or len({s[i][1] for s in shapes}) != 1:
                return
            m = fit3(shapes[0][i][0], shapes[1][i][0], shapes[2][i][0])
            if m is None:
                return
            dims.append(m)
        self.out_dims = dims
        # constant out_shape -> the optimizer phases (keyed on the grads'
        # shapes) are provably shared across all points, so whole point
        # chunks can ship to pool workers with one upd/init payload
        self.out_constant = all(not s1.any() for _s0, s1 in dims)
        self.lc_template = lref
        self.ok = True

    def stripped(self) -> "_PhaseModel":
        """Lean copy for pool payloads: drops the template's object
        lifecycles (``synthesize`` rebuilds lifecycles from the columnar
        template, never from these)."""
        clone = _PhaseModel.__new__(_PhaseModel)
        clone.__dict__.update(self.__dict__)
        clone.template = dataclasses.replace(self.template, lifecycles=())
        return clone

    def synthesize(self, b: int, expected_input_sizes: list[int]
                   ) -> TracedPhase | None:
        """Build the point's TracedPhase, or None when any exactness
        check fails (scalar outside the probed range, negative sizes,
        input-size mismatch). The input sizes a real trace would record
        are fully determined by the point's input shapes, so the caller
        passes that ground truth in."""
        if not (self.b_lo <= b <= self.b_hi):
            return None
        tp = self.template
        in_sizes = _eval_affine(self.in_sizes, b)
        if in_sizes.tolist() != expected_input_sizes:
            return None
        ev_sizes = _eval_affine(self.ev_sizes, b)
        lc_sizes = _eval_affine(self.lc_sizes, b)
        out_sizes = _eval_affine(self.out_sizes, b)
        if (ev_sizes < 0).any() or (lc_sizes < 0).any() \
                or (out_sizes < 0).any():
            return None

        def eval_shapes(models):
            out = []
            for m in models:
                if m is None:
                    out.append(None)
                    continue
                shape = tuple(int(d) for d in _eval_affine(m, b))
                if any(d < 0 for d in shape):
                    return None
                out.append(shape)
            return out

        def eval_rows(row_model):
            """The rows' shapes at ``b``, interned in row order as the
            tracer interns them: (shape column, shape table)."""
            models, rows = row_model
            shapes = eval_shapes(models)
            if shapes is None:
                return None
            table = StringInterner([None])
            return (np.asarray([table.intern(shapes[k]) for k in rows],
                               dtype=np.int32), table.table)

        ev_shapes = eval_rows(self.ev_shapes)
        lc_shapes = eval_rows(self.lc_shapes)
        in_shapes = eval_shapes(self.in_shapes)
        out_shapes = eval_shapes(self.out_shapes)
        if None in (ev_shapes, lc_shapes, in_shapes, out_shapes):
            return None
        leaves, spec = pytree.tree_flatten(tp.out_shape)
        new_leaves = []
        for leaf, dim_model in zip(leaves, self.out_dims):
            shape = tuple(int(d) for d in _eval_affine(dim_model, b))
            if any(d < 0 for d in shape):
                return None
            new_leaves.append(torch.empty(shape, dtype=leaf.dtype,
                                          device="meta"))
        out_shape = pytree.tree_unflatten(new_leaves, spec)
        trace = Trace.from_columnar(
            dataclasses.replace(tp.trace.columnar().with_sizes(ev_sizes),
                                shape=ev_shapes[0],
                                shape_table=ev_shapes[1]),
            num_iterations=tp.trace.num_iterations,
            meta={k: v for k, v in tp.trace.meta.items()
                  if k != "_columns"})
        lifecycles = tuple(dataclasses.replace(
            self.lc_template.with_sizes(lc_sizes),
            shape=lc_shapes[0], shape_table=lc_shapes[1]).to_lifecycles())
        return TracedPhase(
            trace=trace,
            lifecycles=lifecycles,
            input_blocks=tuple(
                BlockInfo(bi.bid, int(s), bi.kind, shp)
                for bi, s, shp in zip(tp.input_blocks, in_sizes,
                                      in_shapes)),
            output_blocks=tuple(
                BlockInfo(bi.bid, int(s), bi.kind, shp)
                for bi, s, shp in zip(tp.output_blocks, out_sizes,
                                      out_shapes)),
            out_shape=out_shape,
            arg_leaf_counts=tp.arg_leaf_counts,
        )


def _trace_sig(entry: TracedPhase) -> tuple:
    """Structural fingerprint of a phase trace: everything except the
    size and shape columns (the shapes' dims vary with the sweep scalar,
    and so does which of them coincide, hence the interned index
    pattern). Two traces with equal signatures differ only in sizes and
    shapes, the precondition for the affine model."""
    c = entry.trace.columnar()
    return (len(c), c.kind.tobytes(), c.block_id.tobytes(), c.t.tobytes(),
            c.op.tobytes(), c.scope.tobytes(), c.phase.tobytes(),
            c.block_kind.tobytes(), c.space.tobytes(),
            tuple(c.op_table), tuple(c.scope_table))


# -- scalar detection --------------------------------------------------------
def _leaf_sig(tree):
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),
            tuple((tuple(getattr(leaf, "shape", ())),
                   str(getattr(leaf, "dtype", None))) for leaf in leaves))


def _aval_nbytes(leaf) -> int:
    """Bytes a real trace records for an input leaf: delegates to the
    tracer's own sizing (the storage of a fresh tensor of the leaf's
    shape and strides), so the interpolation's cross-check can never
    drift from what tracing would have produced."""
    return aval_bytes(leaf)


def _sweep_scalars(points: list[SweepPoint]) -> list[int] | None:
    """Scalar parameter per point for a 1-D batch sweep, or None when
    the points do not form one (different treespecs, dtypes or ranks)."""
    sigs = [_leaf_sig(p.batch) for p in points]
    if len({s[0] for s in sigs}) != 1:
        return None
    ref = sigs[0][1]
    for _, leafsig in sigs:
        if len(leafsig) != len(ref):
            return None
        for (shape, dt), (rshape, rdt) in zip(leafsig, ref):
            if dt != rdt or len(shape) != len(rshape):
                return None
    varying = set()
    for _, leafsig in sigs:
        for li, (shape, _) in enumerate(leafsig):
            for di, d in enumerate(shape):
                if d != ref[li][0][di]:
                    varying.add((li, di))
    if not varying:
        return [0] * len(points)      # identical points: cache handles it
    li, di = sorted(varying)[0]
    return [int(s[1][li][0][di]) for s in sigs]


# -- process-pool workers ----------------------------------------------------
def _report_to_dict(rep: EstimateReport) -> dict:
    return {
        "peak_bytes": rep.peak_bytes,
        "peak_tensor_bytes": rep.peak_tensor_bytes,
        "persistent_bytes": rep.persistent_bytes,
        "oom": rep.oom,
        "breakdown": rep.breakdown,
        "num_events": rep.num_events,
        "sim_peak_reserved": rep.sim.peak_reserved,
        "sim_peak_allocated": rep.sim.peak_allocated,
        "sim_oom_at": rep.sim.oom_at,
        "sim_stats": rep.sim.stats,
        "sim_segments": rep.sim.segments,
        "sim_unbounded": rep.sim_unbounded,
        "depth": rep.depth,
    }


def _pool_worker_chunk(payload: dict) -> list[dict | None]:
    """Stages 2-5 for a chunk of sweep points in a worker process: the
    points' traces are synthesized in the worker from the shipped model
    (array arithmetic), then composed, orchestrated and replayed. A None
    result marks a point whose exactness check failed: the parent traces
    it for real."""
    est = XMemEstimator(**payload["estimator"])
    model: _PhaseModel = payload["model"]
    upd, init = payload["upd"], payload["init"]
    out = []
    for pt in payload["points"]:
        fwd = model.synthesize(pt["b"], pt["expected_input_sizes"])
        if fwd is None:
            out.append(None)
            continue
        rep = est.estimate_from_phases(fwd, upd, init,
                                       capacity=pt["capacity"])
        out.append(_report_to_dict(rep))
    return out


def _pool_worker_jobs(payload: dict) -> list[dict]:
    """Full estimates (stage 1 included, under fake tensors on the CPU)
    for picklable jobs in a worker process: probe points, traced beside
    the parent's own probe, and whole sweeps that cannot be modeled."""
    est = XMemEstimator(**payload["estimator"])
    out = []
    for job in payload["jobs"]:
        rep = est.estimate_training(
            job["fwd_bwd_fn"], job["params"], job["batch"],
            update_fn=job["update_fn"], opt_init_fn=job["opt_init_fn"],
            capacity=job["capacity"])
        d = _report_to_dict(rep)
        if payload["want_phases"]:
            d["phases"] = tuple(
                SweepService._strip_for_pool(e)
                for e in est.trace_phases(
                    job["fwd_bwd_fn"], job["params"], job["batch"],
                    job["update_fn"], job["opt_init_fn"]))
        out.append(d)
    return out


def _pool_warm(_i: int) -> bool:
    return True


class _ColumnarLifecycles(Sequence):
    """Tuple-compatible lifecycles view backed by ``ColumnarBlocks``:
    crosses process boundaries as arrays, materializes on first use."""

    def __init__(self, columns: ColumnarBlocks):
        self.columns = columns
        self._mat = None

    def _m(self):
        if self._mat is None:
            self._mat = self.columns.to_lifecycles()
        return self._mat

    def __len__(self):
        return len(self.columns)

    def __getitem__(self, i):
        return self._m()[i]

    def __iter__(self):
        return iter(self._m())

    def __reduce__(self):
        return (_ColumnarLifecycles, (self.columns,))


class SweepService:
    """Reusable sweep runner: shared trace cache, interpolation models
    and (optionally) a persistent process pool for fan-out."""

    def __init__(self, estimator: XMemEstimator | None = None,
                 processes: int = 0):
        self.estimator = estimator or XMemEstimator.for_torch_gpu()
        self.processes = max(int(processes), 0)
        self._pool: ProcessPoolExecutor | None = None

    # -- pool lifecycle ------------------------------------------------------
    def _get_pool(self) -> ProcessPoolExecutor | None:
        if self.processes <= 0:
            return None
        if self._pool is None:
            import multiprocessing as mp
            # spawn: a worker must not inherit the parent's threads (or
            # a CUDA context, where the parent has one)
            self._pool = ProcessPoolExecutor(
                max_workers=self.processes,
                mp_context=mp.get_context("spawn"))
        return self._pool

    def warm_up(self) -> None:
        """Spin up pool workers (spawn + imports) ahead of timed work."""
        pool = self._get_pool()
        if pool is not None:
            list(pool.map(_pool_warm, range(self.processes)))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals -----------------------------------------------------------
    def _fwd_key(self, p: SweepPoint):
        """The forward phase's trace key, built exactly as
        ``XMemEstimator._trace_phase`` builds it, and the flat leaves."""
        flat, kinds, _ = flatten_kinds(
            [(p.params, BlockKind.PARAM, "params"),
             (p.batch, BlockKind.INPUT, "batch")])
        specs = (pytree.tree_structure(p.params),
                 pytree.tree_structure(p.batch))
        return trace_key(p.fwd_bwd_fn, "fwd", flat, specs, kinds,
                         Phase.FORWARD_BACKWARD), flat

    def _estimate_full(self, p: SweepPoint) -> EstimateReport:
        return self.estimator.estimate_training(
            p.fwd_bwd_fn, p.params, p.batch, update_fn=p.update_fn,
            opt_init_fn=p.opt_init_fn, shard_factor_fn=p.shard_factor_fn,
            collective_specs=p.collective_specs, capacity=p.capacity)

    def _estimator_config(self) -> dict:
        est = self.estimator
        return dict(allocator_policy=est.allocator_policy,
                    orchestrator_policy=est.orchestrator.policy,
                    iterations=est.iterations,
                    capacity=est.capacity,
                    cublas_workspace=est.cublas_workspace)

    @staticmethod
    def _strip_for_pool(entry: TracedPhase | None) -> TracedPhase | None:
        """Make a phase payload lean: ship lifecycles as columns (object
        pickling of thousands of dataclasses is the slow part)."""
        if entry is None:
            return None
        return dataclasses.replace(
            entry, lifecycles=_ColumnarLifecycles(
                ColumnarBlocks.from_lifecycles(entry.lifecycles)))

    @staticmethod
    def _report_from_pool(d: dict) -> EstimateReport:
        sim = SimResult(
            peak_reserved=d["sim_peak_reserved"],
            peak_allocated=d["sim_peak_allocated"],
            oom=d["oom"], oom_at=d["sim_oom_at"],
            curve=[],                  # dropped for IPC leanness
            stats=d["sim_stats"], segments=d["sim_segments"])
        return EstimateReport(
            peak_bytes=d["peak_bytes"],
            peak_tensor_bytes=d["peak_tensor_bytes"],
            persistent_bytes=d["persistent_bytes"],
            oom=d["oom"], sim=sim, breakdown=d["breakdown"],
            wall_time_s=0.0, num_events=d["num_events"],
            sim_unbounded=d["sim_unbounded"], depth=d["depth"])

    @staticmethod
    def _picklable_jobs(gpoints: list[SweepPoint]) -> bool:
        """Can these jobs' functions and inputs cross a process
        boundary? (Module-level step functions can; closures cannot.)"""
        import pickle
        try:
            p = gpoints[0]
            pickle.dumps((p.fwd_bwd_fn, p.update_fn, p.opt_init_fn,
                          p.params, p.batch))
            return True
        except Exception:   # noqa: BLE001 — any pickling failure
            return False

    @staticmethod
    def _job_payload(p: SweepPoint) -> dict:
        return {"fwd_bwd_fn": p.fwd_bwd_fn, "params": p.params,
                "batch": p.batch, "update_fn": p.update_fn,
                "opt_init_fn": p.opt_init_fn, "capacity": p.capacity}

    def _run_group(self, points, idxs, scalars, reports, sources,
                   stats) -> None:
        """Estimate one interpolation group (same functions, params)."""
        est = self.estimator
        pool = self._get_pool()
        gpoints = [points[i] for i in idxs]
        distinct = sorted(set(scalars)) if scalars is not None else []
        # points with shard factors or collectives stay in this process
        plain = all(p.shard_factor_fn is None and not p.collective_specs
                    for p in gpoints)
        picklable = (pool is not None and plain
                     and self._picklable_jobs(gpoints))

        def traced(i, rep):
            reports[i] = rep
            sources[i] = "probe"
            stats["traced"] += 1

        if scalars is None or len(distinct) < 4:
            # no 1-D structure worth modeling: full estimates, fanned out
            # over the pool when the jobs can travel
            if picklable and len(idxs) > 1:
                self._pool_full_jobs(points, idxs, reports, sources, stats)
            else:
                for i in idxs:
                    traced(i, self._estimate_full(points[i]))
            return

        # --- probes: min / median / max scalars, traced for real -------
        probe_vals = [distinct[0], distinct[len(distinct) // 2],
                      distinct[-1]]
        probe_idx = {}
        for i, b in zip(idxs, scalars):
            if b in probe_vals and b not in probe_idx:
                probe_idx[b] = i
        probe_entries: list[tuple[int, TracedPhase]] = []
        upd_entry = init_entry = None

        def note_probe(b, fwd, upd, init):
            nonlocal upd_entry, init_entry
            if fwd is not None:
                probe_entries.append((b, fwd))
                upd_entry, init_entry = upd, init

        def probe_here(b, i):
            traced(i, self._estimate_full(points[i]))
            key, _ = self._fwd_key(points[i])
            entry = est.trace_cache.get(points[i].fwd_bwd_fn, key)
            note_probe(b, entry, *est.trace_phases(
                points[i].fwd_bwd_fn, points[i].params, points[i].batch,
                points[i].update_fn, points[i].opt_init_fn,
                fwd=entry)[1:])

        if picklable:
            # the parent traces the min probe while workers trace the rest
            futures = [
                (b, probe_idx[b], pool.submit(_pool_worker_jobs, {
                    "estimator": self._estimator_config(),
                    "jobs": [self._job_payload(points[probe_idx[b]])],
                    "want_phases": True}))
                for b in probe_vals[1:]]
            probe_here(probe_vals[0], probe_idx[probe_vals[0]])
            for b, i, fut in futures:
                d = fut.result()[0]
                fwd, upd, init = d.pop("phases")
                traced(i, self._report_from_pool(d))
                stats["pooled"] += 1
                note_probe(b, fwd, upd, init)
                # seed the parent cache so duplicate scalars and
                # fallbacks do not re-trace
                key, _ = self._fwd_key(points[i])
                est.trace_cache.put(points[i].fwd_bwd_fn, key, fwd)
        else:
            for b in probe_vals:
                probe_here(b, probe_idx[b])

        # build the model from a structurally consistent probe trio; if
        # one probe diverged structurally, trace one repair probe and
        # trust only the range the consistent probes span. An outer probe
        # that diverged (batch 1: size-1 dims make some copies no-ops)
        # is repaired by its nearest neighbour, which keeps the widest
        # range; a diverged median, between the outer two (the JAX
        # package always repairs between the consistent two)
        model = None
        if len(probe_entries) == 3:
            groups: dict = {}
            for b, e in probe_entries:
                groups.setdefault(_trace_sig(e), []).append((b, e))
            consistent = max(groups.values(), key=len)
            if len(consistent) == 2:
                bl = min(b for b, _ in consistent)
                bh = max(b for b, _ in consistent)
                scalar_index = {}
                for i, b in zip(idxs, scalars):
                    scalar_index.setdefault(b, i)
                if bl > distinct[0]:        # the min probe diverged
                    near = [b for b in distinct if b < bl]
                elif bh < distinct[-1]:     # the max probe diverged
                    near = [b for b in reversed(distinct) if b > bh]
                else:                       # the median diverged
                    near = []
                near = [b for b in near if b not in probe_idx]
                spare = [b for b in distinct
                         if bl < b < bh and b not in probe_idx]
                bm = (near[0] if near
                      else spare[len(spare) // 2] if spare else None)
                if bm is not None:
                    i = scalar_index[bm]
                    traced(i, self._estimate_full(points[i]))
                    probe_idx[bm] = i
                    key, _ = self._fwd_key(points[i])
                    e = est.trace_cache.get(points[i].fwd_bwd_fn, key)
                    if e is not None and _trace_sig(e) == \
                            _trace_sig(consistent[0][1]):
                        consistent.append((bm, e))
            if len(consistent) >= 3:
                model = _PhaseModel(sorted(consistent,
                                           key=lambda x: x[0])[:3])
                if not model.ok:
                    model = None
        stats["model"] = (None if model is None
                          else [model.b_lo, model.b_hi])

        # --- remaining points ------------------------------------------
        rest = [(i, b) for i, b in zip(idxs, scalars) if i not in reports]
        chunk_points: list[tuple[int, dict]] = []
        full_left: list[int] = []
        for i, b in rest:
            p = points[i]
            if b in probe_idx:          # duplicate scalar: cache-hot
                traced(i, self._estimate_full(p))
                continue
            if model is None or not (model.b_lo <= b <= model.b_hi):
                full_left.append(i)     # no model, or outside its range
                continue
            _key, flat = self._fwd_key(p)
            expected = [_aval_nbytes(leaf) for leaf in flat
                        if isinstance(leaf, torch.Tensor)]
            if picklable and model.out_constant:
                chunk_points.append((i, {
                    "b": b, "expected_input_sizes": expected,
                    "capacity": p.capacity}))
                continue
            fwd = model.synthesize(b, expected)
            if fwd is None:
                full_left.append(i)
                continue
            fwd, upd, init = est.trace_phases(
                p.fwd_bwd_fn, p.params, p.batch, p.update_fn,
                p.opt_init_fn, fwd=fwd)
            reports[i] = est.estimate_from_phases(
                fwd, upd, init, shard_factor_fn=p.shard_factor_fn,
                collective_specs=p.collective_specs, capacity=p.capacity)
            sources[i] = "interpolated"
            stats["interpolated"] += 1

        if chunk_points:
            # round-robin chunks: one payload per worker carries the
            # model and the shared optimizer phases once; the parent
            # keeps one share and works it while the pool drains
            shared = {
                "estimator": self._estimator_config(),
                "model": model.stripped(),
                "upd": self._strip_for_pool(upd_entry),
                "init": self._strip_for_pool(init_entry),
            }
            n_chunks = max(min(self.processes + 1, len(chunk_points)), 1)
            chunks = [chunk_points[k::n_chunks] for k in range(n_chunks)]
            own, worker_chunks = chunks[-1], chunks[:-1]
            futures = []
            for chunk in worker_chunks:
                payload = dict(shared)
                payload["points"] = [meta for _i, meta in chunk]
                futures.append((chunk, pool.submit(_pool_worker_chunk,
                                                   payload)))
            for i, meta in own:
                fwd = model.synthesize(meta["b"],
                                       meta["expected_input_sizes"])
                if fwd is None:
                    full_left.append(i)
                    continue
                reports[i] = est.estimate_from_phases(
                    fwd, upd_entry, init_entry, capacity=meta["capacity"])
                sources[i] = "interpolated"
                stats["interpolated"] += 1
            for chunk, fut in futures:
                for (i, _meta), d in zip(chunk, fut.result()):
                    if d is None:   # in-worker exactness check failed
                        full_left.append(i)
                        continue
                    reports[i] = self._report_from_pool(d)
                    sources[i] = "interpolated"
                    stats["pooled"] += 1
                    stats["interpolated"] += 1

        if full_left:
            stats["fallback"] += len(full_left)
            if picklable and len(full_left) > 1:
                self._pool_full_jobs(points, full_left, reports, sources,
                                     stats)
            else:
                for i in full_left:
                    traced(i, self._estimate_full(points[i]))
            for i in full_left:
                sources[i] = "fallback"

    def _pool_full_jobs(self, points, idxs, reports, sources,
                        stats) -> None:
        """Fan whole estimates out over the pool (picklable jobs only)."""
        pool = self._get_pool()
        n_chunks = max(min(self.processes, len(idxs)), 1)
        chunks = [idxs[k::n_chunks] for k in range(n_chunks)]
        futures = []
        for chunk in chunks:
            payload = {"estimator": self._estimator_config(),
                       "jobs": [self._job_payload(points[i])
                                for i in chunk],
                       "want_phases": False}
            futures.append((chunk, pool.submit(_pool_worker_jobs,
                                               payload)))
        for chunk, fut in futures:
            for i, d in zip(chunk, fut.result()):
                reports[i] = self._report_from_pool(d)
                sources[i] = "probe"
                stats["traced"] += 1
                stats["pooled"] += 1

    # -- public API ----------------------------------------------------------
    def estimate_mesh_sweep(self, fwd_bwd_fn, params, batch,
                            topologies: Sequence[MeshTopology], *,
                            update_fn=None, opt_init_fn=None, cfg=None,
                            shard_factors: str = "spec",
                            collectives: bool = True,
                            capacity: int | None = None) -> MeshSweepResult:
        """Per-device estimates for a grid of mesh topologies from ONE
        set of phase traces.

        Stage 1 (tracing) does not depend on the topology: the phases
        are traced once (or served from the trace cache), and stages 2-5
        (compose, shard factors, per-axis collective injection, replay)
        run per topology. With ``shard_factors="spec"`` each topology's
        factors come from the specs the sharding engine would place at
        that mesh, divisibility fallbacks included; ``collectives=True``
        injects the per-axis staging buffers (``mesh_collective_specs``).
        ``capacity`` is the replay's, as for ``estimate_training``."""
        from ..distributed.sharding import (mesh_collective_specs,
                                            shard_factor_fn)
        t0 = time.perf_counter()
        est = self.estimator
        cache = est.trace_cache
        h0, m0 = cache.hits, cache.misses
        fwd, upd, init = est.trace_phases(fwd_bwd_fn, params, batch,
                                          update_fn, opt_init_fn)
        t_trace = time.perf_counter() - t0
        opt_state = init.out_shape if init is not None else None
        reports = []
        for topo in topologies:
            mesh = topo.axis_sizes
            pol = topo.sharding_policy()
            factor = shard_factor_fn(cfg, mesh, pol, mode=shard_factors,
                                     params=params, opt_state=opt_state,
                                     batch=batch)
            specs = (mesh_collective_specs(mesh, pol)
                     if collectives else ())
            reports.append(est.estimate_from_phases(
                fwd, upd, init, shard_factor_fn=factor,
                collective_specs=specs, capacity=capacity))
        stats = {
            "topologies": len(reports),
            "trace_s": t_trace,
            "trace_cache": {"hits": cache.hits - h0,
                            "misses": cache.misses - m0},
            "wall_s": time.perf_counter() - t0,
            "shard_factors": shard_factors,
        }
        return MeshSweepResult(list(topologies), reports, stats)

    def estimate_serving_sweep(self, step_fn, params, cache, batch, *,
                               stream, knob_grid: Sequence,
                               kv_bytes_per_token: int,
                               resident_bytes_per_request: int = 0,
                               capacity: int | None = None
                               ) -> ServingSweepResult:
        """Serving estimates for a grid of ``ServingKnobs`` from at most
        ONE fresh decode trace. Tracing does not depend on the knobs
        (page size, concurrency and KV dtype change only the request
        stream's lowering and the allocator replay), so the whole grid
        shares one cached trace, ``estimate_serving``'s for the same
        step and shapes; ``stats["trace_cache"]`` counts the misses."""
        t0 = time.perf_counter()
        est = self.estimator
        tcache = est.trace_cache
        h0, m0 = tcache.hits, tcache.misses
        estimates = [
            est.estimate_request_stream(
                step_fn, params, cache, batch, stream=stream,
                knobs=k, kv_bytes_per_token=kv_bytes_per_token,
                resident_bytes_per_request=resident_bytes_per_request,
                capacity=capacity)
            for k in knob_grid]
        stats = {
            "knobs": len(estimates),
            "trace_cache": {"hits": tcache.hits - h0,
                            "misses": tcache.misses - m0},
            "wall_s": time.perf_counter() - t0,
        }
        return ServingSweepResult(list(knob_grid), estimates, stats)

    def estimate_many(self, points: Sequence[SweepPoint],
                      interpolate: bool = True) -> SweepResult:
        """One report per point, in order, each equal to the point's
        sequential ``estimate_training``. ``sources[i]`` says how point
        ``i`` was estimated: ``probe`` (a trace, possibly from the
        cache), ``interpolated`` (a synthesized trace) or ``fallback``
        (traced for real after the model refused it)."""
        t0 = time.perf_counter()
        points = list(points)
        reports: dict[int, EstimateReport] = {}
        sources: dict[int, str] = {}
        cache = self.estimator.trace_cache
        h0, m0 = cache.hits, cache.misses
        stats = {"points": len(points), "traced": 0, "interpolated": 0,
                 "fallback": 0, "pooled": 0,
                 "pool_workers": self.processes}

        # group points that can share an interpolation model: the same
        # functions, the same params signature
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(points):
            key = (id(p.fwd_bwd_fn), id(p.update_fn), id(p.opt_init_fn),
                   _leaf_sig(p.params))
            groups.setdefault(key, []).append(i)

        for idxs in groups.values():
            gpoints = [points[i] for i in idxs]
            scalars = _sweep_scalars(gpoints) if interpolate else None
            self._run_group(points, idxs, scalars, reports, sources, stats)

        stats["wall_s"] = time.perf_counter() - t0
        stats["trace_cache"] = {"hits": cache.hits - h0,
                                "misses": cache.misses - m0}
        stats["cache"] = cache.stats()
        n = len(points)
        return SweepResult([reports[i] for i in range(n)], stats,
                           [sources[i] for i in range(n)])


def estimate_many(points: Sequence[SweepPoint],
                  estimator: XMemEstimator | None = None,
                  processes: int = 0,
                  interpolate: bool = True) -> SweepResult:
    """One-shot sweep: see :class:`SweepService`. Creating a service is
    preferable when sweeping repeatedly (warm pool and cache)."""
    svc = SweepService(estimator, processes=processes)
    try:
        return svc.estimate_many(points, interpolate=interpolate)
    finally:
        svc.close()

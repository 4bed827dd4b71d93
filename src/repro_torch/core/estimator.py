"""xMem estimator for PyTorch steps (port of ``repro.core.estimator``).

``XMemEstimator.estimate_training`` is the paper's workflow:

1. trace the job's phases on the CPU under fake tensors
   (``tracer.py``): forward+backward, optimizer init and update; the
   phases are cached (``cache.py``), so a gate's batch candidates trace
   the batch-independent init and update once;
2. classify lifecycles (``analyzer.py``);
3. compose N iterations on one timeline (``_compose_periodic``):
   optimizer state materializes at the first update and persists, which
   is why the paper analyzes >= 2 iterations (we default to 3 like the
   paper); iterations 2..N-2 are a shifted template;
4. orchestrate lifecycles (persistence, gradient release, batches,
   collective injection, sharding), and, in the GPU preset, add
   cuBLAS's two workspaces to the first iteration;
5. replay through the CUDA caching allocator simulation -> peak
   reserved bytes, the estimate, and the OOM verdict.

``estimate_serving`` is the single-phase estimate of a prefill or
decode step with a persistent KV cache; ``estimate_request_stream``
composes a decode step's working set with a paged-KV request stream
(``ServingEstimate``).

Host offload (``OrchestratorPolicy.offload``, an ``OffloadPlan``) is a
separate pass after the orchestrator's: the concretely composed
iterations' optimizer state and a fraction of their saved activations
move to a host space, device staging copies cover the transfers, and
the replay runs per memory space (``breakdown["space_peaks"]``,
``breakdown["offload"]``); the capacity verdict and the phase breakdown
are the device's. Neither the port's step nor the reference's executes
host offload: an offloaded estimate is a plan's, not a run's.

``fastpath=False`` is the frozen reference pipeline: no trace cache,
lifecycles re-derived from the event stream, every iteration composed
concretely, the orchestrator's passes one by one, the object replay
engine. The fast path must match it on every estimate field
(``tests/test_torch_offload.py``); it rejects host offload, as the
reference does. ``calibrate`` fits the transient scale from measured
peaks.

Per-device estimates of a sharded job (the paper's §6.2 extension):
``shard_factor_fn`` (``distributed.sharding.shard_factor_fn``: a
block's division factor from the specs the rule engine places) and
``collective_specs`` (``mesh_collective_specs``: per-axis staging
buffers) enter stage 4 as in the JAX package: the collectives are
injected at the phase bounds of the concretely composed iterations,
sized from the per-device blocks, then every block gets its factor and
the replay runs on per-device sizes. Neither enters the trace key: one
trace serves every mesh (``SweepService.estimate_mesh_sweep``).
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..obs import spans as obs_spans
from .allocator import AllocatorPolicy, CUDA_CACHING, CUDA_CACHING_TORCH
from .analyzer import classify_blocks, phase_peaks, reconstruct_lifecycles
from .cache import BlockInfo, TraceCache, TracedPhase, trace_key
from .depth import compose, depth_plan
from .loops import compose_steps, merge_loops
from .events import (BlockKind, BlockLifecycle, MemorySpace, PeriodicBlocks,
                     Phase, peak_live_bytes, periodic_breakdown_peaks_fast,
                     reduced_for_breakdown)
from .orchestrator import (CollectiveSpec, ContinuousBatchingScheduler,
                           MemoryOrchestrator, OrchestratorPolicy,
                           ServingKnobs)
from .simulator import MemorySimulator, SimResult, split_blocks_by_space
from .tracer import trace_fn

#: bytes of the workspace cuBLAS gets from the caching allocator for each
#: (thread, stream) handle at its first matmul, held for good (torch 2.11
#: on an H100; the first matmul of a process adds 33,554,432 B)
CUBLAS_WORKSPACE_BYTES = 32 << 20
_MATMULS = frozenset({"aten::mm", "aten::addmm", "aten::bmm",
                      "aten::baddbmm"})
#: ids of the workspace blocks: below the orchestrator's upcast
#: (-100000) and offload (-200000 down) namespaces, so an offloaded
#: composition's staging copies never share an id with a workspace
_WORKSPACE_BID = -300_000


def calibration_scale(pairs, quantile: float = 0.9) -> float:
    """The transient scale ``calibrate`` fits from ``(report, truth)``
    pairs: the ``quantile`` of measured over estimated transient bytes
    (peak tensor bytes above the persistent ones), 1.0 without a usable
    pair."""
    ratios = []
    for rep, truth in pairs:
        t_est = rep.peak_tensor_bytes - rep.persistent_bytes
        t_true = truth - rep.persistent_bytes
        if t_est > 0 and t_true > 0:
            ratios.append(t_true / t_est)
    return float(np.quantile(ratios, quantile)) if ratios else 1.0


def flatten_kinds(args_with_kinds: Sequence[tuple]
                  ) -> tuple[list, list[BlockKind], list[str]]:
    """Flatten (pytree, kind, name) triples into tracer-aligned lists."""
    flat_args, kinds, scopes = [], [], []
    for tree, kind, name in args_with_kinds:
        leaves = pytree.tree_leaves(tree)
        flat_args.extend(leaves)
        kinds.extend([kind] * len(leaves))
        scopes.extend([f"{name}[{i}]" for i in range(len(leaves))])
    return flat_args, kinds, scopes


def _fwd_out_kinds(out) -> list[BlockKind]:
    """A forward+backward's output kinds: the loss leaves ``OUTPUT``,
    the gradients ``GRAD``."""
    n_out = len(pytree.tree_leaves(out))
    n_loss = len(pytree.tree_leaves(out[0])) if isinstance(out, tuple) else 1
    return [BlockKind.OUTPUT] * n_loss + [BlockKind.GRAD] * (n_out - n_loss)


def _to_meta(tree):
    """A step's (fake) outputs as ``meta`` tensors: shapes and dtypes
    for the next phase's trace, holding no fake-tensor mode alive."""
    return pytree.tree_map(
        lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def trace_entry(fn, args_with_kinds, phase, out_kind_fn=None,
                grad: bool = False, labeller=None, step_labeller=None):
    """Trace ``fn`` on the ``(tree, kind, name)`` arguments into a
    ``TracedPhase``; returns it and the tracer."""
    flat, kinds, scopes = flatten_kinds(args_with_kinds)
    specs = [pytree.tree_structure(t) for t, _, _ in args_with_kinds]
    counts = [spec.num_leaves for spec in specs]

    def flat_fn(*leaves):
        rebuilt, i = [], 0
        for spec, n in zip(specs, counts):
            rebuilt.append(pytree.tree_unflatten(leaves[i:i + n], spec))
            i += n
        return fn(*rebuilt)

    trace, tr, out = trace_fn(flat_fn, *flat, arg_kinds=kinds,
                              arg_scopes=scopes, phase=phase, grad=grad,
                              out_kind_fn=out_kind_fn, labeller=labeller,
                              step_labeller=step_labeller)
    entry = TracedPhase(
        trace=trace, lifecycles=tuple(tr.lifecycles()),
        input_blocks=tuple(BlockInfo(b.bid, b.size, b.kind, b.shape)
                           for b in tr.input_blocks),
        output_blocks=tuple(BlockInfo(b.bid, b.size, b.kind, b.shape)
                            for b in tr.output_blocks),
        out_shape=_to_meta(out), arg_leaf_counts=tuple(counts))
    return entry, tr


def _depth_info(entry: TracedPhase) -> dict:
    """How a stepped phase's trace was made, as a report carries it:
    its depth composition, with its step-loop composition (``loops``)
    when it has loops long enough to compose."""
    depth = dict(entry.trace.meta.get("depth") or {})
    loops = entry.trace.meta.get("loops")
    if depth and loops and loops["loops"]:
        depth["loops"] = dict(loops)
    return depth


def trace_fwd_in_full(fwd_bwd_fn, params, batch) -> TracedPhase:
    """The forward+backward phase traced at its real depth, never
    composed and never cached: what a composed phase must equal.
    ``XMemEstimator.trace_phases(..., fwd=...)`` takes it."""
    return trace_entry(fwd_bwd_fn, [(params, BlockKind.PARAM, "params"),
                                    (batch, BlockKind.INPUT, "batch")],
                       Phase.FORWARD_BACKWARD, _fwd_out_kinds, grad=True)[0]


@dataclasses.dataclass
class EstimateReport:
    peak_bytes: int               # reserved segments — THE estimate
    peak_tensor_bytes: int        # live-tensor peak (naive lower bound)
    persistent_bytes: int         # params + opt state (+ cache, serving)
    oom: bool
    sim: SimResult
    breakdown: dict               # per-kind / per-phase summary
    wall_time_s: float
    num_events: int
    cache_stats: dict = dataclasses.field(default_factory=dict)
    # the composed timeline and whether ``sim`` replayed it unbounded
    # (``min_feasible_capacity`` reuses both)
    composition: Any = dataclasses.field(default=None, repr=False)
    sim_unbounded: bool = False
    # how the stepped phase's trace was made (``depth.py``): ``source``
    # "composed", "traced" or "fallback", the units, the units traced,
    # and its step loops' composition (``loops``, ``loops.py``);
    # ``probe_traces``: the probes this estimate traced (0 on a hit)
    depth: dict = dataclasses.field(default_factory=dict)

    def fits(self, capacity: int) -> bool:
        return self.peak_bytes <= capacity


class XMemEstimator:
    """Peak-memory estimator; ``for_torch_gpu()`` is the port's preset."""

    def __init__(self,
                 allocator_policy: AllocatorPolicy = CUDA_CACHING,
                 orchestrator_policy: OrchestratorPolicy | None = None,
                 iterations: int = 3,
                 capacity: int = 1 << 62,
                 trace_cache: TraceCache | None = None,
                 cublas_workspace: int = 0,
                 checkpoint: Callable[[str], None] | None = None,
                 fastpath: bool = True):
        self.allocator_policy = allocator_policy
        self.fastpath = fastpath
        self.cublas_workspace = cublas_workspace
        self.orchestrator = MemoryOrchestrator(
            orchestrator_policy or OrchestratorPolicy())
        self.iterations = iterations
        self.capacity = capacity
        # explicit None check: an empty TraceCache is falsy (__len__)
        self.trace_cache = TraceCache() if trace_cache is None \
            else trace_cache
        # stage hook (the admission service's fault sites): called with
        # "tracer" after a trace-cache miss, just before the fake-tensor
        # trace, and with "replay" before the allocator replay
        self.checkpoint = checkpoint
        # traces made at probe depths to compose deeper ones (depth.py)
        self.probe_traces = 0

    @classmethod
    def for_torch_gpu(cls, **kw) -> "XMemEstimator":
        """The CUDA caching allocator simulation as torch runs it
        (``CUDA_CACHING_TORCH``: a refused segment grant releases every
        cached segment before the retry) with eager semantics:
        no fusion folding, no donation, and every gradient alive until
        the in-place update that reads it has finished
        (``grad_release="after_update"``). No synthetic f32 copies of
        the gradients are injected (``optimizer_upcast_coexist``): the
        traced update records its real f32 working copies, leaf by
        leaf, and the JAX preset's all-gradients-at-once copies would
        add twice the gradient bytes the card never allocates. A training
        job's first iteration allocates cuBLAS's workspaces."""
        kw.setdefault("allocator_policy", CUDA_CACHING_TORCH)
        kw.setdefault("cublas_workspace", CUBLAS_WORKSPACE_BYTES)
        kw.setdefault("orchestrator_policy", OrchestratorPolicy(
            grad_release="after_update", donate_params=False,
            donate_opt_state=False, fusion_folding=False,
            optimizer_upcast_coexist=False))
        return cls(**kw)

    def with_cache(self, trace_cache: TraceCache) -> "XMemEstimator":
        """A new estimator with this one's settings over
        ``trace_cache`` (the admission service's per-thread estimators
        around a caller's estimator)."""
        return XMemEstimator(
            allocator_policy=self.allocator_policy,
            orchestrator_policy=self.orchestrator.policy,
            iterations=self.iterations, capacity=self.capacity,
            trace_cache=trace_cache,
            cublas_workspace=self.cublas_workspace, fastpath=self.fastpath)

    def calibrate(self, samples: Sequence[tuple],
                  quantile: float = 0.9) -> float:
        """Fit the transient scale from ``((fwd_bwd, params, batch,
        update_fn, opt_init_fn), truth_bytes)`` samples: the explicit
        form of the paper's calibration loop, one constant per backend
        (``calibration_scale`` over each sample's estimate). The
        ``quantile`` skews high because an underestimate (an OOM) costs
        a scheduler more than headroom does. Returns the scale, also
        set on this estimator's orchestrator policy."""
        pairs = []
        for (fwd_bwd, params, batch, update_fn, opt_init_fn), truth \
                in samples:
            pairs.append((self.estimate_training(
                fwd_bwd, params, batch, update_fn=update_fn,
                opt_init_fn=opt_init_fn), truth))
        scale = calibration_scale(pairs, quantile)
        self.orchestrator.policy = dataclasses.replace(
            self.orchestrator.policy, transient_scale=scale)
        return scale

    # -- phase tracing (cached) -------------------------------------------
    def _trace_phase(self, fn, args_with_kinds, phase,
                     out_kind_fn: Callable | None = None, tag: str = "",
                     grad: bool = False, cached: bool = True) -> TracedPhase:
        """One phase's trace, from the cache or fresh. On the fast path a
        step with a depth plan deep enough is composed from probe traces
        (``depth.py``), and the long step loops inside its layers from
        probes at a few steps, in the phase or in each depth probe
        (``loops.py``); the result is one trace all the same, cached and
        stored under the real key, and the probes are counted on their
        own (``probe_traces``)."""
        flat, kinds, _ = flatten_kinds(args_with_kinds)
        specs = [pytree.tree_structure(t) for t, _, _ in args_with_kinds]
        cache = self.trace_cache if cached else None
        key = None
        if cache is not None:
            key = trace_key(fn, tag, flat, tuple(specs), kinds, phase)
            hit = cache.get(fn, key)
            if hit is not None:
                return hit
        if self.checkpoint is not None:
            self.checkpoint("tracer")
        plan = depth_plan(fn) if cached and self.fastpath else None
        entry = None
        made: list[dict] = []     # each trace's step-loop composition

        def traced(f, awk, labeller=None):
            """One trace of ``f``, its step loops composed (loops.py)."""
            e, labels, li = compose_steps(
                lambda step_labeller, unit_labeller: trace_entry(
                    f, awk, phase, out_kind_fn, grad, unit_labeller,
                    step_labeller), labeller)
            made.append(li)
            self.probe_traces += li["probes"]
            # what ``depth.compose`` reads of a tracer: the unit labels
            return e, types.SimpleNamespace(labels=labels)

        with obs_spans.span("estimator.trace", phase=str(phase), tag=tag):
            if plan is not None and plan.composes:
                entry, info = compose(plan, args_with_kinds, traced)
                # a depth probe whose loops were composed is counted by
                # its step probes, not as a trace of its own
                self.probe_traces += sum(not li["probes"]
                                         for li in made[:info["probes"]])
            if entry is None and plan is None:
                entry, _tr = trace_entry(fn, args_with_kinds, phase,
                                         out_kind_fn, grad)
            elif entry is None:
                entry, _tr = traced(fn, args_with_kinds)
                entry.trace.meta["depth"] = (
                    info if plan.composes
                    else {"source": "traced", "units": plan.units,
                          "units_traced": plan.units})
            if plan is not None:
                entry.trace.meta["loops"] = merge_loops(
                    made, composed_depth=entry.trace.meta["depth"].get(
                        "source") == "composed")
        if cache is not None:
            cache.put(fn, key, entry)
        return entry

    # -- periodic composition ---------------------------------------------
    def _compose_periodic(self, fwd: TracedPhase, upd: TracedPhase | None,
                          init: TracedPhase | None
                          ) -> tuple[PeriodicBlocks, dict]:
        """Stitch phase traces into an N-iteration timeline in O(blocks).

        Iterations {0, 1, N-1} are materialized concretely; iterations
        2..N-2 are exact shifted copies of iteration 1 represented by the
        (cycle, n_cycles, period) template. The last iteration stays
        concrete because gradient release has no next iteration to free
        into.
        """
        N = self.iterations
        cursor = 0
        next_bid = [0]
        update_start: dict[int, int] = {}
        bwd_start: dict[int, int] = {}
        iteration_ends: dict[int, int] = {}

        def fresh_bid() -> int:
            next_bid[0] += 1
            return next_bid[0]

        def place(entry: TracedPhase, it: int, phase: Phase, target: list,
                  output_kind: BlockKind | None = None) -> None:
            nonlocal cursor
            input_bids = {b.bid for b in entry.input_blocks}
            output_bids = ({b.bid for b in entry.output_blocks}
                           if output_kind is not None else ())
            cur = cursor
            bid = next_bid[0]
            append = target.append
            for lc in entry.lifecycles:
                lcb = lc.block_id
                if lcb in input_bids:
                    continue
                ft = lc.free_t
                bid += 1
                append(BlockLifecycle(
                    bid, lc.size, lc.alloc_t + cur,
                    None if ft is None else ft + cur, it, phase, lc.op,
                    lc.scope,
                    output_kind if lcb in output_bids else lc.block_kind,
                    lc.shard_factor, lc.shape))
            next_bid[0] = bid
            cursor = cur + len(entry.trace.events) + 1

        def one_iteration(it: int, target: list, with_init: bool) -> None:
            nonlocal cursor
            for b in fwd.input_blocks:
                if b.kind is BlockKind.INPUT and b.size > 0:
                    target.append(BlockLifecycle(
                        fresh_bid(), b.size, cursor, None, it, Phase.DATA,
                        "host_to_device", "batch", BlockKind.INPUT,
                        1.0, b.shape))
            cursor += 1
            bwd_start[it] = cursor
            place(fwd, it, Phase.FORWARD_BACKWARD, target)
            update_start[it] = cursor
            if with_init and init is not None:
                place(init, it, Phase.OPTIMIZER, target,
                      output_kind=BlockKind.OPT_STATE)
            if upd is not None:
                place(upd, it, Phase.OPTIMIZER, target,
                      output_kind=BlockKind.OUTPUT)
            iteration_ends[it] = cursor

        prefix: list[BlockLifecycle] = []
        cycle: list[BlockLifecycle] = []
        suffix: list[BlockLifecycle] = []

        # t=0: persistent parameter blocks (one per leaf, from fwd inputs)
        for b in fwd.input_blocks:
            if b.kind is BlockKind.PARAM and b.size > 0:
                prefix.append(BlockLifecycle(
                    fresh_bid(), b.size, 0, None, 0, Phase.INIT,
                    "init", "params", BlockKind.PARAM, 1.0, b.shape))
        cursor += 1

        one_iteration(0, prefix, with_init=True)
        period = 0
        cycle_start = cursor
        if N >= 3:
            one_iteration(1, cycle, with_init=False)
            period = cursor - cycle_start
            # iterations 2..N-2 are implicit template replicas; synthetic
            # next-iteration keys let gradient and output release resolve
            # the template's frees one period ahead
            update_start[2] = update_start[1] + period
            iteration_ends[2] = iteration_ends[1] + period
            cursor = cycle_start + (N - 2) * period
        if N >= 2:
            one_iteration(N - 1, suffix, with_init=False)

        n_cycles = max(N - 2, 0)
        meta = dict(iteration_ends=iteration_ends,
                    update_start=update_start, bwd_start=bwd_start,
                    horizon=cursor + 2, cycle_start=cycle_start,
                    period=period, n_cycles=n_cycles)
        pb = PeriodicBlocks(prefix, cycle, n_cycles, period, suffix,
                            meta={"cycle_start": cycle_start})
        return pb, meta

    def _cublas_workspaces(self, first_iteration) -> list[BlockLifecycle]:
        """cuBLAS's workspaces in a job that has a process of its own: one
        for each thread's handle, from its first matmul on: the job's
        thread at the first forward matmul, the autograd engine's thread
        at the first backward one."""
        out = []
        for scope in ("", "backward"):
            first = min((b.alloc_t for b in first_iteration
                         if b.op in _MATMULS and b.scope == scope),
                        default=None)
            if first is not None:
                out.append(BlockLifecycle(
                    _WORKSPACE_BID - len(out), self.cublas_workspace, first,
                    None,
                    0, Phase.FORWARD_BACKWARD, "cublas_workspace", scope,
                    BlockKind.TEMP))
        return out

    # -- public API ---------------------------------------------------------
    def estimate_training(self,
                          fwd_bwd_fn: Callable,     # (params, batch) -> (loss, grads)
                          params, batch,
                          update_fn: Callable | None = None,  # (params, grads, opt_state) -> (params, opt_state)
                          opt_init_fn: Callable | None = None,  # params -> opt_state
                          shard_factor_fn=None,
                          collective_specs: Sequence[CollectiveSpec] = (),
                          capacity: int | None = None) -> EstimateReport:
        """Peak memory of ``iterations`` training steps. ``params`` and
        ``batch`` are pytrees of tensors of any device (``meta`` ones
        allocate nothing): only shapes and dtypes are read. With
        ``shard_factor_fn``/``collective_specs`` the estimate is one
        device's of a sharded job."""
        t0 = time.perf_counter()
        if not self.fastpath:
            policy_before = self.orchestrator.policy
            try:
                return self._estimate_training_reference(
                    fwd_bwd_fn, params, batch, update_fn, opt_init_fn,
                    shard_factor_fn, collective_specs, capacity, t0)
            finally:
                self.orchestrator.policy = policy_before
        cache = self.trace_cache
        h0, m0, p0 = cache.hits, cache.misses, self.probe_traces
        fwd, upd, init = self.trace_phases(fwd_bwd_fn, params, batch,
                                           update_fn, opt_init_fn)
        cache_stats = {"hits": cache.hits - h0, "misses": cache.misses - m0,
                       "global": cache.stats()}
        rep = self.estimate_from_phases(
            fwd, upd, init, shard_factor_fn=shard_factor_fn,
            collective_specs=collective_specs, capacity=capacity, t0=t0,
            cache_stats=cache_stats)
        if rep.depth:
            rep.depth["probe_traces"] = self.probe_traces - p0
        return rep

    def trace_phases(self, fwd_bwd_fn, params, batch, update_fn=None,
                     opt_init_fn=None, fwd: TracedPhase | None = None
                     ) -> tuple[TracedPhase, TracedPhase | None,
                                TracedPhase | None]:
        """Stage 1: per-phase CPU traces (cached). The forward+backward
        runs with grad mode on; its outputs are the loss (``OUTPUT``)
        and the gradients (``GRAD``). Passing ``fwd`` skips the forward
        trace: the sweep service enters here with an interpolated
        forward phase and still gets the optimizer phases resolved
        (normally cache hits: they do not depend on the batch)."""
        if fwd is None:
            fwd = self._trace_phase(
                fwd_bwd_fn,
                [(params, BlockKind.PARAM, "params"),
                 (batch, BlockKind.INPUT, "batch")],
                Phase.FORWARD_BACKWARD, out_kind_fn=_fwd_out_kinds,
                tag="fwd", grad=True)
        init = upd = None
        opt_state = None
        if opt_init_fn is not None:
            init = self._trace_phase(
                opt_init_fn, [(params, BlockKind.PARAM, "params")],
                Phase.OPTIMIZER,
                out_kind_fn=lambda s: [BlockKind.OPT_STATE] * len(
                    pytree.tree_leaves(s)),
                tag="init")
            opt_state = init.out_shape
        if update_fn is not None:
            out = fwd.out_shape
            grads = out[1] if isinstance(out, tuple) else out
            upd_args = [(params, BlockKind.PARAM, "params"),
                        (grads, BlockKind.GRAD, "grads")]
            if opt_state is not None:
                upd_args.append((opt_state, BlockKind.OPT_STATE, "opt_state"))
            upd = self._trace_phase(update_fn, upd_args, Phase.OPTIMIZER,
                                    tag="upd")
        return fwd, upd, init

    def estimate_from_phases(self, fwd: TracedPhase,
                             upd: TracedPhase | None = None,
                             init: TracedPhase | None = None, *,
                             shard_factor_fn=None,
                             collective_specs: Sequence[CollectiveSpec] = (),
                             capacity: int | None = None,
                             t0: float | None = None,
                             cache_stats: dict | None = None
                             ) -> EstimateReport:
        """Stages 2-5 (compose, classify, orchestrate, simulate) from
        already-traced phases: ``estimate_training`` lands here after
        stage 1, and the sweep service enters directly with cached or
        synthesized phases (one trace for every mesh of a mesh sweep)."""
        if t0 is None:
            t0 = time.perf_counter()
        policy_before = self.orchestrator.policy
        try:
            return self._estimate_from_phases(
                fwd, upd, init, shard_factor_fn, collective_specs,
                capacity, t0, cache_stats or {})
        finally:
            self.orchestrator.policy = policy_before

    def _estimate_from_phases(self, fwd, upd, init, shard_factor_fn,
                              collective_specs, capacity, t0,
                              cache_stats) -> EstimateReport:
        if self.checkpoint is not None:
            self.checkpoint("replay")
        policy = self.orchestrator.policy
        # --- stage 2+3: analyze & compose iterations (periodic) ---
        pb, meta = self._compose_periodic(fwd, upd, init)
        concrete = pb.prefix + pb.cycle + pb.suffix
        param_sizes = frozenset(
            b.size for b in fwd.input_blocks if b.kind is BlockKind.PARAM)
        concrete = classify_blocks(concrete, param_sizes)
        if self.cublas_workspace:
            concrete += self._cublas_workspaces(pb.prefix)

        # --- stage 4: orchestrate ---
        # the collectives' phase bounds: concretely composed iterations
        # only (iteration 2's keys on the fast path are template
        # release markers, not an iteration of the timeline)
        phase_bounds = {}
        for it, end in meta["iteration_ends"].items():
            if it not in meta["bwd_start"]:
                continue
            phase_bounds[(it, Phase.FORWARD_BACKWARD.value)] = (
                meta["bwd_start"][it], meta["update_start"][it])
            phase_bounds[(it, Phase.OPTIMIZER.value)] = (
                meta["update_start"][it], end)
        # The JAX package resolves "auto" by a taint pass over the update
        # jaxpr (per-leaf updates fuse into the backward under XLA). An
        # eager step has no such fusion: every gradient lives until the
        # update that reads it has finished.
        if policy.grad_release == "auto":
            self.orchestrator.policy = dataclasses.replace(
                policy, grad_release="after_update")
        concrete = self.orchestrator.run(
            concrete,
            iteration_ends=meta["iteration_ends"],
            update_start=meta["update_start"],
            next_bwd_start=meta["update_start"],
            collective_specs=collective_specs,
            phase_bounds=phase_bounds,
            num_iterations=self.iterations,
            shard_factor_fn=shard_factor_fn)
        # host offload, a separate pass: only the concretely composed
        # iterations get staging blocks (update_start's synthetic
        # template key is a release marker, not an iteration)
        offload_stats = None
        if policy.offload is not None and policy.offload.enabled:
            us_concrete = {it: t for it, t in meta["update_start"].items()
                           if it in meta["bwd_start"]}
            concrete, offload_stats = self.orchestrator.apply_offload(
                concrete, us_concrete, meta["iteration_ends"])

        # --- stage 5: simulate ---
        num_events = (len(fwd.trace.events)
                      + (len(upd.trace.events) if upd else 0)
                      + (len(init.trace.events) if init else 0))
        N = self.iterations
        prefix = [b for b in concrete if b.iteration == 0]
        cyc = [b for b in concrete if b.iteration == 1] if N >= 3 else []
        suffix = ([b for b in concrete if b.iteration == N - 1]
                  if N >= 2 else [])
        pb = PeriodicBlocks(prefix, cyc, pb.n_cycles, pb.period, suffix,
                            meta=pb.meta)
        sim_runner = MemorySimulator(self.allocator_policy,
                                     capacity or self.capacity,
                                     engine="columnar")
        with obs_spans.span("estimator.replay", engine="columnar",
                            num_blocks=pb.num_blocks):
            sim = sim_runner.replay_spaces(pb)

        def is_cycle(b):
            return N >= 3 and b.iteration == 1
        persistent = sum(
            b.sharded_size * (pb.n_cycles if is_cycle(b) else 1)
            for b in concrete
            if b.free_t is None and b.block_kind in (
                BlockKind.PARAM, BlockKind.OPT_STATE))
        # under offload the per-phase breakdown describes the device
        # composition, the one the capacity verdict is about
        bd_pb = pb
        if offload_stats is not None:
            bd_pb = split_blocks_by_space(pb).get(
                MemorySpace.DEVICE_HBM,
                PeriodicBlocks([], [], pb.n_cycles, pb.period, [],
                               dict(pb.meta)))
        liveness_peak, phase_pk = periodic_breakdown_peaks_fast(
            reduced_for_breakdown(bd_pb))
        breakdown = {"phase_peaks": phase_pk,
                     "num_blocks": pb.num_blocks,
                     "liveness_peak": liveness_peak}
        if offload_stats is not None:
            breakdown["space_peaks"] = sim.stats.get("space_peaks", {})
            breakdown["offload"] = offload_stats
        return EstimateReport(
            peak_bytes=sim.peak_reserved,
            peak_tensor_bytes=sim.peak_allocated,
            persistent_bytes=persistent,
            oom=sim.oom,
            sim=sim,
            breakdown=breakdown,
            wall_time_s=time.perf_counter() - t0,
            num_events=num_events,
            cache_stats=cache_stats,
            composition=pb,
            sim_unbounded=(capacity or self.capacity) >= (1 << 62),
            depth=_depth_info(fwd))

    # -- the frozen reference pipeline (fastpath=False) ----------------------
    def _compose_reference(self, fwd: TracedPhase, upd: TracedPhase | None,
                           init: TracedPhase | None
                           ) -> tuple[list[BlockLifecycle], dict]:
        """Every iteration composed concretely, each placement
        re-deriving its lifecycles from the phase's event stream."""
        blocks: list[BlockLifecycle] = []
        cursor = 0
        iteration_ends: dict[int, int] = {}
        update_start: dict[int, int] = {}
        bwd_start: dict[int, int] = {}
        next_bid = [0]

        def fresh_bid():
            next_bid[0] += 1
            return next_bid[0]

        def place(entry: TracedPhase, it, phase, output_kind=None):
            nonlocal cursor
            input_bids = {b.bid for b in entry.input_blocks}
            output_bids = {b.bid for b in entry.output_blocks}
            placed = []
            for lc in reconstruct_lifecycles(entry.trace):
                if lc.block_id in input_bids:
                    continue
                kind = lc.block_kind
                if lc.block_id in output_bids and output_kind is not None:
                    kind = output_kind
                free_t = lc.free_t + cursor if lc.free_t is not None else None
                placed.append(dataclasses.replace(
                    lc, block_id=fresh_bid(), alloc_t=lc.alloc_t + cursor,
                    free_t=free_t, iteration=it, phase=phase,
                    block_kind=kind))
            cursor += len(entry.trace.events) + 1
            return placed

        for b in fwd.input_blocks:
            if b.kind is BlockKind.PARAM and b.size > 0:
                blocks.append(BlockLifecycle(
                    fresh_bid(), b.size, 0, None, 0, Phase.INIT,
                    "init", "params", BlockKind.PARAM, 1.0, b.shape))
        cursor += 1
        for it in range(self.iterations):
            for b in fwd.input_blocks:
                if b.kind is BlockKind.INPUT and b.size > 0:
                    blocks.append(BlockLifecycle(
                        fresh_bid(), b.size, cursor, None, it, Phase.DATA,
                        "host_to_device", "batch", BlockKind.INPUT,
                        1.0, b.shape))
            cursor += 1
            bwd_start[it] = cursor
            blocks.extend(place(fwd, it, Phase.FORWARD_BACKWARD))
            update_start[it] = cursor
            if it == 0 and init is not None:
                # optimizer state materializes at the first update
                blocks.extend(place(init, it, Phase.OPTIMIZER,
                                    output_kind=BlockKind.OPT_STATE))
            if upd is not None:
                blocks.extend(place(upd, it, Phase.OPTIMIZER,
                                    output_kind=BlockKind.OUTPUT))
            iteration_ends[it] = cursor
        bwd_start[self.iterations] = cursor + 1  # sentinel for last grads
        meta = dict(iteration_ends=iteration_ends, update_start=update_start,
                    bwd_start=bwd_start, horizon=cursor + 2)
        return blocks, meta

    def _estimate_training_reference(self, fwd_bwd_fn, params, batch,
                                     update_fn, opt_init_fn,
                                     shard_factor_fn, collective_specs,
                                     capacity, t0) -> EstimateReport:
        """The reference pipeline: uncached traces, a concrete
        N-iteration composition, the frozen classifier, the
        orchestrator's passes one by one, the object replay engine over
        every event. The fast path matches it on every estimate field."""
        opolicy = self.orchestrator.policy
        if opolicy.offload is not None and opolicy.offload.enabled:
            raise NotImplementedError(
                "host offload needs the fast path (fastpath=True): the "
                "reference pipeline is frozen and has no multi-space "
                "replay")
        fwd = self._trace_phase(
            fwd_bwd_fn,
            [(params, BlockKind.PARAM, "params"),
             (batch, BlockKind.INPUT, "batch")],
            Phase.FORWARD_BACKWARD, out_kind_fn=_fwd_out_kinds,
            tag="fwd", grad=True, cached=False)
        init = upd = None
        opt_state = None
        if opt_init_fn is not None:
            init = self._trace_phase(
                opt_init_fn, [(params, BlockKind.PARAM, "params")],
                Phase.OPTIMIZER,
                out_kind_fn=lambda s: [BlockKind.OPT_STATE] * len(
                    pytree.tree_leaves(s)),
                tag="init", cached=False)
            opt_state = init.out_shape
        if update_fn is not None:
            out = fwd.out_shape
            grads = out[1] if isinstance(out, tuple) else out
            upd_args = [(params, BlockKind.PARAM, "params"),
                        (grads, BlockKind.GRAD, "grads")]
            if opt_state is not None:
                upd_args.append((opt_state, BlockKind.OPT_STATE, "opt_state"))
            upd = self._trace_phase(update_fn, upd_args, Phase.OPTIMIZER,
                                    tag="upd", cached=False)

        blocks, meta = self._compose_reference(fwd, upd, init)
        param_sizes = frozenset(
            b.size for b in fwd.input_blocks if b.kind is BlockKind.PARAM)
        # frozen classifier: the reference must not drift as the shared
        # analyzer changes (same output as ``classify_blocks``)
        classified = []
        for b in blocks:
            kind = b.block_kind
            if kind in (BlockKind.ACTIVATION, BlockKind.TEMP):
                in_bwd = any(m in b.scope for m in ("transpose", "backward"))
                if in_bwd and b.size in param_sizes:
                    kind = BlockKind.GRAD
            classified.append(dataclasses.replace(b, block_kind=kind))
        blocks = classified
        if self.cublas_workspace:
            blocks += self._cublas_workspaces(
                [b for b in blocks if b.iteration == 0])

        phase_bounds = {}
        for it, end in meta["iteration_ends"].items():
            phase_bounds[(it, Phase.FORWARD_BACKWARD.value)] = (
                meta["bwd_start"][it], meta["update_start"][it])
            phase_bounds[(it, Phase.OPTIMIZER.value)] = (
                meta["update_start"][it], end)
        o = self.orchestrator
        if o.policy.grad_release == "auto":
            o.policy = dataclasses.replace(o.policy,
                                           grad_release="after_update")
        blocks = o.fold_fused(blocks)
        blocks = o.mark_persistent(blocks)
        blocks = o.batch_per_iteration(blocks, meta["iteration_ends"])
        blocks = o.release_gradients(blocks, meta["update_start"],
                                     meta["update_start"],
                                     meta["iteration_ends"])
        blocks = o.inject_optimizer_upcasts(blocks, meta["update_start"],
                                            meta["iteration_ends"])
        blocks = o.apply_donation(blocks)
        if o.policy.release_outputs_next_iter:
            blocks = o.release_step_outputs(blocks, meta["iteration_ends"])
        blocks = o.apply_transient_scale(blocks)
        if collective_specs and phase_bounds:
            blocks = o.inject_collectives(blocks, collective_specs,
                                          phase_bounds, self.iterations,
                                          shard_factor_fn)
        if shard_factor_fn is not None:
            blocks = o.apply_sharding(blocks, shard_factor_fn)

        if self.checkpoint is not None:
            self.checkpoint("replay")
        sim = MemorySimulator(self.allocator_policy,
                              capacity or self.capacity).replay(blocks)
        persistent = sum(b.sharded_size for b in blocks if b.free_t is None
                         and b.block_kind in (BlockKind.PARAM,
                                              BlockKind.OPT_STATE))
        return EstimateReport(
            peak_bytes=sim.peak_reserved,
            peak_tensor_bytes=sim.peak_allocated,
            persistent_bytes=persistent,
            oom=sim.oom,
            sim=sim,
            breakdown={"phase_peaks": phase_peaks(blocks),
                       "num_blocks": len(blocks),
                       "liveness_peak": peak_live_bytes(blocks)},
            wall_time_s=time.perf_counter() - t0,
            num_events=(len(fwd.trace.events)
                        + (len(upd.trace.events) if upd else 0)
                        + (len(init.trace.events) if init else 0)),
            composition=blocks,
            sim_unbounded=(capacity or self.capacity) >= (1 << 62))

    # -- capacity probing ---------------------------------------------------
    def min_feasible_capacity(self, fwd_bwd_fn, params, batch,
                              update_fn=None, opt_init_fn=None,
                              shard_factor_fn=None, collective_specs=(),
                              report: EstimateReport | None = None) -> int:
        """Smallest device capacity the job fits in, from one instrumented
        replay (plus bounded verification) — see
        ``MemorySimulator.min_feasible_capacity``. Passing an existing
        ``report`` reuses its composition and unbounded replay."""
        if report is None or report.composition is None:
            report = self.estimate_training(
                fwd_bwd_fn, params, batch, update_fn=update_fn,
                opt_init_fn=opt_init_fn, shard_factor_fn=shard_factor_fn,
                collective_specs=collective_specs)
        probe = (report.sim if report.sim_unbounded and not report.sim.oom
                 else None)
        # under offload the question is about the device's memory only;
        # the probe stays valid: ``replay_spaces``' primary result is
        # the device sub-composition's replay
        comp = report.composition
        groups = split_blocks_by_space(comp)
        if len(groups) > 1:
            comp = groups.get(MemorySpace.DEVICE_HBM, [])
        engine = "columnar" if self.fastpath else "object"
        return MemorySimulator(self.allocator_policy, 1 << 62,
                               engine=engine).min_feasible_capacity(
            comp, probe=probe)

    def _serving_phase(self, step_fn, params, cache, batch
                       ) -> tuple[TracedPhase, dict]:
        """A serving step's phase (tag ``"serve"``) and its depth info,
        with the probes this call traced."""
        p0 = self.probe_traces
        entry = self._trace_phase(
            step_fn,
            [(params, BlockKind.PARAM, "params"),
             (cache, BlockKind.CACHE, "cache"),
             (batch, BlockKind.INPUT, "batch")],
            Phase.DECODE, tag="serve")
        depth = _depth_info(entry)
        if depth:
            depth["probe_traces"] = self.probe_traces - p0
        return entry, depth

    def estimate_serving(self, step_fn: Callable, params, cache, batch,
                         shard_factor_fn=None,
                         collective_specs: Sequence[CollectiveSpec] = (),
                         capacity: int | None = None) -> EstimateReport:
        """Single-phase estimate of a serving step ``step_fn(params,
        cache, batch)`` with a persistent cache; in the GPU preset the
        replay adds cuBLAS's workspace at the step's first matmul. With
        ``shard_factor_fn`` the blocks are one device's share (the
        workspace is per device already); ``collective_specs`` is
        accepted and unused, as in the JAX package (a decode step has no
        phase bounds to stage collectives at)."""
        t0 = time.perf_counter()
        entry, depth = self._serving_phase(step_fn, params, cache, batch)
        blocks = list(entry.lifecycles)
        blocks = self.orchestrator.mark_persistent(
            blocks, kinds=(BlockKind.PARAM, BlockKind.CACHE))
        blocks = self.orchestrator.fold_fused(blocks)
        if shard_factor_fn is not None:
            blocks = self.orchestrator.apply_sharding(blocks, shard_factor_fn)
        # the serving thread's cuBLAS workspace, from its first matmul on;
        # held for good, not the step's: no part of the persistent bytes
        workspace = (self._cublas_workspaces(blocks)
                     if self.cublas_workspace else [])
        sim = MemorySimulator(self.allocator_policy,
                              capacity or self.capacity,
                              engine="columnar").replay(blocks + workspace)
        by_kind: dict[str, int] = {}
        for b in blocks:
            if b.free_t is None:
                by_kind[b.block_kind.value] = (by_kind.get(
                    b.block_kind.value, 0) + b.sharded_size)
        return EstimateReport(
            peak_bytes=sim.peak_reserved, peak_tensor_bytes=sim.peak_allocated,
            persistent_bytes=sum(by_kind.values()),
            oom=sim.oom, sim=sim,
            breakdown={"num_blocks": len(blocks),
                       "step_allocs": sum(b.op != "input" for b in blocks),
                       "persistent_by_kind": by_kind},
            wall_time_s=time.perf_counter() - t0,
            num_events=len(entry.trace.events), depth=depth)

    def estimate_request_stream(self, step_fn: Callable, params, cache,
                                batch, *, stream, knobs=None,
                                kv_bytes_per_token: int,
                                resident_bytes_per_request: int = 0,
                                base_dtype_bytes: int = 2,
                                shard_factor_fn=None,
                                capacity: int | None = None
                                ) -> "ServingEstimate":
        """Estimate a serving runtime over a request-driven timeline.

        Two CPU-side components compose additively:

        * **step working set**: the decode step ``step_fn(params, cache,
          batch)`` is traced once under the SAME trace key as
          :meth:`estimate_serving` (tag ``"serve"``; the JAX package
          keys it ``"decode"``, its own ``estimate_serving``'s tag), so
          the serving gate's decode trace serves the stream and a knob
          sweep over page size, concurrency and KV dtype re-lowers the
          request stream but never re-traces. Its transient peak (the
          bytes above parameters and cache) is scaled batch-linearly
          from the traced batch to ``knobs.max_concurrent``: decode
          activations are per-sequence, so the linear model is exact for
          attention-free layers and an upper bound for the rest. In the
          GPU preset the step's replay holds cuBLAS's workspace from the
          step's first matmul on, as :meth:`estimate_serving`'s does;
          the workspace is one per handle, not per sequence, so it is
          added to the scaled transient once, unscaled (the JAX package
          has no workspace). The step's output (the logits) is part of
          the transient, as the JAX package's docstring says; its code
          subtracts every block alive at the step's end, the output
          among them, which leaves the logits out of both parts of the
          sum (2,430,976 B at qwen3-32b's batch 8; the card's decode
          holds them);
        * **paged KV pressure**: the request stream is lowered by the
          continuous-batching scheduler to page-granular allocations
          and replayed through the allocator simulation exactly (join,
          extend, leave and evict at the tick each happens).

        With ``shard_factor_fn`` the step's blocks are one device's share
        before its replay; the paged stream is not sharded, as in the JAX
        package.

        ``worst_case_peak_bytes`` is what an admission gate must trust;
        ``steady_state_peak_bytes`` (median live paged bytes) is what a
        capacity planner provisions for sustained load.
        """
        t0 = time.perf_counter()
        knobs = knobs or ServingKnobs()
        entry, depth = self._serving_phase(step_fn, params, cache, batch)
        blocks = list(entry.lifecycles)
        blocks = self.orchestrator.mark_persistent(
            blocks, kinds=(BlockKind.PARAM, BlockKind.CACHE))
        blocks = self.orchestrator.fold_fused(blocks)
        if shard_factor_fn is not None:
            blocks = self.orchestrator.apply_sharding(blocks,
                                                      shard_factor_fn)
        workspace = (self._cublas_workspaces(blocks)
                     if self.cublas_workspace else [])
        step_sim = MemorySimulator(self.allocator_policy, self.capacity,
                                   engine="columnar").replay(
            blocks + workspace)
        resident = {kind: sum(b.sharded_size for b in blocks
                              if b.free_t is None and b.block_kind is kind)
                    for kind in (BlockKind.PARAM, BlockKind.CACHE)}
        params_bytes = resident[BlockKind.PARAM]
        ws_bytes = sum(b.size for b in workspace)
        transient = max(step_sim.peak_allocated - sum(resident.values())
                        - ws_bytes, 0)
        traced_batch = _leading_dim(batch)
        transient_scaled = -(-transient * knobs.max_concurrent
                             // max(traced_batch, 1)) + ws_bytes

        sched = ContinuousBatchingScheduler(knobs)
        rb = sched.lower(stream, kv_bytes_per_token,
                         resident_bytes_per_request=resident_bytes_per_request,
                         base_dtype_bytes=base_dtype_bytes)
        paged_sim = MemorySimulator(self.allocator_policy, self.capacity,
                                    engine="columnar").replay(rb)
        live = sorted(v for v in rb.meta["live_paged"] if v > 0)
        paged_steady = live[len(live) // 2] if live else 0
        tok_b = rb.meta["kv_bytes_per_token"]
        monolithic = knobs.max_concurrent * (
            stream.max_seq_len * tok_b + int(resident_bytes_per_request))

        worst = params_bytes + transient_scaled + paged_sim.peak_reserved
        steady = params_bytes + transient_scaled + paged_steady
        cap = capacity if capacity is not None else self.capacity
        return ServingEstimate(
            steady_state_peak_bytes=int(steady),
            worst_case_peak_bytes=int(worst),
            persistent_bytes=int(params_bytes),
            step_transient_bytes=int(transient_scaled),
            paged_kv_peak_bytes=int(paged_sim.peak_reserved),
            paged_kv_steady_bytes=int(paged_steady),
            monolithic_cache_bytes=int(monolithic),
            oom=worst > cap,
            sim=paged_sim,
            breakdown={
                "num_blocks": rb.num_blocks,
                "ticks": rb.meta["ticks"],
                "evictions": rb.meta["evictions"],
                "max_occupancy": max(rb.meta["occupancy"], default=0),
                "page_bytes": rb.meta["page_bytes"],
                "knobs": rb.meta["knobs"],
            },
            wall_time_s=time.perf_counter() - t0,
            num_events=len(entry.trace.events) + 2 * rb.num_blocks,
            depth=depth)


def _leading_dim(tree) -> int:
    """Batch size of a traced decode input: leading dim of the first
    tensor leaf (1 for scalars and empty trees)."""
    for leaf in pytree.tree_leaves(tree):
        shape = getattr(leaf, "shape", ())
        if shape:
            return int(shape[0])
    return 1


@dataclasses.dataclass
class ServingEstimate:
    """Serving-runtime estimate over a request-mix timeline.

    Unlike :class:`EstimateReport`'s single number, serving capacity has
    two operating points: the worst-case peak (admission gate: must fit
    or the server runs out of memory under the scripted burst) and the
    steady-state median (provisioning: what sustained load holds). The
    paged-vs-monolithic pair says what paged attention buys."""

    steady_state_peak_bytes: int
    worst_case_peak_bytes: int
    persistent_bytes: int         # parameters, always resident
    step_transient_bytes: int     # decode working set at max_concurrent
    paged_kv_peak_bytes: int      # allocator peak of the paged stream
    paged_kv_steady_bytes: int    # median live paged bytes
    monolithic_cache_bytes: int   # max_concurrent x max_seq full cache
    oom: bool
    sim: SimResult
    breakdown: dict
    wall_time_s: float
    num_events: int
    depth: dict = dataclasses.field(default_factory=dict)   # the step's

    def fits(self, capacity: int) -> bool:
        return self.worst_case_peak_bytes <= capacity

    def to_json(self) -> dict:
        return {
            "steady_state_peak_bytes": self.steady_state_peak_bytes,
            "worst_case_peak_bytes": self.worst_case_peak_bytes,
            "persistent_bytes": self.persistent_bytes,
            "step_transient_bytes": self.step_transient_bytes,
            "paged_kv_peak_bytes": self.paged_kv_peak_bytes,
            "paged_kv_steady_bytes": self.paged_kv_steady_bytes,
            "monolithic_cache_bytes": self.monolithic_cache_bytes,
            "oom": self.oom,
            "breakdown": {k: v for k, v in self.breakdown.items()
                          if k != "knobs"},
            "knobs": self.breakdown.get("knobs", {}),
        }

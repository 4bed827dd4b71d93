"""xMem estimator for PyTorch steps — the serving slice of
``repro.core.estimator``.

``XMemEstimator.estimate_serving`` traces one serving step (prefill or
decode) on the CPU under fake tensors (``tracer.py``), marks the params
and the KV cache persistent, and replays the lifecycles through the
``CUDACachingAllocator`` simulation: the peak reserved bytes are the
estimate the serving gate budgets, and ``torch.cuda.max_memory_reserved``
on the card is its ground truth (``baselines/directprobe.py``).

Not ported yet (ROADMAP Queue 1): the trace cache, the training
estimate (N-iteration composition, gradient release, optimizer state)
and the request-stream estimate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from torch.utils import _pytree as pytree

from ..obs import spans as obs_spans
from .allocator import AllocatorPolicy, CUDA_CACHING
from .events import BlockKind, BlockLifecycle, Phase, Trace
from .orchestrator import MemoryOrchestrator, OrchestratorPolicy
from .simulator import MemorySimulator, SimResult
from .tracer import trace_fn


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


@dataclasses.dataclass(frozen=True)
class TracedPhase:
    """One traced phase: its event stream and block lifecycles."""
    trace: Trace
    lifecycles: tuple[BlockLifecycle, ...]


@dataclasses.dataclass
class EstimateReport:
    peak_bytes: int               # reserved segments — THE estimate
    peak_tensor_bytes: int        # live-tensor peak (naive lower bound)
    persistent_bytes: int         # params + cache + pinned outputs
    oom: bool
    sim: SimResult
    breakdown: dict               # per-kind summary
    wall_time_s: float
    num_events: int

    def fits(self, capacity: int) -> bool:
        return self.peak_bytes <= capacity


class XMemEstimator:
    """Peak-memory estimator; ``for_torch_gpu()`` is the preset the
    port's serving gate uses (CUDACachingAllocator simulation, eager
    semantics: no fusion folding, no donation)."""

    def __init__(self,
                 allocator_policy: AllocatorPolicy = CUDA_CACHING,
                 orchestrator_policy: OrchestratorPolicy | None = None,
                 capacity: int = 1 << 62):
        self.allocator_policy = allocator_policy
        self.orchestrator = MemoryOrchestrator(
            orchestrator_policy or OrchestratorPolicy())
        self.capacity = capacity

    @classmethod
    def for_torch_gpu(cls, **kw) -> "XMemEstimator":
        kw.setdefault("allocator_policy", CUDA_CACHING)
        kw.setdefault("orchestrator_policy", OrchestratorPolicy(
            grad_release="at_update", donate_params=False,
            donate_opt_state=False, fusion_folding=False))
        return cls(**kw)

    def _trace_phase(self, fn, args_with_kinds, phase) -> TracedPhase:
        flat, kinds, scopes = flatten_kinds(args_with_kinds)
        specs = [pytree.tree_structure(t) for t, _, _ in args_with_kinds]
        counts = [spec.num_leaves for spec in specs]

        def flat_fn(*leaves):
            rebuilt, i = [], 0
            for spec, n in zip(specs, counts):
                rebuilt.append(pytree.tree_unflatten(leaves[i:i + n], spec))
                i += n
            return fn(*rebuilt)

        with obs_spans.span("estimator.trace", phase=str(phase)):
            trace, tr, _ = trace_fn(flat_fn, *flat, arg_kinds=kinds,
                                    arg_scopes=scopes, phase=phase)
        return TracedPhase(trace=trace, lifecycles=tuple(tr.lifecycles()))

    def estimate_serving(self, step_fn: Callable, params, cache, batch,
                         capacity: int | None = None) -> EstimateReport:
        """Single-phase estimate of a serving step ``step_fn(params,
        cache, batch)`` with a persistent cache."""
        t0 = time.perf_counter()
        entry = self._trace_phase(
            step_fn,
            [(params, BlockKind.PARAM, "params"),
             (cache, BlockKind.CACHE, "cache"),
             (batch, BlockKind.INPUT, "batch")],
            Phase.DECODE)
        blocks = list(entry.lifecycles)
        blocks = self.orchestrator.mark_persistent(
            blocks, kinds=(BlockKind.PARAM, BlockKind.CACHE))
        blocks = self.orchestrator.fold_fused(blocks)
        sim = MemorySimulator(self.allocator_policy,
                              capacity or self.capacity,
                              engine="columnar").replay(blocks)
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
            num_events=len(entry.trace.events))

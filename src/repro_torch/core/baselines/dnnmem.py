"""DNNMem-reproduction: static computation-graph analysis + basic BFC.

Reproduced from the paper's description (§4.1.1, §5.1) — the original
source is not public, exactly as the xMem authors note. Captured
limitations (each is a deliberate *feature* of the reproduction, since
they drive the accuracy gap the paper measures):

1. Static graph only: analyzes the forward/backward graph; the optimizer
   phase is invisible, so stateful-optimizer memory (Adam's m/v) is
   missed — "estimations relatively more accurate for SGD" (paper §5.1).
2. Framework-level allocator only: one-level BFC, no device allocator,
   and crucially *no reclaim of cached segments* before declaring OOM.
3. No runtime/code sensitivity: gradient lifetimes follow static
   liveness (freed at last static use), so ``zero_grad`` placement and
   donation/fusion behaviors cannot be captured.

A port of ``repro.core.baselines.dnnmem`` onto the port's fake-tensor
trace, with the JAX package's allocator policy (``CUDA_CACHING``, the
bit-identical copy); ``peak_from_lifecycles`` replays any lifecycles,
the JAX package's too.
"""
from __future__ import annotations

import time
from typing import Sequence

from ..allocator import (CUDA_CACHING, AllocatorPolicy, CachingAllocatorSim,
                         DeviceAllocatorSim)
from ..analyzer import reconstruct_lifecycles
from ..events import BlockLifecycle, Trace, lifecycles_to_events
from .common import JobSpec, trace_fwd_bwd


def peak_from_lifecycles(blocks: Sequence[BlockLifecycle],
                         policy: AllocatorPolicy = CUDA_CACHING) -> int:
    """Peak reserved bytes of ``blocks`` replayed through one caching
    allocator over an unbounded device, with no reclaim ladder."""
    # static liveness: persistent params/inputs; grads freed at last
    # static use (which, for outputs, is "never" within the graph —
    # keep them alive to graph end; DNNMem has no optimizer phase)
    events = lifecycles_to_events(blocks)
    # one-level simulation: device has infinite pages but we track
    # against capacity WITHOUT the reclaim ladder
    device = DeviceAllocatorSim(1 << 62, policy.device_page)
    sim = CachingAllocatorSim(policy, device)
    handles = {}
    for e in events:
        if e.kind == "alloc":
            if e.size <= 0:
                continue
            handles[e.block_id] = sim.malloc(e.size, t=e.t)
        else:
            h = handles.pop(e.block_id, None)
            if h is not None:
                sim.free(h, t=e.t)
    return sim.peak_reserved


class DNNMemEstimator:
    name = "dnnmem"

    def __init__(self, policy: AllocatorPolicy = CUDA_CACHING):
        self.policy = policy
        self.last_runtime_s = 0.0

    def estimate(self, job: JobSpec, capacity: int = 1 << 62,
                 trace: Trace | None = None) -> int:
        """``trace``: the job's forward+backward trace when the caller
        has it (an estimator's cache); traced here otherwise."""
        t0 = time.perf_counter()
        if trace is None:
            trace = trace_fwd_bwd(job)
        peak = peak_from_lifecycles(reconstruct_lifecycles(trace),
                                    self.policy)
        self.last_oom_prediction = peak > capacity  # no reclaim modeled
        self.last_runtime_s = time.perf_counter() - t0
        return peak

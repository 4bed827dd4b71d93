"""Horus-style naive estimator: sum tensor sizes, ignore the allocator.

The paper cites Horus as "primarily sums tensor sizes" (§5.1) and uses it
to motivate allocator-aware simulation: without liveness or segment
modeling, estimates are either wild over-counts (every activation
coexists) or under-counts (ignores allocator rounding/caching). We follow
the common formulation: persistent state + gradients + every forward
activation, no liveness, no allocator.

A port of ``repro.core.baselines.tensorsum``: the trace is the port's
fake-tensor trace of the forward+backward (``common.trace_fwd_bwd``),
and ``activation_bytes`` reads any schema-v5 trace, so it sums the JAX
package's trace alike. The reference's ``scan_unroll_cap`` has no
counterpart: the port's model loops over its layers.
"""
from __future__ import annotations

import time

import numpy as np

from ..events import KIND_CODE, BlockKind, Trace
from .common import JobSpec, trace_fwd_bwd

_SUMMED = [KIND_CODE[BlockKind.ACTIVATION], KIND_CODE[BlockKind.TEMP]]


def activation_bytes(trace: Trace) -> int:
    """Bytes of every ``ACTIVATION`` and ``TEMP`` alloc of ``trace``, as
    if all were resident at once."""
    cols = trace.columnar()
    mask = (cols.kind == 1) & np.isin(cols.block_kind, _SUMMED)
    return int(cols.size[mask].sum())


class TensorSumEstimator:
    name = "tensorsum"

    def estimate(self, job: JobSpec, trace: Trace | None = None) -> int:
        """``trace``: the job's forward+backward trace when the caller
        has it (an estimator's cache); traced here otherwise."""
        t0 = time.perf_counter()
        params_b = job.param_bytes()
        opt_b = job.opt_state_bytes()
        grads_b = params_b  # gradient per parameter
        batch_b = job.batch_bytes()
        if trace is None:
            trace = trace_fwd_bwd(job)
        # every tensor assumed simultaneously resident
        act_b = activation_bytes(trace)
        self.last_runtime_s = time.perf_counter() - t0
        return params_b + opt_b + grads_b + batch_b + act_b

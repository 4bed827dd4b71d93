"""Ground truth on the card, and the LLMem-style probe (paper §5.3).

The JAX package reads XLA's compiled memory analysis. On the port's own
stack the truth is the CUDA caching allocator's: run the step once on
the GPU with its inputs (params, cache, batch) already resident, and
read ``torch.cuda.max_memory_reserved()`` — the segments the allocator
holds, which is what the xMem estimate (``peak_bytes``) predicts — and
``max_memory_allocated()`` — the live-tensor peak (``peak_tensor_bytes``).
The allocator's segment sizes at the peak's end come from
``torch.cuda.memory._snapshot()`` for comparison with the simulator's
segments. ``PYTORCH_CUDA_ALLOC_CONF`` is expected unset, as the
simulated allocator assumes its defaults.

``measured_peak`` measures one call of a step (prefill, decode);
``measured_training`` measures ``steps`` training steps from resident
parameters, with the optimizer state made inside the window at the
first update, as the estimator's N-iteration composition places it.

``DirectProbeEstimator`` is the reference's direct-measurement baseline
on the card: it runs the job itself at two reduced batches
(``measured_training`` over ``PROBE_STEPS`` steps each, parameters and
batches made from a seed) and extrapolates linearly in batch,

    peak(B) ≈ fixed + slope * B

This is the methodology family that violates the zero-target-overhead
constraint: it runs the job twice on the very device whose memory the
estimate should spare, and its runtime reflects that. It fails outright
when a probe runs out of device memory or exceeds the capacity (paper
§5.3 limitation (i)/(ii)), which it reports as ``ProbeOOMError``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .common import JobSpec

#: training steps each probe runs: the second is the first whose forward
#: runs with the optimizer state resident, as in every later step
PROBE_STEPS = 2


@dataclasses.dataclass
class MeasuredPeak:
    reserved: int                 # max_memory_reserved (xMem's target)
    allocated: int                # max_memory_allocated
    segment_sizes: list[int]      # reserved segments after the step
    seconds: float                # the step's synchronized wall time
    n_allocs: int                 # allocator requests during the step
    n_segments_created: int       # cudaMalloc calls during the step
    n_alloc_retries: int          # failed cudaMallocs retried after the
                                  # allocator released cached segments
    # with ``history=True``: every allocator request of the step, in
    # order, as (block bytes, innermost "file:line" of this package, and
    # with ``stacks="all"`` the innermost ``at::native`` function), and
    # the request stream itself, (action, address, bytes) for every
    # "alloc" and "free_completed"
    allocs: list[tuple[int, str]] | None = None
    events: list[tuple[str, int, int]] | None = None
    out: Any = dataclasses.field(repr=False, default=None)

    def to_json(self) -> dict:
        return {"reserved": self.reserved, "allocated": self.allocated,
                "n_segments": len(self.segment_sizes),
                "segment_bytes": sum(self.segment_sizes),
                "n_allocs": self.n_allocs,
                "n_segments_created": self.n_segments_created,
                "n_alloc_retries": self.n_alloc_retries}


def _where(frames) -> str:
    here = next((f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']}"
                 for f in frames if "repro_torch" in f["filename"]), "?")
    native = next((f["name"] for f in frames
                   if "at::native::" in f.get("name", "")), None)
    return here if native is None else f"{here} {native[:160]}"


def measured_peak(step: Callable, *args, device=None,
                  history: bool = False,
                  stacks: str = "python") -> MeasuredPeak:
    """Run ``step(*args)`` once on the card and return its peaks.

    Cached free blocks are released first, so the peak counts what the
    resident inputs hold plus what the step itself needs. ``history``
    records the allocator's requests with their stacks (slower; for
    comparing the card's request stream with the trace's); ``stacks``
    is ``"python"`` or ``"all"`` (C++ frames too, which name the ATen
    function that made a request inside an op)."""
    return _measure(lambda: step(*args), device, history, stacks)


def measured_training(fwd_bwd: Callable, update_fn: Callable,
                      opt_init_fn: Callable, params, batch_fn: Callable,
                      steps: int = 3, device=None,
                      history: bool = False, run=None,
                      on_step: Callable | None = None) -> MeasuredPeak:
    """Run ``steps`` training steps on the card and return their peaks.

    The window starts from the resident ``params`` alone (cached blocks
    released, peaks reset). Each step moves ``batch_fn(step)`` to the
    card, runs ``fwd_bwd`` and the in-place ``update_fn``; the
    optimizer state is made by ``opt_init_fn`` after the first
    backward, inside the window. ``out`` is ``train_step.TrainRun``
    (losses, synchronized step seconds); ``run`` and ``on_step`` are
    ``train_step.run_steps``'s (a resumed run brings its state)."""
    from ...train.train_step import run_steps
    return _measure(lambda: run_steps(fwd_bwd, update_fn, opt_init_fn,
                                      params, batch_fn, steps, run, on_step),
                    device, history)


def _measure(run: Callable, device, history: bool,
             stacks: str = "python") -> MeasuredPeak:
    """``run()`` on the card between a reset of the peak statistics and
    a read of them (and of the allocator snapshot)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a measurement needs a CUDA device")
    if os.environ.get("PYTORCH_CUDA_ALLOC_CONF"):
        raise RuntimeError("the measurement expects PYTORCH_CUDA_ALLOC_CONF "
                           "unset: the simulated allocator uses defaults")
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    if history:
        torch.cuda.memory._record_memory_history(stacks=stacks,
                                                 device=device)
    before = torch.cuda.memory_stats(device)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_stats(device)
    snap = torch.cuda.memory._snapshot()
    allocs = events = None
    if history:
        torch.cuda.memory._record_memory_history(enabled=None,
                                                 device=device)
        trace = snap["device_traces"][index]
        allocs = [(e["size"], _where(e.get("frames", ())))
                  for e in trace if e["action"] == "alloc"]
        events = [(e["action"], e["addr"], e["size"]) for e in trace
                  if e["action"] in ("alloc", "free_completed")]
    segments = [s["total_size"] for s in snap["segments"]
                if s["device"] == index]
    return MeasuredPeak(reserved=torch.cuda.max_memory_reserved(device),
                        allocated=torch.cuda.max_memory_allocated(device),
                        segment_sizes=sorted(segments), seconds=seconds,
                        n_allocs=after["allocation.all.allocated"]
                        - before["allocation.all.allocated"],
                        n_segments_created=after["segment.all.allocated"]
                        - before["segment.all.allocated"],
                        n_alloc_retries=after["num_alloc_retries"]
                        - before["num_alloc_retries"],
                        allocs=allocs, events=events, out=out)


class ProbeOOMError(RuntimeError):
    """A probe ran out of device memory, or its peak exceeds the
    capacity: the direct-measurement baseline has no estimate."""


def _scale_batch(tree: Any, factor: int) -> Any:
    """``tree``'s tensors with the leading dimension divided by
    ``factor`` (at least 1), as ``meta`` tensors; scalars unchanged."""
    def scale(leaf):
        if not isinstance(leaf, torch.Tensor) or not leaf.shape:
            return leaf
        b = max(leaf.shape[0] // factor, 1)
        return torch.empty((b,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device="meta")
    return pytree.tree_map(scale, tree)


def _materialize(tree: Any, device, gen: torch.Generator) -> Any:
    """Tensors of ``tree``'s shapes and dtypes on ``device``: floating
    ones drawn from N(0, 0.02) by ``gen``, the others zeros (token ids
    any vocabulary takes). A step's memory does not depend on the
    values: no op of the models has a shape that does."""
    def make(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.is_floating_point():
            return torch.empty(t.shape, dtype=t.dtype,
                               device=device).normal_(0.0, 0.02,
                                                      generator=gen)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return pytree.tree_map(make, tree)


def probe_peak(job: JobSpec, batch: Any) -> int:
    """Reserved peak of ``PROBE_STEPS`` training steps of ``job`` at
    ``batch`` (a pytree of ``meta`` tensors) on the card: the parameters,
    and a batch for each step, made on the card from a seed, then
    ``measured_training`` from the resident parameters. The cache is
    released before the parameters are made: made into the segments an
    earlier run left cached, they would keep parts of those segments
    reserved through the probe's window."""
    if not torch.cuda.is_available():
        raise RuntimeError("a probe runs the job on a CUDA device")
    device = torch.device("cuda")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    params = _materialize(job.params, device, gen)
    return measured_training(
        job.fwd_bwd_fn, job.update_fn, job.opt_init_fn, params,
        lambda step: _materialize(batch, device, gen), PROBE_STEPS,
        device).reserved


class DirectProbeEstimator:
    """LLMem-style estimate: probes at ``batch // f`` for each ``f`` of
    ``probe_fractions``, extrapolated to the full batch. ``measure(job,
    batch) -> bytes`` runs one probe (default ``probe_peak``, on the
    card); ``last_probes`` holds the (batch, peak) of each probe run."""

    name = "directprobe"

    def __init__(self, probe_fractions=(4, 2), capacity: int | None = None,
                 measure: Callable[[JobSpec, Any], int] | None = None):
        self.probe_fractions = probe_fractions
        self.capacity = capacity
        self.measure = probe_peak if measure is None else measure
        self.last_runtime_s = 0.0
        self.last_probes: list[tuple[int, int]] = []

    def _probe(self, job: JobSpec, batch: Any, n: int) -> int:
        try:
            peak = self.measure(job, batch)
        except torch.OutOfMemoryError as e:
            # raised outside the handler, so that the traceback, and the
            # probe's tensors its frames hold, are released first
            reason = str(e).splitlines()[0] if str(e) else "out of memory"
        else:
            self.last_probes.append((n, peak))
            return peak
        raise ProbeOOMError(f"the probe at batch {n} ran out of device "
                            f"memory: {reason}")

    def estimate(self, job: JobSpec) -> int:
        t0 = time.perf_counter()
        self.last_probes = []
        try:
            return self._estimate(job)
        finally:
            self.last_runtime_s = time.perf_counter() - t0

    def _estimate(self, job: JobSpec) -> int:
        f_small, f_large = self.probe_fractions
        b_small = _scale_batch(job.batch, f_small)
        b_large = _scale_batch(job.batch, f_large)
        n_full = max(pytree.tree_leaves(job.batch)[0].shape[0], 1)
        n_small = max(n_full // f_small, 1)
        n_large = max(n_full // f_large, 1)
        p_small = self._probe(job, b_small, n_small)
        if self.capacity is not None and p_small > self.capacity:
            raise ProbeOOMError("probe itself exceeds device capacity")
        if n_large == n_small:
            return p_small
        p_large = self._probe(job, b_large, n_large)
        slope = (p_large - p_small) / (n_large - n_small)
        fixed = p_small - slope * n_small
        return int(fixed + slope * n_full)

"""Ground truth on the card: the peak memory a step really takes.

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
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import torch


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

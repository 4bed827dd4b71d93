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
    # with ``history=True``: every allocator request of the step, in
    # order, as (block bytes, innermost "file:line" of this package)
    allocs: list[tuple[int, str]] | None = None
    out: Any = dataclasses.field(repr=False, default=None)

    def to_json(self) -> dict:
        return {"reserved": self.reserved, "allocated": self.allocated,
                "n_segments": len(self.segment_sizes),
                "segment_bytes": sum(self.segment_sizes),
                "n_allocs": self.n_allocs,
                "n_segments_created": self.n_segments_created}


def _where(frames) -> str:
    for f in frames:
        if "repro_torch" in f["filename"]:
            return f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']}"
    return "?"


def measured_peak(step: Callable, *args, device=None,
                  history: bool = False) -> MeasuredPeak:
    """Run ``step(*args)`` once on the card and return its peaks.

    Cached free blocks are released first, so the peak counts what the
    resident inputs hold plus what the step itself needs. ``history``
    records the allocator's requests with their Python stacks (slower;
    for comparing the card's request stream with the trace's)."""
    if not torch.cuda.is_available():
        raise RuntimeError("measured_peak needs a CUDA device")
    if os.environ.get("PYTORCH_CUDA_ALLOC_CONF"):
        raise RuntimeError("measured_peak expects PYTORCH_CUDA_ALLOC_CONF "
                           "unset: the simulated allocator uses defaults")
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    if history:
        torch.cuda.memory._record_memory_history(stacks="python",
                                                 device=device)
    before = torch.cuda.memory_stats(device)
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_stats(device)
    snap = torch.cuda.memory._snapshot()
    allocs = None
    if history:
        torch.cuda.memory._record_memory_history(enabled=None,
                                                 device=device)
        allocs = [(e["size"], _where(e.get("frames", ())))
                  for e in snap["device_traces"][index]
                  if e["action"] == "alloc"]
    segments = [s["total_size"] for s in snap["segments"]
                if s["device"] == index]
    return MeasuredPeak(reserved=torch.cuda.max_memory_reserved(device),
                        allocated=torch.cuda.max_memory_allocated(device),
                        segment_sizes=sorted(segments), seconds=seconds,
                        n_allocs=after["allocation.all.allocated"]
                        - before["allocation.all.allocated"],
                        n_segments_created=after["segment.all.allocated"]
                        - before["segment.all.allocated"],
                        allocs=allocs, out=out)

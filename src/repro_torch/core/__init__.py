"""xMem core pipeline of the PyTorch port.

``events``, ``analyzer``, ``allocator``, ``simulator``, ``orchestrator``
and ``metrics`` are copies of the JAX package's framework-neutral stages
(trace schema v5, the same allocator simulations); ``tracer`` records a
PyTorch step under fake tensors; ``cache`` memoizes phase traces;
``estimator`` ties them into the training and serving estimates.
"""
from .allocator import (AllocatorPolicy, CachingAllocatorSim, CUDA_CACHING,
                        TPU_ARENA, XLA_BFC)
from .cache import BlockInfo, TraceCache, TracedPhase
from .estimator import EstimateReport, XMemEstimator, flatten_kinds
from .events import (TRACE_SCHEMA_VERSION, BlockKind, BlockLifecycle,
                     ColumnarBlocks, ColumnarTrace, MemoryEvent, Phase,
                     Trace)
from .orchestrator import MemoryOrchestrator, OrchestratorPolicy
from .simulator import MemorySimulator, SimResult
from .tracer import TorchMemoryTracer, trace_fn

__all__ = [
    "AllocatorPolicy", "CachingAllocatorSim", "CUDA_CACHING", "TPU_ARENA",
    "XLA_BFC", "BlockInfo", "TraceCache", "TracedPhase", "EstimateReport",
    "XMemEstimator", "flatten_kinds",
    "TRACE_SCHEMA_VERSION", "BlockKind", "BlockLifecycle", "ColumnarBlocks",
    "ColumnarTrace", "MemoryEvent", "Phase", "Trace", "MemoryOrchestrator",
    "OrchestratorPolicy", "MemorySimulator", "SimResult",
    "TorchMemoryTracer", "trace_fn",
]

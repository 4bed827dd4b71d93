"""Baseline estimators reproduced from the paper's evaluation (§4.1.1),
and the ground truth on the card.

Each baseline represents one methodology family:

* ``TensorSumEstimator``   — Horus-style: sums tensor sizes, no allocator,
                             no liveness (paper §5.1's "simpler static").
* ``DNNMemEstimator``      — static graph analysis + framework-level BFC
                             only: no device level, no cache reclaim, no
                             optimizer-phase capture, no code-placement
                             sensitivity (paper §5.1).
* ``SchedTuneEstimator``   — data-driven ridge regression on model/job
                             features; exhibits the cold-start problem on
                             unseen families (paper §5.2).
* ``DirectProbeEstimator`` — LLMem-style direct measurement: runs
                             scaled-down jobs on the card and
                             extrapolates — high fidelity, but consumes
                             the very resources estimation should spare
                             (paper §5.3).

All share the ``estimate(job) -> int`` interface over a ``JobSpec``.
``measured_peak`` and ``measured_training`` read the card's peaks: the
truth every estimate is held against.
"""
from .common import JobSpec
from .directprobe import (DirectProbeEstimator, MeasuredPeak, ProbeOOMError,
                          measured_peak, measured_training)
from .dnnmem import DNNMemEstimator
from .schedtune import SchedTuneEstimator
from .tensorsum import TensorSumEstimator

__all__ = [
    "JobSpec", "TensorSumEstimator", "DNNMemEstimator",
    "SchedTuneEstimator", "DirectProbeEstimator", "ProbeOOMError",
    "MeasuredPeak", "measured_peak", "measured_training",
]

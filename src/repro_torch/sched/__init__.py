"""Failure-domain-aware fleet scheduling driven by the estimator (port
of ``repro.sched``).

The paper's admission service answers "does this job fit this device?";
this package asks the fleet-shaped question — *which* device, shared
with whom, and what happens when that device dies mid-run:

* :mod:`repro_torch.sched.fleet` — :class:`Node` / :class:`Fleet` model with
  failure domains and the hard co-location invariant (co-resident safe
  thresholds never exceed capacity; any violation anywhere raises
  :class:`~repro_torch.service.faults.ChaosSafetyViolation`);
* :mod:`repro_torch.sched.scheduler` — :class:`FleetScheduler`: estimator-
  driven best-fit bin-packing with domain spreading, priority
  preemption, counter-offer backfill into fragmentation holes, and
  evacuation (fail / flap / shrink / straggler drain) that re-admits
  displaced jobs on warm caches, those that carry a plan context
  through ``train.elastic.shrink_and_replan`` (mesh re-carve, per-device
  re-admission, the planner's counter-offer);
* :mod:`repro_torch.sched.simulator` — :class:`FleetSimulator`: tick-driven
  chaos replay of thousands of arrivals with interleaved fleet events,
  scored by the two-round metrics plus fragmentation / evacuation
  latency / lost-vs-re-placed.
"""
from .fleet import (Assignment, Fleet, Node, NODE_DOWN,  # noqa: F401
                    NODE_DRAINED, NODE_UP)
from .scheduler import (EvacuationOutcome, FleetScheduler,  # noqa: F401
                        PlacementOutcome)
from .simulator import FleetOutcome, FleetSimulator, build_fleet  # noqa: F401

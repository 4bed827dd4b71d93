"""Estimation-as-a-service for the PyTorch port (port of
``repro.service``).

The paper's point is that a-priori CPU-only estimates let a cluster
scheduler make admission decisions without burning GPU time. This
package turns the one-shot estimator into that scheduler-facing
service:

* :mod:`repro_torch.service.store` — disk-backed, content-addressed
  trace store layered under ``core/cache.py`` (schema-v5 columnar
  payloads, LRU + version invalidation, quarantine) so warm estimates
  survive process restarts and are shared across workers;
* :mod:`repro_torch.service.admission` — ``AdmissionRequest`` ->
  ``AdmissionDecision`` over a worker pool that reuses ``SweepService``;
* :mod:`repro_torch.service.degrade` — the degradation ladder (exact ->
  decision log -> analytic bound, widened margins);
* :mod:`repro_torch.service.faults` — the fault-injection harness;
* :mod:`repro_torch.service.cluster` — a cluster-admission simulator
  that replays a job-arrival trace through the service and scores
  OOM/underutilization outcomes with ``core/metrics.py``;
* ``repro_torch.launch.served`` — the line-JSON TCP daemon exposing the
  service to schedulers.

Counter-offers need the remediation planner (slice 10); the fleet
scheduler and sharded estimates come with ``sched/`` and
``distributed/`` (slice 11).
"""
from .admission import (AdmissionDecision, AdmissionRequest,  # noqa: F401
                        AdmissionService)
from .cluster import ClusterSimulator, JobArrival  # noqa: F401
from .degrade import (DecisionLog, DegradePolicy, JobContext,  # noqa: F401
                      RungTimeout, RUNG_ANALYTIC, RUNG_EXACT, RUNG_SWEEP,
                      RUNGS)
from .faults import (ChaosSafetyViolation, FaultError, FaultPlan,  # noqa: F401
                     FaultSpec, FLEET_SITES, TransientFaultError,
                     fleet_event, plan_raising_at)
from .store import TraceStore  # noqa: F401

"""Cluster-admission simulator: replay a job-arrival trace through the
admission service and score outcomes (port of
``repro.service.cluster``).

The paper validates estimates with a two-round protocol (§4.1.4): round
1 checks the OOM prediction on a full-capacity device (Eq. 1/4), round 2
re-runs with max runnable memory = the estimate (Eq. 5) and scores the
memory conserved (Eq. 7/8). This module replays a synthetic cluster's
arrival trace through
:class:`~repro_torch.service.admission.AdmissionService`
and aggregates exactly those metrics via ``core/metrics.py`` — the
scheduler-integration experiment a GPU cluster would run, done entirely
on CPU.

Each :class:`JobArrival` carries the job's callables, the capacity of
the device the scheduler would place it on, and optionally the "true"
peak (an oracle measurement, or a perturbed estimate for sensitivity
studies). Without a truth the estimator is scored against itself —
useful for exercising the admission logic (OOM rejections,
underutilization accounting) deterministically.

**Chaos mode**: ``replay(faults=...)`` re-runs the trace with a
:class:`~repro_torch.service.faults.FaultPlan` injected into the service —
the decisions-served-under-failure experiment. The summary gains
degradation accounting (``served`` / ``degraded`` / per-rung counts),
and a faulted replay that OOM-admits ANY job raises
:class:`~repro_torch.service.faults.ChaosSafetyViolation`: the
degradation ladder's contract is that failures cost headroom, never
safety.

``retry_rejections`` re-submits a rejection on its best counter-offer,
which needs the remediation planner: an arrival with a ``plan`` context
raises ``NotImplementedError`` (slice 10) when the service rejects it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

from ..core import metrics
from ..obs.metrics import Counter, CounterDict
from .admission import AdmissionDecision, AdmissionRequest, AdmissionService
from .faults import ChaosSafetyViolation


@dataclasses.dataclass
class JobArrival:
    """One job in the arrival trace."""

    job_id: str
    fwd_bwd_fn: Callable
    params: Any
    batch: Any
    update_fn: Callable | None = None
    opt_init_fn: Callable | None = None
    capacity: int | None = None         # device bytes (required)
    truth_bytes: int | None = None      # oracle peak; None -> estimate
    family: str = "workload"
    device: str = "sim"
    arrival_s: float = 0.0
    # structured job description (the planner's PlanContext) — enables
    # counter-offers on rejection and the simulator's retry round
    plan: Any | None = None
    deadline_s: float | None = None     # per-job answer budget
    # fleet-scheduler fields (``sched/``): preemption rank and how many
    # arrival ticks the job occupies its device(s) before departing
    # (None = runs for the rest of the replay)
    priority: int = 0
    duration_ticks: int | None = None

    def request(self) -> AdmissionRequest:
        return AdmissionRequest(
            self.job_id, self.fwd_bwd_fn, self.params, self.batch,
            update_fn=self.update_fn, opt_init_fn=self.opt_init_fn,
            capacity=self.capacity, deadline_s=self.deadline_s,
            meta={"plan": self.plan} if self.plan is not None else {})


@dataclasses.dataclass
class ClusterOutcome:
    """Decisions + two-round records + headline summary."""

    decisions: list[AdmissionDecision]
    records: list[metrics.RunRecord]
    summary: dict
    # (job_id, CounterOffer) per job that was re-admitted on a
    # counter-offer during the retry round
    retries: list = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter(zip(self.decisions, self.records))


class ClusterSimulator:
    """Replays arrivals through a service and scores the outcomes."""

    def __init__(self, service: AdmissionService,
                 truth_fn: Callable[[AdmissionDecision], int] | None = None):
        self.service = service
        self.truth_fn = truth_fn

    def replay(self, arrivals: Sequence[JobArrival],
               retry_rejections: bool = False, faults=None,
               deadline_s: float | None = None) -> ClusterOutcome:
        """Replay the arrival trace; with ``retry_rejections`` every
        rejection that came back with counter-offers (the arrival must
        carry a ``plan`` context) is re-submitted on its best offer, and
        the retry decision is what gets scored — the two-round metrics
        then quantify planning vs. plain rejection on the same trace.

        Truth accounting: ``truth_bytes`` describes the job *as
        requested*; a job re-admitted on a counter-offer runs a
        different plan, so its truth falls back to ``truth_fn`` (called
        on the retry decision) or to the offer's own estimate.

        Chaos mode: pass ``faults`` (a ``FaultPlan``) and optionally a
        per-job ``deadline_s`` default. The plan is injected for the
        duration of the replay; the returned summary reports how many
        decisions were served degraded and from which rung, and the
        replay RAISES ``ChaosSafetyViolation`` if any faulted decision
        OOM-admits — degraded answers must widen, never thin, the
        safety margin."""
        if faults is not None:
            with self.service.inject_faults(faults):
                return self._replay(arrivals, retry_rejections,
                                    deadline_s, chaos=True)
        return self._replay(arrivals, retry_rejections, deadline_s,
                            chaos=False)

    def _replay(self, arrivals: Sequence[JobArrival],
                retry_rejections: bool, deadline_s: float | None,
                chaos: bool) -> ClusterOutcome:
        t0 = time.perf_counter()
        decisions: list[AdmissionDecision] = []
        records: list[metrics.RunRecord] = []
        retries: list = []
        for job in arrivals:
            req = job.request()
            if req.deadline_s is None:
                req.deadline_s = deadline_s
            if not retry_rejections:
                # plain-rejection round: do not pay for a planner search
                # whose offers would be discarded anyway
                req.meta.pop("plan", None)
            d = self.service.decide(req)
            offer = None
            if retry_rejections and not d.admit and d.counter_offers \
                    and job.plan is not None:
                best = d.counter_offers[0]
                retry_req = best.admission_request(
                    job.plan.cfg, job.plan.policy, job.plan.shape,
                    capacity=job.capacity,
                    job_id=f"{job.job_id}+offer")
                # the retry must honor the same deadline contract as the
                # original decision — without this a hang fault on the
                # retry path would block the replay past every budget
                retry_req.deadline_s = (job.deadline_s
                                        if job.deadline_s is not None
                                        else deadline_s)
                retry = self.service.decide(retry_req)
                if retry.admit:
                    d, offer = retry, best
                    retries.append((job.job_id, best))
            truth = job.truth_bytes if offer is None else None
            if truth is None and self.truth_fn is not None:
                truth = self.truth_fn(d)
            if truth is None:
                truth = d.peak_bytes
            decisions.append(d)
            records.append(metrics.RunRecord(
                config=job.job_id, family=job.family,
                estimator="admission_service", device=job.device,
                capacity=job.capacity, estimate=d.peak_bytes,
                truth=int(truth), runtime_s=d.wall_s))
        wall = time.perf_counter() - t0
        summary = score(records)
        # per-replay chaos accounting through the registry counter
        # types: the summary keys/values stay bit-for-bit
        # with the old hand-rolled dict — CounterDict preserves
        # first-seen rung order and plain-int values
        served_c = Counter("xmem_replay_served_total")
        degraded_c = Counter("xmem_replay_degraded_total")
        rung_counts = CounterDict(name="xmem_replay_rung_total",
                                  label="rung")
        for d in decisions:
            served_c.inc()
            if d.degraded:
                degraded_c.inc()
            rung_counts.inc(d.rung)
        summary.update(
            wall_s=wall,
            replanned=len(retries),
            served=served_c.value,
            degraded=degraded_c.value,
            rungs=dict(rung_counts.items()),
            requests_per_s=(len(arrivals) / wall if wall > 0
                            and arrivals else 0.0))
        if chaos and summary["oom_admitted"]:
            bad = [r.config for r in records
                   if not r.oom_pred and r.oom_actual]
            raise ChaosSafetyViolation(
                f"chaos replay OOM-admitted {summary['oom_admitted']} "
                f"job(s) under fault injection: {bad}")
        return ClusterOutcome(decisions, records, summary, retries)


def score(records: Sequence[metrics.RunRecord]) -> dict:
    """Two-round scoring of an admission run (Eq. 3/6/8 plus scheduler
    outcome counts). ``oom_admitted`` are round-1 failures where the
    service admitted a job whose true peak exceeds the device
    (catastrophic for a scheduler); ``underutilized_rejected`` are jobs
    the service bounced although they would have fit (wasted capacity);
    ``round2_oom`` are admitted jobs whose true peak exceeds the
    estimate-as-threshold (Eq. 5 failures)."""
    admitted = [r for r in records if not r.oom_pred]
    rejected = [r for r in records if r.oom_pred]
    return {
        "jobs": len(records),
        "admitted": len(admitted),
        "rejected": len(rejected),
        "oom_admitted": sum(1 for r in admitted if r.oom_actual),
        "underutilized_rejected": sum(
            1 for r in rejected if not r.oom_actual),
        "round2_oom": sum(1 for r in admitted
                          if not r.oom_actual and r.oom_round2),
        "mre": metrics.mre(records),
        "pef": metrics.pef(records),
        "mcp_gb": metrics.mcp(records) / 1e9 if records else 0.0,
        "mean_runtime_s": metrics.mean_runtime(records),
    }

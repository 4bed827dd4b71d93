"""Fleet-scale chaos replay (port of ``repro.sched.simulator``):
thousands of arrivals through the
:class:`~repro_torch.sched.scheduler.FleetScheduler` with node failures,
flaps, and capacity shrinks interleaved mid-stream.

Each arrival is one *tick*. Per tick the simulator (in order) restores
flapped nodes whose outage elapsed, polls the fault plan's fleet event
sites (``node.fail`` / ``node.flap`` / ``node.shrink``) and evacuates
the struck node, releases jobs whose ``duration_ticks`` elapsed, feeds
synthetic step times to the straggler detector (when given a
``step_time_fn``) and periodically migrates flagged nodes, then places
the arrival.

Scoring reuses the two-round machinery (``core/metrics.py``) exactly as
:class:`~repro_torch.service.cluster.ClusterSimulator` does — a placed job is
an admit scored against the device capacity, a lost job is scored as a
rejection (so losing a *feasible* job costs the full ``-capacity``
round-1 penalty) — plus fleet-level metrics: fragmentation, evacuation
latency, and jobs lost vs. re-placed. Because every placement path ends
in :meth:`Fleet.place`, a single over-commit anywhere aborts the replay
with :class:`~repro_torch.service.faults.ChaosSafetyViolation`; a completed
replay therefore certifies zero violations by construction.

Delta from the reference: :func:`build_fleet` has no default capacity
(the reference's is a TPU's HBM); the caller gives the nodes' bytes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from ..core import metrics
from ..obs.metrics import Histogram
from ..service.cluster import JobArrival, score
from ..service.faults import FLEET_SITES
from .fleet import Fleet, Node
from .scheduler import EvacuationOutcome, FleetScheduler, PlacementOutcome


def build_fleet(n_nodes: int, capacity: int, *,
                device: str = "sim", domains: int = 4,
                prefix: str = "node") -> Fleet:
    """Homogeneous fleet helper: ``n_nodes`` nodes of ``capacity`` bytes
    each, striped round-robin across ``domains`` failure domains."""
    return Fleet(Node(node_id=f"{prefix}{i:03d}", capacity=capacity,
                      device=device, domain=f"rack{i % domains}")
                 for i in range(n_nodes))


@dataclasses.dataclass
class FleetOutcome:
    """Placements + evacuations + two-round records + fleet summary."""

    placements: list[PlacementOutcome]
    evacuations: list[EvacuationOutcome]
    records: list[metrics.RunRecord]
    summary: dict

    @property
    def displaced_accounted(self) -> bool:
        """True when every job an evacuation displaced is accounted —
        re-placed somewhere or explicitly reported lost."""
        return all(len(e.displaced) == len(e.replaced) + len(e.lost)
                   for e in self.evacuations)


class FleetSimulator:
    """Replays an arrival trace through a fleet scheduler under chaos."""

    def __init__(self, scheduler: FleetScheduler,
                 truth_fn: Callable | None = None):
        self.scheduler = scheduler
        self.truth_fn = truth_fn

    def replay(self, arrivals: Sequence[JobArrival], *, faults=None,
               deadline_s: float | None = None,
               step_time_fn: Callable[[str, int], float] | None = None,
               migrate_every: int = 32) -> FleetOutcome:
        """Replay the trace; ``faults`` (a ``FaultPlan``) is injected
        into the admission service for the duration — its tracer/replay/
        store sites degrade estimates as usual while its fleet event
        sites kill, flap, and shrink nodes mid-stream. ``step_time_fn``
        (node_id, tick) -> seconds drives the straggler detector;
        flagged nodes are drained and migrated every ``migrate_every``
        ticks."""
        service = self.scheduler.service
        if faults is not None:
            with service.inject_faults(faults):
                return self._replay(arrivals, faults, deadline_s,
                                    step_time_fn, migrate_every)
        return self._replay(arrivals, None, deadline_s, step_time_fn,
                            migrate_every)

    def _replay(self, arrivals, faults, deadline_s, step_time_fn,
                migrate_every) -> FleetOutcome:
        sched = self.scheduler
        fleet = sched.fleet
        if deadline_s is not None and sched.deadline_s is None:
            sched.deadline_s = deadline_s
        t0 = time.perf_counter()
        placements: list[PlacementOutcome] = []
        evacuations: list[EvacuationOutcome] = []
        records: list[metrics.RunRecord] = []
        flap_restore: dict[str, int] = {}   # node_id -> restore tick
        depart_at: dict[str, int] = {}      # job_id -> departure tick
        for tick, job in enumerate(arrivals):
            for nid in [n for n, due in flap_restore.items()
                        if due <= tick]:
                fleet.restore(nid)
                del flap_restore[nid]
            if faults is not None:
                evacuations.extend(
                    self._fault_events(faults, tick, flap_restore))
            for jid in [j for j, due in depart_at.items() if due <= tick]:
                sched.release(jid)
                del depart_at[jid]
            if step_time_fn is not None:
                for nid in fleet.up_nodes():
                    sched.note_step_time(nid, step_time_fn(nid, tick))
                if tick and tick % migrate_every == 0:
                    evacuations.extend(sched.migrate_stragglers(tick))
            out = sched.place(job, tick)
            placements.append(out)
            if out.placed and job.duration_ticks is not None:
                depart_at[job.job_id] = tick + max(1, job.duration_ticks)
            records.append(self._record(job, out))
        fleet.check_invariant()             # certify the final state too
        wall = time.perf_counter() - t0
        summary = score(records)
        # per-replay latency distribution through the registry Histogram
        # type: the incremental sum observes walls in append order, so
        # the mean/max stay bit-for-bit with the old list arithmetic
        evac_h = Histogram("xmem_replay_evacuation_seconds")
        for e in evacuations:
            evac_h.observe(e.wall_s)
        summary.update(
            wall_s=wall,
            arrivals_per_s=(len(arrivals) / wall
                            if wall > 0 and arrivals else 0.0),
            violations=0,                   # an over-commit would have raised
            fragmentation=fleet.fragmentation(),
            utilization=fleet.utilization(),
            evacuation_latency_s=evac_h.mean,
            evacuation_latency_max_s=(evac_h.max if evac_h.count
                                      else 0.0),
            **sched.counters)
        return FleetOutcome(placements, evacuations, records, summary)

    # -- fault event polling -------------------------------------------------
    def _fault_events(self, faults, tick: int, flap_restore: dict
                      ) -> list[EvacuationOutcome]:
        """Consume any fleet event sites armed for this tick. The
        struck node is the spec's ``node`` or, unpinned, the busiest up
        node — chaos aims where it hurts most."""
        poll = getattr(faults, "poll", None)
        if poll is None:
            return []
        out = []
        for site in FLEET_SITES:
            spec = poll(site)
            if spec is None:
                continue
            nid = spec.node or self._busiest()
            if nid is None or not self.scheduler.fleet.is_up(nid):
                continue
            evac = self.scheduler.evacuate_node(
                nid, site, tick, shrink_frac=spec.shrink_frac)
            if site == "node.flap":
                flap_restore[nid] = tick + max(1, spec.down_for)
            out.append(evac)
        return out

    def _busiest(self) -> str | None:
        fleet = self.scheduler.fleet
        up = fleet.up_nodes()
        if not up:
            return None
        return max(up, key=lambda nid: (len(fleet.residents(nid)),
                                        fleet.committed(nid), nid))

    # -- scoring -------------------------------------------------------------
    def _record(self, job: JobArrival, out: PlacementOutcome
                ) -> metrics.RunRecord:
        """Two-round record for one arrival. Placed = admit (estimate
        vs. the device capacity the arrival names); a counter-offer /
        elastic placement runs a different plan, so — as in
        ``ClusterSimulator`` — its truth falls back to the charged
        estimate. Lost = rejection: estimate pinned above capacity so a
        feasible job lost costs the round-1 ``-capacity`` penalty and an
        infeasible one scores as a correct rejection."""
        cap = job.capacity
        if out.placed:
            if out.offer is not None:
                est = out.assignment.total_bytes
                truth = est
            else:
                est = out.decision.peak_bytes
                truth = job.truth_bytes
                if truth is None and self.truth_fn is not None:
                    truth = self.truth_fn(out.decision)
                if truth is None:
                    truth = est
            est = min(est, cap)             # placed => charged within cap
        else:
            est = cap + 1
            truth = job.truth_bytes
            if truth is None:
                # no oracle: score the loss as feasible-but-bounced (the
                # decision's peak when one was made, else the device
                # capacity) — losing a job only earns the correct-
                # rejection credit when its true peak exceeds the
                # device, never as a reward for having no room
                truth = (out.decision.peak_bytes
                         if out.decision is not None else cap)
        return metrics.RunRecord(
            config=job.job_id, family=job.family,
            estimator="fleet_scheduler", device=job.device,
            capacity=cap, estimate=int(est), truth=int(truth),
            runtime_s=out.wall_s)

"""Failure-aware fleet scheduler driven entirely by the estimator
(port of ``repro.sched.scheduler``).

Placement policy, in order:

1. **Admission** — the job is decided by the
   :class:`~repro_torch.service.admission.AdmissionService` against the
   best capacity the fleet could currently give it (the largest
   headroom hole; with preemption rights, headroom plus evictable
   lower-priority shares). The decision's *safe threshold* —
   margin-widened when a degraded rung answered — is what every node is
   charged; raw peaks never touch the books, so failures cost headroom,
   never safety.
2. **Bin-packing** — best-fit into the smallest adequate hole (keeps
   the big holes whole for big jobs, i.e. minimizes fragmentation),
   tie-broken by spreading a job family across failure domains.
3. **Priority preemption** — a higher-priority job that fits nowhere
   may evict the cheapest set of strictly-lower-priority residents;
   victims re-enter placement (without cascade-preemption rights) and
   are re-placed or reported lost.
4. **Counter-offer backfill** — a rejection whose arrival carries a
   :class:`~repro_torch.plan.PlanContext` comes back with ranked
   :class:`~repro_torch.plan.CounterOffer`\\ s sized to the largest
   hole; the first offer whose per-device safe threshold fits a (set
   of) fragmentation hole(s) is placed instead of losing the job.

Evacuation (node fail / flap / shrink / straggler drain): displaced
jobs re-enter admission on warm caches, through
:func:`repro_torch.train.elastic.shrink_and_replan` when they carry a
plan context (re-carve the mesh to the devices that still have room,
re-admit with spec-driven per-device factors, apply the planner's
counter-offer when the old plan no longer fits), through plain
placement otherwise or when the elastic path finds no placement. Every
re-placement goes through :meth:`Fleet.place`, which re-verifies the
co-location invariant; an over-commit anywhere raises
:class:`~repro_torch.service.faults.ChaosSafetyViolation`.

Delta from the reference: the reference's elastic path turns any
exception of ``shrink_and_replan`` into "no elastic placement". Its own
tests raise none there; the one refusal the path can meet by design, a
model axis wider than the devices left (``replan_mesh``'s
``ValueError``), is checked before the call and gives the same answer,
and any error of the call itself propagates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

from ..obs import CounterDict, Observability
from ..obs import spans as obs_spans
from ..service.cluster import JobArrival
from ..train.elastic import StragglerMonitor
from .fleet import Assignment, Fleet


@dataclasses.dataclass
class PlacementOutcome:
    """What happened to one arrival."""

    job_id: str
    placed: bool
    kind: str                       # placed|backfill|preempt|evacuation|lost
    assignment: Assignment | None = None
    decision: Any = None            # AdmissionDecision (None: no capacity)
    offer: Any = None               # CounterOffer used by a backfill
    preempted: list = dataclasses.field(default_factory=list)
    preempted_lost: list = dataclasses.field(default_factory=list)
    reason: str = ""
    wall_s: float = 0.0

    @property
    def node_ids(self) -> list[str]:
        return (sorted(self.assignment.shares)
                if self.assignment is not None else [])

    def to_json(self) -> dict:
        d = {"job_id": self.job_id, "placed": self.placed,
             "kind": self.kind, "nodes": self.node_ids,
             "reason": self.reason, "preempted": list(self.preempted),
             "preempted_lost": list(self.preempted_lost)}
        if self.assignment is not None:
            d["shares"] = dict(self.assignment.shares)
            d["topology"] = self.assignment.topology
        if self.decision is not None:
            d["peak_bytes"] = self.decision.peak_bytes
            d["safe_threshold"] = self.decision.safe_threshold
            d["rung"] = self.decision.rung
            d["degraded"] = self.decision.degraded
        if self.offer is not None:
            d["offer"] = self.offer.to_json()
        return d


@dataclasses.dataclass
class EvacuationOutcome:
    """One fleet fault event and where its displaced jobs went."""

    node_id: str
    event: str                      # node.fail|node.flap|node.shrink|straggler
    displaced: list
    replaced: list                  # job ids re-placed somewhere
    lost: list                      # job ids that fit nowhere
    wall_s: float = 0.0             # evacuation latency

    def to_json(self) -> dict:
        return {"node": self.node_id, "event": self.event,
                "displaced": list(self.displaced),
                "replaced": list(self.replaced),
                "lost": list(self.lost), "wall_s": self.wall_s}


class FleetScheduler:
    """Estimator-driven bin-packing over a :class:`Fleet`.

    ``colocate=False`` is the no-co-location baseline (one job per
    node, exclusive) the fleet metrics compare against; ``preempt`` /
    ``backfill`` gate policies 3 and 4; ``deadline_s`` is the default
    per-decision answer budget (jobs may carry their own)."""

    def __init__(self, service, fleet: Fleet, *, colocate: bool = True,
                 preempt: bool = True, backfill: bool = True,
                 deadline_s: float | None = None,
                 obs: Observability | None = None):
        self.service = service
        self.fleet = fleet
        self.colocate = colocate
        self.preempt = preempt
        self.backfill = backfill
        self.deadline_s = deadline_s
        self._node_index = {nid: i for i, nid in enumerate(fleet.nodes)}
        self.monitor = StragglerMonitor(len(fleet.nodes))
        self.obs = obs if obs is not None else Observability(enabled=False)
        self.counters = CounterDict(
            ("placed", "colocated", "backfills", "preemptions",
             "preempted_lost", "lost", "evacuations", "evacuated",
             "re_placed", "lost_after_evacuation", "migrations"),
            registry=self.obs.registry, name="xmem_fleet_events_total",
            label="event", help="Fleet scheduler placement/evacuation events")
        self._m_evac_s = self.obs.registry.histogram(
            "xmem_fleet_evacuation_seconds",
            help="Evacuation latency (displacement to re-placement)")
        self.obs.registry.register_collector("xmem_fleet", lambda: {
            "fragmentation": self.fleet.fragmentation(),
            "utilization": self.fleet.utilization(),
            "jobs_resident": len(self.fleet.assignments)})

    # -- placement -----------------------------------------------------------
    def place(self, job: JobArrival, tick: int = 0, *,
              allow_preempt: bool | None = None,
              source: str = "decide") -> PlacementOutcome:
        """Place one arrival (see module docstring for the policy)."""
        with obs_spans.span("fleet.place", job_id=job.job_id,
                            source=source):
            out = self._place(job, tick, allow_preempt=allow_preempt,
                              source=source)
        self._audit_place(out, tick)
        return out

    def _place(self, job: JobArrival, tick: int = 0, *,
               allow_preempt: bool | None = None,
               source: str = "decide") -> PlacementOutcome:
        t0 = time.perf_counter()
        allow_preempt = (self.preempt if allow_preempt is None
                         else allow_preempt)
        cap = self._best_capacity(job, allow_preempt)
        if cap <= 0:
            return self._lost(job, None, "no capacity in the fleet",
                              t0, tick)
        req = job.request()
        req.capacity = cap
        if req.deadline_s is None:
            req.deadline_s = self.deadline_s
        if not self.backfill:
            req.meta.pop("plan", None)
        decision = self.service.decide(req)
        threshold = decision.safe_threshold
        if decision.admit:
            nodes = self._pick_nodes(threshold, family=job.family,
                                     device=job.device)
            if nodes is not None:
                a = self._assignment(job, {nodes[0]: threshold},
                                     decision, tick, source=source)
                self.fleet.place(a)
                self._count_place(a)
                return PlacementOutcome(
                    job.job_id, True, source, assignment=a,
                    decision=decision,
                    wall_s=time.perf_counter() - t0)
        if allow_preempt and job.priority > 0:
            out = self._try_preempt(job, decision, threshold, tick, t0)
            if out is not None:
                return out
        if self.backfill and decision.counter_offers:
            out = self._try_backfill(job, decision, tick, t0)
            if out is not None:
                return out
        return self._lost(job, decision,
                          f"safe threshold {threshold} fits no hole",
                          t0, tick)

    def release(self, job_id: str) -> Assignment | None:
        """Voluntary departure (the job finished)."""
        return self.fleet.remove(job_id)

    def _assignment(self, job: JobArrival, shares: dict, decision,
                    tick: int, *, source: str, topology: str | None = None,
                    mesh: tuple | None = None,
                    offer=None) -> Assignment:
        return Assignment(
            job_id=job.job_id, shares=shares, priority=job.priority,
            family=job.family, source=source, topology=topology,
            mesh=mesh, placed_tick=tick, truth_bytes=job.truth_bytes,
            arrival=job, ctx=job.plan)

    def _count_place(self, a: Assignment) -> None:
        self.counters["placed"] += 1
        if any(len(self.fleet.residents(nid)) > 1 for nid in a.shares):
            self.counters["colocated"] += 1

    def _audit_place(self, out: PlacementOutcome, tick: int) -> None:
        """One audit record per placement attempt, chained to the
        admission decision's correlation ID (the same ID the planner's
        counter-offer record carries — reject → plan → place is one
        trail)."""
        if self.obs.audit is None:
            return
        # "outcome", not "kind": the record kind is "place"
        rec = {"job_id": out.job_id, "placed": out.placed,
               "outcome": out.kind, "nodes": out.node_ids, "tick": tick,
               "reason": out.reason, "wall_s": round(out.wall_s, 6)}
        cid = None
        if out.decision is not None:
            cid = getattr(out.decision, "correlation_id", None)
            rec.update(rung=out.decision.rung,
                       peak_bytes=out.decision.peak_bytes,
                       safe_threshold=out.decision.safe_threshold,
                       degraded=out.decision.degraded)
        if out.offer is not None:
            rec["offer"] = {"knob": out.offer.knob,
                            "safe_threshold": out.offer.safe_threshold}
        if out.preempted or out.preempted_lost:
            rec["preempted"] = list(out.preempted)
            rec["preempted_lost"] = list(out.preempted_lost)
        self.obs.record("place", correlation_id=cid, **rec)

    def _audit_evacuation(self, out: EvacuationOutcome,
                          tick: int) -> None:
        if self.obs.audit is None:
            return
        self.obs.record(
            "evacuate", node=out.node_id, event=out.event, tick=tick,
            displaced=list(out.displaced), replaced=list(out.replaced),
            lost=list(out.lost), wall_s=round(out.wall_s, 6))

    def _lost(self, job: JobArrival, decision, reason: str, t0: float,
              tick: int) -> PlacementOutcome:
        self.counters["lost"] += 1
        return PlacementOutcome(job.job_id, False, "lost",
                                decision=decision, reason=reason,
                                wall_s=time.perf_counter() - t0)

    # -- capacity + node selection -------------------------------------------
    def _best_capacity(self, job: JobArrival, allow_preempt: bool) -> int:
        """The most memory the fleet could give this job right now —
        the capacity its admission decision (and any planner search) is
        made against. With preemption rights: headroom plus the shares
        of strictly-lower-priority residents."""
        best = 0
        empty_only = not self.colocate
        for nid in self.fleet.up_nodes(job.device):
            if empty_only and self.fleet.residents(nid):
                continue
            h = self.fleet.headroom(nid)
            if allow_preempt and job.priority > 0:
                h += sum(a.shares[nid] for a in self.fleet.residents(nid)
                         if a.priority < job.priority)
            best = max(best, h)
        return best

    def _pick_nodes(self, threshold: int, n: int = 1, *,
                    family: str = "", device: str | None = None,
                    exclude=()) -> list[str] | None:
        """``n`` nodes with ``threshold`` headroom each: best-fit
        (smallest adequate hole first) with two spreading rules — a
        multi-device job prefers distinct failure domains (one rack
        loss displaces it anyway, but a flap of one node should not be
        *every* replica), and ties prefer the domain hosting the fewest
        same-family residents (anti-affinity)."""
        holes = self.fleet.holes(device, empty_only=not self.colocate)
        fits = [(nid, h) for nid, h in holes
                if h >= threshold and nid not in exclude]
        if len(fits) < n:
            return None
        fam_load: dict[str, int] = {}
        for a in self.fleet.assignments.values():
            if a.family != family:
                continue
            for nid in a.shares:
                dom = self.fleet.nodes[nid].domain
                fam_load[dom] = fam_load.get(dom, 0) + 1
        ranked = sorted(fits, key=lambda p: (
            p[1], fam_load.get(self.fleet.nodes[p[0]].domain, 0), p[0]))
        chosen: list[str] = []
        used_domains: set[str] = set()
        for nid, _h in ranked:                  # pass 1: fresh domains
            if len(chosen) == n:
                break
            if self.fleet.nodes[nid].domain in used_domains:
                continue
            chosen.append(nid)
            used_domains.add(self.fleet.nodes[nid].domain)
        for nid, _h in ranked:                  # pass 2: fill remainder
            if len(chosen) == n:
                break
            if nid not in chosen:
                chosen.append(nid)
        return chosen if len(chosen) == n else None

    # -- preemption ----------------------------------------------------------
    def _try_preempt(self, job: JobArrival, decision, threshold: int,
                     tick: int, t0: float) -> PlacementOutcome | None:
        """Evict the cheapest set of strictly-lower-priority residents
        that frees ``threshold`` on one node. Victims re-enter
        placement without cascade-preemption rights."""
        best = None                 # (n_evicted, bytes_evicted, nid, victims)
        for nid in self.fleet.up_nodes(job.device):
            headroom = self.fleet.headroom(nid)
            evictable = sorted(
                (a for a in self.fleet.residents(nid)
                 if a.priority < job.priority),
                key=lambda a: (-a.shares[nid], a.job_id))
            freed, victims = headroom, []
            for a in evictable:
                if freed >= threshold:
                    break
                freed += a.shares[nid]
                victims.append(a)
            if freed >= threshold and victims:
                key = (len(victims), sum(a.total_bytes for a in victims),
                       nid)
                if best is None or key < best[:3]:
                    best = (*key, victims)
        if best is None:
            return None
        _n, _b, nid, victims = best
        for a in victims:
            self.fleet.remove(a.job_id)
        a_new = self._assignment(job, {nid: threshold}, decision, tick,
                                 source="preempt")
        self.fleet.place(a_new)
        self.counters["preemptions"] += 1
        self._count_place(a_new)
        replaced, lost = [], []
        for victim in victims:
            out = self._replace(victim, tick)
            (replaced if out is not None and out.placed
             else lost).append(victim.job_id)
        self.counters["preempted_lost"] += len(lost)
        return PlacementOutcome(
            job.job_id, True, "preempt", assignment=a_new,
            decision=decision, preempted=replaced, preempted_lost=lost,
            wall_s=time.perf_counter() - t0)

    # -- counter-offer backfill ----------------------------------------------
    def _try_backfill(self, job: JobArrival, decision, tick: int,
                      t0: float) -> PlacementOutcome | None:
        """Place the first (cheapest) counter-offer whose per-device
        safe threshold fits the fleet's fragmentation holes — a
        topology offer needs ``n_devices`` adequate holes."""
        for offer in decision.counter_offers:
            threshold = offer.safe_threshold
            nodes = self._pick_nodes(threshold, n=offer.n_devices,
                                     family=job.family, device=job.device)
            if nodes is None:
                continue
            topo = offer.topology
            a = self._assignment(
                job, {nid: threshold for nid in nodes}, decision, tick,
                source="counter-offer",
                topology=topo.label if topo is not None else None,
                mesh=((topo.pod, topo.data, topo.model)
                      if topo is not None else None))
            self.fleet.place(a)
            self.counters["backfills"] += 1
            self._count_place(a)
            return PlacementOutcome(
                job.job_id, True, "backfill", assignment=a,
                decision=decision, offer=offer,
                wall_s=time.perf_counter() - t0)
        return None

    # -- evacuation ----------------------------------------------------------
    def evacuate_node(self, node_id: str, event: str, tick: int = 0, *,
                      shrink_frac: float = 0.5) -> EvacuationOutcome:
        """Apply a fleet fault event and re-place everything it
        displaced. ``event``: ``node.fail`` / ``node.flap`` (down, the
        simulator restores it later) / ``node.shrink`` (partial
        capacity loss, node stays up)."""
        t0 = time.perf_counter()
        with obs_spans.span("fleet.evacuate", node=node_id, event=event):
            if event == "node.shrink":
                displaced = self.fleet.shrink(node_id, shrink_frac)
            else:
                displaced = self.fleet.fail(node_id)
            self.monitor.forget(self._node_index[node_id])
            replaced, lost = self._replace_all(displaced, tick)
        self.counters["evacuations"] += 1
        self.counters["evacuated"] += len(displaced)
        self.counters["re_placed"] += len(replaced)
        self.counters["lost_after_evacuation"] += len(lost)
        out = EvacuationOutcome(
            node_id, event, [a.job_id for a in displaced], replaced,
            lost, wall_s=time.perf_counter() - t0)
        self._m_evac_s.observe(out.wall_s)
        self._audit_evacuation(out, tick)
        return out

    def _replace_all(self, displaced, tick: int) -> tuple[list, list]:
        replaced, lost = [], []
        for a in displaced:
            out = self._replace(a, tick)
            (replaced if out is not None and out.placed
             else lost).append(a.job_id)
        return replaced, lost

    def _replace(self, a: Assignment, tick: int
                 ) -> PlacementOutcome | None:
        """Re-admission of a displaced job: the elastic
        shrink-and-replan path when it carries a plan context, plain
        (cache-warm) placement otherwise. Either way the re-placement
        goes through ``Fleet.place``: the invariant is re-verified."""
        job = a.arrival
        if job is None:
            return None
        if a.ctx is not None:
            out = self._replace_elastic(a, job, tick)
            if out is not None:
                return out
        return self.place(job, tick, allow_preempt=False,
                          source="evacuation")

    def _replace_elastic(self, a: Assignment, job: JobArrival, tick: int
                         ) -> PlacementOutcome | None:
        """Re-carve the displaced job's mesh to the devices that still
        have room, re-admit on the new topology with spec-driven
        factors, and apply the planner's counter-offer when the old
        policy no longer fits (``shrink_and_replan``). None when no
        elastic placement exists: too few holes for the model axis, no
        admitted plan, or no nodes for it."""
        from ..train.elastic import MeshPlan, shrink_and_replan
        t0 = time.perf_counter()
        ctx = a.ctx
        holes = self.fleet.holes(job.device,
                                 empty_only=not self.colocate)
        if not holes:
            return None
        cur = MeshPlan(*(a.mesh or (1, 1, 1)))
        avail = max(min(len(holes), cur.devices), 1)
        if avail < cur.model:   # replan_mesh cannot keep the model axis:
            return None         # plain placement runs
        rp = shrink_and_replan(
            ctx.cfg, ctx.policy, ctx.shape, cur, available_devices=avail,
            hbm_bytes=holes[0][1], service=self.service, space=ctx.space)
        if not rp.admitted:
            return None
        decision = rp.decision
        offer = rp.offer
        threshold = (decision.safe_threshold if decision.admit
                     else offer.safe_threshold)
        nodes = self._pick_nodes(threshold, n=rp.plan.devices,
                                 family=job.family, device=job.device)
        if nodes is None:
            return None
        a2 = self._assignment(
            job, {nid: threshold for nid in nodes}, decision, tick,
            source="evacuation", topology=rp.topology.label,
            mesh=(rp.plan.pod, rp.plan.data, rp.plan.model))
        self.fleet.place(a2)
        self._count_place(a2)
        return PlacementOutcome(
            job.job_id, True, "evacuation", assignment=a2,
            decision=decision, offer=offer,
            wall_s=time.perf_counter() - t0)

    # -- straggler migration -------------------------------------------------
    def note_step_time(self, node_id: str, step_time_s: float) -> None:
        """Feed per-node step timings to the MAD straggler detector."""
        self.monitor.record(self._node_index[node_id], step_time_s)

    def straggler_nodes(self) -> list[str]:
        lag = set(self.monitor.stragglers())
        return [nid for nid, i in self._node_index.items() if i in lag]

    def migrate_stragglers(self, tick: int = 0) -> list[EvacuationOutcome]:
        """Drain each flagged node, re-place its residents elsewhere
        (the drained node is unplaceable during the migration), then
        restore it with a cleared timing window."""
        out = []
        for nid in self.straggler_nodes():
            if not self.fleet.is_up(nid):
                continue
            t0 = time.perf_counter()
            displaced = self.fleet.drain(nid)
            replaced, lost = self._replace_all(displaced, tick)
            self.fleet.restore(nid)
            self.monitor.forget(self._node_index[nid])
            self.counters["migrations"] += len(displaced)
            self.counters["evacuated"] += len(displaced)
            self.counters["re_placed"] += len(replaced)
            self.counters["lost_after_evacuation"] += len(lost)
            ev = EvacuationOutcome(
                nid, "straggler", [a.job_id for a in displaced],
                replaced, lost, wall_s=time.perf_counter() - t0)
            self._m_evac_s.observe(ev.wall_s)
            self._audit_evacuation(ev, tick)
            out.append(ev)
        return out

    def stats(self) -> dict:
        return {**self.counters,
                "fragmentation": self.fleet.fragmentation(),
                "utilization": self.fleet.utilization(),
                "jobs_resident": len(self.fleet.assignments)}

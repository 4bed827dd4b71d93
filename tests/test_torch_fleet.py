"""The port's fleet scheduler (``repro_torch.sched``) against the JAX
package's (``repro.sched``), on the CPU.

* ``Fleet``: the reference's cases (over-commit refused before a state
  change, multi-node, down and drained nodes, whole displacement,
  shrink then restore, holes and fragmentation) and random operation
  sequences run on both packages' fleets: the same results, the same
  refusals at the same steps, equal snapshots after every step.
* ``FleetScheduler`` over a framework-free stub service, one per
  package: the placement policy, the chaos matrix, straggler migration
  and a chaos replay of a few hundred arrivals with five fleet events;
  outcomes (timing fields removed), snapshots, ``stats()``, records and
  summaries equal.
* The port's scheduler over the port's own ``AdmissionService``: the
  fleet charges each decision's safe threshold (a degraded one its
  widened threshold), a plan-carrying arrival is backfilled with the
  planner's first offer that fits a hole, and a plan-carrying displaced
  job is re-placed through ``shrink_and_replan`` (the reference's
  ``test_displaced_plan_job_replans_through_elastic``).
* Elastic re-placement over a stub service per package whose estimate
  of a request is computed from its trees and its own shard factors: a
  job backfilled on a topology offer, then displaced, lands on the same
  re-carved mesh, nodes and charges in both packages; an unexpected
  error of the port's elastic path propagates.
"""
import contextlib
import dataclasses
import math
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.events as jevents
import repro.core.sweep as jsweep
import repro.distributed.sharding as jsharding
import repro.plan as jplan
import repro.sched as jsched
import repro.service as jservice
import repro_torch.core.events as tevents
import repro_torch.core.sweep as tsweep
import repro_torch.distributed.sharding as tsharding
import repro_torch.plan as tplan
import repro_torch.sched as tsched
import repro_torch.service as tservice
import torch_service_jobs as jobs
from repro_torch.configs import get_smoke
from repro_torch.configs.base import smoke_shape
from repro_torch.configs.registry import input_specs
from repro_torch.core.cache import TraceCache
from repro_torch.models import model as TM
from repro_torch.plan import PlanContext, PlanSpace
from repro_torch.service import plan_raising_at
from repro_torch.train import TrainPolicy, make_estimator_hooks

PKGS = {"jax": (jsched, jservice), "torch": (tsched, tservice)}
VIOLATIONS = (jservice.ChaosSafetyViolation, tservice.ChaosSafetyViolation)
# stub safe thresholds of a job at batch 8 and at batch 16
T8, T16 = 1000, 1800
# the timing fields, which differ run to run
WALL = ("wall_s", "arrivals_per_s", "evacuation_latency_s",
        "evacuation_latency_max_s", "mean_runtime_s")


def _untimed(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in WALL}


def _result(r):
    """An operation's result, comparable across the packages."""
    if isinstance(r, list):
        return [_result(x) for x in r]
    if isinstance(r, tuple):
        return tuple(_result(x) for x in r)
    if hasattr(r, "job_id") and hasattr(r, "shares"):
        return ("assignment", r.job_id, dict(r.shares))
    return r


# -- Fleet ---------------------------------------------------------------------
def _run_fleet(pkg: str, ops, caps=(1000, 1000, 1000)):
    """Apply ``ops`` (method name, *args; ``place`` takes a job id and
    its shares) to a fresh fleet of ``pkg``; each step's result (a
    refusal as its exception's name) and the snapshot after it."""
    sched, _ = PKGS[pkg]
    fleet = sched.Fleet([sched.Node(f"n{i}", capacity=c, domain=f"d{i % 2}")
                         for i, c in enumerate(caps)])
    log = []
    for op, *args in ops:
        try:
            if op == "place":
                job_id, shares = args
                r = fleet.place(sched.Assignment(job_id, dict(shares)))
            else:
                r = getattr(fleet, op)(*args)
        except VIOLATIONS:
            r = "ChaosSafetyViolation"
        log.append((op, _result(r), fleet.snapshot()))
    return log


def _value(log, op, *nth):
    """The result of the ``nth`` (default last) step named ``op``."""
    got = [r for o, r, _ in log if o == op]
    return got[nth[0] if nth else -1]


FLEET_CASES = {
    "overcommit_refused_before_state_change": (
        [("place", "j1", {"n0": 700}), ("place", "j2", {"n0": 400}),
         ("committed", "n0"), ("place", "j3", {"n0": 300}),
         ("headroom", "n0")],
        lambda log: (_value(log, "place", 1) == "ChaosSafetyViolation"
                     and "j2" not in log[2][2]["nodes"]["n0"]["residents"]
                     and _value(log, "committed") == 700
                     and _value(log, "headroom") == 0)),
    "multinode_overcommit_refused_whole": (
        [("place", "big", {"n1": 900}),
         ("place", "mesh", {"n0": 500, "n1": 500}), ("committed", "n0")],
        lambda log: (_value(log, "place") == "ChaosSafetyViolation"
                     and _value(log, "committed") == 0)),
    "place_on_down_or_drained_node_refused": (
        [("fail", "n0"), ("place", "j", {"n0": 10}), ("restore", "n0"),
         ("drain", "n1"), ("place", "j", {"n1": 10}), ("holes",),
         ("is_up", "n1")],
        lambda log: (_value(log, "place", 0) == "ChaosSafetyViolation"
                     and _value(log, "place", 1) == "ChaosSafetyViolation"
                     and "n1" not in [n for n, _ in _value(log, "holes")]
                     and _value(log, "is_up") is False)),
    "fail_displaces_multidevice_assignment_whole": (
        [("place", "mesh", {"n0": 400, "n1": 400}),
         ("place", "solo", {"n1": 300}), ("fail", "n0"),
         ("committed", "n1"), ("check_invariant",)],
        lambda log: ([a[1] for a in _value(log, "fail")] == ["mesh"]
                     and _value(log, "committed") == 300)),
    "shrink_evicts_largest_until_fit_then_restore": (
        [("place", "small", {"n0": 200}), ("place", "large", {"n0": 600}),
         ("shrink", "n0", 0.5), ("capacity_of", "n0"), ("committed", "n0"),
         ("check_invariant",), ("restore", "n0"), ("capacity_of", "n0")],
        lambda log: ([a[1] for a in _value(log, "shrink")] == ["large"]
                     and _value(log, "capacity_of", 0) == 500
                     and _value(log, "committed") == 200
                     and _value(log, "capacity_of", 1) == 1000)),
    "fragmentation_and_holes": (
        [("fragmentation",), ("place", "j1", {"n0": 900}),
         ("place", "j2", {"n1": 500}), ("holes",), ("holes", None, True),
         ("fragmentation",), ("utilization",)],
        lambda log: (_value(log, "fragmentation", 0)
                     == pytest.approx(1 - 1 / 3)
                     and _value(log, "holes", 0)[0] == ("n2", 1000)
                     and ("n0", 100) in _value(log, "holes", 0)
                     and _value(log, "holes", 1) == [("n2", 1000)]
                     and _value(log, "fragmentation", 1)
                     == pytest.approx(1 - 1000 / 1600))),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_cases_match_the_reference(case):
    ops, holds = FLEET_CASES[case]
    ref, port = _run_fleet("jax", ops), _run_fleet("torch", ops)
    assert port == ref
    assert holds(port)


def test_node_capacity_is_required():
    with pytest.raises(TypeError):
        tsched.Node("n0")
    with pytest.raises(TypeError):
        tsched.build_fleet(2)


def _random_ops(ops):
    """The reference's random-operation tape as fleet operations."""
    out = []
    for k, (op, size, which) in enumerate(ops):
        nid = f"n{which}"
        out.append([("place", f"j{k}", {nid: size}), ("remove_oldest",),
                    ("fail", nid), ("restore", nid),
                    ("shrink", nid, (size % 100) / 100.0)][op])
    return out


def _run_random(pkg: str, ops):
    sched, _ = PKGS[pkg]
    fleet = sched.Fleet([sched.Node(f"n{i}", capacity=1000,
                                    domain=f"d{i % 2}") for i in range(4)])
    log = []
    for op, *args in _random_ops(ops):
        try:
            if op == "place":
                r = fleet.place(sched.Assignment(args[0], dict(args[1])))
            elif op == "remove_oldest":
                r = (fleet.remove(sorted(fleet.assignments)[0])
                     if fleet.assignments else None)
            elif op == "shrink" and not fleet.is_up(args[0]):
                r = None
            else:
                r = getattr(fleet, op)(*args)
        except VIOLATIONS:
            r = "ChaosSafetyViolation"
        # the invariant, recomputed from the raw state
        for n in fleet.nodes:
            total = sum(a.shares[n] for a in fleet.assignments.values()
                        if n in a.shares)
            assert total <= fleet.capacity_of(n)
            assert fleet.state(n) == "up" or total == 0
        log.append((op, _result(r), fleet.snapshot()))
    return log


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(1, 650),
                          st.integers(0, 3)), min_size=1, max_size=40))
def test_random_operations_match_the_reference(ops):
    assert _run_random("torch", ops) == _run_random("jax", ops)


# -- the scheduler over a stub service -----------------------------------------
@dataclasses.dataclass
class _Offer:
    """A counter-offer as the scheduler reads one."""

    knob: str
    global_batch: int
    safe_threshold: int
    topology: object = None
    n_devices: int = 1

    def to_json(self) -> dict:
        return {"knob": self.knob, "global_batch": self.global_batch,
                "safe_threshold": self.safe_threshold}


class _Stub:
    """``decide`` answers a scripted safe threshold per job at once, in
    the package's own ``AdmissionDecision``; a job that carries a plan
    gets its scripted offers that fit the capacity it was decided at."""

    def __init__(self, service, peaks, offers=None):
        self.service = service
        self.peaks = peaks
        self.offers = offers or {}

    def decide(self, req):
        peak = self.peaks[req.job_id]
        offers = None
        if "plan" in req.meta:
            offers = [o for o in self.offers.get(req.job_id, ())
                      if o.safe_threshold <= req.capacity]
        return self.service.AdmissionDecision(
            job_id=req.job_id, admit=peak <= req.capacity,
            capacity=req.capacity, peak_bytes=peak, peak_tensor_bytes=peak,
            persistent_bytes=0, safe_threshold=peak, breakdown={},
            provenance={"source": "stub"}, wall_s=0.0,
            counter_offers=offers)

    def inject_faults(self, plan):
        return contextlib.nullcontext()


def _pkg(name: str, peaks: dict, offers=None):
    """One package's scheduler pieces over a stub service."""
    sched, service = PKGS[name]
    stub = _Stub(service, peaks, offers)

    def arrival(job_id, **kw):
        return service.JobArrival(job_id, None, None, None, **kw)

    return types.SimpleNamespace(
        sched=sched, service=service, stub=stub, arrival=arrival,
        scheduler=lambda fleet, **kw: sched.FleetScheduler(stub, fleet, **kw))


def _outcome(out) -> dict:
    return _untimed(out.to_json())


def _both(case, peaks, offers=None):
    """Run ``case(pkg)`` for both packages; its observations must be
    equal, and the reference's assertions inside it hold for both."""
    got = {name: case(_pkg(name, peaks, offers)) for name in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _colocation(P):
    fleet = P.sched.Fleet([P.sched.Node("n0", int(2.5 * T8)),
                           P.sched.Node("n1", int(2.5 * T8))])
    s = P.scheduler(fleet)
    outs = [s.place(P.arrival(f"j{i}")) for i in range(4)]
    assert all(o.placed for o in outs)
    assert sorted(len(fleet.residents(n)) for n in fleet.nodes) == [2, 2]
    for n in fleet.nodes:
        assert fleet.committed(n) == 2 * T8 <= fleet.capacity_of(n)
    assert s.counters["colocated"] >= 2
    fifth = s.place(P.arrival("j5"))
    assert not fifth.placed
    return ([_outcome(o) for o in (*outs, fifth)], fleet.snapshot(),
            s.stats())


def _exclusive(P):
    fleet = P.sched.Fleet([P.sched.Node(f"n{i}", int(2.5 * T8))
                           for i in range(3)])
    s = P.scheduler(fleet, colocate=False)
    outs = [s.place(P.arrival(f"j{i}")) for i in range(4)]
    assert [o.placed for o in outs] == [True, True, True, False]
    assert all(len(fleet.residents(n)) == 1 for n in fleet.nodes)
    assert outs[3].kind == "lost" and s.counters["lost"] == 1
    return [_outcome(o) for o in outs], fleet.snapshot(), s.stats()


def _family_spread(P):
    fleet = P.sched.Fleet([P.sched.Node("a0", int(1.2 * T8), domain="rackA"),
                           P.sched.Node("a1", int(1.2 * T8), domain="rackA"),
                           P.sched.Node("b0", int(1.2 * T8), domain="rackB")])
    s = P.scheduler(fleet)
    o1 = s.place(P.arrival("j1", family="llm"))
    o2 = s.place(P.arrival("j2", family="llm"))
    assert (fleet.nodes[o1.node_ids[0]].domain
            != fleet.nodes[o2.node_ids[0]].domain)
    return [_outcome(o) for o in (o1, o2)], fleet.snapshot(), s.stats()


def _preemption(P):
    fleet = P.sched.Fleet([P.sched.Node("n0", int(2.2 * T8))])
    s = P.scheduler(fleet)
    s.place(P.arrival("j1", priority=0))
    s.place(P.arrival("j2", priority=0))
    out = s.place(P.arrival("j3", priority=2))
    assert out.placed and out.kind == "preempt"
    assert len(out.preempted) + len(out.preempted_lost) == 1
    assert out.preempted_lost and s.counters["preempted_lost"] == 1
    fleet.check_invariant()
    return _outcome(out), fleet.snapshot(), s.stats()


def _no_cascade(P):
    fleet = P.sched.Fleet([P.sched.Node("n0", int(1.2 * T8)),
                           P.sched.Node("n1", int(1.2 * T8))])
    s = P.scheduler(fleet)
    s.place(P.arrival("j1", priority=1))
    s.place(P.arrival("j2", priority=0))
    out = s.place(P.arrival("j3", priority=2))
    assert out.placed and out.kind == "preempt" and out.preempted_lost
    assert sorted(fleet.assignments) == ["j2", "j3"]
    return _outcome(out), fleet.snapshot(), s.stats()


def _backfill(P):
    fleet = P.sched.Fleet([P.sched.Node("n0", int(1.5 * T8))])
    s = P.scheduler(fleet)
    out = s.place(P.arrival("big", plan=object()))
    assert out.placed and out.kind == "backfill"
    assert out.offer.global_batch == 8
    a = fleet.assignments["big"]
    assert a.source == "counter-offer"
    assert a.total_bytes == out.offer.safe_threshold <= fleet.capacity_of("n0")
    assert s.counters["backfills"] == 1
    return _outcome(out), fleet.snapshot(), s.stats()


def _backfill_disabled(P):
    s = P.scheduler(P.sched.Fleet([P.sched.Node("n0", int(1.5 * T8))]),
                    backfill=False)
    out = s.place(P.arrival("big", plan=object()))
    assert not out.placed and out.kind == "lost"
    assert out.decision.counter_offers is None
    return _outcome(out), s.stats()


def _stragglers(P):
    fleet = P.sched.Fleet([P.sched.Node(f"n{i}", int(2.5 * T8))
                           for i in range(4)])
    s = P.scheduler(fleet)
    s.place(P.arrival("j1"))
    s.place(P.arrival("j2"))
    slow = sorted({n for a in fleet.assignments.values()
                   for n in a.shares})[0]
    for _ in range(8):
        for nid in fleet.node_ids():
            s.note_step_time(nid, 5.0 if nid == slow else 1.0)
    assert s.straggler_nodes() == [slow]
    (evac,) = s.migrate_stragglers()
    assert evac.event == "straggler" and evac.node_id == slow
    assert set(evac.displaced) == set(evac.replaced) | set(evac.lost)
    assert fleet.is_up(slow) and s.straggler_nodes() == []
    for jid in evac.replaced:
        assert slow not in fleet.assignments[jid].shares
    return _untimed(evac.to_json()), fleet.snapshot(), s.stats()


POLICY_CASES = {"colocation_charges_thresholds": _colocation,
                "exclusive_baseline": _exclusive,
                "family_spreads_across_domains": _family_spread,
                "priority_preemption": _preemption,
                "no_cascade_preemption": _no_cascade,
                "backfill_into_a_hole": _backfill,
                "backfill_disabled_loses_the_job": _backfill_disabled,
                "straggler_migration": _stragglers}


class _AnyPeak(dict):
    """Every job is batch 8 unless named otherwise."""

    def __missing__(self, key):
        return T8


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_placement_policy_matches_the_reference(case):
    offers = {"big": [_Offer("batch", 8, T8), _Offer("batch", 4, T8 // 2)]}
    _both(POLICY_CASES[case], _AnyPeak(big=3 * T8), offers)


def _tableau(P):
    """Three nodes, one per placement kind: ``colo`` hosts two
    co-located jobs, ``excl`` one exclusive job, ``pre`` a job placed by
    a real preemption (with its lost victim)."""
    fleet = P.sched.Fleet([P.sched.Node("colo", int(2.2 * T8), domain="r0"),
                           P.sched.Node("excl", int(1.1 * T16), domain="r1"),
                           P.sched.Node("pre", int(2.2 * T8), domain="r2")])
    s = P.scheduler(fleet)
    for jid, node, share, prio in (("c1", "colo", T8, 5),
                                   ("c2", "colo", T8, 5),
                                   ("x1", "excl", T16, 5),
                                   ("p0", "pre", T8, 0),
                                   ("p1", "pre", T8, 0)):
        fleet.place(P.sched.Assignment(
            jid, {node: share}, priority=prio,
            arrival=P.arrival(jid, priority=prio)))
    out = s.place(P.arrival("hp", priority=1))
    assert out.kind == "preempt" and "hp" in fleet.assignments
    assert fleet.assignments["hp"].shares.keys() == {"pre"}
    return s, fleet


@pytest.mark.parametrize("event", ["node.fail", "node.flap", "node.shrink"])
@pytest.mark.parametrize("target", ["colo", "excl", "pre"])
def test_chaos_matrix_matches_the_reference(event, target):
    def case(P):
        s, fleet = _tableau(P)
        before = set(fleet.assignments)
        evac = s.evacuate_node(target, event, shrink_frac=0.5)
        fleet.check_invariant()
        assert set(evac.displaced) == set(evac.replaced) | set(evac.lost)
        for jid in evac.replaced:
            assert (target not in fleet.assignments[jid].shares
                    or event == "node.shrink")
        assert set(fleet.assignments) \
            == (before - set(evac.displaced)) | set(evac.replaced)
        seen = [_untimed(evac.to_json()), fleet.snapshot(), s.stats()]
        if event == "node.shrink":
            assert fleet.is_up(target)
            assert fleet.capacity_of(target) \
                == int(fleet.nodes[target].capacity * 0.5)
        else:
            assert not fleet.is_up(target)
            fleet.restore(target)
            fleet.check_invariant()
            seen.append(fleet.snapshot())
        return seen

    _both(case, _AnyPeak(x1=T16, hp=T8))


@pytest.mark.parametrize("colocate", [True, False])
def test_simulator_flap_and_unpinned_events_match_the_reference(colocate):
    def case(P):
        fleet = P.sched.Fleet([P.sched.Node(f"n{i}", int(2.5 * T8))
                               for i in range(3)])
        s = P.scheduler(fleet, colocate=colocate)
        arrivals = [P.arrival(f"fl{i}", duration_ticks=20, capacity=T16)
                    for i in range(8)]
        plan = P.service.FaultPlan([
            P.service.fleet_event("node.flap", at=2, node="n0", down_for=3),
            P.service.fleet_event("node.fail", at=5)])
        out = P.sched.FleetSimulator(s).replay(arrivals, faults=plan)
        assert out.summary["violations"] == 0 and out.displaced_accounted
        assert [e.event for e in out.evacuations] == ["node.flap",
                                                      "node.fail"]
        assert fleet.is_up("n0"), "a flapped node returns after down_for"
        return _replay_seen(out)

    _both(case, _AnyPeak())


def _replay_seen(out) -> dict:
    return {"placements": [_outcome(p) for p in out.placements],
            "evacuations": [_untimed(e.to_json()) for e in out.evacuations],
            "records": [{k: v for k, v in dataclasses.asdict(r).items()
                         if k != "runtime_s"} for r in out.records],
            "summary": _untimed(out.summary)}


N_REPLAY = 300
# the reference acceptance replay's five events at 1000 arrivals
# (tests/test_fleet.py), at the same fractions of this trace
CHAOS = (("node.fail", 100, {}), ("node.flap", 300, {"down_for": 50}),
         ("node.shrink", 450, {"shrink_frac": 0.6}), ("node.fail", 600, {}),
         ("node.flap", 800, {"down_for": 40}))


def _replay_peaks():
    # jobs of the sizes batches 8 and 4 would take; one in 31 outgrows
    # every node
    return {f"acc{i}": (4 * T8 if i % 31 == 7 else
                        T8 if i % 2 == 0 else T8 // 2 + i % 5)
            for i in range(N_REPLAY)}


def test_chaos_replay_matches_the_reference():
    node_cap = int(3.2 * T8)

    def run(P, colocate):
        s = P.scheduler(P.sched.build_fleet(10, node_cap),
                        colocate=colocate)
        arrivals = [P.arrival(f"acc{i}", capacity=node_cap,
                              duration_ticks=25,
                              priority=1 if i % 31 == 0 else 0)
                    for i in range(N_REPLAY)]
        plan = P.service.FaultPlan([
            P.service.fleet_event(site, at=at * N_REPLAY // 1000, **kw)
            for site, at, kw in CHAOS])

        def step_time(node, tick):
            # node007 lags through the middle of the trace
            return 5.0 if node == "node007" and 100 <= tick < 200 else 1.0

        return P.sched.FleetSimulator(s).replay(
            arrivals, faults=plan, deadline_s=30.0, step_time_fn=step_time)

    def case(P):
        out, ex = run(P, True), run(P, False)
        assert out.summary["violations"] == 0
        assert len(out.records) == N_REPLAY
        assert out.displaced_accounted
        assert out.summary["evacuations"] >= 5
        assert out.summary["migrations"] > 0
        assert (out.summary["evacuated"] == out.summary["re_placed"]
                + out.summary["lost_after_evacuation"])
        assert out.summary["mcp_gb"] > ex.summary["mcp_gb"]
        assert out.summary["colocated"] > 0
        assert out.summary["lost"] < ex.summary["lost"]
        return _replay_seen(out), _replay_seen(ex)

    _both(case, _replay_peaks())


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 130), min_size=1, max_size=30),
       st.integers(0, 29))
def test_scheduler_sequences_match_the_reference(sizes, evac_at):
    def case(P):
        s = P.scheduler(P.sched.Fleet([
            P.sched.Node(f"n{i}", capacity=100, domain=f"d{i % 2}")
            for i in range(3)]))
        seen = []
        for i, size in enumerate(sizes):
            out = s.place(P.arrival(f"s{i}", capacity=100, priority=i % 3))
            assert not out.placed or size <= 100
            seen.append(_outcome(out))
            if i == evac_at:
                evac = s.evacuate_node("n0", "node.fail")
                assert (set(evac.displaced)
                        == set(evac.replaced) | set(evac.lost))
                s.fleet.restore("n0")
                seen.append(_untimed(evac.to_json()))
            for n in s.fleet.nodes:
                assert s.fleet.committed(n) <= s.fleet.capacity_of(n)
        s.fleet.check_invariant()
        return seen, s.fleet.snapshot(), s.stats()

    _both(case, {f"s{i}": size for i, size in enumerate(sizes)})


# -- the port's scheduler over the port's admission service --------------------
@pytest.fixture(scope="module")
def svc():
    s = tservice.AdmissionService(workers=1, cache=TraceCache())
    yield s
    s.close()


@pytest.fixture(scope="module")
def thr8(svc):
    return svc.decide(jobs.request("thr8", batch=8)).safe_threshold


def test_the_fleet_charges_each_decisions_safe_threshold(svc, thr8):
    fleet = tsched.Fleet([tsched.Node("n0", int(2.5 * thr8)),
                          tsched.Node("n1", int(2.5 * thr8))])
    s = tsched.FleetScheduler(svc, fleet)
    outs = [s.place(jobs.arrival(f"j{i}", batch=8)) for i in range(4)]
    assert all(o.placed and o.decision.rung == "exact" for o in outs)
    for o in outs:
        assert o.assignment.shares == {o.node_ids[0]:
                                       o.decision.safe_threshold}
        assert o.decision.safe_threshold == thr8
    for n in fleet.nodes:
        assert fleet.committed(n) == 2 * thr8 <= fleet.capacity_of(n)
    assert not s.place(jobs.arrival("j5", batch=8)).placed


def test_a_degraded_decision_charges_its_widened_threshold(thr8):
    cold = tservice.AdmissionService(workers=1, cache=TraceCache())
    try:
        fleet = tsched.Fleet([tsched.Node("n0", 4 * thr8)])
        s = tsched.FleetScheduler(cold, fleet)
        with cold.inject_faults(plan_raising_at("tracer")):
            out = s.place(jobs.arrival("hurt", batch=8))
        d = out.decision
        assert out.placed and d.degraded and d.margin > 1.0
        assert d.safe_threshold == math.ceil(d.raw_peak_bytes * d.margin)
        assert fleet.committed("n0") == d.safe_threshold > d.raw_peak_bytes
    finally:
        cold.close()


SPACE_SMALL = PlanSpace(batches=(8, 4), microbatches=(), remat=(),
                        devices=())


def _smoke_arrival(job_id, batch, capacity, plan=True):
    """qwen3-32b's smoke config as a training arrival carrying the
    planner's job description."""
    cfg = dataclasses.replace(get_smoke("qwen3-32b"), remat="none")
    policy = TrainPolicy()
    shape = smoke_shape(32, batch)
    fwd, upd, init = make_estimator_hooks(cfg, policy)
    ctx = PlanContext(cfg, policy, shape, space=SPACE_SMALL) if plan else None
    return tservice.JobArrival(job_id, fwd, TM.abstract_params(cfg),
                               input_specs(cfg, shape), update_fn=upd,
                               opt_init_fn=init, capacity=capacity, plan=ctx)


def test_a_plan_carrying_arrival_is_backfilled_with_the_first_offer_that_fits(
        svc):
    t8 = svc.decide(_smoke_arrival("p8", 8, 1 << 30).request()).peak_bytes
    t32 = svc.decide(_smoke_arrival("p32", 32, 1 << 30).request()).peak_bytes
    assert t8 < t32
    cap = (t8 + t32) // 2
    fleet = tsched.Fleet([tsched.Node("n0", cap)])
    s = tsched.FleetScheduler(svc, fleet)
    out = s.place(_smoke_arrival("bf", 32, cap))
    assert out.placed and out.kind == "backfill"
    offers = out.decision.counter_offers
    first = next(o for o in offers if o.safe_threshold <= cap)
    assert out.offer is first and first.global_batch in (8, 4)
    assert fleet.assignments["bf"].shares == {"n0": first.safe_threshold}
    assert fleet.assignments["bf"].source == "counter-offer"


def test_displaced_plan_job_replans_through_elastic(svc):
    """A displaced job carrying a PlanContext re-enters admission
    through shrink_and_replan: re-carved mesh, spec-driven factors,
    topology recorded on the new assignment."""
    fleet = tsched.Fleet([tsched.Node("n0", 1 << 30),
                          tsched.Node("n1", 1 << 30)])
    s = tsched.FleetScheduler(svc, fleet)
    out = s.place(_smoke_arrival("el", 8, 1 << 30))
    assert out.placed and out.kind == "decide"
    (home,) = out.node_ids
    evac = s.evacuate_node(home, "node.fail")
    assert evac.replaced == ["el"] and not evac.lost
    a = fleet.assignments["el"]
    assert a.source == "evacuation" and a.topology == "1x1x1"
    assert a.mesh == (1, 1, 1) and home not in a.shares
    # charged the re-admission's threshold on the one device left
    d = svc.decide(_smoke_arrival("el2", 8, 1 << 30).request())
    assert list(a.shares.values()) == [d.safe_threshold]
    fleet.check_invariant()
    fleet.restore(home)
    # a job without a plan is re-placed on warm caches, plainly
    plain = s.place(_smoke_arrival("plain", 8, 1 << 30, plan=False))
    evac = s.evacuate_node(plain.node_ids[0], "node.fail")
    assert "plain" in evac.replaced and not evac.lost
    assert fleet.assignments["plain"].topology is None


# -- elastic re-placement over stub estimates, both packages -------------------
ELASTIC = {"jax": (jsched, jservice, jevents, jsharding, jsweep, jplan),
           "torch": (tsched, tservice, tevents, tsharding, tsweep, tplan)}


class _Estimates:
    """A service whose estimate of a request is computed from its own
    trees through the package's own shard factors: every parameter held
    four times (parameter, gradient, two moments) and 64 bytes of
    transient per input byte, each at its per-device factor, plus 1 MiB.
    Rejections that carry a plan get the package's planner's offers, as
    the admission service attaches them; ``raise_on`` raises for a job
    id that ends with it."""

    def __init__(self, pkg: str, raise_on: str | None = None):
        (self.sched, self.service, self.events, self.sharding, self.sweep,
         self.plan) = ELASTIC[pkg]
        self.pkg, self.raise_on = pkg, raise_on
        self.cache = types.SimpleNamespace(
            thread_stats=lambda: {"hits": 0, "misses": 0, "store_hits": 0})
        self.obs = None

    def _leaves(self, tree):
        if self.pkg == "jax":
            import jax
            return jax.tree_util.tree_leaves(tree)
        from torch.utils import _pytree as pytree
        return [x for x in pytree.tree_leaves(tree) if x is not None]

    def _bytes(self, tree, kind, factor, per_byte):
        BL, BK = self.events.BlockLifecycle, self.events.BlockKind
        total = 0
        for leaf in self._leaves(tree):
            shape = tuple(int(d) for d in leaf.shape)
            n = math.prod(shape) * leaf.dtype.itemsize
            f = factor(BL(0, n, 0, None, block_kind=getattr(BK, kind),
                          shape=shape)) if factor else 1.0
            total += int(n * per_byte / max(f, 1.0))
        return total

    def peak(self, params, batch, factor=None):
        return (self._bytes(params, "PARAM", factor, 4)
                + self._bytes(batch, "INPUT", factor, 64) + (1 << 20))

    def decide(self, req):
        if self.raise_on and req.job_id.endswith(self.raise_on):
            raise RuntimeError(f"unexpected: {req.job_id}")
        p = self.peak(req.params, req.batch, req.shard_factor_fn)
        d = self.service.AdmissionDecision(
            job_id=req.job_id, admit=p <= req.capacity,
            capacity=req.capacity, peak_bytes=p, peak_tensor_bytes=p,
            persistent_bytes=0, safe_threshold=p, breakdown={},
            provenance={"source": "stub", "sweep": {}}, wall_s=0.0)
        ctx = req.meta.get("plan") if req.meta else None
        if ctx is not None and not d.admit:
            d.counter_offers = self.plan.RemediationPlanner(self).plan(
                ctx.cfg, ctx.policy, ctx.shape, capacity=req.capacity,
                space=ctx.space, job_id=req.job_id, baseline=d).offers
        return d

    def decide_sweep(self, reqs):
        return [self.decide(r) for r in reqs]

    def mesh_sweep(self, fwd, params, batch, topologies, *, cfg=None,
                   capacity=None, **kw):
        reports = []
        for t in topologies:
            f = self.sharding.shard_factor_fn(
                cfg, t.axis_sizes, t.sharding_policy(), params=params,
                batch=batch)
            p = self.peak(params, batch, f)
            reports.append(types.SimpleNamespace(
                peak_bytes=p, peak_tensor_bytes=p, persistent_bytes=0,
                oom=capacity is not None and p > capacity, breakdown={}))
        return self.sweep.MeshSweepResult(list(topologies), reports, {})

    def inject_faults(self, plan):
        return contextlib.nullcontext()


def _elastic_arrival(pkg: str, job_id: str, capacity: int):
    sched, service, *_ = ELASTIC[pkg]
    if pkg == "jax":
        from repro.configs import get_smoke as get
        from repro.configs.base import smoke_shape as shape_of
        from repro.configs.registry import input_specs as specs
        from repro.models import model as M
        from repro.train import TrainPolicy as Policy
        from repro.train import make_estimator_hooks as hooks
        space = jplan.PlanSpace(devices=(2, 4), batches=(),
                                microbatches=(), remat=())
    else:
        get, shape_of, specs, M = (get_smoke, smoke_shape, input_specs, TM)
        Policy, hooks = TrainPolicy, make_estimator_hooks
        space = tplan.PlanSpace(devices=(2, 4), batches=(),
                                microbatches=(), remat=())
    cfg = dataclasses.replace(get("qwen3-32b"), remat="none")
    policy, shape = Policy(), shape_of(32, 64)
    fwd, upd, init = hooks(cfg, policy)
    ctx = ELASTIC[pkg][5].PlanContext(cfg, policy, shape, space=space)
    return service.JobArrival(job_id, fwd, M.abstract_params(cfg),
                              specs(cfg, shape), update_fn=upd,
                              opt_init_fn=init, capacity=capacity,
                              plan=ctx)


def _elastic_case(pkg: str):
    sched = ELASTIC[pkg][0]
    stub = _Estimates(pkg)
    one = _elastic_arrival(pkg, "probe", 1 << 40)
    single = stub.decide(one.request()).peak_bytes
    cap = single * 9 // 10
    fleet = sched.Fleet([sched.Node(f"n{i}", cap, domain=f"d{i % 2}")
                         for i in range(4)])
    s = sched.FleetScheduler(stub, fleet)
    out = s.place(_elastic_arrival(pkg, "mesh", cap))
    assert out.placed and out.kind == "backfill"
    assert out.offer.knob == "topology" and out.offer.n_devices > 1
    a = fleet.assignments["mesh"]
    home = sorted(a.shares)[0]
    evac = s.evacuate_node(home, "node.fail")
    assert evac.replaced == ["mesh"] and not evac.lost
    b = fleet.assignments["mesh"]
    assert b.source == "evacuation" and home not in b.shares
    assert b.topology is not None and b.mesh is not None
    fleet.check_invariant()
    return (out.offer.topology.label, a.mesh, dict(a.shares),
            _outcome(evac), b.topology, b.mesh, dict(b.shares),
            fleet.snapshot(), s.stats())


def test_elastic_replacement_equals_the_reference_on_the_same_estimates():
    got = {pkg: _elastic_case(pkg) for pkg in ELASTIC}
    assert got["torch"] == got["jax"]


def test_an_unexpected_error_of_the_elastic_path_propagates():
    stub = _Estimates("torch")
    single = stub.decide(_elastic_arrival("torch", "probe",
                                          1 << 40).request()).peak_bytes
    cap = single * 9 // 10
    fleet = tsched.Fleet([tsched.Node(f"n{i}", cap) for i in range(4)])
    s = tsched.FleetScheduler(stub, fleet)
    assert s.place(_elastic_arrival("torch", "mesh", cap)).placed
    stub.raise_on = "/shrink/baseline"
    home = sorted(fleet.assignments["mesh"].shares)[0]
    with pytest.raises(RuntimeError, match="unexpected"):
        s.evacuate_node(home, "node.fail")
    # the reference swallows the same error into a plain placement
    jstub = _Estimates("jax")
    jfleet = jsched.Fleet([jsched.Node(f"n{i}", cap) for i in range(4)])
    js = jsched.FleetScheduler(jstub, jfleet)
    assert js.place(_elastic_arrival("jax", "mesh", cap)).placed
    jstub.raise_on = "/shrink/baseline"
    jhome = sorted(jfleet.assignments["mesh"].shares)[0]
    js.evacuate_node(jhome, "node.fail")

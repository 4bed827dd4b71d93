"""Fleet model: heterogeneous nodes, failure domains, and the one
invariant everything else defends (port of ``repro.sched.fleet``).

A :class:`Fleet` is a set of :class:`Node`\\ s — each with an HBM
capacity, a device class, and a failure domain — plus the set of live
:class:`Assignment`\\ s. An assignment charges each node it touches the
job's per-device **safe threshold** (Eq. 5: the estimate validated as a
max-runnable-memory cap — for degraded decisions that is the
margin-widened value), never the raw peak. The co-location invariant

    sum(co-resident safe thresholds on node n) <= capacity(n)

is enforced at **every** mutation: ``place`` refuses an over-commit
with :class:`~repro_torch.service.faults.ChaosSafetyViolation` before any
state changes, and ``check_invariant`` re-verifies the whole fleet
after each fail / shrink / restore, so no scheduler bug — initial
placement, backfill, preemption, or post-evacuation re-placement — can
ever leave a device over-committed.

Failure semantics: ``fail`` takes a node down and returns every
displaced assignment (a multi-device assignment is displaced whole —
a job cannot run on half its mesh); ``shrink`` reduces a node's
*effective* capacity in place (partial HBM loss / MIG re-slice) and
evicts largest-share residents until the survivors fit; ``drain``
keeps the node up but unplaceable (straggler migration); ``restore``
brings a down/drained node back at its nominal capacity.

Delta from the reference: a :class:`Node` has no default capacity (the
reference's is a TPU's HBM); every node states its own, in bytes.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable

from ..service.faults import ChaosSafetyViolation

NODE_UP = "up"
NODE_DOWN = "down"
NODE_DRAINED = "drained"


@dataclasses.dataclass(frozen=True)
class Node:
    """One schedulable device (a GPU host's card)."""

    node_id: str
    capacity: int                   # nominal device-memory bytes
    device: str = "sim"             # device class (jobs match on this)
    domain: str = "rack0"           # failure domain (spread target)


@dataclasses.dataclass
class Assignment:
    """One placed job: which nodes it occupies and what each is charged.

    ``shares`` maps node_id -> charged bytes; single-device jobs have
    one entry, mesh jobs one per device, each charged the per-device
    safe threshold. ``mesh`` keeps the (pod, data, model) carve so an
    evacuation can re-enter ``train.elastic.shrink_and_replan`` from
    the placement that just died."""

    job_id: str
    shares: dict
    priority: int = 0
    family: str = "workload"
    source: str = "decide"          # decide|counter-offer|evacuation|...
    topology: str | None = None     # mesh label for multi-device jobs
    mesh: tuple | None = None       # (pod, data, model) of the placement
    placed_tick: int = 0
    truth_bytes: int | None = None  # oracle peak (whole job, as placed)
    arrival: Any = None             # originating JobArrival (re-placement)
    ctx: Any = None                 # PlanContext (elastic re-planning)

    @property
    def total_bytes(self) -> int:
        return sum(self.shares.values())

    @property
    def n_devices(self) -> int:
        return len(self.shares)


class Fleet:
    """Thread-safe fleet state; see module docstring for the invariant."""

    def __init__(self, nodes: Iterable[Node]):
        nodes = list(nodes)
        ids = [n.node_id for n in nodes]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate node ids in {ids}")
        if not nodes:
            raise ValueError("a fleet needs at least one node")
        self.nodes: dict[str, Node] = {n.node_id: n for n in nodes}
        self._capacity = {n.node_id: int(n.capacity) for n in nodes}
        self._state = {n.node_id: NODE_UP for n in nodes}
        self.assignments: dict[str, Assignment] = {}
        self._resident: dict[str, set] = {n.node_id: set() for n in nodes}
        self._lock = threading.RLock()

    # -- queries -------------------------------------------------------------
    def node_ids(self) -> list[str]:
        return list(self.nodes)

    def state(self, node_id: str) -> str:
        return self._state[node_id]

    def is_up(self, node_id: str) -> bool:
        return self._state[node_id] == NODE_UP

    def up_nodes(self, device: str | None = None) -> list[str]:
        """Placeable nodes, optionally restricted to a device class."""
        with self._lock:
            return [nid for nid, n in self.nodes.items()
                    if self._state[nid] == NODE_UP
                    and (device is None or n.device == device)]

    def capacity_of(self, node_id: str) -> int:
        """Effective capacity (post-shrink), not the nominal one."""
        return self._capacity[node_id]

    def committed(self, node_id: str) -> int:
        with self._lock:
            return sum(self.assignments[j].shares[node_id]
                       for j in self._resident[node_id])

    def headroom(self, node_id: str) -> int:
        with self._lock:
            return self._capacity[node_id] - self.committed(node_id)

    def residents(self, node_id: str) -> list[Assignment]:
        with self._lock:
            return [self.assignments[j]
                    for j in sorted(self._resident[node_id])]

    def holes(self, device: str | None = None,
              empty_only: bool = False) -> list[tuple[str, int]]:
        """(node_id, headroom) of placeable nodes, largest hole first.
        ``empty_only`` restricts to nodes with no residents — the
        no-co-location baseline's placement rule."""
        with self._lock:
            out = []
            for nid in self.up_nodes(device):
                if empty_only and self._resident[nid]:
                    continue
                h = self.headroom(nid)
                if h > 0:
                    out.append((nid, h))
            out.sort(key=lambda p: (-p[1], p[0]))
            return out

    def fragmentation(self, device: str | None = None) -> float:
        """1 - largest free hole / total free bytes over up nodes: 0.0
        when all free memory is one contiguous (single-node) hole, ->1
        as the same total shatters across many small holes."""
        with self._lock:
            free = [self.headroom(nid) for nid in self.up_nodes(device)]
            free = [f for f in free if f > 0]
            total = sum(free)
            if total <= 0:
                return 0.0
            return 1.0 - max(free) / total

    def utilization(self) -> float:
        with self._lock:
            cap = sum(self._capacity[nid] for nid in self.up_nodes())
            if cap <= 0:
                return 0.0
            used = sum(self.committed(nid) for nid in self.up_nodes())
            return used / cap

    # -- mutation (every path defends the invariant) -------------------------
    def place(self, a: Assignment) -> None:
        """Commit an assignment. Raises :class:`ChaosSafetyViolation`
        (before any state changes) if any touched node would be
        over-committed, down, or drained — the scheduler-bug backstop
        behind every placement path."""
        with self._lock:
            if a.job_id in self.assignments:
                raise ValueError(f"job {a.job_id!r} is already placed")
            if not a.shares:
                raise ValueError("assignment with no shares")
            for nid, share in a.shares.items():
                if nid not in self.nodes:
                    raise KeyError(f"unknown node {nid!r}")
                if self._state[nid] != NODE_UP:
                    raise ChaosSafetyViolation(
                        f"placement of {a.job_id!r} on "
                        f"{self._state[nid]} node {nid!r}")
                if share < 0:
                    raise ValueError("negative share")
                if self.committed(nid) + share > self._capacity[nid]:
                    raise ChaosSafetyViolation(
                        f"placing {a.job_id!r} would commit "
                        f"{self.committed(nid) + share} > capacity "
                        f"{self._capacity[nid]} on node {nid!r}")
            self.assignments[a.job_id] = a
            for nid in a.shares:
                self._resident[nid].add(a.job_id)
            self.check_invariant()

    def remove(self, job_id: str) -> Assignment | None:
        with self._lock:
            a = self.assignments.pop(job_id, None)
            if a is not None:
                for nid in a.shares:
                    self._resident[nid].discard(job_id)
            return a

    def fail(self, node_id: str) -> list[Assignment]:
        """Node loss: mark down, displace every assignment touching it
        (multi-device assignments are displaced whole)."""
        with self._lock:
            self._state[node_id] = NODE_DOWN
            displaced = [self.remove(j)
                         for j in sorted(self._resident[node_id])]
            self.check_invariant()
            return [a for a in displaced if a is not None]

    def drain(self, node_id: str) -> list[Assignment]:
        """Straggler migration: keep the node up but unplaceable and
        displace its residents so the scheduler can move them."""
        with self._lock:
            self._state[node_id] = NODE_DRAINED
            displaced = [self.remove(j)
                         for j in sorted(self._resident[node_id])]
            self.check_invariant()
            return [a for a in displaced if a is not None]

    def shrink(self, node_id: str, frac: float) -> list[Assignment]:
        """Partial capacity loss: effective capacity *= ``frac``; evict
        largest-share residents until the survivors fit (each eviction
        displaces the whole assignment). The invariant holds on exit."""
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"shrink_frac must be in [0, 1], got {frac}")
        with self._lock:
            self._capacity[node_id] = int(self._capacity[node_id] * frac)
            displaced = []
            while (self._resident[node_id]
                   and self.committed(node_id) > self._capacity[node_id]):
                victim = max(self._resident[node_id],
                             key=lambda j: (
                                 self.assignments[j].shares[node_id], j))
                displaced.append(self.remove(victim))
            self.check_invariant()
            return displaced

    def restore(self, node_id: str) -> None:
        """Bring a down/drained node back at its nominal capacity."""
        with self._lock:
            self._state[node_id] = NODE_UP
            self._capacity[node_id] = int(self.nodes[node_id].capacity)
            self.check_invariant()

    def check_invariant(self) -> None:
        """Full-fleet verification: no node over-committed, no resident
        on a non-up node. Raises :class:`ChaosSafetyViolation`."""
        with self._lock:
            for nid in self.nodes:
                committed = self.committed(nid)
                if committed > self._capacity[nid]:
                    raise ChaosSafetyViolation(
                        f"node {nid!r} over-committed: {committed} > "
                        f"{self._capacity[nid]}")
                if self._state[nid] != NODE_UP and self._resident[nid]:
                    raise ChaosSafetyViolation(
                        f"{self._state[nid]} node {nid!r} still hosts "
                        f"{sorted(self._resident[nid])}")

    def snapshot(self) -> dict:
        """JSON-safe fleet state (daemon ``place``/``evacuate`` kinds)."""
        with self._lock:
            return {
                "nodes": {nid: {
                    "state": self._state[nid],
                    "capacity": self._capacity[nid],
                    "nominal_capacity": self.nodes[nid].capacity,
                    "device": self.nodes[nid].device,
                    "domain": self.nodes[nid].domain,
                    "committed": self.committed(nid),
                    "residents": sorted(self._resident[nid]),
                } for nid in self.nodes},
                "jobs": len(self.assignments),
                "fragmentation": self.fragmentation(),
                "utilization": self.utilization(),
            }

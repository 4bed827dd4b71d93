"""Elastic re-carving and straggler detection (port of
``repro.train.elastic``).

Elasticity model: the mesh is re-carved along the ``data``/``pod`` axes
when nodes join or leave (``replan_mesh``), keeping the model axis, and
the global batch is preserved by resizing each replica's share
(``reshard_batch_size``). ``shrink_and_replan`` (``ElasticReplan``)
re-admits the job on the re-carved mesh with spec-driven per-device
shard factors and, when the old plan no longer fits, applies the
remediation planner's best counter-offer on that mesh; the fleet
scheduler re-places a displaced job that carries a plan through it.

Deterministic shard assignment means any spare worker can recompute a
slow worker's shard; ``StragglerMonitor`` is the detection half: each
worker's recent step times, and a MAD-based outlier rule over the
workers' medians that names the shards to reassign.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A target device layout (axis sizes)."""

    pod: int
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.pod * self.data * self.model


def replan_mesh(current: MeshPlan, available_devices: int,
                min_model: int = 1) -> MeshPlan:
    """Re-carve the mesh after a membership change.

    Keeps the model axis (tensor parallelism needs a stable weight
    sharding) and folds the loss into data/pod parallelism: losing nodes
    costs throughput, not correctness.
    """
    model = max(current.model, min_model)
    if available_devices < model:
        raise ValueError(
            f"cannot keep model axis {model} with only "
            f"{available_devices} devices")
    replicas = available_devices // model
    # prefer keeping pods balanced: largest pod count that divides
    pod = math.gcd(current.pod, replicas) or 1
    data = replicas // pod
    if pod * data < replicas:
        # unreachable while the carve is a gcd (a gcd of replicas always
        # divides it): a floor so a pod choice that is not a divisor
        # falls back to a flat data axis instead of stranding replicas
        pod, data = 1, replicas
    return MeshPlan(pod=pod, data=data, model=model)


def reshard_batch_size(global_batch: int, old: MeshPlan, new: MeshPlan
                       ) -> int:
    """Per-replica batch after re-carving (global batch preserved; if not
    divisible, round up per replica and trim in the data pipeline)."""
    replicas = new.pod * new.data
    return -(-global_batch // replicas)


@dataclasses.dataclass
class ElasticReplan:
    """Outcome of a shrink event: the re-carved mesh, the admission
    decision on it, and, when the old policy no longer fits, the
    planner's counter-offer already applied to (cfg, policy, shape)."""

    plan: MeshPlan                  # the re-carved mesh
    topology: object                # MeshTopology used for admission
    decision: object                # AdmissionDecision on the new mesh
    offer: object | None            # applied CounterOffer (or None)
    cfg: object
    policy: object
    shape: object

    @property
    def admitted(self) -> bool:
        return bool(self.decision.admit or self.offer is not None)


def shrink_and_replan(cfg, policy, shape, current: MeshPlan,
                      available_devices: int, hbm_bytes: int, *,
                      fsdp: bool | None = None, min_model: int = 1,
                      service=None, space=None) -> ElasticReplan:
    """Shrink event -> planner: after ``replan_mesh`` re-carves the
    mesh, re-admit the job on the new topology with spec-driven
    per-device factors instead of assuming the old policy still fits;
    on rejection, search microbatch/batch remediations *on that mesh*
    (``PlanSpace.base_topology``) and apply the best counter-offer.
    Returns the updated (cfg, policy, shape) beside the decision, so the
    training driver can restart from a checkpoint with a plan that fits
    the smaller fleet. fsdp defaults to on above 8e9 parameters, as in
    the JAX package."""
    from ..core.sweep import MeshTopology
    from ..plan import PlanSpace, RemediationPlanner

    new = replan_mesh(current, available_devices, min_model=min_model)
    if fsdp is None:
        fsdp = cfg.param_count() > 8e9
    topo = MeshTopology(pod=new.pod, data=new.data, model=new.model,
                        fsdp=bool(fsdp) and new.pod * new.data > 1)
    space = space or PlanSpace(remat=())
    space = dataclasses.replace(space, base_topology=topo, devices=())
    planner = RemediationPlanner(service)
    res = planner.plan(cfg, policy, shape, capacity=hbm_bytes,
                       space=space, job_id=f"{cfg.name}/shrink")
    offer = None
    cfg2, policy2, shape2 = cfg, policy, shape
    if not res.baseline.admit and res.offers:
        offer = res.offers[0]
        cfg2, policy2, shape2 = offer.apply(cfg, policy, shape)
    return ElasticReplan(plan=new, topology=topo, decision=res.baseline,
                         offer=offer, cfg=cfg2, policy=policy2,
                         shape=shape2)


class StragglerMonitor:
    """Per-worker step-time tracking with MAD outlier detection."""

    def __init__(self, n_workers: int, window: int = 32,
                 threshold: float = 4.0):
        self.n = n_workers
        self.window = window
        self.threshold = threshold
        self._times: list[list[float]] = [[] for _ in range(n_workers)]

    def record(self, worker: int, step_time_s: float) -> None:
        t = self._times[worker]
        t.append(step_time_s)
        if len(t) > self.window:
            t.pop(0)

    def forget(self, worker: int) -> None:
        """Drop a worker's timing history — call when its node fails,
        flaps, or is drained so stale samples neither flag the restored
        node as a straggler nor skew the fleet median while it's gone."""
        self._times[worker] = []

    def stragglers(self) -> list[int]:
        """Workers whose median step time is a MAD outlier vs the fleet."""
        meds = np.array([np.median(t) if t else np.nan for t in self._times])
        valid = meds[~np.isnan(meds)]
        if len(valid) < 3:
            return []
        fleet_med = np.median(valid)
        mad = np.median(np.abs(valid - fleet_med)) + 1e-9
        out = []
        for i, m in enumerate(meds):
            if not np.isnan(m) and (m - fleet_med) / mad > self.threshold:
                out.append(i)
        return out

    def reassignment_plan(self) -> dict[int, int]:
        """{straggler_shard: backup_worker} — deterministic pairing of
        flagged shards to the fastest healthy workers."""
        lag = self.stragglers()
        if not lag:
            return {}
        meds = [(np.median(t) if t else float("inf"), i)
                for i, t in enumerate(self._times)]
        healthy = [i for _, i in sorted(meds) if i not in lag]
        return {s: healthy[k % len(healthy)] for k, s in enumerate(lag)}

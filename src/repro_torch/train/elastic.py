"""Elastic re-carving and straggler detection (port of
``repro.train.elastic``).

Elasticity model: the mesh is re-carved along the ``data``/``pod`` axes
when nodes join or leave (``replan_mesh``), keeping the model axis, and
the global batch is preserved by resizing each replica's share
(``reshard_batch_size``). Both are pure arithmetic, copied. The
reference's ``shrink_and_replan`` (``ElasticReplan``) re-admits the job
on the re-carved mesh with spec-driven per-device shard factors; it
needs the sharding module and the planner's mesh axes, which are not
ported (slice 11c of the port; ``sched/`` is ported, and its
re-placement of a displaced job that carries a plan raises until then).

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

"""Straggler detection (the ``StragglerMonitor`` of
``repro.train.elastic``, copied; the mesh re-carving there waits for the
port's planner).

Deterministic shard assignment means any spare worker can recompute a
slow worker's shard; ``StragglerMonitor`` is the detection half: each
worker's recent step times, and a MAD-based outlier rule over the
workers' medians that names the shards to reassign.
"""
from __future__ import annotations

import numpy as np


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

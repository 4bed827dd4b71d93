"""SchedTune-reproduction: data-driven memory prediction (paper §5.2).

A ridge regression over job features (parameter bytes, batch size, depth,
width, optimizer statefulness, activation proxy) trained on historical
(configuration, measured-peak) pairs. Fast at inference (paper Table 4:
2 s), but exhibits the cold-start problem: configurations outside the
training distribution — new families, unseen batch ranges — degrade
sharply, which drives its Worst-quadrant PEF results (paper Fig. 8) and
the negative Transformer MCP (paper Table 3).

A copy of ``repro.core.baselines.schedtune`` (closed-form ridge in plain
numpy), so both packages fit and predict bit for bit alike.
"""
from __future__ import annotations

import time

import numpy as np

from .common import JobSpec


class SchedTuneEstimator:
    name = "schedtune"

    def __init__(self, l2: float = 1e-3):
        self.l2 = l2
        self.w: np.ndarray | None = None
        self.mu: np.ndarray | None = None
        self.sd: np.ndarray | None = None
        self.last_runtime_s = 0.0

    def fit(self, jobs: list[JobSpec], truths_bytes: list[int]) -> None:
        X = np.array([j.features() for j in jobs], dtype=np.float64)
        y = np.array(truths_bytes, dtype=np.float64) / 1e6  # MB target
        self.mu = X.mean(axis=0)
        self.sd = X.std(axis=0) + 1e-9
        Xn = (X - self.mu) / self.sd
        Xb = np.concatenate([Xn, np.ones((len(Xn), 1))], axis=1)
        A = Xb.T @ Xb + self.l2 * np.eye(Xb.shape[1])
        self.w = np.linalg.solve(A, Xb.T @ y)

    def estimate(self, job: JobSpec) -> int:
        t0 = time.perf_counter()
        if self.w is None:
            # cold start with no history at all: crude parametric guess
            est = (job.param_bytes() * 3 + job.batch_bytes() * 8)
            self.last_runtime_s = time.perf_counter() - t0
            return int(est)
        x = (np.array(job.features()) - self.mu) / self.sd
        xb = np.concatenate([x, [1.0]])
        est_mb = float(xb @ self.w)
        self.last_runtime_s = time.perf_counter() - t0
        return max(int(est_mb * 1e6), 1)

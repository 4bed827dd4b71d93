"""Evaluation metrics and statistical machinery (paper §4.1.4–4.1.5).

Implements the paper's two-round validation protocol and the three
headline metrics, with the notation of Table 1 / Eq. 1–8:

* round 1: does the estimator's OOM prediction (Eq. 1) match reality on a
  device with full capacity? (Eq. 4)
* round 2: rerun with max runnable memory = the *estimate*; success means
  the estimate was directly usable as a safe OOM threshold (Eq. 5).

In the port, "reality" is the card: ``torch.cuda.max_memory_reserved``
of the step run on the GPU (``baselines/directprobe.py``). A copy of
the JAX package's module (numpy only), so both packages score the same
records identically.

Also provides one-way ANOVA (F statistic, between/within decomposition)
in plain numpy and the Monte Carlo record aggregation used by RQ1–RQ4.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class RunRecord:
    """One (configuration j, estimator e, device d) evaluation run."""

    config: str
    family: str            # cnn-analogue / transformer / moe / ssm / ...
    estimator: str
    device: str
    capacity: int          # M_d^max
    estimate: int          # \hat{M}^peak_{jde}
    truth: int             # M^peak_{jid} (oracle)
    runtime_s: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)

    # --- Eq. 1: predicted OOM on full-capacity device ---
    @property
    def oom_pred(self) -> bool:
        return self.estimate > self.capacity

    # --- actual OOM on full-capacity device (round 1) ---
    @property
    def oom_actual(self) -> bool:
        return self.truth > self.capacity

    # --- Eq. 4: round-1 correctness ---
    @property
    def c1(self) -> bool:
        return self.oom_pred == self.oom_actual

    # --- round 2: run again with capacity = estimate (only if c1 and no
    # actual OOM). OOM_{jde2} is true iff the true peak exceeds the
    # estimate-as-capacity. ---
    @property
    def oom_round2(self) -> bool:
        return self.truth > self.estimate

    # --- Eq. 5: overall success ---
    @property
    def c2(self) -> bool:
        if not self.c1:
            return False
        if self.oom_actual:          # correctly predicted an OOM job
            return True
        return not self.oom_round2   # estimate usable as safe threshold

    # --- Eq. 2: relative error (defined only when no real OOM) ---
    @property
    def rel_error(self) -> float | None:
        if self.oom_actual or self.truth == 0:
            return None
        return abs(self.estimate - self.truth) / self.truth

    # --- Eq. 7: memory conserved, with OOM penalty ---
    @property
    def mem_saved(self) -> int:
        if self.c1 and self.oom_actual:
            return self.capacity          # avoided wasting whole device
        if self.c1 and not self.oom_round2:
            return self.capacity - self.estimate
        return -self.capacity             # failure penalty


# ---------------------------------------------------------------------------
def mre(records: Sequence[RunRecord]) -> float | None:
    """Eq. 3 — median relative error over valid runs."""
    errs = [r.rel_error for r in records if r.rel_error is not None]
    return float(np.median(errs)) if errs else None


def pef(records: Sequence[RunRecord]) -> float:
    """Eq. 6 with C_{jde2} — probability of estimation failure."""
    if not records:
        return 0.0
    return 1.0 - sum(r.c2 for r in records) / len(records)


def mcp(records: Sequence[RunRecord]) -> float:
    """Eq. 8 — average memory conserved per run (bytes)."""
    if not records:
        return 0.0
    return float(np.mean([r.mem_saved for r in records]))


def mean_runtime(records: Sequence[RunRecord]) -> float:
    return float(np.mean([r.runtime_s for r in records])) if records else 0.0


def group_by(records: Sequence[RunRecord], key: str) -> dict[str, list[RunRecord]]:
    out: dict[str, list[RunRecord]] = defaultdict(list)
    for r in records:
        out[getattr(r, key, None) or r.meta.get(key, "?")].append(r)
    return dict(out)


def quadrant(records: Sequence[RunRecord], thr: float = 0.20) -> str:
    """Paper Fig. 8 quadrant for one (model, estimator) cell."""
    m, p = mre(records), pef(records)
    if m is None:
        return "n/a"
    lo_m, lo_p = m < thr, p < thr
    return {(True, True): "optimal", (False, True): "overestimation",
            (True, False): "underestimation", (False, False): "worst"}[
        (lo_m, lo_p)]


# ---------------------------------------------------------------------------
def capacity_sweep(min_capacity: int,
                   capacities: Sequence[int]) -> dict[int, bool]:
    """Feasibility verdict per candidate capacity from one
    ``min_feasible_capacity`` value (estimation fast path).

    The PEF/MCP Monte-Carlo protocol probes many device capacities per
    job; replaying ``would_oom`` once per capacity costs O(capacities)
    full allocator replays. A single instrumented replay yields the
    job's minimum feasible capacity, after which every probe is a
    comparison: feasible iff capacity >= min_capacity."""
    return {int(c): int(c) >= min_capacity for c in capacities}


def mem_conserved_at(min_capacity: int, capacity: int,
                     estimate: int) -> int:
    """Eq. 7 analogue computed from a min-capacity verdict: a correctly
    admitted job conserves (capacity - estimate); an infeasible one
    correctly rejected conserves the whole device."""
    if min_capacity > capacity:
        return capacity                 # avoided wasting the device
    return capacity - estimate


# ---------------------------------------------------------------------------
def anova_oneway(groups: Sequence[Sequence[float]]) -> dict:
    """One-way ANOVA: F statistic + df, plain numpy (paper §4.1.4)."""
    groups = [np.asarray(g, dtype=np.float64) for g in groups if len(g)]
    k = len(groups)
    n = sum(len(g) for g in groups)
    if k < 2 or n <= k:
        return {"F": float("nan"), "df_between": 0, "df_within": 0,
                "ss_between": 0.0, "ss_within": 0.0}
    grand = np.concatenate(groups).mean()
    ss_between = sum(len(g) * (g.mean() - grand) ** 2 for g in groups)
    ss_within = sum(((g - g.mean()) ** 2).sum() for g in groups)
    df_b, df_w = k - 1, n - k
    ms_b = ss_between / df_b
    ms_w = ss_within / df_w if df_w else float("nan")
    F = ms_b / ms_w if ms_w else float("inf")
    return {"F": float(F), "df_between": df_b, "df_within": df_w,
            "ss_between": float(ss_between), "ss_within": float(ss_within),
            "eta_sq": float(ss_between / (ss_between + ss_within))
            if (ss_between + ss_within) else 0.0}


def f_critical_approx(df1: int, df2: int, alpha: float = 0.05) -> float:
    """Approximate F critical value (Wilson–Hilferty-based), no scipy."""
    if df1 <= 0 or df2 <= 0:
        return float("nan")
    z = 1.6449 if alpha == 0.05 else 2.3263  # alpha=0.01
    a, b = 2.0 / (9.0 * df1), 2.0 / (9.0 * df2)
    num = (1.0 - b) + z * math.sqrt(b + a - a * b * (z ** 2 / 9.0) ** 0)
    # Paulson approximation:
    h = 2.0 / (1.0 / (2 * df1 - 1) + 1.0 / (2 * df2 - 1))
    lam = (z * z - 3.0) / 6.0
    w = z * math.sqrt(h + lam) / h - (1.0 / (2 * df2 - 1)
                                      - 1.0 / (2 * df1 - 1)) \
        * (lam + 5.0 / 6.0 - 2.0 / (3.0 * h))
    return math.exp(2.0 * w)


# ---------------------------------------------------------------------------
def summarize(records: Sequence[RunRecord]) -> dict:
    """Per-estimator headline table (the paper's abstract-level numbers)."""
    out = {}
    for est, recs in group_by(records, "estimator").items():
        out[est] = {
            "n": len(recs),
            "mre": mre(recs),
            "pef": pef(recs),
            "mcp_gb": mcp(recs) / 1e9,
            "runtime_s": mean_runtime(recs),
        }
    return out


def improvement_vs_best_baseline(records: Sequence[RunRecord],
                                 ours: str = "xmem") -> dict:
    """Headline improvements (paper: 'decreases MRE by 91%, PEF by 75%,
    increases MCP by 368%') computed the same way: ours vs best baseline."""
    s = summarize(records)
    if ours not in s:
        return {}
    base = {k: v for k, v in s.items() if k != ours}
    if not base:
        return {}
    best_mre = min((v["mre"] for v in base.values() if v["mre"] is not None),
                   default=None)
    best_pef = min(v["pef"] for v in base.values())
    best_mcp = max(v["mcp_gb"] for v in base.values())
    o = s[ours]
    return {
        "mre_reduction_pct": (1 - o["mre"] / best_mre) * 100
        if best_mre else None,
        "pef_reduction_pct": (1 - o["pef"] / best_pef) * 100
        if best_pef else None,
        "mcp_increase_pct": (o["mcp_gb"] / best_mcp - 1) * 100
        if best_mcp > 0 else None,
    }

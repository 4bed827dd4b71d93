"""Graceful-degradation ladder for admission decisions (port of
``repro.service.degrade``).

A production admission service must never turn "the estimator broke"
into "no admission decision": SchedTune-style historical predictors
degrade to coarse answers instead of failing, and xMem's service does
the same. The ladder has three rungs, tried in order:

1. **exact** — the normal columnar-replay estimate. Margin 1.0; the
   fault-free path is bit-identical to a direct estimator call.
2. **sweep** — a cached/interpolated point from the
   :class:`DecisionLog`: every successful exact decision records its
   (structural family, batch-bytes scalar, peak) triple, and a later
   failure on the same family answers from an affine fit over those
   points — the same piecewise-affine-in-batch structure the sweep
   service's exact interpolation exploits. Margin ``sweep_margin``.
3. **analytic** — a closed-form upper bound: from the job's
   ``PlanContext`` via
   :func:`repro_torch.launch.analytic.analytic_peak_bytes`
   when the request carries one, else from the request avals alone
   (:func:`analytic_request_bound`), scaled by observed transient
   ratios when the log has any evidence. Margin ``analytic_margin``.

Degraded rungs multiply their raw estimate by a **widened safety
margin** (>1) before the admit comparison, per the paper's threshold
methodology: a degraded answer must stay OOM-safe, trading admission
headroom (possible underutilized-rejections) for zero OOM-admitted.
Every decision reports the rung that answered and the margin applied.

The request fingerprints read the port's pytrees
(``torch.utils._pytree``) and size a leaf as the tracer does
(``tracer.aval_bytes``); ``analytic_request_bound`` sizes parameter
leaves by shape and itemsize, torch dtypes and numpy dtypes alike.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..obs import spans as obs_spans

#: Rung names, in degradation order.
RUNG_EXACT = "exact"
RUNG_SWEEP = "sweep"
RUNG_ANALYTIC = "analytic"
RUNGS = (RUNG_EXACT, RUNG_SWEEP, RUNG_ANALYTIC)

#: Transient-bytes-per-input-byte bound used by the aval-only analytic
#: rung when the decision log holds no evidence yet. Deliberately
#: conservative — a degraded overestimate costs headroom, a degraded
#: underestimate costs an OOM.
DEFAULT_TRANSIENT_RATIO = 64.0


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Knobs of the ladder (see module docstring)."""

    sweep_margin: float = 1.15      # widened margin for rung-2 answers
    analytic_margin: float = 1.50   # widened margin for rung-3 answers
    retries: int = 2                # rung-1 retries on transient faults
    backoff_s: float = 0.05         # first-retry backoff
    backoff_cap_s: float = 0.5      # exponential backoff cap
    jitter: float = 0.25            # +/- fraction of the backoff step
    default_deadline_s: float | None = None   # per-request budget

    def margin_for(self, rung: str) -> float:
        if rung == RUNG_SWEEP:
            return self.sweep_margin
        if rung == RUNG_ANALYTIC:
            return self.analytic_margin
        return 1.0


class RungTimeout(Exception):
    """A rung exceeded the request's deadline budget and was abandoned."""


@dataclasses.dataclass(frozen=True)
class JobContext:
    """The training job a request was built from: its model config,
    train policy and shape. Carried as ``AdmissionRequest.meta["job"]``,
    it lets the analytic rung bound the job from its configuration
    (``launch.analytic.analytic_peak_bytes``) rather than from its
    input avals alone."""

    cfg: Any
    policy: Any
    shape: Any


# -- request fingerprints ----------------------------------------------------
def request_family(req) -> tuple | None:
    """Structural family of a request: the function identities plus the
    parameter avals and the batch *structure* (treedef, leaf ranks and
    dtypes — not the dims, which carry the sweep scalar). Two requests
    in one family differ only by batch sizing, the precondition for the
    rung-2 affine fit. None when the forward fn has no safe identity."""
    from ..core.cache import _aval_sig, fn_identity

    ident = fn_identity(req.fwd_bwd_fn)
    if ident is None:
        return None
    idents = (ident,
              fn_identity(req.update_fn) if req.update_fn else None,
              fn_identity(req.opt_init_fn) if req.opt_init_fn else None)
    params_sig = tuple(_aval_sig(leaf) for leaf
                       in pytree.tree_leaves(req.params))
    batch_leaves = pytree.tree_leaves(req.batch)
    batch_sig = (str(pytree.tree_structure(req.batch)),
                 tuple((len(getattr(l, "shape", ())),
                        str(getattr(l, "dtype", None)))
                       for l in batch_leaves))
    # per-device execution models must not cross-pollinate families;
    # neither may offload plans — an offloaded peak is lower, and using
    # it as evidence for a non-offload request would under-answer.
    # Serving knobs separate too: a paged fp8 small-page peak is no
    # evidence for a monolithic bf16 request
    shard_sig = (req.shard_factor_fn is not None,
                 bool(req.collective_specs),
                 getattr(req, "offload", None),
                 getattr(req, "serving", None))
    return (idents, params_sig, batch_sig, shard_sig)


def _tree_bytes(tree) -> int:
    from ..core.tracer import aval_bytes
    return sum(aval_bytes(l) for l in pytree.tree_leaves(tree))


def request_scalar(req) -> int:
    """The 1-D sweep scalar of a request: total batch input bytes."""
    return _tree_bytes(req.batch)


@dataclasses.dataclass
class _LogPoint:
    scalar: int
    peak: int
    persistent: int


class DecisionLog:
    """Rung-2 evidence: recent exact decisions per structural family.

    Thread-safe; bounded per family (newest points win). ``lookup``
    answers a scalar from the family's points — exact cached hit,
    affine interpolation through the two nearest points, or
    transient-proportional scaling from a single point."""

    def __init__(self, max_families: int = 64,
                 max_points_per_family: int = 32):
        self.max_families = max_families
        self.max_points = max_points_per_family
        self._lock = threading.Lock()
        self._data: dict[tuple, dict[int, _LogPoint]] = {}
        # global transient evidence for the analytic rung
        self.max_transient_ratio = 0.0
        self.max_persistent = 0
        self.records = 0

    def record(self, family: tuple | None, scalar: int, peak: int,
               persistent: int) -> None:
        if family is None:
            return
        with self._lock:
            pts = self._data.get(family)
            if pts is None:
                if len(self._data) >= self.max_families:
                    self._data.pop(next(iter(self._data)))
                pts = self._data[family] = {}
            pts[scalar] = _LogPoint(scalar, peak, persistent)
            while len(pts) > self.max_points:
                pts.pop(next(iter(pts)))
            if scalar > 0:
                ratio = max(peak - persistent, 0) / scalar
                if ratio > self.max_transient_ratio:
                    self.max_transient_ratio = ratio
            if persistent > self.max_persistent:
                self.max_persistent = persistent
            self.records += 1

    def lookup(self, family: tuple | None, scalar: int
               ) -> tuple[int, str] | None:
        """Raw (un-margined) peak for ``scalar`` from this family's
        evidence, plus how it was derived ("cached" / "interpolated" /
        "scaled"). None when the family has no points."""
        if family is None:
            return None
        with self._lock:
            pts = self._data.get(family)
            if not pts:
                obs_spans.event("decision_log.miss")
                return None
            points = sorted(pts.values(), key=lambda p: p.scalar)
        exact = next((p for p in points if p.scalar == scalar), None)
        if exact is not None:
            obs_spans.event("decision_log.hit", derived="cached")
            return exact.peak, "cached"
        if len(points) >= 2:
            # the two nearest points bracket (or best-effort flank) the
            # query; peak is piecewise affine in batch bytes, so a line
            # through them is the sweep-service interpolation done coarse
            lo = max((p for p in points if p.scalar <= scalar),
                     key=lambda p: p.scalar, default=points[0])
            hi = min((p for p in points if p.scalar >= scalar),
                     key=lambda p: p.scalar, default=points[-1])
            if lo.scalar == hi.scalar:
                lo = points[0] if hi is not points[0] else points[1]
            slope = (hi.peak - lo.peak) / (hi.scalar - lo.scalar)
            peak = lo.peak + slope * (scalar - lo.scalar)
            floor = max(lo.persistent, hi.persistent)
            obs_spans.event("decision_log.hit", derived="interpolated")
            return max(int(peak), floor), "interpolated"
        p = points[0]
        obs_spans.event("decision_log.hit", derived="scaled")
        if p.scalar <= 0:
            return p.peak, "scaled"
        # one point: persistent stays, transients scale with the batch
        transient = max(p.peak - p.persistent, 0)
        peak = p.persistent + int(transient * (scalar / p.scalar))
        return max(peak, p.persistent), "scaled"

    def monotone_bound(self, family: tuple | None, scalar: int
                       ) -> int | None:
        """The smallest recorded peak of this family at a scalar at or
        above ``scalar``: live tensors do not shrink as the batch grows,
        so it bounds the peak at ``scalar`` from above, up to the
        allocator's rounding of segments (a rung's margin covers it).
        None when no point lies at or above it."""
        if family is None:
            return None
        with self._lock:
            pts = self._data.get(family) or {}
            above = [p.peak for p in pts.values() if p.scalar >= scalar]
        return min(above, default=None)

    def stats(self) -> dict:
        with self._lock:
            return {"families": len(self._data),
                    "points": sum(len(v) for v in self._data.values()),
                    "records": self.records,
                    "max_transient_ratio": round(
                        self.max_transient_ratio, 3)}


# -- rung 3: analytic upper bounds -------------------------------------------
def analytic_request_bound(req, log: DecisionLog | None = None, *,
                           workspace_bytes: int = 0) -> int:
    """Closed-form peak upper bound from the request alone.

    With a ``meta["plan"]`` or ``meta["job"]`` context the bound comes
    from the config-level roofline accounting
    (``launch/analytic.analytic_peak_bytes`` — full activation
    materialization, no remat credit). Without one,
    from the avals: params + grads + fp32 optimizer moments + a
    conservative transient-per-input-byte ratio (the log's observed
    maximum when any exact decision has landed, else
    ``DEFAULT_TRANSIENT_RATIO``). ``workspace_bytes`` (the port's
    addition; 0 gives the reference's bound) is added either way: the
    library workspaces an estimator's replay holds beside the job's
    tensors."""
    ctx = (req.meta.get("plan") or req.meta.get("job")) if req.meta \
        else None
    if ctx is not None and all(
            hasattr(ctx, a) for a in ("cfg", "policy", "shape")):
        from ..launch.analytic import analytic_peak_bytes
        return workspace_bytes + analytic_peak_bytes(
            ctx.cfg, ctx.shape,
            microbatches=getattr(ctx.policy, "microbatches", 1) or 1,
            with_optimizer=req.opt_init_fn is not None
            or req.update_fn is not None)
    p_bytes = 0
    n_params = 0
    for leaf in pytree.tree_leaves(req.params):
        shape = tuple(getattr(leaf, "shape", ()))
        n = int(np.prod(shape)) if shape else 1
        p_bytes += n * _itemsize(getattr(leaf, "dtype", np.float32))
        n_params += n
    in_bytes = _tree_bytes(req.batch)
    grads = p_bytes if req.update_fn is not None else 0
    # two fp32 moments per parameter (Adam-family worst case)
    opt = 2 * 4 * n_params if req.opt_init_fn is not None else 0
    ratio = DEFAULT_TRANSIENT_RATIO
    if log is not None and log.records:
        # observed evidence, widened: the largest transient ratio any
        # exact decision exhibited (margin is applied by the caller)
        ratio = max(log.max_transient_ratio * 2.0, 4.0)
    return workspace_bytes + int(p_bytes + grads + opt + in_bytes
                                 + ratio * max(in_bytes, 1))


def _itemsize(dtype) -> int:
    """Bytes of one element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def backoff_delays(policy: DegradePolicy, seed: str) -> list[float]:
    """Capped exponential backoff schedule with deterministic jitter
    (seeded by the job id, so replays are reproducible)."""
    import random
    rng = random.Random(seed)
    out = []
    for attempt in range(policy.retries):
        base = min(policy.backoff_s * (2 ** attempt), policy.backoff_cap_s)
        out.append(base * (1.0 + policy.jitter * (2 * rng.random() - 1)))
    return out

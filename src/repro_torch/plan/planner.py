"""Remediation planner: rejections become cheapest-feasible counter-offers
(port of ``repro.plan.planner``).

Given a job the admission service just bounced, search the plan space
(global batch, gradient-accumulation microbatches, remat policy, mesh
topology, optional vocab padding, host offload, and for a serving mix
the page size x concurrency x KV dtype x prefix-cache grid) and return
a ranked list of :class:`CounterOffer`\\ s that *do* fit the capacity,
each scored by the analytic roofline cost model (``plan/cost.py``,
priced for the H100), so the first offer is the cheapest modeled
slowdown, not merely the smallest memory.

The search is **trace-frugal**: every knob goes through the cheapest
estimation that is exact for it.

* **topology** — the traced program does not depend on the mesh, so
  the whole (pod, data, model, fsdp) grid replays the baseline's cached
  traces (``AdmissionService.mesh_sweep``): zero fresh traces;
* **batch** — only the input shapes change, so the candidates ride
  ``AdmissionService.decide_sweep``'s affine trace model; the rejected
  batch is swept along as the max-probe anchor;
* **microbatches / remat / pad_vocab** — these change the traced
  program, so each distinct candidate costs one fresh forward+backward
  trace (the optimizer phases stay warm through the content-addressed
  cache);
* **offload** — only the orchestrator's offload pass and the replay
  change, so every candidate replays the baseline's traces: zero fresh
  traces;
* **serving knobs** — only the request stream's lowering and its replay
  change, except the concurrency: the port traces the decode step at
  each distinct ``max_concurrent`` of the grid (``pick_serving`` has
  traced at the concurrency since the admission service was ported: at
  qwen3-32b's full width, 8 layers and a 2064-position cache, the
  batch-1 trace's transient scaled to 8 is 110,477,312 B where the
  batch-8 trace's is 177,967,104 B). The reference shares one batch-1
  trace across the grid. A serving search therefore costs at most
  ``serving_trace_budget`` traces, the baseline's included.

Every offer is *reproducible*: ``CounterOffer.admission_request``
rebuilds the exact request, and a direct ``AdmissionService.decide`` on
it yields the offer's estimate bit-identically.

A topology offer carries the spec-driven shard factors and collective
specs the mesh sweep used (``admission_request`` rebuilds them), so its
decision reproduces the sweep's row to the byte.

Delta from the reference, for the port's admission rule: a candidate is
feasible when its replay at the capacity did not run out of memory and
its peak fits (the service's rule; the mesh sweep replays each topology
at the capacity for it); the reference compares the unbounded peak with
the capacity.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

from ..configs.base import ModelConfig, ShapeSpec
from ..core.orchestrator import OffloadPlan, ServingKnobs
from ..obs import spans as obs_spans
from ..core.sweep import MeshTopology, topology_grid
from ..service.admission import (AdmissionDecision, AdmissionRequest,
                                 AdmissionService)
from ..service.degrade import JobContext
from ..train.train_step import TrainPolicy, make_estimator_hooks
from .cost import plan_cost, serving_cost

_REMAT_ORDER = ("none", "dots", "full")     # ascending memory savings


@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """Which knobs the planner may turn, and how far.

    ``None`` means "derive a default grid from the rejected plan"; an
    empty tuple switches the axis off."""

    batches: tuple | None = None        # explicit per-replica batch grid
    microbatches: tuple | None = None   # explicit accumulation factors
    remat: tuple | None = None          # explicit remat rungs to try
    devices: tuple = ()                 # device counts for the mesh grid
    pods: tuple = (1,)                  # pod counts forwarded to the grid
    base_topology: MeshTopology | None = None  # fixed mesh for ALL plans
    pad_vocab_multiple: int | None = None      # padded-vocab mesh variants
    batch_halvings: int = 3             # default batch grid depth
    mb_doublings: int = 2               # default microbatch grid depth
    max_offers: int = 5                 # ranked offers returned
    early_stop: bool = False            # stop fresh-trace singles at the
    #                                     first feasible offer (replan path)
    # host-offload axes: candidates change only the orchestrator's
    # offload pass, never the traced program (zero fresh traces)
    offload_opt_state: bool = False     # try optimizer-state offload
    offload_activations: tuple = ()     # activation fractions to try
    #                                     (each combined with opt-state
    #                                     offload when that is enabled)
    # serving axes: empty tuple = keep the rejected plan's value
    page_sizes: tuple = ()              # KV page sizes (tokens) to try
    max_concurrents: tuple = ()         # in-flight sequence caps to try
    kv_dtypes: tuple = ()               # KV element widths (bytes)
    prefix_cache: tuple = ()            # (True, False) toggles to try


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """The structured job description a planner search needs: attach as
    ``AdmissionRequest.meta["plan"]`` and a rejection comes back with
    ``counter_offers`` populated."""

    cfg: ModelConfig
    policy: TrainPolicy
    shape: ShapeSpec
    space: PlanSpace = PlanSpace()


@dataclasses.dataclass(frozen=True)
class ServingPlanContext:
    """The serving job description a ``plan_serving`` search needs:
    pass as ``AdmissionService.decide_serving(..., plan=ctx)`` and a
    request-driven rejection comes back with serving counter-offers.

    ``step_inputs(max_concurrent) -> (cache, batch)`` gives the decode
    step's cache and batch at a concurrency (``pick_serving`` passes
    meta tensors at that batch); without it every candidate reuses
    ``cache`` and ``batch``, the reference's one trace."""

    decode_fn: Any
    params: Any
    cache: Any
    batch: Any
    mix: Any                            # RequestMix (or RequestStream)
    knobs: Any = None                   # base ServingKnobs (rejected plan)
    kv_bytes_per_token: int = 0
    resident_bytes_per_request: int = 0
    space: PlanSpace = PlanSpace()
    step_inputs: Callable | None = None


@dataclasses.dataclass
class CounterOffer:
    """One feasible alternative plan for a rejected job."""

    job_id: str
    knob: str                       # axis that produced it
    global_batch: int
    microbatches: int
    remat: str
    topology: MeshTopology | None
    pad_vocab_multiple: int | None
    capacity: int
    peak_bytes: int
    safe_threshold: int             # Eq. 5: the estimate as memory cap
    cost: dict                      # roofline terms (plan/cost.py)
    slowdown: float                 # cost ratio vs the rejected plan
    source: str                     # estimate provenance
    report: Any = None              # EstimateReport (in-process use)
    offload_opt_state: bool = False
    offload_activations: float = 0.0
    space_peaks: dict | None = None     # per-space peak bytes
    # serving knobs: the offered ServingKnobs as a dict plus the
    # ServingEstimate summary; None for training offers
    serving: dict | None = None

    @property
    def n_devices(self) -> int:
        return self.topology.n_devices if self.topology is not None else 1

    @property
    def headroom_bytes(self) -> int:
        return self.capacity - self.peak_bytes

    def offload_plan(self) -> OffloadPlan | None:
        """The :class:`~repro_torch.core.orchestrator.OffloadPlan` this
        offer promises, or None for a device-only offer."""
        if not (self.offload_opt_state or self.offload_activations):
            return None
        return OffloadPlan(optimizer_state=self.offload_opt_state,
                           activations=float(self.offload_activations))

    def to_json(self) -> dict:
        d = {
            "knob": self.knob,
            "global_batch": self.global_batch,
            "microbatches": self.microbatches,
            "remat": self.remat,
            "topology": (self.topology.label
                         if self.topology is not None else None),
            "n_devices": self.n_devices,
            "pad_vocab_multiple": self.pad_vocab_multiple,
            "peak_bytes": self.peak_bytes,
            "safe_threshold": self.safe_threshold,
            "headroom_bytes": self.headroom_bytes,
            "slowdown": round(self.slowdown, 4),
            "device_s_per_token": self.cost["device_s_per_token"],
            "source": self.source,
            "offload_opt_state": self.offload_opt_state,
            "offload_activations": self.offload_activations,
        }
        if self.space_peaks:
            d["space_peaks"] = dict(self.space_peaks)
        if self.serving is not None:
            d["serving"] = dict(self.serving)
        return d

    def serving_knobs(self) -> ServingKnobs | None:
        """The :class:`~repro_torch.core.orchestrator.ServingKnobs` this
        offer promises, or None for a training offer."""
        if self.serving is None:
            return None
        k = self.serving["knobs"]
        return ServingKnobs(page_size=k["page_size"],
                            max_concurrent=k["max_concurrent"],
                            kv_dtype_bytes=k["kv_dtype_bytes"],
                            prefix_cache=k["prefix_cache"],
                            speculative_k=k["speculative_k"])

    # -- reproduction --------------------------------------------------------
    def apply(self, cfg: ModelConfig, policy: TrainPolicy,
              shape: ShapeSpec) -> tuple[ModelConfig, TrainPolicy,
                                         ShapeSpec]:
        """The offered (cfg, policy, shape): the rejected job's tuple
        with this offer's knobs applied."""
        if self.remat != cfg.remat:
            cfg = dataclasses.replace(cfg, remat=self.remat)
        if self.pad_vocab_multiple != cfg.pad_vocab_multiple \
                and self.pad_vocab_multiple is not None:
            cfg = dataclasses.replace(
                cfg, pad_vocab_multiple=self.pad_vocab_multiple)
        if self.microbatches != policy.microbatches:
            policy = dataclasses.replace(
                policy, microbatches=self.microbatches)
        if self.global_batch != shape.global_batch:
            shape = dataclasses.replace(
                shape, global_batch=self.global_batch)
        return cfg, policy, shape

    def admission_request(self, cfg: ModelConfig, policy: TrainPolicy,
                          shape: ShapeSpec, *, capacity: int | None = None,
                          job_id: str | None = None, shard_factor_fn=None,
                          collective_specs=()) -> AdmissionRequest:
        """The exact admission request this offer promises will fit:
        ``AdmissionService.decide`` on it reproduces ``peak_bytes``
        bit-identically (topology offers carry the same spec-driven
        shard factors and collective specs the mesh sweep used; pass
        ``shard_factor_fn``/``collective_specs`` when the original
        request pinned its own execution model). The request carries the
        offered job as ``meta["job"]`` (the analytic rung's
        configuration bound)."""
        from ..configs.registry import input_specs
        from ..models import model as M
        cfg2, policy2, shape2 = self.apply(cfg, policy, shape)
        fwd, upd, init = make_estimator_hooks(cfg2, policy2)
        params = M.abstract_params(cfg2)
        batch = input_specs(cfg2, shape2)
        kw = _factor_kwargs(cfg2, params, batch, self.topology, init,
                            shard_factor_fn, collective_specs)
        return AdmissionRequest(
            job_id or f"{self.job_id}+offer", fwd, params, batch,
            update_fn=upd, opt_init_fn=init,
            capacity=self.capacity if capacity is None else capacity,
            offload=self.offload_plan(),
            meta={"job": JobContext(cfg2, policy2, shape2)}, **kw)


@dataclasses.dataclass
class PlanResult:
    """Ranked offers + the rejecting baseline + search accounting."""

    offers: list
    baseline: AdmissionDecision
    stats: dict

    def best(self) -> CounterOffer | None:
        return self.offers[0] if self.offers else None

    def __iter__(self):
        return iter(self.offers)

    def __len__(self):
        return len(self.offers)

    def to_json(self) -> dict:
        d = {
            "admit": self.baseline.admit,
            "peak_bytes": self.baseline.peak_bytes,
            "capacity": self.baseline.capacity,
            "counter_offers": [o.to_json() for o in self.offers],
            "stats": self.stats,
        }
        if self.baseline.correlation_id is not None:
            d["correlation_id"] = self.baseline.correlation_id
        return d


# ---------------------------------------------------------------------------
def _factor_kwargs(cfg, params, batch, topo: MeshTopology | None,
                   opt_init_fn, custom_factor_fn=None,
                   custom_collectives=(), opt_state=None) -> dict:
    """shard_factor_fn / collective_specs for a plan's mesh, built the
    way ``estimate_mesh_sweep`` builds them (spec mode, the optimizer
    state's shapes from ``opt_init_fn`` on the meta parameters), so
    direct decisions reproduce sweep estimates. A caller-supplied
    factor function or collective specs (the rejected request's own
    execution model) override the mesh derivation; ``opt_state``
    skips the per-candidate ``opt_init_fn`` call (the optimizer shapes
    do not depend on the batch)."""
    if custom_factor_fn is not None or custom_collectives:
        kw = {}
        if custom_factor_fn is not None:
            kw["shard_factor_fn"] = custom_factor_fn
        if custom_collectives:
            kw["collective_specs"] = tuple(custom_collectives)
        return kw
    if topo is None:
        return {}
    from ..distributed.sharding import (mesh_collective_specs,
                                        shard_factor_fn)
    pol = topo.sharding_policy()
    if opt_state is None and opt_init_fn is not None:
        opt_state = opt_init_fn(params)
    return {
        "shard_factor_fn": shard_factor_fn(
            cfg, topo.axis_sizes, pol, params=params,
            opt_state=opt_state, batch=batch),
        "collective_specs": mesh_collective_specs(topo.axis_sizes, pol),
    }


def _batch_candidates(space: PlanSpace, b0: int, m0: int) -> tuple:
    if space.batches is not None:
        return tuple(b for b in space.batches
                     if 0 < b < b0 and b % m0 == 0)
    out, b = [], b0 // 2
    for _ in range(space.batch_halvings):
        if b < max(m0, 1) or b % m0:
            break
        out.append(b)
        b //= 2
    return tuple(out)


def _mb_candidates(space: PlanSpace, b0: int, m0: int) -> tuple:
    if space.microbatches is not None:
        return tuple(m for m in space.microbatches
                     if m > m0 and b0 % m == 0)
    out, m = [], m0 * 2
    for _ in range(space.mb_doublings):
        if m > b0 or b0 % m:
            break
        out.append(m)
        m *= 2
    return tuple(out)


def _remat_candidates(space: PlanSpace, cfg: ModelConfig) -> tuple:
    cur = (_REMAT_ORDER.index(cfg.remat)
           if cfg.remat in _REMAT_ORDER else len(_REMAT_ORDER) - 1)
    if space.remat is not None:
        return tuple(r for r in space.remat
                     if r in _REMAT_ORDER and _REMAT_ORDER.index(r) > cur)
    # default: only the strongest rung (each rung is one fresh trace)
    return ("full",) if cur < _REMAT_ORDER.index("full") else ()


def _offload_candidates(space: PlanSpace) -> tuple:
    """Offload ladder: optimizer state first (cheap, bounded transfer),
    then each activation fraction stacked on top of it."""
    out = []
    if space.offload_opt_state:
        out.append(OffloadPlan(optimizer_state=True))
    for f in space.offload_activations:
        f = float(f)
        if 0.0 < f <= 1.0:
            out.append(OffloadPlan(
                optimizer_state=space.offload_opt_state, activations=f))
    return tuple(out)


def _topologies(space: PlanSpace) -> tuple:
    if space.base_topology is not None or not space.devices:
        return ()
    return tuple(t for n in space.devices
                 for t in topology_grid(n, pods=space.pods))


def serving_trace_budget(space: PlanSpace, base: ServingKnobs) -> int:
    """Most traces a serving search may cost, its baseline's included:
    1 + the distinct ``max_concurrent`` values of its grid (the decode
    step is traced at each concurrency)."""
    return 1 + len({k.max_concurrent for k in _serving_grid(space, base)})


# ---------------------------------------------------------------------------
class RemediationPlanner:
    """Search the plan space around a rejected admission request.

    Shares the service's content-addressed trace cache, its batched
    sweep path and its mesh-sweep path, so repeated planner runs (and a
    planner run right after the rejection that triggered it) stay warm.
    """

    def __init__(self, service: AdmissionService | None = None):
        self.service = service or AdmissionService(workers=1)

    def _request(self, job_id, fwd, params, batch, upd, init, capacity,
                 factor_kwargs, offload=None) -> AdmissionRequest:
        return AdmissionRequest(job_id, fwd, params, batch,
                                update_fn=upd, opt_init_fn=init,
                                capacity=capacity, offload=offload,
                                **factor_kwargs)

    # -- the search ----------------------------------------------------------
    def plan(self, cfg: ModelConfig, policy: TrainPolicy,
             shape: ShapeSpec, *, capacity: int,
             space: PlanSpace | None = None, job_id: str = "job",
             baseline: AdmissionDecision | None = None,
             shard_factor_fn=None, collective_specs=()) -> PlanResult:
        """Ranked counter-offers for (cfg, policy, shape) at ``capacity``.

        ``baseline`` short-circuits the initial decision when the caller
        already holds the rejection (the ``AdmissionService.decide``
        wiring); ``shard_factor_fn`` / ``collective_specs`` pin the
        rejected request's own execution model on every candidate, and
        the mesh axes (``devices`` / ``pad_vocab_multiple``) are then
        off, since a topology offer under a foreign execution model
        would quote a peak for the wrong sharding.
        ``stats["fresh_traces"]`` counts trace-cache misses of the
        search itself; the baseline decision, when the planner has to
        make it, is counted as ``baseline_traces``."""
        space = space or PlanSpace()
        # the rejecting decision's correlation ID, taken before the
        # candidates' decisions open their own scopes, so the plan's
        # audit record chains to the rejection it remediates
        cid = obs_spans.current_correlation_id()
        with obs_spans.span("planner.plan", job_id=job_id):
            result = self._plan_search(
                cfg, policy, shape, capacity=capacity, space=space,
                job_id=job_id, baseline=baseline,
                shard_factor_fn=shard_factor_fn,
                collective_specs=collective_specs)
        self._audit_plan("training", job_id, cid, result)
        return result

    def _audit_plan(self, mode: str, job_id: str, cid: str | None,
                    result: PlanResult) -> None:
        """One audit record per planner search (kind="plan")."""
        obs = getattr(self.service, "obs", None)
        if obs is None or obs.audit is None:
            return
        obs.record(
            "plan", correlation_id=cid, mode=mode, job_id=job_id,
            offers=[{"knob": o.knob, "global_batch": o.global_batch,
                     "peak_bytes": o.peak_bytes,
                     "slowdown": o.slowdown}
                    for o in result.offers[:5]],
            stats={k: result.stats.get(k) for k in
                   ("candidates", "feasible", "offers",
                    "fresh_traces", "already_fits")})

    def _plan_search(self, cfg: ModelConfig, policy: TrainPolicy,
                     shape: ShapeSpec, *, capacity: int, space: PlanSpace,
                     job_id: str, baseline: AdmissionDecision | None,
                     shard_factor_fn, collective_specs) -> PlanResult:
        from ..configs.registry import input_specs
        from ..models import model as M
        svc = self.service
        cache = svc.cache
        t0 = time.perf_counter()
        b0, m0 = shape.global_batch, max(policy.microbatches, 1)
        base_topo = space.base_topology
        fwd, upd, init = make_estimator_hooks(cfg, policy)
        params = M.abstract_params(cfg)
        batch0 = input_specs(cfg, shape)
        # the optimizer's shapes do not depend on the batch: resolved
        # once for every candidate's spec factors
        opt_state0 = None
        if base_topo is not None and shard_factor_fn is None \
                and init is not None:
            opt_state0 = init(params)

        def factor_kw(c, p, b):
            return _factor_kwargs(c, p, b, base_topo, init,
                                  shard_factor_fn, collective_specs,
                                  opt_state=opt_state0)

        base_kw = factor_kw(cfg, params, batch0)
        before = cache.thread_stats()
        if baseline is None:
            baseline = svc.decide(self._request(
                f"{job_id}/baseline", fwd, params, batch0, upd, init,
                capacity, base_kw))
        baseline_traces = cache.thread_stats()["misses"] \
            - before["misses"]

        stats = {"capacity": capacity, "candidates": 0, "feasible": 0,
                 "axes": {}, "baseline_traces": baseline_traces,
                 "already_fits": bool(baseline.admit)}
        if baseline.admit:
            stats.update(fresh_traces=0, offers=0,
                         wall_s=time.perf_counter() - t0)
            return PlanResult([], baseline, stats)

        before = cache.thread_stats()
        base_cost = plan_cost(cfg, shape, microbatches=m0,
                              topology=base_topo)
        offers: list[CounterOffer] = []

        def add(knob, d: AdmissionDecision, *, gb=b0, mb=m0, topo=base_topo,
                cfg2=None, pad=None, offload=None):
            stats["candidates"] += 1
            if not d.admit:
                return
            stats["feasible"] += 1
            c2 = cfg2 if cfg2 is not None else cfg
            shape2 = (dataclasses.replace(shape, global_batch=gb)
                      if gb != shape.global_batch else shape)
            bd = d.breakdown or {}
            transfer = bd.get("offload", {}).get(
                "transfer_bytes_per_iter", 0)
            cost = plan_cost(c2, shape2, microbatches=mb, topology=topo,
                             offload_transfer_bytes=transfer)
            offers.append(CounterOffer(
                job_id=job_id, knob=knob, global_batch=gb,
                microbatches=mb, remat=c2.remat, topology=topo,
                pad_vocab_multiple=pad if pad is not None
                else c2.pad_vocab_multiple,
                capacity=capacity, peak_bytes=d.peak_bytes,
                safe_threshold=d.safe_threshold, cost=cost,
                slowdown=(cost["device_s_per_token"]
                          / max(base_cost["device_s_per_token"], 1e-30)),
                source=d.provenance["source"], report=d.report,
                offload_opt_state=(offload.optimizer_state
                                   if offload is not None else False),
                offload_activations=(offload.activations
                                     if offload is not None else 0.0),
                space_peaks=bd.get("space_peaks")))

        def sweep_rows(knob, res, **kw):
            """A mesh sweep's rows as candidates, each decided by the
            service's rule (the sweep replayed it at the capacity)."""
            for topo, rep in res:
                add(knob, AdmissionDecision(
                    job_id=f"{job_id}/{knob}-{topo.label}",
                    admit=not rep.oom and rep.peak_bytes <= capacity,
                    capacity=capacity, peak_bytes=rep.peak_bytes,
                    peak_tensor_bytes=rep.peak_tensor_bytes,
                    persistent_bytes=rep.persistent_bytes,
                    safe_threshold=rep.peak_bytes,
                    breakdown=rep.breakdown,
                    provenance={"source": "mesh-sweep"}, wall_s=0.0,
                    report=rep), topo=topo, **kw)

        # --- topology axis: replays of the cached phases -------------
        # a caller-pinned execution model (custom factors / collectives)
        # describes the job's current placement; the planner cannot
        # reason about how it composes with a different mesh, so the
        # mesh axes are off rather than answered under the wrong model
        custom_model = shard_factor_fn is not None \
            or bool(collective_specs)
        topos = () if custom_model else _topologies(space)
        if topos:
            sweep_rows("topology", svc.mesh_sweep(
                fwd, params, batch0, topos, update_fn=upd, opt_init_fn=init,
                cfg=cfg, capacity=capacity))
            stats["axes"]["topology"] = len(topos)

        # --- padded-vocab mesh variants (only useful with model > 1) ---
        if (space.pad_vocab_multiple and not custom_model
                and cfg.pad_vocab_multiple is None
                and cfg.vocab % space.pad_vocab_multiple):
            mp = tuple(t for t in topos if t.model > 1)
            if mp:
                cfgp = dataclasses.replace(
                    cfg, pad_vocab_multiple=space.pad_vocab_multiple)
                fwdp, updp, initp = make_estimator_hooks(cfgp, policy)
                sweep_rows("pad_vocab", svc.mesh_sweep(
                    fwdp, M.abstract_params(cfgp), input_specs(cfgp, shape),
                    mp, update_fn=updp, opt_init_fn=initp, cfg=cfgp,
                    capacity=capacity), cfg2=cfgp,
                    pad=space.pad_vocab_multiple)
                stats["axes"]["pad_vocab"] = len(mp)

        # --- batch axis: the sweep's affine trace model, the rejected
        # batch as the max-probe anchor (excluded from the offers) -----
        batches = _batch_candidates(space, b0, m0)
        if batches:
            grid = (b0,) + batches
            reqs = []
            for b in grid:
                batch_b = input_specs(
                    cfg, dataclasses.replace(shape, global_batch=b))
                reqs.append(self._request(
                    f"{job_id}/b{b}", fwd, params, batch_b, upd, init,
                    capacity, factor_kw(cfg, params, batch_b)))
            decisions = svc.decide_sweep(reqs)
            for b, d in zip(grid, decisions):
                if b != b0:
                    add("batch", d, gb=b)
            stats["axes"]["batch"] = len(batches)
            stats["sweep"] = decisions[0].provenance.get("sweep", {})

        # --- microbatch / remat singles: each changes the traced
        # program, so each candidate is one fresh forward trace ---------
        singles: list[tuple] = []
        for m in _mb_candidates(space, b0, m0):
            singles.append(("microbatch", cfg,
                            dataclasses.replace(policy, microbatches=m),
                            {"mb": m}))
        for r in _remat_candidates(space, cfg):
            singles.append(("remat", dataclasses.replace(cfg, remat=r),
                            policy, {}))
        stats["axes"]["microbatch"] = sum(
            1 for s in singles if s[0] == "microbatch")
        stats["axes"]["remat"] = sum(1 for s in singles
                                     if s[0] == "remat")
        singles.sort(key=lambda s: plan_cost(
            s[1], shape, microbatches=s[3].get("mb", m0),
            topology=base_topo)["device_s_per_token"])
        for knob, cfg2, pol2, meta in singles:
            if space.early_stop and offers:
                break
            f2, u2, i2 = make_estimator_hooks(cfg2, pol2)
            params2 = M.abstract_params(cfg2)
            batch2 = input_specs(cfg2, shape)
            d = svc.decide(self._request(
                f"{job_id}/{knob}{meta.get('mb', cfg2.remat)}", f2,
                params2, batch2, u2, i2, capacity,
                factor_kw(cfg2, params2, batch2)))
            add(knob, d, mb=meta.get("mb", m0), cfg2=cfg2)

        # --- offload axis: the traced program is offload-independent,
        # so every candidate replays the baseline's warm traces --------
        offload_plans = _offload_candidates(space)
        stats["axes"]["offload"] = len(offload_plans)
        for op in offload_plans:
            if space.early_stop and offers:
                break
            tag = (f"opt{int(op.optimizer_state)}"
                   f"-act{op.activations:g}")
            d = svc.decide(self._request(
                f"{job_id}/offload-{tag}", fwd, params, batch0, upd, init,
                capacity, base_kw, offload=op))
            add("offload", d, offload=op)

        after = cache.thread_stats()
        offers.sort(key=lambda o: (o.cost["device_s_per_token"],
                                   o.n_devices, o.peak_bytes,
                                   o.knob, o.global_batch))
        offers = offers[:max(space.max_offers, 0)]
        stats.update(offers=len(offers),
                     fresh_traces=after["misses"] - before["misses"],
                     wall_s=time.perf_counter() - t0)
        return PlanResult(offers, baseline, stats)

    # -- the serving search --------------------------------------------------
    def plan_serving(self, ctx: ServingPlanContext, *, capacity: int,
                     job_id: str = "serve",
                     baseline: AdmissionDecision | None = None
                     ) -> PlanResult:
        """Ranked serving counter-offers for a rejected request mix.

        Every candidate re-lowers the request stream and replays; the
        decode step is traced once per distinct concurrency of the grid
        (``ctx.step_inputs``), so the search with its baseline costs at
        most ``serving_trace_budget(space, knobs)`` = 1 + the grid's
        distinct ``max_concurrent`` values traces. Offers are ranked by
        the serving roofline (``serving_cost``), and each reproduces
        bit-identically through a direct ``decide_serving`` with
        ``CounterOffer.serving_knobs()``."""
        cid = obs_spans.current_correlation_id()
        with obs_spans.span("planner.plan_serving", job_id=job_id):
            result = self._plan_serving_search(
                ctx, capacity=capacity, job_id=job_id, baseline=baseline)
        self._audit_plan("serving", job_id, cid, result)
        return result

    def _plan_serving_search(self, ctx: ServingPlanContext, *,
                             capacity: int, job_id: str,
                             baseline: AdmissionDecision | None
                             ) -> PlanResult:
        svc = self.service
        cache = svc.cache
        t0 = time.perf_counter()
        space = ctx.space or PlanSpace()
        base_knobs = ctx.knobs or ServingKnobs()

        def decide(tag, knobs):
            step_cache, step_batch = (
                ctx.step_inputs(knobs.max_concurrent)
                if ctx.step_inputs is not None else (ctx.cache, ctx.batch))
            return svc.decide_serving(
                f"{job_id}/{tag}", ctx.decode_fn, ctx.params, step_cache,
                step_batch, capacity=capacity, mix=ctx.mix, knobs=knobs,
                kv_bytes_per_token=ctx.kv_bytes_per_token,
                resident_bytes_per_request=ctx.resident_bytes_per_request)

        before = cache.thread_stats()
        if baseline is None:
            baseline = decide("baseline", base_knobs)
        baseline_traces = cache.thread_stats()["misses"] \
            - before["misses"]
        avg_seq, shared_prefix = _mix_profile(ctx.mix)
        stats = {"capacity": capacity, "candidates": 0, "feasible": 0,
                 "axes": {}, "baseline_traces": baseline_traces,
                 "already_fits": bool(baseline.admit),
                 "trace_budget": serving_trace_budget(space, base_knobs)}
        if baseline.admit:
            stats.update(fresh_traces=0, offers=0,
                         wall_s=time.perf_counter() - t0)
            return PlanResult([], baseline, stats)

        before = cache.thread_stats()
        grid = _serving_grid(space, base_knobs)
        stats["axes"]["serving"] = len(grid)
        params_bytes = baseline.persistent_bytes
        base_cost = serving_cost(
            params_bytes=params_bytes,
            kv_bytes_per_token=ctx.kv_bytes_per_token, knobs=base_knobs,
            avg_seq_len=avg_seq, shared_prefix_len=shared_prefix)
        offers: list[CounterOffer] = []
        for knobs in grid:
            stats["candidates"] += 1
            tag = (f"pg{knobs.page_size}-c{knobs.max_concurrent}"
                   f"-kv{knobs.kv_dtype_bytes}"
                   f"-px{int(knobs.prefix_cache)}")
            d = decide(tag, knobs)
            if not d.admit or d.degraded:
                continue
            stats["feasible"] += 1
            cost = serving_cost(
                params_bytes=params_bytes,
                kv_bytes_per_token=ctx.kv_bytes_per_token, knobs=knobs,
                avg_seq_len=avg_seq, shared_prefix_len=shared_prefix)
            serving = dict(d.breakdown.get("serving", {}))
            serving["knobs"] = dataclasses.asdict(knobs)
            offers.append(CounterOffer(
                job_id=job_id, knob="serving",
                global_batch=knobs.max_concurrent, microbatches=1,
                remat="none", topology=None, pad_vocab_multiple=None,
                capacity=capacity, peak_bytes=d.peak_bytes,
                safe_threshold=d.safe_threshold, cost=cost,
                slowdown=(cost["device_s_per_token"]
                          / max(base_cost["device_s_per_token"], 1e-30)),
                source=d.provenance["source"], report=d.report,
                serving=serving))
        after = cache.thread_stats()
        offers.sort(key=lambda o: (o.cost["device_s_per_token"],
                                   o.peak_bytes, o.global_batch))
        offers = offers[:max(space.max_offers, 0)]
        stats.update(offers=len(offers),
                     fresh_traces=after["misses"] - before["misses"],
                     wall_s=time.perf_counter() - t0)
        return PlanResult(offers, baseline, stats)


# ---------------------------------------------------------------------------
def _serving_grid(space: PlanSpace, base: ServingKnobs) -> list:
    """The ServingKnobs candidates of a plan space: the full product over
    the enabled axes (base value where an axis is empty), the base point
    excluded (it is the rejected plan)."""
    pages = space.page_sizes or (base.page_size,)
    concs = space.max_concurrents or (base.max_concurrent,)
    dtypes = space.kv_dtypes or (base.kv_dtype_bytes,)
    prefixes = space.prefix_cache or (base.prefix_cache,)
    out = []
    for p, c, d, x in itertools.product(pages, concs, dtypes, prefixes):
        k = dataclasses.replace(base, page_size=p, max_concurrent=c,
                                kv_dtype_bytes=d, prefix_cache=x)
        if k != base:
            out.append(k)
    return out


def _mix_profile(mix) -> tuple[float, int]:
    """(average total sequence length, shared prefix tokens) of a
    RequestMix or a concrete RequestStream: the serving cost model's
    traffic inputs."""
    buckets = getattr(mix, "buckets", None)
    if buckets is not None:
        total = sum(c for _p, _d, c in buckets)
        avg = (sum((p + d) * c for p, d, c in buckets)
               / max(total, 1))
        return avg, int(getattr(mix, "shared_prefix_len", 0))
    reqs = getattr(mix, "requests", ())
    if reqs:
        avg = sum(r.prompt_len + r.decode_len for r in reqs) / len(reqs)
        shared = min(r.shared_prefix_len for r in reqs)
        return avg, int(shared)
    return 1.0, 0


# ---------------------------------------------------------------------------
def run_plan_search(arch: str, hbm_bytes: int, *, seq: int = 48,
                    batch: int = 32, microbatches: int = 1,
                    remat: str | None = None,
                    devices: tuple = (4, 8, 16), smoke: bool = True,
                    offload: bool = True,
                    space: PlanSpace | None = None,
                    service: AdmissionService | None = None,
                    verbose: bool = True,
                    n_layers: int | None = None) -> dict:
    """Plan a training job of ``arch`` (its smoke config by default)
    that does not fit ``hbm_bytes`` and print/return the ranked offers.
    ``offload`` adds the host-offload axes (optimizer state + half the
    activations) to the default space; offload offers print their
    per-space peaks. ``devices`` is the topology axis's grid of device
    counts (``()`` for a single-device search); ``n_layers`` cuts the
    depth."""
    from ..configs import get_config, get_smoke
    from ..configs.base import smoke_shape
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    policy = TrainPolicy(optimizer="adamw",
                         microbatches=max(int(microbatches), 1))
    shape = smoke_shape(seq_len=seq, global_batch=batch)
    if space is None:
        space = PlanSpace(devices=tuple(devices),
                          offload_opt_state=bool(offload),
                          offload_activations=(0.5,) if offload else ())
    planner = RemediationPlanner(service)
    res = planner.plan(cfg, policy, shape, capacity=hbm_bytes,
                       job_id=f"{cfg.name}-plan", space=space)
    record = {"arch": cfg.name, "kind": "xmem_plan",
              "hbm_bytes": hbm_bytes, "seq": seq, "batch": batch,
              "microbatches": policy.microbatches, "remat": cfg.remat,
              **res.to_json()}
    if verbose:
        if res.baseline.admit:
            print(f"[xmem-plan] {cfg.name}: already fits "
                  f"({res.baseline.peak_bytes/2**20:.2f} MiB <= "
                  f"{hbm_bytes/2**20:.2f} MiB) — nothing to remediate",
                  flush=True)
        else:
            print(f"[xmem-plan] {cfg.name}: rejected at "
                  f"{res.baseline.peak_bytes/2**20:.2f} MiB vs "
                  f"{hbm_bytes/2**20:.2f} MiB — "
                  f"{res.stats['candidates']} candidates, "
                  f"{res.stats['feasible']} feasible, "
                  f"{res.stats['fresh_traces']} fresh traces, "
                  f"{res.stats['wall_s']*1e3:.0f} ms", flush=True)
            for i, o in enumerate(res.offers):
                topo = o.topology.label if o.topology else "1dev"
                line = (f"[xmem-plan]   #{i+1} {o.knob:10s} "
                        f"b={o.global_batch:<4d} mb={o.microbatches:<3d} "
                        f"remat={o.remat:5s} {topo:12s} "
                        f"peak={o.peak_bytes/2**20:7.2f} MiB "
                        f"slowdown=x{o.slowdown:.2f}")
                if o.space_peaks:
                    line += "  spaces[" + " ".join(
                        f"{k}={v/2**20:.2f}MiB"
                        for k, v in sorted(o.space_peaks.items())) + "]"
                print(line, flush=True)
    return record

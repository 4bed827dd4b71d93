"""Admission service: request/response estimation over a worker pool
(port of ``repro.service.admission``).

The scheduler-facing API of the estimator. An :class:`AdmissionRequest`
names one training job by the exact callables the runtime would execute
and the capacity of the device it would run on; the service answers
with an :class:`AdmissionDecision` carrying the estimate, the safe
threshold (Eq. 5: the estimate usable as max-runnable-memory), the
breakdown and cache provenance (memory-warm / disk-warm / traced).

Estimates are produced by the same ``XMemEstimator`` pipeline as the
one-shot gates — the exact rung is bit-identical to a direct
``estimate_training(..., capacity=req.capacity)``. What the service
adds:

* a shared thread-safe :class:`~repro_torch.core.cache.TraceCache`,
  optionally layered over a persistent
  :class:`~repro_torch.service.store.TraceStore` (content-addressed
  keys, so re-created but structurally identical step functions are
  warm — across decisions AND process restarts);
* concurrent serving: ``submit`` fans decisions out over a thread pool,
  one estimator per worker thread (the orchestrator mutates per-call
  policy state, so estimator instances are not shared across threads;
  the trace cache is);
* batched decisions: ``decide_sweep`` routes a family of requests that
  differ in the batch through ``SweepService.estimate_many``;
* robustness: a graceful-degradation ladder (exact replay ->
  cached/interpolated decision-log point -> analytic upper bound, each
  degraded rung with a widened safety margin — see
  :mod:`repro_torch.service.degrade`), per-request deadline budgets
  with capped-backoff retries on transient failures, and fault
  injection via :mod:`repro_torch.service.faults`. A rung failure falls
  to the next rung instead of propagating, and every decision reports
  which rung answered, the margin applied and why the upper rungs fell
  (``provenance["rung_errors"]``).

The fault-free, deadline-free path runs the exact rung inline with no
extra threads, and an exception there propagates.

Deltas from the reference, each for the port's estimator:

* **the exact rung replays at the request's capacity and admits on
  ``not oom and peak_bytes <= capacity``** (the reference replays
  unbounded and admits on ``peak_bytes <= capacity``). The port's
  allocator simulation reclaims cached segments before it reports an
  out-of-memory, as torch does, so a replay can run out of memory
  while its reserved peak stays at or under the capacity; the port's
  gates have always refused that, and so does the service;
* **an out-of-memory replay is no evidence**: its peak is where the
  replay stopped, not the job's peak, so the decision log does not
  record it;
* **rung 2 never answers below the decision log's monotone bound**:
  a job's live tensors do not shrink as its batch grows, so the
  smallest recorded peak at a batch at or above the request's bounds
  its peak up to the allocator's rounding (which the rung's margin
  covers), and the answer is the larger of the log's interpolation and
  that bound. Peaks are concave in the batch: on an H100, qwen3-32b cut
  to 4 layers at sequence 4096 peaks at 50.58, 67.61 and 74.07 GB
  reserved at batches 1, 2 and 4, where a line or a batch-proportional
  transient under-answers;
* **rung 3 counts the cuBLAS workspaces** the port's estimator (and
  the card) holds, and **bounds a request from its job's
  configuration** when the
  request carries one (``meta["job"]``, a
  :class:`~repro_torch.service.degrade.JobContext`, set by the port's
  gates and the daemon's ``train`` kind), as the reference does for a
  ``meta["plan"]`` context: the bound from the avals alone counts
  64 bytes of transient per input byte, and a language model's inputs
  are token ids a few bytes each;
* an abandoned rung stops at its next stage boundary (the estimator's
  ``tracer`` or ``replay`` checkpoint) instead of finishing its trace
  into the void.

Counter-offers (a rejection with a ``meta["plan"]`` context, or
``decide_serving(plan=...)``) need the remediation planner and raise
``NotImplementedError`` (slice 10), as do host-offload requests;
``mesh_sweep`` and requests with shard factors or collectives need the
sharding module (slice 11).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Sequence

from ..core.cache import GLOBAL_TRACE_CACHE, TraceCache
from ..core.estimator import EstimateReport, XMemEstimator
from ..core.orchestrator import ServingKnobs
from ..core.sweep import SweepPoint, SweepService
from ..obs import CounterDict, Observability
from ..obs import spans as obs_spans
from .degrade import (RUNG_ANALYTIC, RUNG_EXACT, RUNG_SWEEP, DecisionLog,
                      DegradePolicy, RungTimeout, analytic_request_bound,
                      backoff_delays, request_family, request_scalar)
from .faults import TransientFaultError
from .store import TraceStore

#: the rung thread's abandonment flag (set by ``_call_with_deadline``
#: when the deadline passes; read at the estimator's stage checkpoints)
_RUNG = threading.local()


def _not_ported(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (slice {slice_no} of the port)")


@dataclasses.dataclass
class AdmissionRequest:
    """One job to gate: the ``estimate_training`` argument tuple plus
    the device capacity the scheduler would place it on (required: the
    port has no default device size). ``deadline_s`` is this request's
    answer budget — a slow or hung exact estimate is abandoned at the
    deadline and answered from a lower rung (None defers to the
    service-wide default). ``meta["job"]`` (a ``JobContext``) lets the
    analytic rung bound the job from its configuration."""

    job_id: str
    fwd_bwd_fn: Callable
    params: Any
    batch: Any
    update_fn: Callable | None = None
    opt_init_fn: Callable | None = None
    shard_factor_fn: Callable | None = None
    collective_specs: Sequence = ()
    capacity: int | None = None         # device bytes (required)
    probe_min_capacity: bool = False    # also compute min feasible capacity
    deadline_s: float | None = None     # per-request budget
    # host-offload schedule (core.orchestrator.OffloadPlan): not ported
    # (slice 10); a request that carries one raises
    offload: Any | None = None
    # serving-knob signature (ServingKnobs.signature()) — separates
    # degradation-ladder evidence families per serving configuration
    serving: Any | None = None
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AdmissionDecision:
    """The service's answer. ``safe_threshold`` is the (margin-widened)
    estimate — the value round 2 of the paper's protocol validates as a
    max-runnable-memory cap (Eq. 5). ``provenance["source"]`` records
    where stage 1 came from: "memory" (warm cache), "disk" (persistent
    store after a restart), "traced" (cold), or "degraded" (a lower
    rung answered — ``rung``/``margin`` say which and at what widening;
    ``provenance["rung_errors"]`` records why the upper rungs fell)."""

    job_id: str
    admit: bool
    capacity: int
    peak_bytes: int
    peak_tensor_bytes: int
    persistent_bytes: int
    safe_threshold: int
    breakdown: dict
    provenance: dict
    wall_s: float
    min_feasible_capacity: int | None = None
    report: EstimateReport | None = None     # full report (in-process use)
    # ranked feasible alternatives: the planner's (slice 10); always
    # None in the port
    counter_offers: list | None = None
    # degradation provenance
    rung: str = RUNG_EXACT          # which ladder rung answered
    margin: float = 1.0             # safety widening applied to the peak
    raw_peak_bytes: int | None = None   # rung estimate before widening
    deadline_s: float | None = None     # budget this answer honored
    # per-request correlation ID — set only when the service runs with
    # observability enabled; the same ID appears on every span and
    # audit record this decision produced
    correlation_id: str | None = None

    @property
    def degraded(self) -> bool:
        return self.rung != RUNG_EXACT

    def to_json(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "job_id", "admit", "capacity", "peak_bytes",
            "peak_tensor_bytes", "persistent_bytes", "safe_threshold",
            "provenance", "wall_s", "min_feasible_capacity",
            "rung", "margin", "raw_peak_bytes", "deadline_s")}
        d["degraded"] = self.degraded
        d["breakdown"] = {k: v for k, v in self.breakdown.items()
                          if k in ("phase_peaks", "num_blocks",
                                   "liveness_peak", "degraded",
                                   "space_peaks", "offload", "serving")}
        if self.counter_offers is not None:
            d["counter_offers"] = [o.to_json()
                                   for o in self.counter_offers]
        if self.correlation_id is not None:
            d["correlation_id"] = self.correlation_id
        return d


def _provenance(cache: TraceCache | None, before: dict) -> dict:
    """Provenance from the calling thread's OWN counter deltas —
    concurrent decisions on other threads do not bleed into this
    request's hits/misses (``TraceCache.thread_stats``)."""
    if cache is None:
        return {"source": "traced", "trace_cache": {}}
    after = cache.thread_stats()
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    store_hits = after["store_hits"] - before["store_hits"]
    source = ("traced" if misses else
              "disk" if store_hits else "memory")
    return {"source": source,
            "trace_cache": {"hits": hits, "misses": misses,
                            "store_hits": store_hits}}


def _call_with_deadline(fn: Callable[[], Any], timeout: float | None):
    """Run ``fn`` bounded by ``timeout`` seconds. ``None`` runs inline
    (zero overhead). Otherwise ``fn`` runs on a fresh daemon thread and
    a late result is abandoned: :class:`RungTimeout` is raised here,
    and the thread is flagged, so it stops at its next stage checkpoint
    (``AdmissionService._fault_site``) instead of tracing on into the
    void; work it finished before then (a trace landing in the shared
    cache) is kept. A per-call thread (not a pool) so a hung rung can
    never starve other requests' rung execution."""
    if timeout is None:
        return fn()
    box: dict = {}
    done = threading.Event()
    abandoned = threading.Event()
    # ContextVars don't follow a fresh thread — copy the caller's
    # context so the observability span/correlation state (and any
    # other contextvar) survives onto the rung thread
    ctx = contextvars.copy_context()

    def run():
        _RUNG.abandoned = abandoned
        try:
            box["value"] = ctx.run(fn)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name="xmem-rung")
    t.start()
    if not done.wait(timeout):
        abandoned.set()
        raise RungTimeout(f"rung exceeded {timeout:.3f}s budget")
    if "error" in box:
        raise box["error"]
    return box["value"]


class AdmissionService:
    """Long-running estimation service (see module docstring).

    ``store_dir`` enables the persistent trace store; ``workers`` sizes
    the thread pool behind ``submit``; ``processes`` is forwarded to the
    underlying ``SweepService`` replay fan-out. ``degrade`` configures
    the degradation ladder (margins, retries, default deadline);
    ``deadline_s`` is shorthand for its ``default_deadline_s``.
    ``faults`` attaches a :class:`~repro_torch.service.faults.FaultPlan`
    (tests / chaos replay; see also :meth:`inject_faults`). The default
    estimator factory is ``XMemEstimator.for_torch_gpu``; a service
    built with neither ``cache`` nor ``store_dir`` shares
    ``GLOBAL_TRACE_CACHE``.
    """

    def __init__(self, estimator_factory: Callable[..., XMemEstimator]
                 | None = None, *, store_dir: str | None = None,
                 workers: int = 2, processes: int = 0,
                 cache: TraceCache | None = None,
                 store_max_entries: int = 256,
                 degrade: DegradePolicy | None = None,
                 deadline_s: float | None = None,
                 faults=None, obs: Observability | None = None):
        self._factory = estimator_factory or XMemEstimator.for_torch_gpu
        if cache is not None and store_dir is not None:
            # attaching the service's store to a caller-owned (possibly
            # process-global) cache would silently make every estimator
            # in the process disk-backed — refuse instead
            raise ValueError(
                "pass either cache= (bring your own, optionally with its "
                "own store) or store_dir=, not both")
        store = None
        if store_dir is not None:
            store = TraceStore(store_dir, max_entries=store_max_entries)
        if cache is not None:
            self.cache = cache
        elif store is not None:
            self.cache = TraceCache(store=store)
        else:
            # no explicit cache/store: share the process-global cache so
            # one-off service instances (per-gate construction) stay warm
            self.cache = GLOBAL_TRACE_CACHE
        self.degrade = degrade or DegradePolicy()
        if deadline_s is not None:
            self.degrade = dataclasses.replace(
                self.degrade, default_deadline_s=deadline_s)
        self.faults = faults
        self.log = DecisionLog()
        self.workers = max(int(workers), 1)
        self._processes = processes
        self._pool: ThreadPoolExecutor | None = None
        self._tls = threading.local()
        self._lock = threading.Lock()
        # decide_sweep runs on ONE estimator (SweepService is stateful)
        # — serialize it; decide()/submit() stay concurrent
        self._sweep_lock = threading.Lock()
        # every service owns an Observability handle. The
        # metrics registry is the SINGLE source for the service
        # counters — stats()/health() and the daemon's metrics kind
        # all read the same objects; spans/audit/correlation IDs only
        # activate when the handle is enabled (default: disabled).
        self.obs = obs if obs is not None else Observability(enabled=False)
        reg = self.obs.registry
        self._m_requests = reg.counter(
            "xmem_service_requests_total", "decisions served")
        self.rung_counts = CounterDict(
            (RUNG_EXACT, RUNG_SWEEP, RUNG_ANALYTIC), registry=reg,
            name="xmem_service_rung_total", label="rung",
            help="decisions answered per degradation-ladder rung")
        self._m_retries = reg.counter(
            "xmem_service_retries_total",
            "transient-fault retries on the exact rung")
        self._m_timeouts = reg.counter(
            "xmem_service_timeouts_total", "rung deadline expiries")
        self._m_abandoned = reg.counter(
            "xmem_service_abandoned_rungs_total",
            "rungs abandoned at the deadline")
        self._m_in_flight = reg.gauge(
            "xmem_service_in_flight", "decisions currently executing")
        self._m_decide_s = reg.histogram(
            "xmem_service_decide_seconds", "decide wall time")
        reg.register_collector("xmem_trace_cache",
                               lambda: self.cache.stats())
        reg.register_collector("xmem_decision_log",
                               lambda: self.log.stats())
        reg.register_collector(
            "xmem_faults",
            lambda: self.faults.stats() if self.faults is not None
            else {})
        self.sweep = SweepService(self._make_estimator(),
                                  processes=processes)

    # legacy counter surface — reads delegate to the registry so the
    # stats/health dict shapes (pinned by tests and old callers) can
    # never drift from the metrics export
    @property
    def requests_served(self) -> int:
        return self._m_requests.value

    @property
    def retry_count(self) -> int:
        return self._m_retries.value

    @property
    def timeout_count(self) -> int:
        return self._m_timeouts.value

    @property
    def abandoned_rungs(self) -> int:
        return self._m_abandoned.value

    @property
    def _in_flight(self) -> int:
        return self._m_in_flight.value

    # -- estimator plumbing --------------------------------------------------
    def _make_estimator(self) -> XMemEstimator:
        est = self._factory(trace_cache=self.cache)
        if est.trace_cache is not self.cache:
            raise ValueError("admission service needs a fastpath "
                             "estimator sharing the service cache")
        # route the estimator's stage checkpoints through the service's
        # (swappable) fault plan — a no-op attribute read when unset
        est.checkpoint = self._fault_site
        return est

    def _fault_site(self, site: str) -> None:
        plan = self.faults
        if plan is not None:
            plan.check(site)
        abandoned = getattr(_RUNG, "abandoned", None)
        if abandoned is not None and abandoned.is_set():
            raise RungTimeout(f"rung abandoned at its deadline ({site})")

    @property
    def estimator(self) -> XMemEstimator:
        """Per-thread estimator over the shared trace cache."""
        est = getattr(self._tls, "est", None)
        if est is None:
            est = self._tls.est = self._make_estimator()
        return est

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="xmem-admit")
            return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()
        self.sweep.close()
        self.obs.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- fault plumbing ------------------------------------------------------
    def set_faults(self, plan) -> None:
        """Attach/detach a fault plan on the service AND its persistent
        store (if any)."""
        self.faults = plan
        store = getattr(self.cache, "store", None)
        if store is not None:
            store.faults = plan

    @contextlib.contextmanager
    def inject_faults(self, plan):
        """Scoped fault injection — chaos replays wrap themselves here
        so a failed assertion never leaves the service poisoned. Exit
        cancels the plan: workers stranded in an injected hang (their
        rung was abandoned at the deadline) wake immediately instead of
        sleeping out the full ``hang_s``."""
        prev = self.faults
        store = getattr(self.cache, "store", None)
        prev_store = store.faults if store is not None else None
        if plan is not None and hasattr(plan, "arm"):
            plan.arm()
        self.set_faults(plan)
        try:
            yield self
        finally:
            self.faults = prev
            if store is not None:
                store.faults = prev_store
            if plan is not None and hasattr(plan, "cancel"):
                plan.cancel()

    def _deadline_for(self, req: AdmissionRequest) -> float | None:
        if req.deadline_s is not None:
            return req.deadline_s
        return self.degrade.default_deadline_s

    def _count_rung(self, rung: str, served: int = 1) -> None:
        self._m_requests.inc(served)
        self.rung_counts.inc(rung, served)

    def _audit_decision(self, decision: AdmissionDecision,
                        via: str = "decide") -> None:
        """One audit record per decision (kind="decide") carrying the
        correlation ID, cache provenance, rung, and chosen offer — the
        offline reject→plan→retry reconstruction substrate."""
        obs = self.obs
        if obs.audit is None:
            return
        rec = {"via": via, "job_id": decision.job_id,
               "admit": decision.admit,
               "capacity": decision.capacity,
               "peak_bytes": decision.peak_bytes,
               "safe_threshold": decision.safe_threshold,
               "rung": decision.rung, "margin": decision.margin,
               "degraded": decision.degraded,
               "source": decision.provenance.get("source"),
               "wall_s": decision.wall_s}
        offers = decision.counter_offers
        if offers is not None:
            rec["n_offers"] = len(offers)
            if offers:
                top = offers[0].to_json()
                rec["chosen_offer"] = {
                    k: top.get(k) for k in
                    ("knob", "global_batch", "microbatches",
                     "peak_bytes", "slowdown")}
        obs.record("decide", correlation_id=decision.correlation_id,
                   **rec)

    # -- decisions -----------------------------------------------------------
    @staticmethod
    def _check_request(req: AdmissionRequest) -> None:
        """Caller errors, raised before any rung runs."""
        if req.capacity is None:
            raise ValueError(f"request {req.job_id!r} has no capacity "
                             f"(the device's bytes)")
        if req.offload is not None:
            raise _not_ported("host offload", 10)
        if req.shard_factor_fn is not None or req.collective_specs:
            raise _not_ported("sharded estimates (shard factors, "
                              "collectives)", 11)

    def decide(self, req: AdmissionRequest) -> AdmissionDecision:
        """Synchronous decision for one request. With a fault plan or a
        deadline, estimator/store/timeout failures degrade down the
        rung ladder; fault-free and deadline-free, the exact rung runs
        inline and its exceptions propagate, as do caller errors."""
        self._check_request(req)
        t0 = time.perf_counter()
        deadline_s = self._deadline_for(req)
        self._m_in_flight.inc()
        try:
            # mint the per-request correlation ID and open
            # the root span. decide() executes ON the worker thread
            # for submit()/decide_many(), so the context var reaches
            # every layer this decision touches. Observers never feed
            # back into the decision — the instrumented path stays
            # bit-identical.
            with self.obs.request("decide", job_id=req.job_id) as cid:
                if deadline_s is None and self.faults is None:
                    # fault-free fast path: exact rung inline, no
                    # extra threads — bit-identical to the pre-ladder
                    # service
                    decision = self._decide_exact(req, t0, None)
                    decision = self._attach_counter_offers(req, decision)
                else:
                    decision = self._decide_ladder(req, deadline_s, t0)
                    if not decision.degraded:
                        decision = self._attach_counter_offers(req,
                                                               decision)
                if cid is not None:
                    decision.correlation_id = cid
                self._m_decide_s.observe(decision.wall_s)
                self._audit_decision(decision)
                return decision
        finally:
            self._m_in_flight.dec()

    def _decide_exact(self, req: AdmissionRequest, t0: float,
                      deadline_s: float | None,
                      timeout: float | None = None) -> AdmissionDecision:
        """The exact rung: full-fidelity estimate (optionally bounded by
        ``timeout`` on a side thread), decision-log recording for the
        sweep rung's future evidence."""
        def run():
            est = self.estimator
            cache = est.trace_cache
            before = cache.thread_stats()
            rep = est.estimate_training(
                req.fwd_bwd_fn, req.params, req.batch,
                update_fn=req.update_fn, opt_init_fn=req.opt_init_fn,
                capacity=req.capacity)
            min_cap = None
            if req.probe_min_capacity:
                min_cap = est.min_feasible_capacity(
                    req.fwd_bwd_fn, req.params, req.batch, report=rep)
            return rep, _provenance(cache, before), min_cap

        with obs_spans.span("rung.exact", job_id=req.job_id):
            rep, prov, min_cap = _call_with_deadline(run, timeout)
        self._count_rung(RUNG_EXACT)
        self._record_exact(req, rep)
        decision = self._decision(req, rep, prov,
                                  time.perf_counter() - t0, min_cap)
        decision.deadline_s = deadline_s
        return decision

    def _record_exact(self, req: AdmissionRequest,
                      rep: EstimateReport) -> None:
        if rep.oom:
            return      # the replay stopped at the capacity: no peak
        try:
            self.log.record(request_family(req), request_scalar(req),
                            rep.peak_bytes, rep.persistent_bytes)
        except Exception:   # noqa: BLE001 — evidence is best-effort
            pass

    def _decide_ladder(self, req: AdmissionRequest,
                       deadline_s: float | None,
                       t0: float) -> AdmissionDecision:
        """Walk the rungs: exact (with capped-backoff retries on
        transient faults, abandoned at the deadline) -> sweep-log ->
        analytic. See module docstring of ``degrade``."""
        deadline_at = None if deadline_s is None else t0 + deadline_s
        errors: list[str] = []
        delays = backoff_delays(self.degrade, req.job_id)
        attempt = 0
        while True:
            remaining = None
            if deadline_at is not None:
                remaining = deadline_at - time.perf_counter()
                if remaining <= 0:
                    errors.append("deadline exhausted before exact replay")
                    break
            try:
                return self._decide_exact(req, t0, deadline_s,
                                          timeout=remaining)
            except TransientFaultError as e:
                errors.append(f"transient: {e}")
                if attempt >= len(delays):
                    errors.append("retries exhausted")
                    break
                delay = delays[attempt]
                attempt += 1
                if remaining is not None:
                    # never sleep past the budget — keep enough of it to
                    # still answer from a lower rung
                    delay = max(min(delay, remaining * 0.5), 0.0)
                self._m_retries.inc()
                obs_spans.event("rung.retry", attempt=attempt)
                time.sleep(delay)
            except RungTimeout as e:
                errors.append(f"timeout: {e}")
                self._m_timeouts.inc()
                self._m_abandoned.inc()
                break
            except Exception as e:   # noqa: BLE001 — rung falls, never propagates
                errors.append(f"{type(e).__name__}: {e}")
                break
        return self._decide_degraded(req, errors, t0, deadline_s)

    def _decide_degraded(self, req: AdmissionRequest, errors: list[str],
                         t0: float, deadline_s: float | None,
                         workspaces: int = 2) -> AdmissionDecision:
        """Rungs 2-3: answer from the decision log or the analytic
        bound. Pure CPU arithmetic — never traces, never raises. The
        analytic bound adds the estimator's cuBLAS workspaces, which
        the exact rung's replay holds (``workspaces``: one per thread
        that multiplies, two in a training step, one in a serving
        step)."""
        got = None
        try:
            got = self.log.lookup(request_family(req), request_scalar(req))
        except Exception as e:   # noqa: BLE001 — evidence lookup is best-effort
            errors.append(f"sweep-log: {type(e).__name__}: {e}")
        if got is not None:
            raw, how = got
            bound = self.log.monotone_bound(request_family(req),
                                            request_scalar(req))
            if bound is not None and bound > raw:
                raw, how = bound, f"{how}+monotone"
            return self._degraded_decision(req, raw, RUNG_SWEEP, how,
                                           errors, t0, deadline_s)
        errors.append("sweep-log: no evidence for this job family")
        try:
            raw = analytic_request_bound(
                req, self.log, workspace_bytes=workspaces
                * self.estimator.cublas_workspace)
            how = "bound"
        except Exception as e:   # noqa: BLE001 — last rung must answer
            errors.append(f"analytic: {type(e).__name__}: {e}")
            raw, how = req.capacity + 1, "refuse"  # unknowable: never admit
        return self._degraded_decision(req, raw, RUNG_ANALYTIC, how,
                                       errors, t0, deadline_s)

    def _degraded_decision(self, req: AdmissionRequest, raw_peak: int,
                           rung: str, how: str, errors: list[str],
                           t0: float, deadline_s: float | None
                           ) -> AdmissionDecision:
        margin = self.degrade.margin_for(rung)
        peak = int(math.ceil(raw_peak * margin))
        obs_spans.event(f"rung.{rung}", derived=how, margin=margin)
        prov = {"source": "degraded", "rung": rung, "margin": margin,
                "derived": how, "rung_errors": list(errors),
                "trace_cache": {}}
        self._count_rung(rung)
        return AdmissionDecision(
            job_id=req.job_id,
            admit=peak <= req.capacity,
            capacity=req.capacity,
            peak_bytes=peak,
            peak_tensor_bytes=int(raw_peak),
            persistent_bytes=0,
            safe_threshold=peak,
            breakdown={"degraded": True},
            provenance=prov,
            wall_s=time.perf_counter() - t0,
            rung=rung, margin=margin, raw_peak_bytes=int(raw_peak),
            deadline_s=deadline_s)

    def _attach_counter_offers(self, req: AdmissionRequest,
                               decision: AdmissionDecision
                               ) -> AdmissionDecision:
        """A rejection whose request carries a structured plan context
        (``meta["plan"]``) would come back with ranked counter-offers
        from the remediation planner, which is not ported: such a
        rejection raises. Degraded decisions skip planning, as in the
        reference."""
        ctx = req.meta.get("plan") if req.meta else None
        if ctx is None or decision.admit or decision.degraded:
            return decision
        raise _not_ported("counter-offers (the remediation planner)", 10)

    def decide_serving(self, job_id: str, decode_fn: Callable, params,
                       cache_tree, batch, *, capacity: int,
                       shard_factor_fn=None,
                       deadline_s: float | None = None,
                       mix=None, stream=None, knobs=None,
                       kv_bytes_per_token: int | None = None,
                       resident_bytes_per_request: int = 0,
                       plan=None) -> AdmissionDecision:
        """Serving decision — the ``launch/serve.py`` gate.

        Two modes share one cached decode trace:

        * **static** (no ``mix``/``stream``): the original single-phase
          estimate of a decode step with a persistent monolithic cache;
        * **request-driven**: pass a ``RequestMix`` (or a concrete
          ``RequestStream``) plus ``knobs``/``kv_bytes_per_token`` and
          the decision gates on the continuous-batching worst-case
          peak, with the full
          :class:`~repro_torch.core.estimator.ServingEstimate` under
          ``breakdown["serving"]`` (whitelisted onto the wire).

        Both replay at ``capacity`` and admit on ``not oom and
        peak_bytes <= capacity``, as ``decide`` does. Degrades like
        ``decide``: a failed or over-deadline estimate is answered from
        the analytic rung over (params + cache + batch) avals, with
        serving knobs separating evidence families. Serving
        counter-offers (``plan``) need the planner (slice 10) and
        raise."""
        if plan is not None:
            raise _not_ported("serving counter-offers (the remediation "
                              "planner)", 10)
        if shard_factor_fn is not None:
            raise _not_ported("sharded serving estimates", 11)
        t0 = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.degrade.default_deadline_s
        if stream is None and mix is not None:
            stream = mix.stream()
        if stream is not None and kv_bytes_per_token is None:
            raise ValueError(
                "request-driven serving decisions need kv_bytes_per_token")
        if stream is not None and knobs is None:
            knobs = ServingKnobs()
        knob_sig = knobs.signature() if knobs is not None else None

        def run():
            est = self.estimator
            cache = est.trace_cache
            before = cache.thread_stats()
            if stream is not None:
                se = est.estimate_request_stream(
                    decode_fn, params, cache_tree, batch, stream=stream,
                    knobs=knobs, kv_bytes_per_token=kv_bytes_per_token,
                    resident_bytes_per_request=resident_bytes_per_request,
                    capacity=capacity)
                rep = EstimateReport(
                    peak_bytes=se.worst_case_peak_bytes,
                    peak_tensor_bytes=se.steady_state_peak_bytes,
                    persistent_bytes=se.persistent_bytes,
                    oom=se.oom, sim=se.sim,
                    breakdown={"num_blocks": se.breakdown["num_blocks"],
                               "serving": se.to_json()},
                    wall_time_s=se.wall_time_s,
                    num_events=se.num_events)
            else:
                rep = est.estimate_serving(decode_fn, params, cache_tree,
                                           batch, capacity=capacity)
            return rep, _provenance(cache, before)

        req = AdmissionRequest(job_id, decode_fn, params, batch,
                               capacity=capacity, deadline_s=deadline_s,
                               serving=knob_sig)
        self._m_in_flight.inc()
        try:
            with self.obs.request("serve", job_id=job_id) as cid:
                decision = None
                if deadline_s is None and self.faults is None:
                    rep, prov = run()
                else:
                    try:
                        rep, prov = _call_with_deadline(run, deadline_s)
                    except Exception as e:   # noqa: BLE001 — degrade, never fail
                        errors = [f"{type(e).__name__}: {e}"]
                        if isinstance(e, RungTimeout):
                            self._m_timeouts.inc()
                            self._m_abandoned.inc()
                        # the resident KV cache is persistent state:
                        # count it with the params for the aval bound
                        proxy = AdmissionRequest(
                            job_id, decode_fn, (params, cache_tree),
                            batch, capacity=capacity, serving=knob_sig)
                        decision = self._decide_degraded(
                            proxy, errors, t0, deadline_s, workspaces=1)
                if decision is None:
                    self._count_rung(RUNG_EXACT)
                    decision = self._decision(req, rep, prov,
                                              time.perf_counter() - t0,
                                              None)
                    decision.deadline_s = deadline_s
                if cid is not None:
                    decision.correlation_id = cid
                self._m_decide_s.observe(decision.wall_s)
                self._audit_decision(decision, via="serve")
                return decision
        finally:
            self._m_in_flight.dec()

    def _decision(self, req: AdmissionRequest, rep: EstimateReport,
                  provenance: dict, wall_s: float,
                  min_cap: int | None) -> AdmissionDecision:
        provenance.setdefault("rung", RUNG_EXACT)
        provenance.setdefault("margin", 1.0)
        return AdmissionDecision(
            job_id=req.job_id,
            admit=not rep.oom and rep.peak_bytes <= req.capacity,
            capacity=req.capacity,
            peak_bytes=rep.peak_bytes,
            peak_tensor_bytes=rep.peak_tensor_bytes,
            persistent_bytes=rep.persistent_bytes,
            safe_threshold=rep.peak_bytes,
            breakdown=rep.breakdown,
            provenance=provenance,
            wall_s=wall_s,
            min_feasible_capacity=min_cap,
            report=rep,
            raw_peak_bytes=rep.peak_bytes)

    def submit(self, req: AdmissionRequest) -> "Future[AdmissionDecision]":
        """Concurrent decision: runs on the service's worker pool."""
        self._check_request(req)
        return self._get_pool().submit(self.decide, req)

    def decide_many(self, reqs: Sequence[AdmissionRequest]
                    ) -> list[AdmissionDecision]:
        """Fan a batch of independent requests over the worker pool.
        Each request keeps its own deadline budget (measured from when
        its decision starts executing)."""
        return [f.result() for f in [self.submit(r) for r in reqs]]

    def decide_sweep(self, reqs: Sequence[AdmissionRequest]
                     ) -> list[AdmissionDecision]:
        """Batched decisions through ``SweepService.estimate_many`` —
        requests sharing structure (a batch-size admission sweep) pay
        three probe traces, the rest interpolate. ``meta["plan"]``
        contexts are ignored on this path (a planner search per
        rejected point would defeat the batching); route individual
        rejections through ``decide`` for counter-offers.

        Deadline budget: the tightest request deadline bounds the whole
        batched sweep; a sweep that fails or runs past it is abandoned
        (the sweep estimator is rebuilt — the stranded worker finishes
        into the void) and EVERY point is answered from the degraded
        rungs instead."""
        for r in reqs:
            self._check_request(r)
        t0 = time.perf_counter()
        cache = self.cache
        deadlines = [self._deadline_for(r) for r in reqs]
        bounded = [d for d in deadlines if d is not None]
        timeout = min(bounded) if bounded else None
        points = [SweepPoint(
            r.fwd_bwd_fn, r.params, r.batch, update_fn=r.update_fn,
            opt_init_fn=r.opt_init_fn, capacity=r.capacity)
            for r in reqs]

        def run_sweep():
            before = cache.thread_stats()
            result = self.sweep.estimate_many(points)
            return result, _provenance(cache, before)

        # one correlation ID covers the whole batched sweep — the
        # points share probe traces, so their spans and audit records
        # genuinely belong to one operation
        with self.obs.request("sweep") as cid:
            decisions = None
            with self._sweep_lock:
                if timeout is None and self.faults is None:
                    result, prov = run_sweep()
                else:
                    try:
                        result, prov = _call_with_deadline(run_sweep,
                                                           timeout)
                    except Exception as e:   # noqa: BLE001 — degrade every point
                        errors = [f"{type(e).__name__}: {e}"]
                        if isinstance(e, RungTimeout):
                            self._m_timeouts.inc()
                            self._m_abandoned.inc()
                            # the abandoned worker still owns the old
                            # sweep estimator — swap in a fresh one for
                            # later calls
                            self.sweep = SweepService(
                                self._make_estimator(),
                                processes=self._processes)
                        decisions = [
                            self._decide_degraded(r, list(errors), t0, d)
                            for r, d in zip(reqs, deadlines)]
            if decisions is None:
                prov["sweep"] = {k: result.stats[k] for k in
                                 ("points", "traced", "interpolated",
                                  "fallback", "pooled")}
                # per-decision wall_s is the AMORTIZED share of the
                # batched sweep (summing per-job costs must not
                # over-count the sweep N times); each decision gets its
                # own provenance copy so callers mutating one cannot
                # alter siblings
                wall = (time.perf_counter() - t0) / max(len(reqs), 1)
                self._count_rung(RUNG_EXACT, served=len(reqs))
                decisions = []
                for r, rep, d in zip(reqs, result.reports, deadlines):
                    self._record_exact(r, rep)
                    dec = self._decision(r, rep, copy.deepcopy(prov),
                                         wall, None)
                    dec.deadline_s = d
                    decisions.append(dec)
            for dec in decisions:
                if cid is not None:
                    dec.correlation_id = cid
                self._audit_decision(dec, via="sweep")
            return decisions

    def mesh_sweep(self, *args, **kwargs):
        """Per-device estimates over a mesh-topology grid: needs the
        sharding module, which is not ported."""
        raise _not_ported("mesh sweeps (distributed/sharding.py)", 11)

    def stats(self) -> dict:
        return {"requests_served": self.requests_served,
                "workers": self.workers,
                "rungs": dict(self.rung_counts),
                "trace_cache": self.cache.stats()}

    def health(self) -> dict:
        """Liveness/diagnostics surface for the daemon's ``health``
        request kind: rung counters, degradation totals, store state
        (incl. quarantine/recovery), queue depth and in-flight count."""
        with self._lock:
            pool = self._pool
            d = {
                "status": "ok",
                "requests_served": self.requests_served,
                "in_flight": self._in_flight,
                "queue_depth": (pool._work_queue.qsize()
                                if pool is not None else 0),
                "workers": self.workers,
                "rungs": dict(self.rung_counts),
                "degraded": (self.rung_counts[RUNG_SWEEP]
                             + self.rung_counts[RUNG_ANALYTIC]),
                "retries": self.retry_count,
                "timeouts": self.timeout_count,
                "abandoned_rungs": self.abandoned_rungs,
                "deadline_s": self.degrade.default_deadline_s,
            }
        d["decision_log"] = self.log.stats()
        d["trace_cache"] = self.cache.stats()
        if self.faults is not None:
            d["faults"] = self.faults.stats()
        return d

"""Host offload, ``calibrate`` and the frozen reference pipeline in the
port's estimator, against the JAX package's semantics, on the CPU.

* **no-offload bit-identity**: no plan and a disabled plan give the same
  estimate, equal to the port's estimates before host offload was ported
  (pinned below, exact), with no space keys;
* **offload semantics** (the reference's ``tests/test_offload.py``): the
  device peak falls, transfer bytes grow with the fraction, the pageable
  space replays with its own policy, ``min_feasible_capacity`` counts the
  device space, the reference pipeline rejects offload;
* **the same composed lifecycles through both packages**: the port's
  ``apply_offload`` and multi-space replay equal the JAX package's on
  one composition: device peak, ``space_peaks`` and transfer bytes
  (exact);
* **planner and service**: offload offers cost zero fresh traces and
  reproduce; offload requests are a family of their own in the decision
  log; the analytic bound stays an upper bound under offload; the
  daemon's ``offload`` object;
* ``calibrate`` gives the JAX package's scale on the same (report,
  truth) samples (exact);
* ``fastpath=False`` equals the fast path on the smoke families, every
  estimate field (exact).
"""
import dataclasses
import functools
import json
import types

import pytest
import torch

import torch_service_jobs as jobs
from repro.core import estimator as jestimator
from repro.core import orchestrator as jorch
from repro.core import simulator as jsim
from repro.core.allocator import CUDA_CACHING as J_CUDA_CACHING
from repro.core.events import BlockKind as JKind
from repro.core.events import BlockLifecycle as JBlock
from repro.core.events import MemorySpace as JSpace
from repro.core.events import Phase as JPhase
from repro_torch.configs import get_smoke
from repro_torch.configs.base import smoke_shape
from repro_torch.configs.registry import input_specs
from repro_torch.core.allocator import (CUDA_CACHING, CUDA_CACHING_TORCH,
                                        TPU_ARENA)
from repro_torch.core.analyzer import classify_blocks
from repro_torch.core.cache import TraceCache
from repro_torch.core.estimator import XMemEstimator, calibration_scale
from repro_torch.core.events import BlockKind, MemorySpace
from repro_torch.core.orchestrator import (MemoryOrchestrator, OffloadPlan,
                                           OrchestratorPolicy)
from repro_torch.core.simulator import MemorySimulator, split_blocks_by_space
from repro_torch.launch import served
from repro_torch.launch.analytic import analytic_peak_bytes
from repro_torch.models import model as M
from repro_torch.plan import PlanSpace, RemediationPlanner
from repro_torch.service import AdmissionRequest, AdmissionService
from repro_torch.service.degrade import request_family
from repro_torch.train import TrainPolicy, make_estimator_hooks

OFFLOAD_FULL = OffloadPlan(optimizer_state=True, activations=0.5,
                           min_block_bytes=4096)
# the toy job of torch_service_jobs at widths whose saved activations
# are worth offloading
D, H, B = 256, 1024, 1024


def _shapes():
    params = {f"w{i}": torch.empty((D, H) if i % 2 == 0 else (H, D),
                                   device="meta") for i in range(jobs.L)}
    data = {"x": torch.empty((B, D), device="meta"),
            "y": torch.empty((B, D), device="meta")}
    return params, data


def _estimator(offload=None, *, policy=CUDA_CACHING, fastpath=True,
               workspace=0):
    opolicy = OrchestratorPolicy(
        grad_release="after_update", donate_params=False,
        donate_opt_state=False, fusion_folding=False,
        optimizer_upcast_coexist=False, offload=offload)
    return XMemEstimator(allocator_policy=policy,
                         orchestrator_policy=opolicy,
                         trace_cache=TraceCache(), fastpath=fastpath,
                         cublas_workspace=workspace)


def _estimate(offload=None, **kw):
    fwd, upd, init = jobs.make_hooks()
    params, batch = _shapes()
    return _estimator(offload, **kw).estimate_training(
        fwd, params, batch, update_fn=upd, opt_init_fn=init)


# ---------------------------------------------------------------------------
# the port's estimates before host offload was ported (the GPU preset,
# sequence 48, batch 8): (arch, capacity, peak, tensor peak, persistent,
# oom, liveness peak)
PINNED = [
    ("qwen3-32b", None, 71303168, 70683648, 1068804, False, 70675216),
    ("qwen3-32b", 69206016, 69206016, 68909056, 1068804, True, 70675216),
    ("phi3.5-moe-42b-a6.6b", None, 73400320, 72225280, 1565828, False,
     72219920),
    ("phi3.5-moe-42b-a6.6b", 69206016, 69206016, 68803072, 1565828, True,
     72219920),
    ("internvl2-1b", None, 71303168, 70383616, 1068164, False, 70378000),
    ("internvl2-1b", 69206016, 69206016, 69054464, 1068164, True, 70378000),
]


@pytest.mark.parametrize("row", PINNED, ids=lambda r: f"{r[0]}-{r[1]}")
def test_no_offload_estimates_are_unchanged(row):
    arch, cap, *want = row
    cfg = get_smoke(arch)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = M.abstract_params(cfg)
    batch = input_specs(cfg, smoke_shape(48, 8))
    for offload in (None, OffloadPlan()):
        est = XMemEstimator.for_torch_gpu(trace_cache=TraceCache())
        est.orchestrator.policy = dataclasses.replace(
            est.orchestrator.policy, offload=offload)
        r = est.estimate_training(fwd, params, batch, upd, init,
                                  capacity=cap)
        assert [r.peak_bytes, r.peak_tensor_bytes, r.persistent_bytes,
                r.oom, r.breakdown["liveness_peak"]] == want
        assert "space_peaks" not in r.breakdown
        assert "offload" not in r.breakdown


@pytest.mark.parametrize("policy", [CUDA_CACHING, CUDA_CACHING_TORCH])
def test_disabled_plan_is_the_no_offload_estimate(policy):
    base = _estimate(None, policy=policy)
    got = _estimate(OffloadPlan(), policy=policy)
    assert (got.peak_bytes, got.peak_tensor_bytes, got.persistent_bytes) \
        == (base.peak_bytes, base.peak_tensor_bytes, base.persistent_bytes)
    assert got.breakdown == base.breakdown
    assert "space_peaks" not in got.breakdown


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [TPU_ARENA, CUDA_CACHING])
def test_offload_reduces_device_peak(policy):
    """The live device peak falls. Reserved bytes (the arena's rounded
    live bytes) fall with it; the caching allocator's segments stay
    reserved from the first iteration, before offloaded optimizer state
    exists, so there they may not."""
    base = _estimate(None, policy=policy)
    off = _estimate(OFFLOAD_FULL, policy=policy)
    assert off.peak_tensor_bytes < base.peak_tensor_bytes
    if policy is TPU_ARENA:
        assert off.peak_bytes < base.peak_bytes
    assert off.peak_bytes <= base.peak_bytes
    peaks = off.breakdown["space_peaks"]
    assert peaks["device_hbm"] == off.peak_bytes
    assert peaks["host_pinned"] > 0
    stats = off.breakdown["offload"]
    assert stats["opt_state_blocks"] > 0
    assert stats["activation_blocks"] > 0
    assert stats["transfer_bytes_per_iter"] > 0
    assert stats["space"] == "host_pinned"


def test_transfer_bytes_monotone_in_fraction():
    prev = -1
    for frac in (0.25, 0.5, 1.0):
        rep = _estimate(OffloadPlan(activations=frac, min_block_bytes=4096))
        cur = rep.breakdown["offload"]["activation_bytes"]
        assert cur >= prev
        prev = cur
    assert prev > 0


def test_pageable_space_uses_malloc_policy():
    plan = dataclasses.replace(OFFLOAD_FULL,
                               space=MemorySpace.HOST_PAGEABLE)
    rep = _estimate(plan)
    host = rep.sim.stats["host_spaces"]["host_pageable"]
    assert host["policy"] == "host_pageable"
    assert rep.breakdown["space_peaks"]["host_pageable"] > 0


def test_reference_path_rejects_offload():
    with pytest.raises(NotImplementedError, match="fast path"):
        _estimate(OFFLOAD_FULL, fastpath=False)


def test_min_feasible_capacity_is_device_space():
    fwd, upd, init = jobs.make_hooks()
    params, batch = _shapes()
    est = _estimator(OFFLOAD_FULL, policy=TPU_ARENA)
    rep = est.estimate_training(fwd, params, batch, update_fn=upd,
                                opt_init_fn=init)
    mfc = est.min_feasible_capacity(fwd, params, batch, update_fn=upd,
                                    opt_init_fn=init, report=rep)
    assert mfc >= rep.peak_bytes
    host = rep.breakdown["space_peaks"]["host_pinned"]
    # below the device peak plus the host's: the host space is not counted
    assert mfc < rep.peak_bytes + host
    groups = split_blocks_by_space(rep.composition)
    assert not MemorySimulator(TPU_ARENA, capacity=mfc).replay(
        groups[MemorySpace.DEVICE_HBM]).oom


def test_workspaces_keep_apart_from_the_staging_copies():
    """The GPU preset's cuBLAS workspaces and the offload pass's staging
    copies have ids of their own: a staging copy's free never releases a
    workspace (the workspaces hold 64 MiB through every replay)."""
    off = _estimate(OFFLOAD_FULL, workspace=32 << 20,
                    policy=CUDA_CACHING_TORCH)
    base = _estimate(None, workspace=32 << 20, policy=CUDA_CACHING_TORCH)
    comp = off.composition
    ids = [b.block_id for part in (comp.prefix, comp.cycle, comp.suffix)
           for b in part]
    assert len(ids) == len(set(ids))
    assert off.peak_tensor_bytes >= 2 * (32 << 20)
    assert off.peak_bytes <= base.peak_bytes


# ---------------------------------------------------------------------------
def _composed(est, offload):
    """The port's composed, classified and orchestrated lifecycles of the
    toy job (the offload pass's input) and the iteration markers."""
    fwd_fn, upd_fn, init_fn = jobs.make_hooks()
    params, batch = _shapes()
    fwd, upd, init = est.trace_phases(fwd_fn, params, batch, upd_fn, init_fn)
    pb, meta = est._compose_periodic(fwd, upd, init)
    concrete = classify_blocks(
        pb.prefix + pb.cycle + pb.suffix,
        frozenset(b.size for b in fwd.input_blocks
                  if b.kind is BlockKind.PARAM))
    concrete = est.orchestrator.run(
        concrete, iteration_ends=meta["iteration_ends"],
        update_start=meta["update_start"],
        next_bwd_start=meta["update_start"], num_iterations=3)
    us = {it: t for it, t in meta["update_start"].items()
          if it in meta["bwd_start"]}
    return concrete, us, meta["iteration_ends"]


def _to_jax(b):
    return JBlock(b.block_id, b.size, b.alloc_t, b.free_t, b.iteration,
                  JPhase(b.phase.value), b.op, b.scope,
                  JKind(b.block_kind.value), b.shard_factor, b.shape,
                  JSpace(b.space.value))


@pytest.mark.parametrize("plan", [
    OFFLOAD_FULL, OffloadPlan(optimizer_state=True),
    OffloadPlan(activations=1.0, min_block_bytes=0),
    dataclasses.replace(OFFLOAD_FULL, space=MemorySpace.HOST_PAGEABLE)])
def test_offload_pass_equals_the_reference_on_the_same_lifecycles(plan):
    est = _estimator()
    blocks, us, ends = _composed(est, plan)
    port_orch = MemoryOrchestrator(OrchestratorPolicy(offload=plan))
    got, got_stats = port_orch.apply_offload(blocks, us, ends)
    jplan = jorch.OffloadPlan(
        optimizer_state=plan.optimizer_state, activations=plan.activations,
        space=JSpace(plan.space.value), min_block_bytes=plan.min_block_bytes,
        stage_ticks=plan.stage_ticks)
    jorch_ = jorch.MemoryOrchestrator(jorch.OrchestratorPolicy(offload=jplan))
    want, want_stats = jorch_.apply_offload([_to_jax(b) for b in blocks],
                                            us, ends)
    assert got_stats == want_stats
    assert [_to_jax(b) for b in got] == want
    a = MemorySimulator(CUDA_CACHING).replay_spaces(got)
    b = jsim.MemorySimulator(J_CUDA_CACHING).replay_spaces(want)
    assert a.peak_reserved == b.peak_reserved
    assert a.stats["space_peaks"] == b.stats["space_peaks"]


# ---------------------------------------------------------------------------
def _svc():
    return AdmissionService(
        functools.partial(XMemEstimator.for_torch_gpu, cublas_workspace=0),
        workers=1, cache=TraceCache())


def test_offload_offer_feasible_zero_traces_reproducible():
    cfg, policy = get_smoke("qwen3-32b"), TrainPolicy()
    shape = smoke_shape(48, 32)
    svc = _svc()
    probe = RemediationPlanner(svc).plan(cfg, policy, shape,
                                         capacity=1 << 62)
    peak = probe.baseline.peak_bytes
    cap = peak - peak // 50
    space = PlanSpace(offload_opt_state=True, offload_activations=(0.5,),
                      batches=(), microbatches=(), remat=())
    res = RemediationPlanner(svc).plan(cfg, policy, shape, capacity=cap,
                                       space=space, job_id="offload")
    assert not res.baseline.admit
    offers = [o for o in res.offers if o.knob == "offload"]
    assert offers, "no feasible offload counter-offer"
    assert res.stats["axes"]["offload"] == 2
    assert res.stats["fresh_traces"] == 0
    for o in offers:
        assert o.peak_bytes <= cap
        assert o.space_peaks and o.space_peaks["host_pinned"] > 0
        j = o.to_json()
        assert "offload_opt_state" in j and "space_peaks" in j
        cold = _svc()
        d = cold.decide(o.admission_request(cfg, policy, shape,
                                            capacity=cap))
        assert d.admit and d.peak_bytes == o.peak_bytes
        assert d.breakdown["space_peaks"] == o.space_peaks
    svc.close()


def test_offload_requests_do_not_pollute_sweep_evidence():
    req = jobs.request("a")
    off = dataclasses.replace(req, offload=OFFLOAD_FULL)
    assert request_family(req) != request_family(off)
    svc = AdmissionService(workers=1, cache=TraceCache())
    svc.decide(off)
    # the offloaded peak is no evidence for the device-only request
    assert svc.log.lookup(request_family(req), 1) is None
    assert svc.log.lookup(request_family(off), 1) is not None
    svc.close()


@pytest.mark.parametrize("arch", ["qwen3-32b", "phi3.5-moe-42b-a6.6b",
                                  "internvl2-1b"])
def test_analytic_remains_upper_bound(arch):
    """Offload never raises the device peak, so the analytic bound (which
    models no offload) stays an upper bound wherever it held without:
    offloaded device peak <= no-offload peak <= max(bound, that peak)."""
    cfg, policy = get_smoke(arch), TrainPolicy()
    shape = smoke_shape(48, 8)
    bound = analytic_peak_bytes(cfg, shape, microbatches=1,
                                with_optimizer=True)
    assert bound > 0
    fwd, upd, init = make_estimator_hooks(cfg, policy)
    svc = AdmissionService(workers=1, cache=TraceCache())

    def peak(i, plan):
        return svc.decide(AdmissionRequest(
            f"{arch}-{i}", fwd, M.abstract_params(cfg),
            input_specs(cfg, shape), update_fn=upd, opt_init_fn=init,
            capacity=1 << 62, offload=plan)).peak_bytes

    base = peak(0, None)
    ceiling = max(bound, base)
    for i, plan in enumerate((OffloadPlan(optimizer_state=True),
                              OffloadPlan(optimizer_state=True,
                                          activations=1.0)), start=1):
        p = peak(i, plan)
        assert p <= base <= ceiling, (arch, plan, p, base)
    svc.close()


# ---------------------------------------------------------------------------
TRAIN_REQ = {"kind": "train", "arch": "qwen3-32b", "smoke": True,
             "seq": 48, "batch": 32, "hbm_gib": 1.0}
OFF = {"offload": {"optimizer_state": True, "activations": 0.5,
                   "min_block_bytes": 4096}}


def test_daemon_train_offload():
    svc = AdmissionService(workers=1, cache=TraceCache())
    base = served.handle_request(svc, dict(TRAIN_REQ), device="cpu")
    off = served.handle_request(svc, {**TRAIN_REQ, **OFF}, device="cpu")
    assert base["ok"] and off["ok"]
    assert off["peak_bytes"] <= base["peak_bytes"]
    peaks = off["breakdown"]["space_peaks"]
    assert peaks["device_hbm"] == off["peak_bytes"]
    assert peaks["host_pinned"] > 0
    assert "space_peaks" not in base["breakdown"]
    json.dumps(off)
    svc.close()


def test_build_offload_plan_parses_and_gates():
    assert served.build_offload_plan({}) is None
    assert served.build_offload_plan(
        {"offload": {"optimizer_state": False}}) is None
    p = served.build_offload_plan({"offload": {
        "activations": 0.25, "space": "host_pageable"}})
    assert p.activations == 0.25
    assert p.space is MemorySpace.HOST_PAGEABLE


def test_daemon_plan_with_offload_keys():
    svc = _svc()
    d = served.handle_request(svc, dict(TRAIN_REQ, hbm_gib=16.0),
                              device="cpu")
    cap_gib = d["peak_bytes"] * 0.98 / 2**30
    resp = served.handle_request(svc, {
        "kind": "plan", "arch": "qwen3-32b", "smoke": True, "seq": 48,
        "batch": 32, "hbm_gib": cap_gib, "batch_grid": [],
        "microbatch_grid": [], "remat_grid": [], "offload_opt_state": True,
        "offload_activations": [0.5]}, device="cpu")
    assert resp["ok"] and not resp["admit"]
    offs = [o for o in resp["counter_offers"] if o["knob"] == "offload"]
    assert offs
    assert all(o["space_peaks"]["host_pinned"] > 0 for o in offs)
    assert resp["stats"]["axes"]["offload"] == 2
    svc.close()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantile", [0.5, 0.9, 1.0])
def test_calibrate_equals_the_references_scale(quantile):
    """The same (report, truth) samples through both packages'
    ``calibrate``: the JAX estimator's ``estimate_training`` answers with
    the port's reports, so only the fit is compared."""
    samples = []
    for arch in ("qwen3-32b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_smoke(arch)
        fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
        for b, over in ((4, 1.10), (8, 1.25), (16, 0.95)):
            job = (fwd, M.abstract_params(cfg),
                   input_specs(cfg, smoke_shape(48, b)), upd, init)
            rep = XMemEstimator.for_torch_gpu(
                trace_cache=TraceCache()).estimate_training(*job[:3],
                                                            job[3], job[4])
            truth = rep.persistent_bytes + int(
                (rep.peak_tensor_bytes - rep.persistent_bytes) * over)
            samples.append((job, truth, rep))
    est = XMemEstimator.for_torch_gpu(trace_cache=TraceCache())
    got = est.calibrate([(job, truth) for job, truth, _ in samples],
                        quantile=quantile)
    assert est.orchestrator.policy.transient_scale == got
    reports = iter([rep for _, _, rep in samples])
    jest = jestimator.XMemEstimator.for_torch_gpu()
    jest.estimate_training = lambda *a, **k: next(reports)
    want = jest.calibrate([(job, truth) for job, truth, _ in samples],
                          quantile=quantile)
    assert got == want
    assert calibration_scale([(rep, truth) for _, truth, rep in samples],
                             quantile) == want
    # no usable sample: the scale stays 1.0
    flat = types.SimpleNamespace(peak_tensor_bytes=10, persistent_bytes=10)
    assert calibration_scale([(flat, 5)]) == 1.0


# ---------------------------------------------------------------------------
def _assert_reports_equal(a, b):
    assert a.peak_bytes == b.peak_bytes
    assert a.peak_tensor_bytes == b.peak_tensor_bytes
    assert a.persistent_bytes == b.persistent_bytes
    assert a.oom == b.oom
    assert a.num_events == b.num_events
    assert a.breakdown == b.breakdown
    assert a.sim.peak_reserved == b.sim.peak_reserved
    assert a.sim.peak_allocated == b.sim.peak_allocated


@pytest.mark.parametrize("arch", ["qwen3-32b", "phi3.5-moe-42b-a6.6b",
                                  "internvl2-1b", "musicgen-medium",
                                  "xlstm-1.3b"])
@pytest.mark.parametrize("capacity", [None, 69206016])
def test_reference_pipeline_equals_the_fast_path(arch, capacity):
    cfg = get_smoke(arch)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    args = (fwd, M.abstract_params(cfg), input_specs(cfg, smoke_shape(32, 4)),
            upd, init)
    fast = XMemEstimator.for_torch_gpu(trace_cache=TraceCache())
    slow = XMemEstimator.for_torch_gpu(trace_cache=TraceCache(),
                                       fastpath=False)
    a = fast.estimate_training(*args, capacity=capacity)
    b = slow.estimate_training(*args, capacity=capacity)
    _assert_reports_equal(a, b)
    # the reference never caches and keeps a flat composition
    assert len(slow.trace_cache) == 0
    assert isinstance(b.composition, list)
    if capacity is None:
        assert slow.min_feasible_capacity(*args[:3], report=b) \
            == fast.min_feasible_capacity(*args[:3], report=a)


@pytest.mark.parametrize("iterations", [2, 3, 5])
def test_reference_pipeline_equals_the_fast_path_over_iterations(iterations):
    a = _estimator(policy=CUDA_CACHING_TORCH)
    b = _estimator(policy=CUDA_CACHING_TORCH, fastpath=False)
    a.iterations = b.iterations = iterations
    fwd, upd, init = jobs.make_hooks()
    params, batch = _shapes()
    _assert_reports_equal(
        a.estimate_training(fwd, params, batch, upd, init),
        b.estimate_training(fwd, params, batch, upd, init))

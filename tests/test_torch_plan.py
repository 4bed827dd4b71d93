"""The port's remediation planner (``repro_torch.plan``) against the JAX
package's, on the CPU at smoke size.

* ``plan_cost`` / ``serving_cost`` equal the reference's under the
  reference's v5e constants (the port's module constants patched), over
  a grid of configs, remat, microbatches, offload transfers and serving
  knobs; exact (``==``). The port's own constants are the H100's.
* The training search on a rejected smoke job: the JAX planner, fed the
  port's own estimates for every candidate (the two packages trace
  different programs, so their peaks are not the same numbers), gives
  the port's offers: the same knobs, batches, microbatches and offload
  flags, in the same order, with equal ``peak_bytes`` (exact) and
  slowdowns (relative 1e-12) under the v5e constants. Under the H100
  constants the offers are the same set; the rank change is stated in
  ``test_h100_constants_keep_the_offer_set``.
* Every offer reproduces bit-identically through ``admission_request``
  on a cold service; ``to_json`` is wire-safe; an admitted job gets no
  offers; ``decide`` attaches offers for a ``meta["plan"]`` context.
* ``replan_if_needed`` with and without a feasible microbatch count; the
  cluster retry reduces rejections, and a plain replay is unchanged.
* The daemon's ``plan`` and ``serve_plan`` kinds in process and over the
  socket.
* ``replan_mesh`` / ``reshard_batch_size`` equal the reference's.
* The mesh axes (the topology grid, a fixed base topology, padded-vocab
  variants) and a request's own shard factors or collectives: the JAX
  planner fed the port's estimates (mesh-sweep rows included) gives the
  port's offers; topology offers reproduce through
  ``admission_request``; ``shrink_and_replan`` equals the reference's on
  the same estimates.
* The serving search costs exactly 1 + its distinct concurrencies
  traces, and its offers reproduce through ``decide_serving``.
"""
import dataclasses
import functools
import json
import math
import socket
import threading
import types

import pytest

from repro.configs import get_smoke as jget_smoke
from repro.configs.base import smoke_shape as jget_smoke_shape
from repro.core import sweep as jsweep
from repro.plan import cost as jcost
from repro.plan import planner as jplanner
from repro.service import admission as jadmission
from repro.train import TrainPolicy as JTrainPolicy
from repro.train import elastic as jelastic
from repro_torch.configs import get_smoke
from repro_torch.configs.base import smoke_shape
from repro_torch.core.cache import TraceCache
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.orchestrator import ServingKnobs
from repro_torch.core.sweep import MeshTopology
from repro_torch.launch import serve as tserve
from repro_torch.launch import served
from repro_torch.launch import train as ttrain
from repro_torch.plan import (PlanContext, PlanSpace, RemediationPlanner,
                              run_plan_search, serving_trace_budget)
from repro_torch.plan import cost as tcost
from repro_torch.service import AdmissionService, ClusterSimulator, JobArrival
from repro_torch.train import TrainPolicy, make_estimator_hooks
from repro_torch.train import elastic as telastic

ARCH = "qwen3-32b"
SEQ, BATCH = 48, 32
V5E = {"PEAK_FLOPS": jcost.PEAK_FLOPS, "HBM_BW": jcost.HBM_BW,
       "PCIE_BW": jcost.PCIE_BW}
FULL_SPACE = PlanSpace(offload_opt_state=True, offload_activations=(0.5,),
                       max_offers=20)


@pytest.fixture
def v5e(monkeypatch):
    """The port's cost constants set to the reference's (v5e) ones."""
    for name, value in V5E.items():
        monkeypatch.setattr(tcost, name, value)


def _svc():
    """A one-worker service over a fresh cache whose estimators hold no
    cuBLAS workspace: at smoke size the two 32 MiB workspaces would be
    most of every peak, and the knobs would move nothing."""
    return AdmissionService(
        functools.partial(XMemEstimator.for_torch_gpu, cublas_workspace=0),
        workers=1, cache=TraceCache())


def _job():
    return get_smoke(ARCH), TrainPolicy(), smoke_shape(SEQ, BATCH)


def _capacity(svc):
    """Just below the job's unbounded peak: it rejects, and every axis
    has a feasible candidate."""
    cfg, policy, shape = _job()
    peak = ttrain.admission_check(cfg, policy, shape, 1 << 62,
                                  service=svc)[1].peak_bytes
    return peak - peak // 50


# ---------------------------------------------------------------------------
def test_h100_constants():
    assert (tcost.PEAK_FLOPS, tcost.HBM_BW, tcost.PCIE_BW) \
        == (989e12, 3.35e12, 64e9)
    # the compute/memory crossover moved from the v5e's 240 FLOP/B
    assert round(tcost.PEAK_FLOPS / tcost.HBM_BW) == 295
    assert round(jcost.PEAK_FLOPS / jcost.HBM_BW) == 241


@pytest.mark.parametrize("arch", [ARCH, "phi3.5-moe-42b-a6.6b",
                                  "internvl2-1b", "xlstm-1.3b"])
def test_plan_cost_equals_the_reference_under_v5e(v5e, arch):
    for remat in ("none", "dots", "full"):
        tcfg = dataclasses.replace(get_smoke(arch), remat=remat)
        jcfg = dataclasses.replace(jget_smoke(arch), remat=remat)
        for batch in (4, 32):
            for mb in (1, 2, 4):
                for transfer in (0, 1 << 20, 1 << 34):
                    got = tcost.plan_cost(
                        tcfg, smoke_shape(SEQ, batch), microbatches=mb,
                        offload_transfer_bytes=transfer)
                    want = jcost.plan_cost(
                        jcfg, jget_smoke_shape(SEQ, batch),
                        microbatches=mb, offload_transfer_bytes=transfer)
                    assert got == want, (remat, batch, mb, transfer)


def test_serving_cost_equals_the_reference_under_v5e(v5e):
    from repro.core.orchestrator import ServingKnobs as JKnobs
    for page in (8, 16, 64):
        for c in (1, 8, 256):
            for kv in (1, 2):
                for prefix in (True, False):
                    for spec_k in (0, 2):
                        kw = dict(page_size=page, max_concurrent=c,
                                  kv_dtype_bytes=kv, prefix_cache=prefix,
                                  speculative_k=spec_k)
                        args = dict(params_bytes=123_456_789,
                                    kv_bytes_per_token=32_768,
                                    avg_seq_len=2064.0,
                                    shared_prefix_len=100)
                        assert tcost.serving_cost(
                            knobs=ServingKnobs(**kw), **args) \
                            == jcost.serving_cost(knobs=JKnobs(**kw),
                                                  **args)


# ---------------------------------------------------------------------------
class _Recording:
    """Wraps a port service: records every decision by job id, and
    every mesh sweep (its arguments and rows)."""

    def __init__(self, svc):
        self.svc, self.by_id, self.sweeps = svc, {}, []
        self.cache, self.obs = svc.cache, svc.obs

    def mesh_sweep(self, *args, **kw):
        res = self.svc.mesh_sweep(*args, **kw)
        self.sweeps.append((args, kw, res))
        return res

    def decide(self, req):
        d = self.svc.decide(req)
        self.by_id[req.job_id] = (req, d)
        return d

    def decide_sweep(self, reqs):
        out = self.svc.decide_sweep(reqs)
        for r, d in zip(reqs, out):
            self.by_id[r.job_id] = (r, d)
        return out


class _Table:
    """A stand-in for the JAX service that answers the JAX planner's
    requests (matched by job id) with the port's estimates: an admitted
    candidate's peak, or a rejected one's unbounded peak (the reference
    replays unbounded and compares the peak with the capacity)."""

    def __init__(self, answers, rows=None):
        self.answers = answers
        self.rows = rows or {}
        self.cache = types.SimpleNamespace(
            thread_stats=lambda: {"hits": 0, "misses": 0, "store_hits": 0})
        self.obs = None

    def _decision(self, req):
        peak, breakdown = self.answers[req.job_id]
        return jadmission.AdmissionDecision(
            job_id=req.job_id, admit=peak <= req.capacity,
            capacity=req.capacity, peak_bytes=peak, peak_tensor_bytes=peak,
            persistent_bytes=0, safe_threshold=peak, breakdown=breakdown,
            provenance={"source": "memory", "sweep": {}}, wall_s=0.0,
            report=types.SimpleNamespace(breakdown=breakdown))

    def decide(self, req):
        return self._decision(req)

    def decide_sweep(self, reqs):
        return [self._decision(r) for r in reqs]

    def mesh_sweep(self, fwd, params, batch, topologies, *, cfg=None,
                   **kw):
        """The port's unbounded per-device peaks of the same rows."""
        pad = cfg.pad_vocab_multiple if cfg is not None else None
        reports = [types.SimpleNamespace(
            peak_bytes=self.rows[(pad, t.label)], breakdown={})
            for t in topologies]
        return jsweep.MeshSweepResult(list(topologies), reports, {})


def _port_search(svc, capacity, space=FULL_SPACE, **kw):
    cfg, policy, shape = _job()
    rec = _Recording(svc)
    res = RemediationPlanner(rec).plan(cfg, policy, shape,
                                       capacity=capacity, space=space,
                                       job_id="misfit", **kw)
    return res, rec


def _reference_offers(svc, rec, capacity, space=FULL_SPACE, jspace=None,
                      **jkw):
    """The JAX planner over the port's estimates of the same
    candidates. Checks the two admission rules agree at ``capacity``
    on every candidate, a mesh sweep's rows among them: an admitted one
    replayed unbounded peaks where it did at the capacity, a rejected
    one peaks above it."""
    answers = {}
    for job_id, (req, d) in rec.by_id.items():
        free = svc.decide(dataclasses.replace(req, capacity=1 << 62,
                                              job_id=f"{job_id}/free"))
        if d.admit:
            assert free.peak_bytes == d.peak_bytes, job_id
        else:
            assert free.peak_bytes > capacity, job_id
        answers[job_id] = (free.peak_bytes, free.breakdown)
    rows = {}
    for args, kw, res in rec.sweeps:
        assert kw["capacity"] == capacity
        free = svc.mesh_sweep(*args, **dict(kw, capacity=None))
        for topo, at, un in zip(res.topologies, res.reports, free.reports):
            if not at.oom and at.peak_bytes <= capacity:
                assert un.peak_bytes == at.peak_bytes, topo.label
            else:
                assert un.peak_bytes > capacity, topo.label
            rows[(kw["cfg"].pad_vocab_multiple, topo.label)] = un.peak_bytes
    if jspace is None:
        jspace = jplanner.PlanSpace(
            offload_opt_state=space.offload_opt_state,
            offload_activations=space.offload_activations,
            max_offers=space.max_offers)
    jcfg = jget_smoke(ARCH)
    base = answers.setdefault("misfit/baseline", (capacity + 1, {}))
    table = _Table(answers, rows)
    baseline = table._decision(types.SimpleNamespace(
        job_id="misfit/baseline", capacity=capacity))
    assert base[0] > capacity
    return jplanner.RemediationPlanner(table).plan(
        jcfg, JTrainPolicy(), jget_smoke_shape(SEQ, BATCH),
        capacity=capacity, space=jspace, job_id="misfit",
        baseline=baseline, **jkw)


def _summary(offer):
    return (offer.knob, offer.global_batch, offer.microbatches, offer.remat,
            offer.offload_opt_state, offer.offload_activations,
            offer.peak_bytes, offer.pad_vocab_multiple,
            offer.topology.label if offer.topology is not None else None,
            offer.n_devices)


def test_training_offers_equal_the_references(v5e):
    svc = _svc()
    cap = _capacity(svc)
    res, rec = _port_search(svc, cap)
    assert not res.baseline.admit
    want = _reference_offers(svc, rec, cap)
    assert [_summary(o) for o in res.offers] \
        == [_summary(o) for o in want.offers]
    for got, ref in zip(res.offers, want.offers):
        assert math.isclose(got.slowdown, ref.slowdown, rel_tol=1e-12)
    # every axis answered: batch, microbatch and offload offers
    assert {o.knob for o in res.offers} == {"batch", "microbatch",
                                            "offload"}
    assert res.stats["axes"] == want.stats["axes"]
    assert (res.stats["candidates"], res.stats["feasible"]) \
        == (want.stats["candidates"], want.stats["feasible"])
    svc.close()


def test_h100_constants_keep_the_offer_set(monkeypatch):
    """The H100's constants price the same feasible set; the rank moves
    where the roofline's binding term does. The stated change on this
    smoke job: optimizer-state offload drops from 5th (v5e: x1.72,
    ahead of batch 4's x2.07) to 6th (H100: x3.52, behind it). Its
    binding term is the host link, and the H100's HBM is 4.09x the
    v5e's where its link is only 2x, so a transfer-bound offer costs
    relatively more on the H100. Every other offer keeps its place."""
    svc = _svc()
    cap = _capacity(svc)
    h100, _ = _port_search(svc, cap)
    for name, value in V5E.items():
        monkeypatch.setattr(tcost, name, value)
    v5e, _ = _port_search(svc, cap)
    key = sorted(_summary(o) for o in h100.offers)
    assert key == sorted(_summary(o) for o in v5e.offers)
    rank_h100 = [(o.knob, o.global_batch, o.microbatches,
                  o.offload_opt_state, o.offload_activations)
                 for o in h100.offers]
    rank_v5e = [(o.knob, o.global_batch, o.microbatches,
                 o.offload_opt_state, o.offload_activations)
                for o in v5e.offers]
    head = [("microbatch", 32, 2, False, 0.0),
            ("microbatch", 32, 4, False, 0.0),
            ("batch", 16, 1, False, 0.0), ("batch", 8, 1, False, 0.0)]
    opt, b4 = ("offload", 32, 1, True, 0.0), ("batch", 4, 1, False, 0.0)
    act = ("offload", 32, 1, True, 0.5)
    assert rank_v5e == head + [opt, b4, act]
    assert rank_h100 == head + [b4, opt, act]
    opt_h100 = next(o for o in h100.offers if o.knob == "offload")
    assert opt_h100.cost["step_time_s"] == opt_h100.cost["t_transfer_s"]
    svc.close()


def test_offers_reproduce_bit_identically_and_are_wire_safe():
    svc = _svc()
    cap = _capacity(svc)
    res, _ = _port_search(svc, cap)
    cfg, policy, shape = _job()
    cold = _svc()
    for o in res.offers:
        d = cold.decide(o.admission_request(cfg, policy, shape))
        assert d.admit and d.peak_bytes == o.peak_bytes, o.to_json()
        assert d.breakdown.get("space_peaks") == o.space_peaks
    wire = json.loads(json.dumps(res.to_json()))
    assert wire["admit"] is False
    assert len(wire["counter_offers"]) == len(res.offers)
    assert wire["stats"]["fresh_traces"] == res.stats["fresh_traces"]
    svc.close()
    cold.close()


def test_admitted_job_gets_no_offers():
    svc = _svc()
    cfg, policy, shape = _job()
    res = RemediationPlanner(svc).plan(cfg, policy, shape,
                                       capacity=1 << 62)
    assert res.baseline.admit and res.offers == [] and res.best() is None
    assert res.stats["already_fits"] and res.stats["fresh_traces"] == 0
    svc.close()


def test_decide_attaches_offers_for_a_plan_context():
    svc = _svc()
    cap = _capacity(svc)
    cfg, policy, shape = _job()
    want, _ = _port_search(svc, cap, PlanSpace())
    req = ttrain.train_request(cfg, policy, shape, cap)
    req.meta["plan"] = PlanContext(cfg, policy, shape)
    d = svc.decide(req)
    assert not d.admit and d.counter_offers
    assert [_summary(o) for o in d.counter_offers] \
        == [_summary(o) for o in want.offers]
    assert d.provenance["plan"]["offers"] == len(d.counter_offers)
    assert d.to_json()["counter_offers"][0]["knob"] \
        == d.counter_offers[0].knob
    # an admitted request with a context plans nothing
    req.capacity = 1 << 62
    assert svc.decide(req).counter_offers is None
    svc.close()


# ---------------------------------------------------------------------------
def test_replan_if_needed_with_and_without_a_feasible_offer(capsys):
    svc = _svc()
    cap = _capacity(svc)
    cfg, policy, shape = _job()
    p, rep, decision = ttrain.replan_if_needed(cfg, policy, shape, cap,
                                               service=svc)
    assert decision is None and p.microbatches == 2
    assert rep.peak_bytes <= cap and not rep.oom
    assert "[xmem] replanning: microbatches -> 2" in capsys.readouterr().out
    # admitted as asked: the asked policy and its decision
    p, rep, decision = ttrain.replan_if_needed(cfg, policy, shape, 1 << 62,
                                               service=svc)
    assert p == policy and decision.admit
    # nothing fits: the asked policy and the gate's own rejection
    p, rep, decision = ttrain.replan_if_needed(cfg, policy, shape, 1 << 20,
                                               service=svc)
    assert p == policy and not decision.admit
    svc.close()


def test_train_main_trains_the_asked_batch_at_the_offer(capsys):
    """The launcher: a rejection of ``--batch`` replanned to 2
    microbatches trains batch 32 (the GPU preset's workspaces make this
    capacity different from the tests' service's)."""
    cfg, policy, shape = _job()
    gate = ttrain.gate_service()
    peak = ttrain.admission_check(cfg, policy, shape, 1 << 62,
                                  service=gate)[1].peak_bytes
    mb2 = ttrain.admission_check(
        cfg, dataclasses.replace(policy, microbatches=2), shape, 1 << 62,
        service=gate)[1].peak_bytes
    assert mb2 < peak
    gib = mb2 / 2**30
    rc = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--seq", str(SEQ), "--batch", str(BATCH),
                      "--steps", "1", "--capacity-gib", repr(gib)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "replanning: microbatches -> 2" in out
    assert json.loads(out.strip().splitlines()[-1])["batch"] == BATCH


# ---------------------------------------------------------------------------
def _arrivals(capacity, truth, with_plan):
    cfg, policy, shape = _job()
    from repro_torch.configs.registry import input_specs
    from repro_torch.models import model as M
    fwd, upd, init = make_estimator_hooks(cfg, policy)
    ctx = PlanContext(cfg, policy, shape,
                      space=PlanSpace(batches=(16,), microbatches=(),
                                      remat=()))
    jobs = [JobArrival(
        "misfit", fwd, M.abstract_params(cfg), input_specs(cfg, shape),
        update_fn=upd, opt_init_fn=init, capacity=capacity,
        truth_bytes=truth, plan=ctx if with_plan else None)]
    small = dataclasses.replace(shape, global_batch=4)
    jobs.append(JobArrival(
        "fits", fwd, M.abstract_params(cfg), input_specs(cfg, small),
        update_fn=upd, opt_init_fn=init, capacity=capacity,
        plan=ctx if with_plan else None))
    return jobs


def test_cluster_retry_reduces_rejections():
    svc = _svc()
    cap = _capacity(svc)
    cfg, policy, shape = _job()
    est = ttrain.admission_check(cfg, policy, shape, 1 << 62,
                                 service=svc)[1].peak_bytes
    truth = cap - 4096      # the job would have fit: a false rejection
    plain = ClusterSimulator(svc).replay(_arrivals(cap, truth, False))
    retry = ClusterSimulator(svc).replay(_arrivals(cap, truth, True),
                                         retry_rejections=True)
    assert est > cap
    assert plain.summary["underutilized_rejected"] == 1
    assert retry.summary["underutilized_rejected"] == 0
    assert retry.summary["oom_admitted"] == plain.summary["oom_admitted"] \
        == 0
    assert retry.summary["replanned"] == 1
    assert retry.summary["admitted"] == plain.summary["admitted"] + 1
    (job_id, offer), = retry.retries
    assert job_id == "misfit" and offer.global_batch == 16
    d = retry.decisions[0]
    assert d.admit and d.job_id == "misfit+offer"
    assert d.peak_bytes == offer.peak_bytes
    svc.close()


def test_plain_replay_unchanged_without_plan_context():
    svc = _svc()
    out = ClusterSimulator(svc).replay(_arrivals(1 << 62, None, False))
    assert out.summary["rejected"] == 0
    assert out.summary["replanned"] == 0 and out.retries == []
    assert all(d.counter_offers is None for d in out.decisions)
    svc.close()


# ---------------------------------------------------------------------------
def _plan_request(cap):
    return {"kind": "plan", "arch": ARCH, "smoke": True, "seq": SEQ,
            "batch": BATCH, "hbm_gib": cap / 2**30, "max_offers": 4,
            "offload_opt_state": True, "offload_activations": [0.5]}


def test_daemon_plan_kind_in_process():
    svc = AdmissionService(workers=1, cache=TraceCache())
    cfg, policy, shape = _job()
    peak = ttrain.admission_check(cfg, policy, shape, 1 << 62,
                                  service=svc)[1].peak_bytes
    # the daemon's service holds the GPU preset's workspaces: reject by
    # 1 MiB under the peak
    cap = peak - (1 << 20)
    resp = served.handle_request(svc, _plan_request(cap), device="cpu")
    assert resp["ok"] and resp["admit"] is False
    offers = resp["counter_offers"]
    assert offers and len(offers) <= 4
    assert all(o["peak_bytes"] <= cap for o in offers)
    slow = [o["slowdown"] for o in offers]
    assert slow == sorted(slow)
    json.dumps(resp)
    bad = served.handle_request(svc, {"kind": "plan", "arch": "nope",
                                      "hbm_gib": 1.0}, device="cpu")
    assert not bad["ok"] and bad["kind"] == "error"
    svc.close()


SERVE_PLAN = {"kind": "serve_plan", "arch": ARCH, "smoke": True,
              "mix": "48:16:64", "max_concurrent": 64, "page_size": 16,
              "kv_dtype_bytes": 2, "page_sizes": [16, 32],
              "max_concurrents": [16, 32], "kv_dtypes": [1, 2]}


def _serve_plan_capacity(svc):
    """Between the mix's worst case at its own knobs and at a quarter of
    its concurrency: it rejects, and smaller concurrencies fit."""
    cfg = get_smoke(ARCH)
    mix = tserve.parse_mix(SERVE_PLAN["mix"])
    hi, _ = tserve.pick_serving(cfg, mix, 1 << 62,
                                knobs=ServingKnobs(max_concurrent=64),
                                service=svc)
    lo, _ = tserve.pick_serving(cfg, mix, 1 << 62,
                                knobs=ServingKnobs(max_concurrent=16),
                                service=svc)
    assert lo.peak_bytes < hi.peak_bytes
    return (lo.peak_bytes + hi.peak_bytes) // 2


def test_daemon_serve_plan_kind_in_process():
    svc = AdmissionService(workers=1, cache=TraceCache())
    cap = _serve_plan_capacity(svc)
    resp = served.handle_request(svc, dict(SERVE_PLAN, hbm_gib=cap / 2**30),
                                 device="cpu")
    assert resp["ok"] and resp["admit"] is False, resp
    offers = resp["counter_offers"]
    assert offers and all(o["knob"] == "serving" for o in offers)
    assert all(o["peak_bytes"] <= int(cap / 2**30 * 2**30) for o in offers)
    assert resp["provenance"]["plan"]["offers"] == len(offers)
    json.dumps(resp)
    svc.close()


def test_daemon_plan_kinds_over_the_socket():
    svc = AdmissionService(workers=2, cache=TraceCache())
    cfg, policy, shape = _job()
    peak = ttrain.admission_check(cfg, policy, shape, 1 << 62,
                                  service=svc)[1].peak_bytes
    scap = _serve_plan_capacity(svc)
    server = served.AdmissionServer(("127.0.0.1", 0), svc)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        with socket.create_connection((host, port), timeout=300) as s:
            f = s.makefile("rwb")
            out = []
            for req in (_plan_request(peak - (1 << 20)),
                        dict(SERVE_PLAN, hbm_gib=scap / 2**30)):
                f.write((json.dumps(req) + "\n").encode())
                f.flush()
                out.append(json.loads(f.readline()))
        plan, serve_plan = out
        assert plan["ok"] and plan["counter_offers"]
        assert serve_plan["ok"] and serve_plan["counter_offers"]
        # the repeat: the daemon's shared cache keeps the search warm
        again = served.request_once(host, port,
                                    _plan_request(peak - (1 << 20)),
                                    timeout=300)
        assert [o["peak_bytes"] for o in again["counter_offers"]] \
            == [o["peak_bytes"] for o in plan["counter_offers"]]
        assert again["stats"]["fresh_traces"] == 0
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


# ---------------------------------------------------------------------------
def test_replan_mesh_and_reshard_equal_the_reference():
    for pod in (0, 1, 2, 3, 4, 5):
        for data in (1, 2, 4):
            for model in (1, 2, 4):
                cur_t = telastic.MeshPlan(pod=pod, data=data, model=model)
                cur_j = jelastic.MeshPlan(pod=pod, data=data, model=model)
                for avail in range(0, 21):
                    for min_model in (1, 2):
                        try:
                            want = jelastic.replan_mesh(cur_j, avail,
                                                        min_model)
                        except ValueError:
                            with pytest.raises(ValueError):
                                telastic.replan_mesh(cur_t, avail, min_model)
                            continue
                        got = telastic.replan_mesh(cur_t, avail, min_model)
                        assert dataclasses.astuple(got) \
                            == dataclasses.astuple(want)
                        assert got.devices == want.devices
                        for gb in (1, 7, 32, 256):
                            assert telastic.reshard_batch_size(
                                gb, cur_t, got) \
                                == jelastic.reshard_batch_size(gb, cur_j,
                                                               want)


def _half(b):
    """A per-device factor of 2 on every block (a pinned execution
    model); both packages' planners pass it through untouched."""
    return 2.0


def _fixed_collective():
    from repro_torch.core.events import Phase
    from repro_torch.core.orchestrator import CollectiveSpec
    return (CollectiveSpec("bucket", 1 << 16, Phase.FORWARD_BACKWARD),)


# (port space, port kwargs, reference space, reference kwargs, the offer
# knobs the port must produce)
MESH_CASES = {
    "devices": (PlanSpace(devices=(2, 4), remat=(), max_offers=64), {},
                jplanner.PlanSpace(devices=(2, 4), remat=(), max_offers=64),
                {}, {"topology", "batch", "microbatch"}),
    "devices_pad_vocab": (
        PlanSpace(devices=(2,), pad_vocab_multiple=96, batches=(),
                  microbatches=(), remat=(), max_offers=64), {},
        jplanner.PlanSpace(devices=(2,), pad_vocab_multiple=96, batches=(),
                           microbatches=(), remat=(), max_offers=64), {},
        {"topology", "pad_vocab"}),
    "base_topology": (
        PlanSpace(base_topology=MeshTopology(data=2, model=2), remat=(),
                  max_offers=64), {},
        jplanner.PlanSpace(base_topology=jsweep.MeshTopology(data=2,
                                                             model=2),
                           remat=(), max_offers=64), {},
        {"batch", "microbatch"}),
    "shard_factor_fn": (
        PlanSpace(devices=(2,), remat=(), max_offers=64),
        {"shard_factor_fn": _half},
        jplanner.PlanSpace(devices=(2,), remat=(), max_offers=64),
        {"shard_factor_fn": _half}, {"batch", "microbatch"}),
    "collective_specs": (
        PlanSpace(remat=(), max_offers=64),
        {"collective_specs": _fixed_collective()},
        jplanner.PlanSpace(remat=(), max_offers=64),
        {"collective_specs": ("a pinned spec",)}, {"batch", "microbatch"}),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_axes_answer_as_the_reference(v5e, case):
    """Each mesh axis, and a request's own execution model, answers: the
    port's offers equal the JAX planner's over the same estimates, and
    every offer reproduces through ``admission_request``."""
    space, kw, jspace, jkw, knobs = MESH_CASES[case]
    svc = _svc()
    free, _ = _port_search(svc, 1 << 62, space, **kw)
    cap = free.baseline.peak_bytes - free.baseline.peak_bytes // 50
    res, rec = _port_search(svc, cap, space, **kw)
    assert not res.baseline.admit
    want = _reference_offers(svc, rec, cap, jspace=jspace, **jkw)
    assert [_summary(o) for o in res.offers] \
        == [_summary(o) for o in want.offers]
    for got, ref in zip(res.offers, want.offers):
        assert math.isclose(got.slowdown, ref.slowdown, rel_tol=1e-12)
    assert res.stats["axes"] == want.stats["axes"]
    assert (res.stats["candidates"], res.stats["feasible"]) \
        == (want.stats["candidates"], want.stats["feasible"])
    assert {o.knob for o in res.offers} == knobs
    if "base_topology" in case:
        assert all(o.topology == space.base_topology for o in res.offers)
    cfg, policy, shape = _job()
    for o in res.offers:
        d = svc.decide(o.admission_request(cfg, policy, shape, **kw))
        assert d.admit and d.peak_bytes == o.peak_bytes, o.to_json()
    svc.close()


def test_topology_offers_hold_their_mesh_sweep_rows_to_the_byte():
    svc = _svc()
    cfg, policy, shape = _job()
    space = PlanSpace(devices=(2, 4), batches=(), microbatches=(),
                      remat=(), max_offers=64)
    free, _ = _port_search(svc, 1 << 62, space)
    cap = free.baseline.peak_bytes - free.baseline.peak_bytes // 50
    res, rec = _port_search(svc, cap, space)
    ((args, kw, sweep),) = rec.sweeps
    rows = {t.label: r for t, r in sweep}
    assert res.offers and all(o.knob == "topology" for o in res.offers)
    for o in res.offers:
        row = rows[o.topology.label]
        assert (o.peak_bytes, o.safe_threshold) == (row.peak_bytes,
                                                    row.peak_bytes)
        assert not row.oom and o.n_devices == o.topology.n_devices
        assert o.to_json()["topology"] == o.topology.label
    rejected = [t for t, r in sweep if r.oom or r.peak_bytes > cap]
    assert len(res.offers) + len(rejected) == len(sweep)
    # the topology axis replays the baseline's cached traces
    assert res.stats["fresh_traces"] == 0
    assert sweep.stats["trace_cache"]["misses"] == 0
    svc.close()


def test_run_plan_search_default_mesh_grid_answers(capsys):
    svc = _svc()
    free = run_plan_search(ARCH, 1 << 62, seq=SEQ, batch=BATCH, service=svc,
                           verbose=False)
    assert free["admit"] and free["counter_offers"] == []
    cap = free["peak_bytes"] - free["peak_bytes"] // 50
    rec = run_plan_search(ARCH, cap, seq=SEQ, batch=BATCH, service=svc)
    assert not rec["admit"]
    assert rec["stats"]["axes"]["topology"] == sum(
        len(jsweep.topology_grid(n)) for n in (4, 8, 16))
    offers = rec["counter_offers"]
    assert any(o["topology"] is not None for o in offers)
    out = capsys.readouterr().out
    assert "rejected" in out and "topology" in out
    svc.close()


def test_shrink_and_replan_equals_the_reference_on_the_same_estimates(v5e):
    """The re-carved mesh, the baseline on it, the applied offer and the
    updated (cfg, policy, shape): the port's, and the JAX package's
    over the port's estimates of the same requests."""
    svc = _svc()
    cfg, policy, shape = _job()
    space = PlanSpace(remat=(), max_offers=64)
    rec = _Recording(svc)
    free = telastic.shrink_and_replan(
        cfg, policy, shape, telastic.MeshPlan(1, 4, 2), 4, 1 << 62,
        service=svc, space=space)
    assert free.decision.admit and free.offer is None
    cap = free.decision.peak_bytes - free.decision.peak_bytes // 50
    got = telastic.shrink_and_replan(
        cfg, policy, shape, telastic.MeshPlan(1, 4, 2), 4, cap,
        service=rec, space=space)
    assert (got.plan.pod, got.plan.data, got.plan.model) == (1, 2, 2)
    assert got.topology == MeshTopology(data=2, model=2)
    assert not got.decision.admit and got.offer is not None and got.admitted
    answers = {}
    for job_id, (req, d) in rec.by_id.items():
        un = svc.decide(dataclasses.replace(req, capacity=1 << 62))
        assert un.peak_bytes == d.peak_bytes if d.admit \
            else un.peak_bytes > cap
        answers[job_id] = (un.peak_bytes, un.breakdown)
    want = jelastic.shrink_and_replan(
        jget_smoke(ARCH), JTrainPolicy(), jget_smoke_shape(SEQ, BATCH),
        jelastic.MeshPlan(1, 4, 2), 4, cap, service=_Table(answers),
        space=jplanner.PlanSpace(remat=(), max_offers=64))
    assert dataclasses.astuple(got.plan) == dataclasses.astuple(want.plan)
    assert got.topology.label == want.topology.label
    # the port's rejection replayed at the capacity; the reference's
    # peak is the unbounded one it was given
    assert got.decision.admit == want.decision.admit is False
    assert want.decision.peak_bytes == answers["qwen3-smoke/shrink/baseline"][0]
    assert _summary(got.offer) == _summary(want.offer)
    assert (got.policy.microbatches, got.shape.global_batch, got.cfg.remat) \
        == (want.policy.microbatches, want.shape.global_batch,
            want.cfg.remat)
    # the offer's request, decided again, holds its peak
    d = svc.decide(got.offer.admission_request(cfg, policy, shape))
    assert d.admit and d.peak_bytes == got.offer.peak_bytes
    # a mesh whose model axis the devices left cannot hold refuses
    with pytest.raises(ValueError):
        telastic.shrink_and_replan(cfg, policy, shape,
                                   telastic.MeshPlan(1, 1, 4), 2, cap,
                                   service=svc)
    svc.close()


# ---------------------------------------------------------------------------
def test_serving_search_traces_once_per_concurrency_and_reproduces():
    svc = AdmissionService(workers=1, cache=TraceCache())
    cfg = get_smoke(ARCH)
    mix = tserve.parse_mix(SERVE_PLAN["mix"])
    cap = _serve_plan_capacity(AdmissionService(workers=1,
                                                cache=TraceCache()))
    base = ServingKnobs(max_concurrent=64)
    space = PlanSpace(page_sizes=(16, 32), max_concurrents=(32, 16, 8),
                      kv_dtypes=(1, 2))
    d, gate = tserve.pick_serving(cfg, mix, cap, knobs=base, space=space,
                                  service=svc)
    plan = d.provenance["plan"]
    assert not d.admit and d.counter_offers
    budget = serving_trace_budget(space, base)
    assert budget == 1 + 3 == plan["trace_budget"]
    traces = d.provenance["trace_cache"]["misses"] + plan["fresh_traces"]
    assert traces == budget, (d.provenance, plan)
    assert plan["candidates"] == 12
    for o in d.counter_offers:
        again, _ = tserve.pick_serving(cfg, mix, cap,
                                       knobs=o.serving_knobs(), service=svc)
        assert again.admit and again.peak_bytes == o.peak_bytes
        assert again.breakdown["serving"] == o.serving
    costs = [o.cost["device_s_per_token"] for o in d.counter_offers]
    assert costs == sorted(costs)
    svc.close()


def test_serve_mix_plan_prints_the_offers(capsys):
    svc = AdmissionService(workers=1, cache=TraceCache())
    cap = _serve_plan_capacity(svc)
    svc.close()
    rc = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--capacity-gib", repr(cap / 2**30),
                      "--serve-mix", SERVE_PLAN["mix"],
                      "--max-concurrent", "64", "--plan"])
    out = capsys.readouterr().out
    assert rc == 2 and "rejected" in out
    assert "offer #1:" in out

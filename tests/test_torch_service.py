"""The port's admission service against the port's own estimator and the
JAX package's scoring.

* **The exact rung is bit-identical to the direct port estimator**
  (``estimate_training(..., capacity=...)``): ``peak_bytes``,
  ``peak_tensor_bytes``, ``persistent_bytes``, ``oom`` and
  ``breakdown``, for the dense and MoE smoke jobs, also under
  ``decide_many`` with 2 workers (provenance per thread).
* ``decide_sweep`` equals ``decide``.
* The port's ``admit`` rule on a replay that runs out of memory with
  ``peak_bytes <= capacity``.
* ``pick_batch`` and ``pick_train_batch`` through the service give the
  gate the direct estimator gave; ``pick_serving`` equals
  ``estimate_request_stream`` at the same knobs.
* ``ClusterSimulator``'s ``score`` is bit-identical to the reference's
  over the same ``RunRecord``s.
* What waits for later slices raises ``NotImplementedError`` naming it.
"""
import dataclasses

import pytest

import torch_service_jobs as jobs
from repro.core import metrics as jmetrics
from repro.service import cluster as jcluster
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import metrics as tmetrics
from repro_torch.core.cache import GLOBAL_TRACE_CACHE, TraceCache
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.orchestrator import ServingKnobs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.service import (AdmissionService, JobContext,
                                 plan_raising_at)
from repro_torch.service import cluster as tcluster
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks

SEQ = 32
FIELDS = ("peak_bytes", "peak_tensor_bytes", "persistent_bytes")


def _direct(cfg, batch, capacity, est=None):
    est = est or XMemEstimator.for_torch_gpu()
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    return est.estimate_training(
        fwd, TM.abstract_params(cfg),
        treg.input_specs(cfg, smoke_shape(SEQ, batch)), update_fn=upd,
        opt_init_fn=init, capacity=capacity)


def _same(decision, rep):
    for f in FIELDS:
        assert getattr(decision, f) == getattr(rep, f), f
    assert decision.report.oom == rep.oom
    assert decision.breakdown == rep.breakdown
    assert decision.report.num_events == rep.num_events
    assert decision.report.sim.peak_reserved == rep.sim.peak_reserved


@pytest.mark.parametrize("arch", ["qwen3-32b", "phi3.5-moe-42b-a6.6b"])
def test_exact_rung_is_bit_identical_to_the_port_estimator(arch):
    cfg = treg.get_smoke(arch)
    want = {b: _direct(cfg, b, 1 << 40) for b in (2, 4)}
    svc = AdmissionService(workers=2, cache=TraceCache())
    reqs = [ttrain.train_request(cfg, TrainPolicy(), smoke_shape(SEQ, b),
                                 1 << 40) for b in (2, 4)]
    for req, b in zip(reqs, (2, 4)):
        d = svc.decide(req)
        assert d.rung == "exact" and d.admit
        assert d.safe_threshold == d.raw_peak_bytes == d.peak_bytes
        _same(d, want[b])
    # the same requests on two worker threads: identical, every
    # provenance that thread's own (all warm now)
    many = svc.decide_many([dataclasses.replace(r) for r in reqs * 3])
    for d, b in zip(many, (2, 4) * 3):
        _same(d, want[b])
        assert d.provenance["source"] == "memory"
        assert d.provenance["trace_cache"]["misses"] == 0
    svc.close()


def test_provenance_is_per_thread_under_concurrency():
    svc = AdmissionService(workers=4, cache=TraceCache())
    svc.decide(jobs.request("warmup"))
    cold = jobs.request("cold", batch=jobs.B + 3)
    futs = [svc.submit(cold)] + [svc.submit(jobs.request(f"warm{i}"))
                                 for i in range(6)]
    decisions = [f.result(timeout=120) for f in futs]
    assert decisions[0].provenance["trace_cache"]["misses"] >= 1
    for d in decisions[1:]:
        assert d.provenance["source"] == "memory"
        assert d.provenance["trace_cache"]["misses"] == 0
    svc.close()


def test_recreated_hooks_are_warm():
    svc = AdmissionService(workers=1, cache=TraceCache())
    d1 = svc.decide(jobs.request("a"))
    assert d1.provenance["source"] == "traced"
    d2 = svc.decide(jobs.request("b"))
    assert d2.provenance["source"] == "memory"
    assert d2.provenance["trace_cache"] == {"hits": 3, "misses": 0,
                                            "store_hits": 0}
    svc.close()


def test_decide_sweep_matches_decide():
    svc = AdmissionService(workers=1, cache=TraceCache())
    reqs = [jobs.request(f"b{b}", batch=b) for b in (2, 4, 6, 8, 12, 16)]
    sweep = svc.decide_sweep(reqs)
    ref_svc = AdmissionService(workers=1, cache=TraceCache())
    for req, d in zip(reqs, sweep):
        ref = ref_svc.decide(dataclasses.replace(req))
        for f in (*FIELDS, "admit"):
            assert getattr(d, f) == getattr(ref, f), f
    assert sweep[0].provenance["sweep"]["points"] == len(reqs)
    svc.close()
    ref_svc.close()


def test_admit_needs_a_replay_that_did_not_run_out_of_memory():
    """The reference admits when ``peak_bytes <= capacity``. The port's
    allocator simulation, as torch's allocator, frees its cached
    segments and retries before it reports an out-of-memory, so a
    replay that ran out of memory has a reserved peak at or under the
    capacity: the reference's rule would admit a job that cannot run.
    The port admits on ``not oom and peak_bytes <= capacity``, the rule
    its gates always had."""
    svc = AdmissionService(workers=1, cache=TraceCache())
    free = svc.decide(jobs.request("free", capacity=1 << 40))
    assert free.admit and not free.report.oom
    at = svc.decide(jobs.request("at", capacity=free.peak_bytes))
    assert at.admit                      # estimate == capacity admits
    tight = svc.decide(jobs.request("tight",
                                    capacity=free.peak_bytes - 1))
    assert tight.report.oom and tight.peak_bytes <= tight.capacity
    assert not tight.admit
    svc.close()


def test_pick_batch_through_the_service_is_the_direct_gate():
    cfg = treg.get_smoke("qwen3-32b")
    params = TM.abstract_params(cfg)

    def direct_at(capacity):
        est, out = XMemEstimator.for_torch_gpu(), {}
        for b in (16, 1):
            cache = TM.init_cache(cfg, b, 64, device="meta")
            out[b] = tuple(est.estimate_serving(
                fn, params, cache, spec, capacity=capacity)
                for fn, spec in ((tserve.make_prefill_fn(cfg),
                                  tserve.prompt_specs(cfg, b, 64)),
                                 (tserve.make_decode_fn(cfg),
                                  tserve.decode_input(cfg, b))))
        return out
    free = direct_at(None)
    # batch 16's decode fits where its prefill does not
    cap = max(free[16][1].peak_bytes, max(r.peak_bytes for r in free[1]))
    direct = direct_at(cap)
    batch, gate = tserve.pick_batch(cfg, 64, capacity=cap,
                                    candidates=(16, 1),
                                    service=AdmissionService(
                                        workers=1, cache=TraceCache()))
    assert batch == 1
    rows = gate["candidates"]
    assert [c["fits"] for c in rows] == [False, True]
    for row, b in zip(rows, (16, 1)):
        pre, dec = direct[b]
        assert row["decode_peak"] == dec.peak_bytes
        assert row["prefill_peak"] == pre.peak_bytes
        assert row["peak"] == max(pre.peak_bytes, dec.peak_bytes)
        assert row["source"] == "traced" and row["rung"] == "exact"
    assert gate["decode"].report.peak_tensor_bytes == \
        direct[1][1].peak_tensor_bytes
    # the default service: the process-wide cache, the same gate
    _, again = tserve.pick_batch(cfg, 64, capacity=cap, candidates=(1,))
    assert again["peak"] == gate["peak"]
    assert GLOBAL_TRACE_CACHE.misses >= 2


def test_pick_train_batch_through_the_service_is_the_direct_gate():
    cfg = treg.get_smoke("qwen3-32b")
    need = _direct(cfg, 8, 1 << 62).peak_bytes
    want = {b: _direct(cfg, b, need - 1) for b in (8, 1)}
    b, gate = ttrain.pick_train_batch(cfg, TrainPolicy(), SEQ, need - 1,
                                      (8, 1))
    assert b == 1
    for row, cb in zip(gate["candidates"], (8, 1)):
        rep = want[cb]
        assert (row["estimate"], row["tensor"], row["oom"]) == \
            (rep.peak_bytes, rep.peak_tensor_bytes, rep.oom)
        assert row["fits"] == (not rep.oom and rep.peak_bytes <= need - 1)
        assert row["rung"] == "exact"
    assert [r["source"] for r in gate["candidates"]] == ["traced"] * 2
    assert gate["decision"].report is gate["report"]
    assert gate["trace_cache"] == {"hits": 2, "misses": 4}
    # an estimator the caller passes keeps its role: its traces are hits
    est = XMemEstimator.for_torch_gpu()
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    est.trace_phases(fwd, TM.abstract_params(cfg),
                     treg.input_specs(cfg, smoke_shape(SEQ, 8)), upd, init)
    _, gate = ttrain.pick_train_batch(cfg, TrainPolicy(), SEQ, 1 << 62,
                                      (8,), est=est)
    assert gate["candidates"][0]["source"] == "memory"
    assert gate["trace_cache"] == {"hits": 3, "misses": 3}


def test_pick_serving_is_the_request_stream_estimate():
    cfg = treg.get_smoke("qwen3-32b")
    mix = tserve.parse_mix("48:16:4,16:48:4")
    knobs = ServingKnobs(page_size=16, max_concurrent=4, kv_dtype_bytes=2)
    max_len = 64
    kv_tok, resident = tserve.serving_cache_profile(cfg, max_len)
    want = XMemEstimator.for_torch_gpu().estimate_request_stream(
        tserve.make_decode_fn(cfg), TM.abstract_params(cfg),
        TM.init_cache(cfg, 4, max_len, device="meta"),
        tserve.decode_input(cfg, 4), stream=mix.stream(), knobs=knobs,
        kv_bytes_per_token=kv_tok, resident_bytes_per_request=resident,
        capacity=1 << 30)
    svc = AdmissionService(workers=1, cache=TraceCache())
    d, gate = tserve.pick_serving(cfg, mix, 1 << 30, knobs=knobs,
                                  max_len=max_len, service=svc)
    assert gate["serving"] == want.to_json()
    assert d.peak_bytes == want.worst_case_peak_bytes and d.admit
    assert (gate["kv_bytes_per_token"], gate["resident_bytes_per_request"]) \
        == (kv_tok, resident)
    d2, _ = tserve.pick_serving(cfg, mix, want.worst_case_peak_bytes - 1,
                                knobs=knobs, max_len=max_len, service=svc)
    assert not d2.admit and d2.peak_bytes == d.peak_bytes
    with pytest.raises(NotImplementedError, match="slice 10"):
        tserve.pick_serving(cfg, mix, 1 << 30, space=object())
    svc.close()


def test_cluster_score_is_bit_identical_to_the_reference():
    rows = [("a", "dense", 100, 90, 120), ("b", "dense", 100, 130, 90),
            ("c", "moe", 100, 80, 70), ("d", "moe", 100, 101, 99),
            ("e", "vlm", 100, 95, 95)]
    trecs = [tmetrics.RunRecord(c, f, "svc", "gpu", cap, est, truth, 0.5)
             for c, f, cap, est, truth in rows]
    jrecs = [jmetrics.RunRecord(c, f, "svc", "gpu", cap, est, truth, 0.5)
             for c, f, cap, est, truth in rows]
    assert tcluster.score(trecs) == jcluster.score(jrecs)


def test_what_waits_for_later_slices_raises():
    svc = AdmissionService(workers=1, cache=TraceCache())
    with pytest.raises(NotImplementedError, match="slice 10"):
        svc.decide(jobs.request("offload", offload=object()))
    with pytest.raises(NotImplementedError, match="slice 11"):
        svc.decide(jobs.request("sharded", shard_factor_fn=lambda b: 2.0))
    with pytest.raises(NotImplementedError, match="slice 11"):
        svc.mesh_sweep(None, None, None, ())
    # a rejection with a plan context would get counter-offers
    plan = JobContext(None, None, None)
    with pytest.raises(NotImplementedError, match="slice 10"):
        svc.decide(jobs.request("reject", capacity=1, meta={"plan": plan}))
    assert svc.decide(jobs.request("admit", meta={"plan": plan})).admit
    with pytest.raises(NotImplementedError, match="slice 10"):
        svc.decide_serving("s", None, None, None, None, capacity=1,
                           plan=object())
    with pytest.raises(ValueError, match="capacity"):
        svc.decide(jobs.request("nocap", capacity=None))
    svc.close()


def test_cache_and_store_dir_conflict(tmp_path):
    with pytest.raises(ValueError):
        AdmissionService(cache=TraceCache(), store_dir=str(tmp_path / "s"))
    assert not (tmp_path / "s").exists()     # refused before touching disk


def test_default_factory_is_the_gpu_preset():
    svc = AdmissionService(workers=1, cache=TraceCache())
    est = svc.estimator
    ref = XMemEstimator.for_torch_gpu()
    assert est.allocator_policy == ref.allocator_policy
    assert est.cublas_workspace == ref.cublas_workspace > 0
    assert est.orchestrator.policy == ref.orchestrator.policy
    assert est.trace_cache is svc.cache
    assert AdmissionService(workers=1).cache is GLOBAL_TRACE_CACHE
    svc.close()


def test_a_faulted_gate_reports_its_rung():
    cfg = treg.get_smoke("qwen3-32b")
    svc = ttrain.gate_service()
    b, gate = ttrain.pick_train_batch(cfg, TrainPolicy(), SEQ, 1 << 40,
                                      (4,), service=svc)
    with svc.inject_faults(plan_raising_at("replay")):
        b2, gate2 = ttrain.pick_train_batch(cfg, TrainPolicy(), SEQ,
                                            1 << 40, (4,), service=svc)
    row = gate2["candidates"][0]
    assert (row["rung"], row["source"], row["oom"]) == \
        ("sweep", "degraded", None)
    assert row["estimate"] >= gate["candidates"][0]["estimate"]
    assert gate2["report"] is None and b2 == 4
    assert b == 4

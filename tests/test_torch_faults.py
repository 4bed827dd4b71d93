"""The port's fault harness and degradation ladder against the JAX
package's and against the card's contract.

* ``FaultPlan`` hit/fire/exhaust counts, ``backoff_delays`` and
  ``DecisionLog.lookup`` are bit-identical to the reference's on the
  same inputs (stdlib code on both sides).
* ``request_scalar`` and ``analytic_request_bound`` are byte-exact to
  the JAX package's for the smoke dense job (qwen3-32b), with and
  without decision-log evidence; ``launch/analytic.py`` is bit-identical
  to the reference for every smoke config.
* The reference's ladder cases on the port's small job
  (``torch_service_jobs``): analytic when cold, the decision-log rung,
  transient retry, a hang abandoned at the deadline, ``decide_serving``
  degrading, the health surface, and the chaos replay's zero-OOM matrix
  with ``ChaosSafetyViolation`` on a forced unsafe answer.
* The port's ladder deltas: an out-of-memory replay is no evidence, a
  rung-2 answer never falls below the log's monotone bound, a job's
  configuration bounds rung 3, and an abandoned rung stops at its next
  stage checkpoint.
"""
import math
import threading
import time

import pytest
import torch

import torch_service_jobs as jobs
from repro.configs import registry as jreg
from repro.configs.base import ALL_SHAPES as JAX_SHAPES
from repro.launch import analytic as janalytic
from repro.models import model as JM
from repro.service import AdmissionRequest as JaxRequest
from repro.service import degrade as jdeg
from repro.service import faults as jfaults
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ALL_SHAPES, smoke_shape
from repro_torch.core.cache import TraceCache
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.service import (FLEET_SITES, AdmissionRequest,
                                 AdmissionService,
                                 ChaosSafetyViolation, ClusterSimulator,
                                 DegradePolicy, FaultPlan, FaultSpec,
                                 JobContext, TransientFaultError,
                                 fleet_event, plan_raising_at)
from repro_torch.service import degrade as tdeg
from repro_torch.service import faults as tfaults
from repro_torch.service.degrade import (RUNG_ANALYTIC, RUNG_EXACT,
                                         RUNG_SWEEP, DecisionLog,
                                         backoff_delays, request_family,
                                         request_scalar)
from repro_torch.train.train_step import TrainPolicy

B, D, H, L = jobs.B, jobs.D, jobs.H, jobs.L


def _svc(**kw):
    kw.setdefault("workers", 1)
    if "store_dir" not in kw:
        kw.setdefault("cache", TraceCache())
    return AdmissionService(**kw)


# -- bit-identical to the reference ------------------------------------------
_SCRIPT = [("tracer", "raise", 2, 0), ("replay", "transient", 1, 2),
           ("tracer", "raise", None, 5), ("store.load", "corrupt", 1, 0)]


def _drive(mod):
    plan = mod.FaultPlan([mod.FaultSpec(s, k, times=t, after=a)
                          for s, k, t, a in _SCRIPT])
    outcomes = []
    for site in ["tracer"] * 8 + ["replay"] * 4 + ["store.load"] * 2:
        try:
            plan.check(site)
            outcomes.append("ok")
        except Exception as e:   # noqa: BLE001 — the outcome is the type
            outcomes.append(type(e).__name__)
    return outcomes, plan.stats()


def test_fault_plan_counts_match_the_reference():
    assert _drive(tfaults) == _drive(jfaults)


def test_backoff_delays_match_the_reference():
    for kw in ({}, {"retries": 5, "backoff_s": 0.1, "backoff_cap_s": 0.3},
               {"retries": 3, "jitter": 0.0}):
        for seed in ("job-1", "job-2", "qwen3-32b/b8"):
            assert backoff_delays(DegradePolicy(**kw), seed) == \
                jdeg.backoff_delays(jdeg.DegradePolicy(**kw), seed)


def test_decision_log_lookup_matches_the_reference():
    points = [(("f",), 100, 1000, 400), (("f",), 300, 2200, 400),
              (("g",), 64, 5000, 4990), (("g",), 128, 5010, 4990),
              (("h",), 50, 900, 100)]
    logs = (DecisionLog(), jdeg.DecisionLog())
    for log in logs:
        for fam, s, peak, pers in points:
            log.record(fam, s, peak, pers)
    for fam in (("f",), ("g",), ("h",), ("none",)):
        for s in (0, 1, 50, 64, 100, 128, 150, 200, 300, 1000):
            assert logs[0].lookup(fam, s) == logs[1].lookup(fam, s)
    assert logs[0].stats() == logs[1].stats()
    bounded = [DecisionLog(max_families=2, max_points_per_family=3),
               jdeg.DecisionLog(max_families=2, max_points_per_family=3)]
    for log in bounded:
        for f in range(4):
            for s in range(5):
                log.record((f,), s, s * 10, 1)
    assert bounded[0].stats() == bounded[1].stats()
    assert [bounded[0].lookup((f,), 7) for f in range(4)] == \
        [bounded[1].lookup((f,), 7) for f in range(4)]


def _dense_requests(batch=2, seq=32):
    """The smoke dense job as the port's and the JAX package's
    requests."""
    tcfg = treg.get_smoke("qwen3-32b")
    jcfg = jreg.get_smoke("qwen3-32b")
    tf, tu, ti = ttrain.make_estimator_hooks(tcfg, TrainPolicy())
    jf, ju, ji = jax_hooks(jcfg, JaxTrainPolicy())
    from repro.configs.base import smoke_shape as jsmoke
    tr = AdmissionRequest(
        "dense", tf, TM.abstract_params(tcfg),
        treg.input_specs(tcfg, smoke_shape(seq, batch)), update_fn=tu,
        opt_init_fn=ti, capacity=1 << 30)
    jr = JaxRequest(
        "dense", jf, JM.abstract_params(jcfg),
        jreg.input_specs(jcfg, jsmoke(seq, batch)), update_fn=ju,
        opt_init_fn=ji, capacity=1 << 30)
    return tr, jr


def test_request_scalar_and_analytic_bound_are_byte_exact_to_jax():
    for batch in (1, 2, 8):
        tr, jr = _dense_requests(batch)
        assert request_scalar(tr) == jdeg.request_scalar(jr)
        # cold: the default transient ratio
        assert tdeg.analytic_request_bound(tr) == \
            jdeg.analytic_request_bound(jr)
        # with the same evidence in both logs
        tlog, jlog = DecisionLog(), jdeg.DecisionLog()
        for log in (tlog, jlog):
            log.record(("x",), 4096, 9_000_000, 1_000_000)
            log.record(("x",), 8192, 13_000_000, 1_000_000)
        assert tdeg.analytic_request_bound(tr, tlog) == \
            jdeg.analytic_request_bound(jr, jlog)


def test_analytic_module_is_bit_identical_for_every_smoke_config():
    for arch in treg.ARCH_IDS:
        tcfg, jcfg = treg.get_smoke(arch), jreg.get_smoke(arch)
        for tshape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
            assert tanalytic.analytic_flops(tcfg, tshape) == \
                janalytic.analytic_flops(jcfg, jshape)
            assert tanalytic.analytic_flops(
                tcfg, tshape, remat_refwd=False) == \
                janalytic.analytic_flops(jcfg, jshape, remat_refwd=False)
            kw = dict(n_devices=4, model_shards=2, fsdp_shards=1,
                      microbatches=2)
            assert tanalytic.analytic_bytes(tcfg, tshape, **kw) == \
                janalytic.analytic_bytes(jcfg, jshape, **kw)
            for mb in (1, 4):
                assert tanalytic.analytic_peak_bytes(
                    tcfg, tshape, microbatches=mb) == \
                    janalytic.analytic_peak_bytes(jcfg, jshape,
                                                  microbatches=mb)


# -- the fault plan ----------------------------------------------------------
class TestFaultPlan:
    def test_fires_then_exhausts(self):
        plan = FaultPlan([FaultSpec("tracer", "raise", times=2)])
        for _ in range(2):
            with pytest.raises(Exception):
                plan.check("tracer")
        plan.check("tracer")        # exhausted: no-op
        assert plan.stats()["fired"]["tracer"] == 2
        assert plan.stats()["hits"]["tracer"] == 3

    def test_transient_is_distinct(self):
        plan = FaultPlan([FaultSpec("tracer", "transient", times=1)])
        with pytest.raises(TransientFaultError):
            plan.check("tracer")

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            FaultSpec("tracer", "explode")

    def test_fleet_events_poll_but_never_check(self):
        plan = FaultPlan([fleet_event(s, at=1) for s in FLEET_SITES])
        for s in FLEET_SITES:
            plan.check(s)                   # tick 0: nothing scheduled
            assert plan.poll(s) is not None  # tick 1: fires
        with pytest.raises(ValueError):
            fleet_event("tracer")


# -- the ladder --------------------------------------------------------------
class TestDegradationLadder:
    def test_analytic_rung_when_cold(self):
        svc = _svc()
        with svc.inject_faults(plan_raising_at("tracer")):
            d = svc.decide(jobs.request("cold"))
        assert d.degraded and d.rung == RUNG_ANALYTIC
        assert d.margin == svc.degrade.analytic_margin
        assert d.peak_bytes == math.ceil(d.raw_peak_bytes * d.margin)
        assert d.provenance["source"] == "degraded"
        assert any("Fault" in e for e in d.provenance["rung_errors"])
        p_bytes = sum(4 * D * H for _ in range(L))
        assert d.raw_peak_bytes > 3 * p_bytes
        # the bound holds the training step's two cuBLAS workspaces, as
        # the exact rung's replay does: never thinner than the exact one
        ws = svc.estimator.cublas_workspace
        assert ws > 0 and d.raw_peak_bytes > 2 * ws
        assert d.peak_bytes >= svc.decide(jobs.request("exact")).peak_bytes
        svc.close()

    def test_sweep_rung_cached_point(self):
        svc = _svc()
        exact = svc.decide(jobs.request("seed", batch=B))
        assert exact.rung == RUNG_EXACT and exact.margin == 1.0
        with svc.inject_faults(plan_raising_at("replay")):
            d = svc.decide(jobs.request("hurt", batch=B))
        assert d.rung == RUNG_SWEEP
        assert d.provenance["derived"] == "cached"
        assert d.raw_peak_bytes == exact.peak_bytes
        assert d.peak_bytes == math.ceil(
            exact.peak_bytes * svc.degrade.sweep_margin)
        assert svc.rung_counts[RUNG_SWEEP] == 1
        svc.close()

    def test_sweep_rung_interpolates_up_to_the_monotone_bound(self):
        svc = _svc()
        lo = svc.decide(jobs.request("lo", batch=4))
        hi = svc.decide(jobs.request("hi", batch=16))
        with svc.inject_faults(plan_raising_at("replay")):
            d = svc.decide(jobs.request("mid", batch=8))
        assert d.rung == RUNG_SWEEP
        assert d.provenance["derived"].startswith("interpolated")
        # the log's line through the two points, raised to the peak at
        # the next larger batch: memory does not fall as the batch grows
        line, how = svc.log.lookup(request_family(jobs.request()),
                                   request_scalar(jobs.request(batch=8)))
        assert how == "interpolated"
        assert d.raw_peak_bytes == max(line, hi.peak_bytes)
        assert lo.peak_bytes <= d.raw_peak_bytes <= hi.peak_bytes
        svc.close()

    def test_sweep_rung_scales_a_single_point_up(self):
        svc = _svc()
        seed = svc.decide(jobs.request("seed", batch=4))
        with svc.inject_faults(plan_raising_at("tracer")):
            d = svc.decide(jobs.request("scaled", batch=16))
        assert d.rung == RUNG_SWEEP
        assert d.provenance["derived"] == "scaled"
        assert d.raw_peak_bytes >= seed.peak_bytes
        svc.close()

    def test_sweep_rung_never_scales_below_a_larger_batch(self):
        svc = _svc()
        seed = svc.decide(jobs.request("seed", batch=16))
        with svc.inject_faults(plan_raising_at("tracer")):
            d = svc.decide(jobs.request("smaller", batch=4))
        assert d.provenance["derived"] == "scaled+monotone"
        assert d.raw_peak_bytes == seed.peak_bytes
        svc.close()

    def test_monotone_bound(self):
        log = DecisionLog()
        assert log.monotone_bound(("f",), 10) is None
        for s, peak in ((100, 1000), (300, 2200), (200, 2500)):
            log.record(("f",), s, peak, 400)
        assert log.monotone_bound(("f",), 50) == 1000
        assert log.monotone_bound(("f",), 150) == 2200
        assert log.monotone_bound(("f",), 300) == 2200
        assert log.monotone_bound(("f",), 301) is None
        assert log.monotone_bound(None, 1) is None

    def test_an_out_of_memory_replay_is_no_evidence(self):
        svc = _svc()
        free = svc.decide(jobs.request("free", batch=B))
        svc.decide(jobs.request("tight", batch=B,
                                capacity=free.peak_bytes // 2))
        assert svc.log.stats()["records"] == 1
        svc.close()

    def test_the_jobs_configuration_bounds_the_analytic_rung(self):
        cfg = treg.get_smoke("qwen3-32b")
        shape = smoke_shape(32, 2)
        req = ttrain.train_request(cfg, TrainPolicy(), shape, 1 << 30)
        assert isinstance(req.meta["job"], JobContext)
        assert tdeg.analytic_request_bound(req) == \
            tanalytic.analytic_peak_bytes(cfg, shape)
        assert tdeg.analytic_request_bound(req, workspace_bytes=7) == \
            7 + tanalytic.analytic_peak_bytes(cfg, shape)
        bare = ttrain.train_request(cfg, TrainPolicy(), shape, 1 << 30)
        bare.meta = {}
        assert tdeg.analytic_request_bound(bare) != \
            tdeg.analytic_request_bound(req)

    def test_transient_fault_retries_to_exact(self):
        svc = _svc()
        plan = FaultPlan([FaultSpec("tracer", "transient", times=1)])
        with svc.inject_faults(plan):
            d = svc.decide(jobs.request("flaky"))
        assert not d.degraded and d.rung == RUNG_EXACT
        assert svc.retry_count >= 1
        assert plan.stats()["fired"]["tracer"] == 1
        svc.close()

    def test_hang_abandoned_at_deadline(self):
        svc = _svc()
        plan = FaultPlan([FaultSpec("tracer", "hang", hang_s=20.0,
                                    times=None)])
        with svc.inject_faults(plan):
            d = svc.decide(jobs.request("stuck", deadline_s=0.75))
        assert d.degraded
        assert d.deadline_s == 0.75
        assert d.wall_s < 5.0
        assert svc.timeout_count >= 1 and svc.abandoned_rungs >= 1
        assert any("timeout" in e for e in d.provenance["rung_errors"])
        svc.close()

    def test_an_abandoned_rung_stops_at_its_next_checkpoint(self):
        """Woken from its hang when the injection scope exits, the
        abandoned rung raises at the checkpoint instead of tracing: the
        cache gets no trace."""
        svc = _svc()
        plan = FaultPlan([FaultSpec("tracer", "hang", hang_s=60.0,
                                    times=None)])
        with svc.inject_faults(plan):
            d = svc.decide(jobs.request("abandon", deadline_s=0.3))
        assert d.degraded
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline and any(
                t.name == "xmem-rung" and t.is_alive()
                for t in threading.enumerate()):
            time.sleep(0.02)
        assert not any(t.name == "xmem-rung" and t.is_alive()
                       for t in threading.enumerate())
        assert len(svc.cache) == 0 and svc.cache.misses == 1
        svc.close()

    def test_ladder_path_matches_inline_values(self):
        ref_svc = _svc()
        ref = ref_svc.decide(jobs.request("ref"))
        svc = _svc(deadline_s=120.0)
        d = svc.decide(jobs.request("ladder"))
        assert not d.degraded
        assert (d.peak_bytes, d.peak_tensor_bytes, d.persistent_bytes) \
            == (ref.peak_bytes, ref.peak_tensor_bytes,
                ref.persistent_bytes)
        assert d.breakdown == ref.breakdown
        ref_svc.close()
        svc.close()

    def test_decide_serving_degrades(self):
        svc = _svc()

        def decode(p, c, b):
            return torch.tanh(b["x"] @ p["w0"]) + c["kv"][:, :H]

        params = {"w0": torch.empty((D, H), device="meta")}
        cache = {"kv": torch.empty((B, 2 * H), device="meta")}
        batch = {"x": torch.empty((B, D), device="meta")}
        with svc.inject_faults(plan_raising_at("tracer")):
            d = svc.decide_serving("srv", decode, params, cache, batch,
                                   capacity=1 << 30)
        assert d.degraded and d.rung == RUNG_ANALYTIC
        assert d.raw_peak_bytes > 4 * B * 2 * H
        svc.close()

    def test_decide_sweep_degrades_every_point(self):
        svc = _svc()
        reqs = [jobs.request(f"p{b}", batch=b) for b in (4, 8, 16)]
        with svc.inject_faults(plan_raising_at("tracer")):
            decisions = svc.decide_sweep(reqs)
        assert len(decisions) == len(reqs)
        assert all(d.degraded for d in decisions)
        decisions2 = svc.decide_sweep(
            [jobs.request(f"q{b}", batch=b) for b in (4, 8, 16)])
        assert all(not d.degraded for d in decisions2)
        svc.close()

    def test_health_surface(self):
        svc = _svc()
        svc.decide(jobs.request("ok"))
        with svc.inject_faults(plan_raising_at("tracer")):
            svc.decide(jobs.request("bad", batch=16))
        h = svc.health()
        assert h["status"] == "ok"
        assert h["requests_served"] == 2
        assert h["rungs"][RUNG_EXACT] == 1
        assert h["degraded"] == 1
        assert h["in_flight"] == 0
        assert h["decision_log"]["records"] == 1
        assert "trace_cache" in h
        svc.close()


class TestDecisionLogFamilies:
    def test_family_separates_structures(self):
        r1 = jobs.request("a", batch=8)
        r2 = jobs.request("b", batch=16)
        assert request_family(r1) == request_family(r2)
        assert request_scalar(r2) == 2 * request_scalar(r1)
        r3 = jobs.request("c", batch=8)
        r3.update_fn = None
        assert request_family(r3) != request_family(r1)


# -- chaos replay ------------------------------------------------------------
class TestChaosReplay:
    SITES = ("tracer", "replay")
    STORE_SITES = ("store.load", "store.save")

    def _truth(self):
        svc = _svc()
        out = ClusterSimulator(svc).replay(
            [jobs.arrival(f"j{b}", batch=b) for b in (4, 8, 16)])
        svc.close()
        return {d.job_id: d.peak_bytes for d in out.decisions}

    def _arrivals(self, truth):
        return [jobs.arrival(f"j{b}", batch=b, truth_bytes=truth[f"j{b}"])
                for b in (4, 8, 16)]

    def test_matrix_serves_all_zero_oom(self):
        truth = self._truth()
        for site in self.SITES:
            svc = _svc()
            out = ClusterSimulator(svc).replay(
                self._arrivals(truth), faults=plan_raising_at(site))
            assert out.summary["served"] == 3, site
            assert out.summary["oom_admitted"] == 0, site
            assert out.summary["degraded"] == 3, site
            for d in out.decisions:
                assert d.rung in (RUNG_SWEEP, RUNG_ANALYTIC)
                assert d.margin > 1.0
                assert d.provenance["rung_errors"]
            svc.close()

    def test_matrix_store_sites(self, tmp_path):
        truth = self._truth()
        for site in self.STORE_SITES:
            svc = AdmissionService(
                workers=1, store_dir=str(tmp_path / site.replace(".", "_")))
            out = ClusterSimulator(svc).replay(
                self._arrivals(truth), faults=plan_raising_at(site))
            assert out.summary["served"] == 3, site
            assert out.summary["oom_admitted"] == 0, site
            svc.close()

    def test_hang_matrix_answers_within_deadline(self):
        truth = self._truth()
        svc = _svc()
        plan = FaultPlan([FaultSpec("tracer", "hang", hang_s=15.0,
                                    times=None)])
        out = ClusterSimulator(svc).replay(
            self._arrivals(truth), faults=plan, deadline_s=0.75)
        assert out.summary["served"] == 3
        assert out.summary["oom_admitted"] == 0
        for d in out.decisions:
            assert d.degraded and d.wall_s < 5.0
        svc.close()

    def test_faults_detached_after_replay(self):
        svc = _svc()
        ClusterSimulator(svc).replay(
            [jobs.arrival("j8")], faults=plan_raising_at("tracer"))
        assert svc.faults is None
        assert not svc.decide(jobs.request("after")).degraded
        svc.close()

    def test_safety_violation_raises(self):
        svc = _svc()
        bad = jobs.arrival("liar", batch=4, capacity=1 << 40,
                           truth_bytes=(1 << 40) + 1)
        with pytest.raises(ChaosSafetyViolation):
            ClusterSimulator(svc).replay(
                [bad], faults=plan_raising_at("tracer"))
        svc.close()

    def test_plain_replay_unchanged(self):
        svc = _svc()
        out = ClusterSimulator(svc).replay(
            [jobs.arrival(f"j{b}", batch=b) for b in (4, 8)])
        assert out.summary["degraded"] == 0
        assert out.summary["rungs"] == {RUNG_EXACT: 2}
        assert out.summary["oom_admitted"] == 0
        svc.close()


class TestHangCancellation:
    def test_cancel_wakes_a_sleeping_hang(self):
        plan = FaultPlan([FaultSpec("tracer", "hang", hang_s=60.0,
                                    times=1)])
        plan.arm()
        woke = threading.Event()

        def sleeper():
            plan.check("tracer")
            woke.set()

        t = threading.Thread(target=sleeper, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not woke.is_set()
        plan.cancel()
        assert woke.wait(5.0)

    def test_inject_faults_exit_frees_hung_rung_threads(self):
        svc = _svc()
        try:
            svc.decide(jobs.request("hc-warm"))
            plan = FaultPlan([FaultSpec("replay", "hang", hang_s=60.0,
                                        times=None)])
            t0 = time.perf_counter()
            with svc.inject_faults(plan):
                d = svc.decide(jobs.request("hc-hang", deadline_s=0.5))
            assert d.degraded
            assert time.perf_counter() - t0 < 10.0
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline:
                stuck = [t for t in threading.enumerate()
                         if t.name == "xmem-rung" and t.is_alive()]
                if not stuck:
                    break
                time.sleep(0.05)
            assert not stuck
        finally:
            svc.close()


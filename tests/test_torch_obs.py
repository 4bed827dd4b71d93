"""The port's observability modules against the JAX package's.

* The same sequence of counter, gauge, histogram and collector
  operations gives the same Prometheus text, the same
  ``parse_prometheus`` dict and the same JSON as ``repro.obs.metrics``.
* The same ``AuditLog`` appends, torn tail, corrupt middle line and
  rotation give the same records and recovery reports (the records'
  wall-clock ``ts`` aside).
* ``ingest``'s residual records and summary are the same.
* ``Observability.request`` mints distinct correlation IDs and yields
  ``None`` when disabled; an instrumented service decides
  bit-identically to a bare one and audits each decision once.
* The reference's audit, metrics and ingest cases.
"""
import json
import os
import threading

import pytest

import torch_service_jobs as jobs
from repro.obs import audit as jaudit
from repro.obs import ingest as jingest
from repro.obs import metrics as jmetrics
from repro_torch.core.cache import TraceCache
from repro_torch.launch.served import handle_request
from repro_torch.obs import (AuditLog, CounterDict, MetricsRegistry,
                             Observability, parse_prometheus)
from repro_torch.obs import audit as taudit
from repro_torch.obs import ingest as tingest
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.ingest import GPUMemorySnapshot, TelemetryIngestor
from repro_torch.service import AdmissionService


# -- bit-identical to the reference ------------------------------------------
def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("xmem_req_total", "requests", labels={"kind": "train"})
    c2 = reg.counter("xmem_req_total", labels={"kind": "serve"})
    g = reg.gauge("xmem_in_flight", "in flight")
    h = reg.histogram("xmem_decide_seconds", "decide time")
    cd = mod.CounterDict(("exact", "sweep"), registry=reg,
                         name="xmem_rung_total", label="rung")
    for i in range(300):
        c.inc()
        if i % 3 == 0:
            c2.inc(2)
        g.inc()
        if i % 2:
            g.dec()
        h.observe(i / 97.0)
        cd.inc("exact" if i % 5 else "analytic")
    cd["sweep"] += 4
    reg.register_collector("xmem_cache", lambda: {
        "hits": 7, "misses": 2, "store": {"loads": 3, "dir": "/x"}})
    reg.register_collector("xmem_bad", lambda: 1 / 0)
    text = reg.to_prometheus()
    return text, mod.parse_prometheus(text), reg.to_json(), dict(cd.items())


def test_metrics_registry_matches_the_reference():
    assert _drive_metrics(tmetrics) == _drive_metrics(jmetrics)


def _drive_audit(mod, d):
    with mod.AuditLog(d, max_bytes=160) as log:
        for i in range(12):
            log.append({"kind": "decide", "i": i})
        path = log.path
    with open(path, "ab") as f:
        f.write(b'{"seq": 99, "kind": "dec')           # torn tail
    out = []
    with mod.AuditLog(d, max_bytes=160) as log:
        out.append(dict(log.recovery))
        log.append({"kind": "after", "i": 12})
        path = log.path
    with open(path, "ab") as f:
        f.write(b"not json at all\n")                   # corrupt middle
        f.write(b'{"kind": "lost"}\n')
    with mod.AuditLog(d, max_bytes=160) as log:
        out.append(dict(log.recovery))
        out.append(log.rotations)
        out.append([{k: v for k, v in r.items() if k != "ts"}
                    for r in log.records()])
        out.append(sorted(n.split(".", 2)[2] for n in os.listdir(
            os.path.join(d, mod.AuditLog.QUARANTINE_DIR))))
    return out


def test_audit_log_matches_the_reference(tmp_path):
    assert _drive_audit(taudit, str(tmp_path / "t")) == \
        _drive_audit(jaudit, str(tmp_path / "j"))


def _drive_ingest(mod, d):
    ing = mod.TelemetryIngestor(d)
    snap = mod.GPUMemorySnapshot(timestamp=1.0, reserved_mb=1.5,
                                 allocated_mb=1.2, total_mb=80.0)
    recs = [ing.ingest("digest-a", "fam0", 2**20, snapshot=snap),
            ing.ingest("digest-a", "fam0", 2**20, observed_bytes=3 * 2**19),
            ing.ingest("digest-b", "fam1", 5 * 2**20,
                       observed_bytes=4 * 2**20)]
    ing.close()
    ing = mod.TelemetryIngestor(d)
    out = ([{k: v for k, v in r.items() if k != "ts"} for r in recs],
           ing.summary(), len(ing.residuals("digest-a")))
    ing.close()
    return out


def test_ingest_matches_the_reference(tmp_path):
    assert _drive_ingest(tingest, str(tmp_path / "t")) == \
        _drive_ingest(jingest, str(tmp_path / "j"))


# -- Observability -----------------------------------------------------------
def test_request_scope_mints_distinct_ids_and_none_when_disabled():
    obs = Observability(enabled=True)
    cids = []
    for _ in range(5):
        with obs.request("decide", job_id="x") as cid:
            cids.append(cid)
    assert len(set(cids)) == 5 and all(c.startswith("xm-") for c in cids)
    off = Observability(enabled=False)
    with off.request("decide", job_id="x") as cid:
        assert cid is None
    assert off.tracer.started == 0


def _obs_service(tmp_path, workers=1):
    obs = Observability(enabled=True, audit_dir=str(tmp_path / "audit"))
    return AdmissionService(workers=workers, cache=TraceCache(), obs=obs)


def test_instrumented_decision_bit_identical_to_bare(tmp_path):
    bare = AdmissionService(workers=1, cache=TraceCache())
    inst = _obs_service(tmp_path)
    try:
        d0 = bare.decide(jobs.request("bit"))
        d1 = inst.decide(jobs.request("bit"))
        for f in ("peak_bytes", "peak_tensor_bytes", "persistent_bytes",
                  "safe_threshold", "breakdown"):
            assert getattr(d1, f) == getattr(d0, f), f
        assert d1.correlation_id and d0.correlation_id is None
        assert d1.to_json()["correlation_id"] == d1.correlation_id
        assert "correlation_id" not in d0.to_json()
    finally:
        bare.close()
        inst.close()


def test_decide_many_exactly_one_audit_record_each(tmp_path):
    svc = _obs_service(tmp_path, workers=2)
    try:
        decisions = svc.decide_many([jobs.request(f"many-{i}",
                                                  batch=jobs.B + i)
                                     for i in range(6)])
        by_job = {}
        for r in svc.obs.audit.records(kind="decide"):
            by_job.setdefault(r["job_id"], []).append(r)
        for d in decisions:
            (mine,) = by_job[d.job_id]
            assert mine["correlation_id"] == d.correlation_id
            assert mine["peak_bytes"] == d.peak_bytes
        assert len({d.correlation_id for d in decisions}) == 6
        assert svc.obs.registry.to_json()["counters"][
            "xmem_service_requests_total"] == 6
    finally:
        svc.close()


def test_daemon_metrics_kind_serves_both_formats(tmp_path):
    svc = _obs_service(tmp_path)
    try:
        svc.decide(jobs.request("daemon"))
        out = handle_request(svc, {"kind": "metrics"}, device="cpu")
        assert out["metrics"]["counters"]["xmem_service_requests_total"] == 1
        assert parse_prometheus(out["prometheus"])[
            "xmem_service_requests_total"] == 1.0
        out2 = handle_request(svc, {"kind": "metrics"}, device="cpu")
        assert parse_prometheus(out2["prometheus"])[
            'xmem_daemon_requests_total{kind="metrics"}'] >= 1.0
    finally:
        svc.close()


# -- the reference's cases -----------------------------------------------------
class TestAuditLog:
    def test_append_reopen_round_trip(self, tmp_path):
        d = str(tmp_path)
        with AuditLog(d) as log:
            for i in range(3):
                rec = log.append({"kind": "decide", "i": i})
                assert rec["seq"] == i + 1 and rec["ts"] > 0
        with AuditLog(d) as log:
            assert [r["i"] for r in log.records()] == [0, 1, 2]
            assert log.recovery == {"records": 3, "torn_bytes": 0,
                                    "quarantined": 0}

    def test_torn_tail_quarantined_not_lost(self, tmp_path):
        d = str(tmp_path)
        with AuditLog(d) as log:
            for i in range(5):
                log.append({"kind": "decide", "i": i})
            path = log.path
        torn = b'{"seq": 6, "kind": "dec'
        with open(path, "ab") as f:
            f.write(torn)
        with AuditLog(d) as log:
            assert log.recovery["torn_bytes"] == len(torn)
            assert [r["i"] for r in log.records()] == [0, 1, 2, 3, 4]
            qdir = os.path.join(d, AuditLog.QUARANTINE_DIR)
            (qfile,) = os.listdir(qdir)
            with open(os.path.join(qdir, qfile), "rb") as f:
                assert f.read() == torn
            assert log.append({"kind": "decide", "i": 5})["seq"] == 6

    def test_rotation_preserves_order_and_durability(self, tmp_path):
        d = str(tmp_path)
        with AuditLog(d, max_bytes=128) as log:
            for i in range(20):
                log.append({"kind": "decide", "i": i})
            assert log.rotations >= 1
        with AuditLog(d, max_bytes=128) as log:
            assert [r["i"] for r in log.records()] == list(range(20))

    def test_fsync_mode_validated(self, tmp_path):
        with pytest.raises(ValueError):
            AuditLog(str(tmp_path), fsync="sometimes")


class TestMetricsRegistry:
    def test_concurrent_mutation_is_exact(self):
        reg = MetricsRegistry()
        c = reg.counter("xmem_test_total")
        g = reg.gauge("xmem_test_gauge")
        h = reg.histogram("xmem_test_seconds")
        threads, per = 8, 500

        def work():
            for i in range(per):
                c.inc()
                g.inc()
                g.dec()
                h.observe(float(i))

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        assert c.value == threads * per and g.value == 0
        assert h.count == threads * per and h.max == float(per - 1)

    def test_counterdict_behaves_like_a_dict(self):
        d = CounterDict(("a", "b"), name="xmem_cd_total", label="k")
        d["a"] += 2
        d.inc("c")
        assert list(d.keys()) == ["a", "b", "c"]
        assert d == {"a": 2, "b": 0, "c": 1}
        with pytest.raises(KeyError):
            d["unknown"]


class TestIngest:
    def test_residual_ingestion_persists_across_reopen(self, tmp_path):
        d = str(tmp_path / "telemetry")
        ing = TelemetryIngestor(d)
        snap = GPUMemorySnapshot(timestamp=1.0, reserved_mb=1.5,
                                 allocated_mb=1.2)
        rec = ing.ingest("digest-a", "fam0", estimate_bytes=2 ** 20,
                         snapshot=snap)
        assert rec["residual_bytes"] == rec["observed_bytes"] - 2 ** 20
        ing.ingest("digest-a", "fam0", estimate_bytes=2 ** 20,
                   observed_bytes=2 ** 20)
        ing.close()
        ing = TelemetryIngestor(d)
        summary = ing.summary()["digest-a/fam0"]
        assert summary["n"] == 2
        assert summary["max_ratio"] == pytest.approx(1.5)
        ing.close()

    def test_ingest_cli_round_trip(self, tmp_path, capsys):
        d = str(tmp_path / "telemetry")
        assert tingest.main(["--dir", d, "--model-digest", "abc",
                             "--family", "fam", "--estimate-bytes",
                             "1000000", "--observed-mb", "1.2"]) == 0
        rec = json.loads(capsys.readouterr().out)
        assert rec["observed_bytes"] == int(1.2 * 2 ** 20)
        assert tingest.main(["--dir", d, "--summary"]) == 0
        assert json.loads(capsys.readouterr().out)["abc/fam"]["n"] == 1


def test_hillclimb_runs_under_one_correlation_id():
    from repro_torch.launch import hillclimb as thc
    obs = Observability(enabled=True)
    out = thc.xmem_batch_hillclimb("qwen3-32b", 1 << 40, seq=32,
                                   max_batch=4, verbose=False, obs=obs)
    cid = out["correlation_id"]
    assert cid and out["best_batch"] == 4
    spans = obs.to_chrome_trace()["traceEvents"]
    ids = {e["args"].get("correlation_id") for e in spans
           if e.get("args", {}).get("correlation_id")}
    assert ids == {cid}
    bare = thc.xmem_batch_hillclimb("qwen3-32b", 1 << 40, seq=32,
                                    max_batch=4, verbose=False)
    assert "correlation_id" not in bare
    assert [p["peak_bytes"] for p in bare["probes"]] == \
        [p["peak_bytes"] for p in out["probes"]]

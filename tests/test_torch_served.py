"""The port's admission daemon and the ``--serve-mix`` entry, on the CPU.

* ``handle_request`` answers ``train`` and ``serve`` for smoke jobs at a
  given capacity (``hbm_gib``), the ``train`` answer equal to the gate's
  decision; a request on the CPU without a capacity is an error.
* A socket round trip, and the reference's hardening cases: malformed
  and oversized lines, backpressure, draining, health over the wire, a
  socket fault, the wire deadline.
* ``place`` and ``evacuate`` (with ``restore``) answer the reference
  daemon's shape, directly and over the socket on the server's fleet;
  a fleet on the CPU without a capacity is a structured error.
* A ``plan`` request's mesh axes (``devices``, ``pad_vocab_multiple``)
  answer with the planner's topology and padded-vocab offers, equal to
  an in-process search; a ``train`` request's ``offload`` object answers
  with per-space peaks, a malformed one with a structured error.
* ``--once`` reads one request from stdin; ``serve_mix_main`` exits 0
  when the mix fits and 2 when it does not.
"""
import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.cache import TraceCache
from repro_torch.launch import serve as tserve
from repro_torch.launch import served
from repro_torch.launch import train as ttrain
from repro_torch.obs import parse_prometheus
from repro_torch.service import (AdmissionService, FaultPlan, FaultSpec,
                                 RUNG_ANALYTIC, RUNG_EXACT, RUNG_SWEEP)
from repro_torch.train.train_step import TrainPolicy

ROOT = Path(__file__).resolve().parents[1]
GIB = 0.25
TRAIN = {"kind": "train", "arch": "qwen3-32b", "smoke": True, "seq": 32,
         "batch": 4, "hbm_gib": GIB}


def _svc(**kw):
    kw.setdefault("workers", 1)
    kw.setdefault("cache", TraceCache())
    return AdmissionService(**kw)


def test_train_answer_is_the_gates_decision():
    svc = _svc()
    resp = served.handle_request(svc, dict(TRAIN), device="cpu")
    assert resp["ok"] and resp["admit"]
    ok, rep = ttrain.admission_check(
        treg.get_smoke("qwen3-32b"), TrainPolicy(), smoke_shape(32, 4),
        int(GIB * 2**30))
    assert ok
    assert (resp["peak_bytes"], resp["peak_tensor_bytes"],
            resp["persistent_bytes"]) == (rep.peak_bytes,
                                          rep.peak_tensor_bytes,
                                          rep.persistent_bytes)
    assert resp["rung"] == RUNG_EXACT and resp["capacity"] == 2**28
    assert resp["provenance"]["source"] == "traced"
    again = served.handle_request(svc, dict(TRAIN, id="again"),
                                  device="cpu")
    assert again["provenance"]["source"] == "memory"
    assert again["job_id"] == "again"
    assert again["peak_bytes"] == resp["peak_bytes"]
    svc.close()


def test_train_without_a_capacity_on_the_cpu_is_an_error():
    svc = _svc()
    d = dict(TRAIN)
    del d["hbm_gib"]
    resp = served.handle_request(svc, d, device="cpu")
    assert resp == {"ok": False, "kind": "error", "error": resp["error"]}
    assert "hbm_gib" in resp["error"]
    # a request that says it runs on the CPU needs one on any daemon
    resp = served.handle_request(svc, dict(d, device="cpu"))
    assert not resp["ok"] and "hbm_gib" in resp["error"]
    svc.close()


def test_serve_answer_is_the_serving_gate():
    svc = _svc()
    req = {"kind": "serve", "arch": "qwen3-32b", "smoke": True,
           "max_len": 32, "batch": 2, "hbm_gib": GIB}
    resp = served.handle_request(svc, req, device="cpu")
    batch, gate = tserve.pick_batch(treg.get_smoke("qwen3-32b"), 32,
                                    int(GIB * 2**30), candidates=(2,),
                                    service=_svc())
    assert resp["ok"] and resp["admit"] and resp["batch"] == batch == 2
    assert resp["peak_bytes"] == gate["peak"]
    assert resp["candidates"] == gate["candidates"]
    svc.close()


def test_plan_request_answers_its_mesh_axes():
    import functools

    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.plan import RemediationPlanner

    def svc_():
        # without the cuBLAS workspaces, which are most of a smoke
        # job's peak and would hide the per-device shares
        return _svc(estimator_factory=functools.partial(
            XMemEstimator.for_torch_gpu, cublas_workspace=0))
    svc = svc_()
    job = dict(TRAIN, kind="plan", seq=48, batch=32)
    free = served.handle_request(svc, job, device="cpu")
    assert free["ok"] and free["admit"]
    cap = free["peak_bytes"] - free["peak_bytes"] // 50
    req = dict(job, hbm_gib=cap / 2**30, devices=[2, 4],
               pad_vocab_multiple=96, batch_grid=[16], microbatch_grid=[],
               remat_grid=[], max_offers=64)
    resp = json.loads(json.dumps(served.handle_request(svc, req,
                                                       device="cpu")))
    assert resp["ok"] and not resp["admit"]
    knobs = {o["knob"] for o in resp["counter_offers"]}
    assert {"topology", "pad_vocab"} <= knobs
    assert resp["stats"]["axes"]["topology"] == 3 + 5     # 2 and 4 devices
    assert all(o["topology"] is not None for o in resp["counter_offers"]
               if o["knob"] in ("topology", "pad_vocab"))
    cfg, policy, shape = served._train_job(req)
    want = RemediationPlanner(svc_()).plan(
        cfg, policy, shape, capacity=served.request_capacity(req, "cpu"),
        space=served.build_plan_space(req), job_id="qwen3-32b-plan")
    assert resp["counter_offers"] == json.loads(json.dumps(
        [o.to_json() for o in want.offers]))
    svc.close()


FLEET = dict(TRAIN, kind="place", fleet_nodes=3, fleet_hbm_gib=GIB)


def test_place_and_evacuate_answer_the_references_shape():
    from repro.core.cache import TraceCache as JTraceCache
    from repro.launch import served as jserved
    from repro.service import AdmissionService as JAdmissionService
    svc, jsvc = _svc(), JAdmissionService(workers=1, cache=JTraceCache())
    try:
        r1 = served.handle_request(svc, dict(FLEET, id="a"), device="cpu")
        r2 = served.handle_request(svc, dict(FLEET, id="b"), device="cpu")
        assert r1["ok"] and r1["placed"] and r1["nodes"]
        assert r2["ok"] and r2["placed"]
        home = r1["nodes"][0]
        assert r1["fleet"]["nodes"][home]["committed"] \
            == r1["safe_threshold"] > 0
        assert r1["provenance"]["source"] == "traced"
        assert r2["provenance"]["source"] == "memory"
        r3 = served.handle_request(svc, {"kind": "evacuate", "node": home,
                                         "event": "node.flap"},
                                   device="cpu")
        assert r3["ok"]
        assert set(r3["displaced"]) == set(r3["replaced"]) | set(r3["lost"])
        assert r3["fleet"]["nodes"][home]["state"] == "down"
        r4 = served.handle_request(svc, {"kind": "evacuate", "node": home,
                                         "event": "restore"}, device="cpu")
        assert r4["fleet"]["nodes"][home]["state"] == "up"
        for r in (r1, r2, r3, r4):
            json.dumps(r)           # wire responses stay JSON-safe
        # the reference daemon's answers to the same requests: the same
        # keys (the port's place answer adds the decision's provenance)
        # and the same fleet
        ref = [jserved.handle_request(jsvc, d) for d in (
            dict(FLEET, id="a"), dict(FLEET, id="b"),
            {"kind": "evacuate", "node": home, "event": "node.flap"},
            {"kind": "evacuate", "node": home, "event": "restore"})]
        assert set(r1) == set(ref[0]) | {"provenance"}
        assert [r["nodes"] for r in (r1, r2)] \
            == [r["nodes"] for r in ref[:2]]
        assert {k for k in r3 if k != "wall_s"} \
            == {k for k in ref[2] if k != "wall_s"}
        assert [(r3[k], r4.get(k)) for k in ("displaced", "replaced")] \
            == [(ref[2][k], ref[3].get(k)) for k in ("displaced", "replaced")]
        assert set(r4) == set(ref[3])
        assert r4["fleet"]["nodes"].keys() == ref[3]["fleet"]["nodes"].keys()
    finally:
        svc.close()
        jsvc.close()


def test_a_fleet_on_the_cpu_needs_a_capacity():
    svc = _svc()
    try:
        d = dict(FLEET)
        del d["fleet_hbm_gib"]
        for req in (d, {"kind": "evacuate", "node": "node000"}):
            resp = served.handle_request(svc, req, device="cpu")
            assert resp == {"ok": False, "kind": "error",
                            "error": resp["error"]}
            assert "fleet_hbm_gib" in resp["error"]
        # the request's capacity is not the fleet's
        assert not served.handle_request(svc, dict(d, hbm_gib=1.0),
                                         device="cpu")["ok"]
    finally:
        svc.close()


def test_offload_answers_a_structured_error():
    svc = _svc()
    resp = served.handle_request(
        svc, dict(TRAIN, offload={"optimizer_state": True,
                                  "space": "no_such_space"}), device="cpu")
    assert resp["ok"] is False and resp["kind"] == "error"
    assert "ValueError" in resp["error"]
    resp = served.handle_request(
        svc, dict(TRAIN, offload={"optimizer_state": True,
                                  "min_block_bytes": 0}), device="cpu")
    assert resp["ok"] and resp["breakdown"]["space_peaks"]["host_pinned"] > 0
    svc.close()


def test_wire_deadline_reaches_request():
    req = served.build_train_request(dict(TRAIN, deadline_s=2.5), "cpu")
    assert req.deadline_s == 2.5
    assert served.build_train_request(dict(TRAIN), "cpu").deadline_s is None
    assert req.meta["job"].shape.global_batch == 4


def test_wire_job_is_the_launchers_job():
    cfg, policy, shape = served._train_job(
        {"arch": "internvl2-1b", "smoke": False, "batch": 8})
    assert cfg == treg.get_config("internvl2-1b")
    assert (shape.seq_len, shape.global_batch) == (4096, 8)
    assert policy == TrainPolicy()
    cut, _, _ = served._train_job({"arch": "qwen3-32b", "smoke": False,
                                   "n_layers": 4})
    assert cut.n_layers == 4


# -- the socket ----------------------------------------------------------------
def _server(**kw):
    svc = _svc(workers=2)
    server = served.AdmissionServer(("127.0.0.1", 0), svc, device="cpu",
                                    **kw)
    server.thread = threading.Thread(target=server.serve_forever,
                                     daemon=True)
    server.thread.start()
    return server, svc


def _lines(server, payloads):
    host, port = server.server_address[:2]
    with socket.create_connection((host, port), timeout=60.0) as s:
        f = s.makefile("rwb")
        out = []
        for p in payloads:
            f.write(p if isinstance(p, bytes)
                    else (json.dumps(p) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def _stop(server, svc):
    server.shutdown()
    server.server_close()
    svc.close()


def test_socket_round_trip_and_the_wire_kinds():
    server, svc = _server()
    try:
        host, port = server.server_address[:2]
        resp = served.request_once(host, port, dict(TRAIN))
        assert resp["ok"] and resp["admit"]
        health, stats, metrics = _lines(server, [
            {"kind": "health"}, {"kind": "stats"}, {"kind": "metrics"}])
        assert health["health"]["requests_served"] == 1
        assert stats["stats"]["requests_served"] == 1
        parsed = parse_prometheus(metrics["prometheus"])
        assert parsed["xmem_service_requests_total"] == 1.0
        assert metrics["metrics"]["counters"][
            "xmem_service_requests_total"] == 1
    finally:
        _stop(server, svc)


def test_place_and_evacuate_over_the_socket_on_the_servers_fleet():
    server, svc = _server(fleet_nodes=2, fleet_hbm_gib=GIB)
    try:
        place = {k: v for k, v in FLEET.items()
                 if k not in ("fleet_nodes", "fleet_hbm_gib")}
        placed, = _lines(server, [place])
        assert placed["ok"] and placed["nodes"] == ["node000"]
        assert sorted(placed["fleet"]["nodes"]) == ["node000", "node001"]
        assert placed["fleet"]["nodes"]["node000"]["capacity"] \
            == int(GIB * 2**30)
        evac, back = _lines(server, [
            {"kind": "evacuate", "node": "node000", "event": "node.fail"},
            {"kind": "evacuate", "node": "node000", "event": "restore"}])
        assert evac["displaced"] == evac["replaced"] == [placed["job_id"]]
        assert evac["fleet"]["nodes"]["node001"]["residents"] \
            == [placed["job_id"]]
        assert back["fleet"]["nodes"]["node000"]["state"] == "up"
    finally:
        _stop(server, svc)


def test_shutdown_drains_and_stops():
    server, svc = _server()
    host, port = server.server_address[:2]
    resp = served.request_once(host, port, {"kind": "shutdown"})
    assert resp == {"ok": True, "shutdown": True}
    server.thread.join(timeout=30)
    assert not server.thread.is_alive() and server.draining
    server.server_close()
    svc.close()


def test_malformed_line_keeps_connection():
    server, svc = _server()
    try:
        r1, r2, r3 = _lines(server, [b"{this is not json\n", b"[1, 2, 3]\n",
                                     {"kind": "ping"}])
        assert r1 == {"ok": False, "kind": "error", "error": r1["error"]}
        assert "bad JSON" in r1["error"]
        assert r2["kind"] == "error"
        assert r3["pong"]
        assert server.malformed == 2
    finally:
        _stop(server, svc)


def test_oversized_line_bounded():
    server, svc = _server(max_line_bytes=256)
    try:
        big = b'{"kind": "ping", "pad": "' + b"x" * 1024 + b'"}\n'
        r1, r2 = _lines(server, [big, {"kind": "ping"}])
        assert r1["kind"] == "error" and "exceeds" in r1["error"]
        assert r2["pong"]
        assert server.oversized == 1
    finally:
        _stop(server, svc)


def test_backpressure_overloaded():
    server, svc = _server(max_in_flight=0)
    try:
        (r,) = _lines(server, [{"kind": "ping"}])
        assert r["kind"] == "overloaded" and not r["ok"]
        assert server.rejected_overload == 1
    finally:
        _stop(server, svc)


def test_draining_refuses_new_work():
    server, svc = _server()
    try:
        server.draining = True
        (r,) = _lines(server, [{"kind": "ping"}])
        assert r["kind"] == "draining" and not r["ok"]
    finally:
        _stop(server, svc)


def test_health_kind_over_wire():
    server, svc = _server()
    try:
        (r,) = _lines(server, [{"kind": "health"}])
        h = r["health"]
        assert h["status"] == "ok"
        assert set(h["rungs"]) == {RUNG_EXACT, RUNG_SWEEP, RUNG_ANALYTIC}
        assert h["daemon"]["max_in_flight"] == 8
        assert h["daemon"]["in_flight"] == 1
        assert not h["daemon"]["draining"]
    finally:
        _stop(server, svc)


def test_socket_fault_answers_error():
    server, svc = _server(
        faults=FaultPlan([FaultSpec("socket", "raise", times=1)]))
    try:
        r1, r2 = _lines(server, [{"kind": "ping"}, {"kind": "ping"}])
        assert r1["kind"] == "error" and "socket fault" in r1["error"]
        assert r2["pong"]
    finally:
        _stop(server, svc)


# -- the command lines -----------------------------------------------------------
def test_once_reads_one_request_from_stdin(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(TRAIN) + "\n"))
    assert served.main(["--once", "--device", "cpu"]) == 0
    resp = json.loads(capsys.readouterr().out)
    assert resp["ok"] and resp["admit"] and resp["rung"] == RUNG_EXACT


def test_once_in_a_process_of_its_own(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.served", "--once",
         "--device", "cpu", "--store-dir", str(tmp_path / "store")],
        input=json.dumps(TRAIN) + "\n", capture_output=True, text=True,
        env=env, timeout=300, check=True)
    resp = json.loads(run.stdout.splitlines()[-1])
    assert resp["ok"] and resp["provenance"]["source"] == "traced"
    assert len(os.listdir(tmp_path / "store")) == 3


@pytest.mark.parametrize("gib,rc", [(0.25, 0), (0.001, 2)])
def test_serve_mix_main_exits_by_the_verdict(gib, rc, capsys):
    argv = ["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
            "--capacity-gib", str(gib), "--serve-mix", "48:16:4,16:48:4",
            "--max-concurrent", "4"]
    assert tserve.main(argv) == rc
    out = capsys.readouterr().out
    assert ("admitted" if rc == 0 else "rejected") in out


def test_serve_mix_needs_a_capacity_on_the_cpu_and_no_plan(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                     "--serve-mix", "16:16:2"])
    # --plan on a mix that fits: admitted, no search, no offers
    assert tserve.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                        "--capacity-gib", "1", "--serve-mix", "16:16:2",
                        "--plan"]) == 0
    out = capsys.readouterr().out
    assert "admitted" in out and "offer #" not in out


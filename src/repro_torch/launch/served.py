"""Admission-service daemon: estimation-as-a-service over line JSON
(port of ``repro.launch.served``).

The long-running form of the admission gate: a scheduler connects over
TCP (newline-delimited JSON, one request per line) and gets a priori
CPU-only admission decisions without touching the card. The daemon
shares one content-addressed trace cache across all connections and
(with ``--store-dir``) persists traces to disk, so a restarted daemon
answers repeat requests without re-tracing.

  PYTHONPATH=src python -m repro_torch.launch.served --port 7777 \
      --store-dir /tmp/xmem-store --workers 2

  # one-shot mode (no socket): read a single request from stdin
  echo '{"kind":"train","arch":"qwen3-32b","smoke":true,"batch":8,
         "hbm_gib":0.25}' | \
      PYTHONPATH=src python -m repro_torch.launch.served --once --device cpu

Request kinds:

* ``train`` — ``{"kind":"train","arch":...,"smoke":bool,"optimizer":
  "adamw","microbatches":1,"clip_norm":1.0,"seq":64,"batch":8,
  "n_layers":4,"hbm_gib":0.25,"probe_min_capacity":false,
  "deadline_s":2.0}``: the job the port's ``launch/train.py`` builds
  from the same fields (``seq``/``batch`` default to 64/8 for a smoke
  config, to ``TRAIN_4K``'s otherwise), decided at ``hbm_gib`` GiB; an
  optional ``"offload":{"optimizer_state":true,"activations":0.5}``
  object estimates with host offload applied (the response's breakdown
  carries the per-space peaks);
* ``serve`` — ``{"kind":"serve","arch":...,"smoke":bool,"max_len":64,
  "batch":8,"hbm_gib":0.25}`` (gates on max(prefill, decode));
* ``plan`` — the same job fields as ``train`` plus the remediation
  search space: ``{"kind":"plan","arch":...,"batch":32,"hbm_gib":0.01,
  "devices":[4,8],"batch_grid":[16,8],"microbatch_grid":[2,4],
  "remat_grid":["full"],"pad_vocab_multiple":16,"max_offers":5,
  "offload_opt_state":true,"offload_activations":[0.5]}`` answers a job
  that does not fit with ranked feasible counter-offers (grid keys are
  optional: defaults derive from the job; ``devices`` adds the mesh
  topologies of those device counts, each offer's peak per device, and
  ``pad_vocab_multiple`` their padded-vocab variants);
* ``serve_plan`` — ``{"kind":"serve_plan","arch":...,"mix":"48:16:8",
  "max_concurrent":8,"page_size":16,"kv_dtype_bytes":2,
  "page_sizes":[8,16],"max_concurrents":[4,8],"kv_dtypes":[1,2],
  "hbm_gib":0.05}``: the request-driven serving gate for the mix, with
  ranked serving counter-offers on a rejection when a grid key is
  given;
* ``place`` — the same job fields as ``train`` plus ``"priority"``,
  ``"family"`` and ``"duration_ticks"``: the daemon's fleet scheduler
  (``repro_torch.sched``) decides the job at the best capacity its
  fleet can give and places it (best fit, then priority preemption);
  the answer carries the placement, the decision's provenance and the
  fleet's snapshot;
* ``evacuate`` — ``{"kind":"evacuate","node":"node001","event":
  "node.fail"|"node.flap"|"node.shrink"|"restore","shrink_frac":0.5}``:
  a fault on one node of the fleet and where its displaced jobs went
  (``restore`` brings the node back);
* ``stats`` / ``ping`` / ``shutdown`` / ``metrics`` (the registry as
  JSON and Prometheus text);
* ``health`` — degradation/robustness diagnostics: rung counters,
  retry/timeout totals, store + quarantine state, queue depth, daemon
  in-flight/rejected counts.

Without ``hbm_gib`` a request is decided at the capacity of the
daemon's device (``--device``, default ``cuda``: what the card's
caching allocator can hold); a daemon on the CPU (``--device cpu``), or
a request with ``"device": "cpu"``, must give ``hbm_gib``. The fleet
(built on the first ``place``/``evacuate`` request) has
``--fleet-nodes`` nodes (a request's ``fleet_nodes``; default 4) of
``--fleet-hbm-gib`` GiB each (a request's ``fleet_hbm_gib``), else of
the daemon's card's capacity; on the CPU the flag or the request must
give it.

Hardening: request lines are length-bounded (oversized or malformed
lines get a structured ``{"kind": "error"}`` response and the
connection stays up), reads carry a per-connection idle timeout,
``--max-in-flight`` sheds load with ``{"kind": "overloaded"}`` instead
of queueing without bound, and shutdown drains in-flight requests (new
requests are refused with ``{"kind": "draining"}``). ``train`` requests
honor a wire-level ``deadline_s`` budget — over-deadline estimates are
answered degraded (see ``repro_torch.service.degrade``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import socketserver
import sys
import threading

import torch

from ..configs import get_config, get_smoke
from ..configs.base import TRAIN_4K, smoke_shape
from ..core.events import MemorySpace
from ..core.orchestrator import OffloadPlan, ServingKnobs
from ..plan import PlanSpace, RemediationPlanner
from ..sched import FleetScheduler, build_fleet
from ..service import AdmissionService, JobArrival
from ..train import TrainPolicy
from .serve import device_capacity, parse_mix, pick_batch, pick_serving
from .train import train_request

def _train_job(d: dict):
    """(cfg, policy, shape) from a wire-level train-job description,
    as the port's ``launch/train.py`` builds them from its flags: the
    config (smoke or full, ``n_layers`` cutting the depth, ``remat``),
    the policy's optimizer, microbatches and clip norm, and
    ``smoke_shape(seq, batch)``. ``seq``/``batch`` default to 64/8 for
    a smoke config and to ``TRAIN_4K``'s otherwise."""
    arch = d["arch"]
    smoke = bool(d.get("smoke", True))
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=int(d.get("n_layers",
                                                      cfg.n_layers)))
    if d.get("remat"):
        cfg = dataclasses.replace(cfg, remat=str(d["remat"]))
    policy = TrainPolicy(
        optimizer=d.get("optimizer", "adamw"),
        microbatches=int(d.get("microbatches", 1)),
        clip_norm=d.get("clip_norm", 1.0))
    seq = int(d.get("seq", 64 if smoke else TRAIN_4K.seq_len))
    batch = int(d.get("batch", 8 if smoke else TRAIN_4K.global_batch))
    return cfg, policy, smoke_shape(seq, batch)


def request_capacity(d: dict, device: str = "cuda") -> int:
    """Bytes a wire request is decided at: ``hbm_gib`` GiB, else the
    capacity of the card the request runs on (its ``device``, default
    the daemon's). A request on the CPU must give ``hbm_gib``."""
    if "hbm_gib" in d:
        return int(float(d["hbm_gib"]) * 2**30)
    device = str(d.get("device", device))
    if torch.device(device).type != "cuda":
        raise ValueError(f"a request on {device!r} needs hbm_gib (the "
                         f"CPU has no card to read a capacity from)")
    return device_capacity(device)


def build_offload_plan(d: dict) -> OffloadPlan | None:
    """OffloadPlan from the optional wire-level ``offload`` object
    (``{"optimizer_state": bool, "activations": 0..1,
    "space": "host_pinned"|"host_pageable", "min_block_bytes": n}``);
    None when absent or disabled."""
    o = d.get("offload")
    if not o:
        return None
    kw = {}
    if "space" in o:
        kw["space"] = MemorySpace(str(o["space"]))
    if "min_block_bytes" in o:
        kw["min_block_bytes"] = int(o["min_block_bytes"])
    plan = OffloadPlan(
        optimizer_state=bool(o.get("optimizer_state", False)),
        activations=float(o.get("activations", 0.0)), **kw)
    return plan if plan.enabled else None


def build_train_request(d: dict, device: str = "cuda"):
    """AdmissionRequest from a wire-level train-job description."""
    cfg, policy, shape = _train_job(d)
    deadline = d.get("deadline_s")
    req = train_request(
        cfg, policy, shape, request_capacity(d, device),
        probe_min_capacity=bool(d.get("probe_min_capacity", False)),
        deadline_s=float(deadline) if deadline is not None else None,
        offload=build_offload_plan(d))
    req.job_id = str(d.get("id", f"{d['arch']}-b{shape.global_batch}"))
    return req


def build_fleet_arrival(d: dict, device: str = "cuda") -> JobArrival:
    """JobArrival (fleet placement) from a wire-level train job."""
    req = build_train_request(d, device)
    duration = d.get("duration_ticks")
    return JobArrival(
        req.job_id, req.fwd_bwd_fn, req.params, req.batch,
        update_fn=req.update_fn, opt_init_fn=req.opt_init_fn,
        capacity=req.capacity, deadline_s=req.deadline_s,
        family=str(d.get("family", d.get("arch", "workload"))),
        priority=int(d.get("priority", 0)),
        duration_ticks=int(duration) if duration is not None else None)


def fleet_scheduler(service, d: dict, server=None,
                    device: str = "cuda") -> FleetScheduler:
    """The daemon's fleet scheduler, built lazily on the first
    ``place``/``evacuate`` request — sized by the server's
    ``--fleet-nodes``/``--fleet-hbm-gib`` flags, overridable by
    ``fleet_nodes``/``fleet_hbm_gib`` on that first request; without a
    size, each node has the capacity of the daemon's card (on the CPU
    there is none, and the request is an error). Shared (and internally
    locked) across all daemon connections."""
    sched = getattr(service, "_fleet_scheduler", None)
    if sched is None:
        n = int(d.get("fleet_nodes",
                      getattr(server, "fleet_nodes", None) or 4))
        hbm = d.get("fleet_hbm_gib", getattr(server, "fleet_hbm_gib", None))
        if hbm is not None:
            capacity = int(float(hbm) * 2**30)
        elif torch.device(device).type == "cuda":
            capacity = device_capacity(device)
        else:
            raise ValueError(f"a fleet on {device!r} needs fleet_hbm_gib "
                             f"(the CPU has no card to read a capacity "
                             f"from)")
        sched = FleetScheduler(service, build_fleet(n, capacity),
                               obs=service.obs)
        service._fleet_scheduler = sched
    return sched


def build_plan_space(d: dict) -> PlanSpace:
    """PlanSpace from the optional wire-level grid keys, the mesh axes
    (``devices``, ``pad_vocab_multiple``) included."""
    return PlanSpace(
        batches=(tuple(int(b) for b in d["batch_grid"])
                 if "batch_grid" in d else None),
        microbatches=(tuple(int(m) for m in d["microbatch_grid"])
                      if "microbatch_grid" in d else None),
        remat=(tuple(str(r) for r in d["remat_grid"])
               if "remat_grid" in d else None),
        devices=tuple(int(n) for n in d.get("devices", ())),
        pad_vocab_multiple=d.get("pad_vocab_multiple"),
        max_offers=int(d.get("max_offers", 5)),
        offload_opt_state=bool(d.get("offload_opt_state", False)),
        offload_activations=tuple(
            float(f) for f in d.get("offload_activations", ())))


def build_serving_knobs(d: dict) -> ServingKnobs:
    """ServingKnobs from a wire-level ``serve_plan`` request."""
    return ServingKnobs(
        page_size=int(d.get("page_size", 16)),
        max_concurrent=int(d.get("max_concurrent", 8)),
        kv_dtype_bytes=int(d.get("kv_dtype_bytes", 2)),
        prefix_cache=bool(d.get("prefix_cache", True)),
        speculative_k=int(d.get("speculative_k", 0)))


def build_serving_space(d: dict) -> PlanSpace | None:
    """Serving-axis PlanSpace from a wire request, or None when the
    request enables no axis (gate only, no counter-offer search)."""
    pages = tuple(int(p) for p in d.get("page_sizes", ()))
    concs = tuple(int(c) for c in d.get("max_concurrents", ()))
    dtypes = tuple(int(b) for b in d.get("kv_dtypes", ()))
    prefixes = tuple(bool(x) for x in d.get("prefix_cache_grid", ()))
    if not (pages or concs or dtypes or prefixes):
        return None
    return PlanSpace(page_sizes=pages, max_concurrents=concs,
                     kv_dtypes=dtypes, prefix_cache=prefixes,
                     max_offers=int(d.get("max_offers", 5)))


def handle_request(service, d: dict, server=None,
                   device: str = "cuda") -> dict:
    """One wire request -> one JSON-safe response dict. ``device`` is
    the daemon's (the server's, when there is one)."""
    if server is not None:
        device = server.device
    kind = d.get("kind", "train")
    service.obs.registry.counter(
        "xmem_daemon_requests_total",
        "Daemon requests by wire kind", labels={"kind": kind}).inc()
    try:
        if kind == "ping":
            return {"ok": True, "pong": True}
        if kind == "stats":
            return {"ok": True, "stats": service.stats()}
        if kind == "health":
            h = service.health()
            if server is not None:
                h["daemon"] = server.daemon_stats()
            return {"ok": True, "health": h}
        if kind == "metrics":
            # the whole registry — service + daemon + collectors — in
            # both wire shapes, from the one source of truth
            reg = service.obs.registry
            return {"ok": True, "metrics": reg.to_json(),
                    "prometheus": reg.to_prometheus()}
        if kind == "shutdown":
            return {"ok": True, "shutdown": True}
        if kind == "train":
            decision = service.decide(build_train_request(d, device))
            return {"ok": True, **decision.to_json()}
        if kind == "plan":
            cfg, policy, shape = _train_job(d)
            res = RemediationPlanner(service).plan(
                cfg, policy, shape, capacity=request_capacity(d, device),
                space=build_plan_space(d),
                job_id=str(d.get("id", f"{d['arch']}-plan")))
            return {"ok": True, **res.to_json()}
        if kind == "place":
            sched = fleet_scheduler(service, d, server, device)
            out = sched.place(build_fleet_arrival(d, device))
            prov = (out.decision.provenance if out.decision is not None
                    else None)
            return {"ok": True, **out.to_json(), "provenance": prov,
                    "fleet": sched.fleet.snapshot()}
        if kind == "evacuate":
            sched = fleet_scheduler(service, d, server, device)
            node = str(d["node"])
            event = str(d.get("event", "node.fail"))
            if event == "restore":
                sched.fleet.restore(node)
                return {"ok": True, "node": node, "event": "restore",
                        "fleet": sched.fleet.snapshot()}
            out = sched.evacuate_node(
                node, event, shrink_frac=float(d.get("shrink_frac", 0.5)))
            return {"ok": True, **out.to_json(),
                    "fleet": sched.fleet.snapshot()}
        if kind == "serve_plan":
            arch = d["arch"]
            cfg = (get_smoke(arch) if d.get("smoke", True)
                   else get_config(arch))
            mix = parse_mix(str(d["mix"]), int(d.get("arrival_period", 1)),
                            int(d.get("shared_prefix", 0)))
            max_len = d.get("max_len")
            decision, gate = pick_serving(
                cfg, mix, request_capacity(d, device),
                knobs=build_serving_knobs(d), space=build_serving_space(d),
                max_len=int(max_len) if max_len is not None else None,
                service=service)
            return {"ok": True, **decision.to_json(),
                    "kv_bytes_per_token": gate["kv_bytes_per_token"],
                    "resident_bytes_per_request":
                        gate["resident_bytes_per_request"]}
        if kind == "serve":
            arch = d["arch"]
            cfg = (get_smoke(arch) if d.get("smoke", True)
                   else get_config(arch))
            cand = (int(d["batch"]),) if "batch" in d \
                else (64, 32, 16, 8, 4, 2, 1)
            batch, gate = pick_batch(cfg, int(d.get("max_len", 64)),
                                     request_capacity(d, device),
                                     candidates=cand, service=service)
            resp = {"ok": True, "admit": batch is not None,
                    "batch": batch, "candidates": gate["candidates"]}
            if batch is not None:
                resp.update(peak_bytes=gate["peak"],
                            prefill_peak=gate["prefill"].peak_bytes,
                            decode_peak=gate["decode"].peak_bytes,
                            source=gate["decode"].provenance["source"])
            return resp
        return {"ok": False, "kind": "error",
                "error": f"unknown request kind {kind!r}"}
    except Exception as e:  # noqa: BLE001 — a bad request must not kill the daemon
        return {"ok": False, "kind": "error",
                "error": f"{type(e).__name__}: {e}"}


class _Handler(socketserver.StreamRequestHandler):
    """Hardened line-JSON handler.

    A malformed or oversized line costs the CLIENT one structured
    ``{"kind": "error"}`` response, never the daemon its connection or
    its process; an idle connection is dropped at the read timeout; a
    daemon at its in-flight cap answers ``{"kind": "overloaded"}``
    immediately instead of queueing the request behind the pool."""

    def setup(self):
        super().setup()
        self.connection.settimeout(self.server.read_timeout)

    def _send(self, resp: dict) -> None:
        self.wfile.write((json.dumps(resp) + "\n").encode())
        self.wfile.flush()

    def _read_line(self):
        """One bounded line; None at EOF/timeout (drop the connection),
        False for an oversized line (already answered + drained)."""
        limit = self.server.max_line_bytes
        try:
            raw = self.rfile.readline(limit + 1)
        except (TimeoutError, socket.timeout, OSError):
            return None
        if not raw:
            return None
        if len(raw) > limit and not raw.endswith(b"\n"):
            # drain the remainder of the oversized line so the NEXT
            # line parses cleanly, then refuse this one
            while True:
                try:
                    chunk = self.rfile.readline(limit)
                except (TimeoutError, socket.timeout, OSError):
                    return None
                if not chunk or chunk.endswith(b"\n"):
                    break
            self.server._m_oversized.inc()
            self._send({"ok": False, "kind": "error",
                        "error": f"request line exceeds "
                                 f"{limit} bytes"})
            return False
        return raw

    def handle(self):
        server = self.server
        service = server.service
        while True:
            raw = self._read_line()
            if raw is None:
                return
            if raw is False:
                continue
            line = raw.strip()
            if not line:
                continue
            if server.faults is not None:
                try:
                    server.faults.check("socket")
                except Exception as e:  # noqa: BLE001 — injected socket fault
                    self._send({"ok": False, "kind": "error",
                                "error": f"socket fault: {e}"})
                    continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                server._m_malformed.inc()
                self._send({"ok": False, "kind": "error",
                            "error": f"bad JSON: {e}"})
                continue
            if server.draining:
                self._send({"ok": False, "kind": "draining",
                            "error": "daemon is shutting down"})
                continue
            if not server.enter():
                server._m_rejected.inc()
                self._send({"ok": False, "kind": "overloaded",
                            "error": f"daemon at max in-flight "
                                     f"({server.max_in_flight})"})
                continue
            try:
                resp = handle_request(service, d, server=server)
            finally:
                server.leave()
            self._send(resp)
            if resp.get("shutdown"):
                threading.Thread(target=server.graceful_shutdown,
                                 daemon=True).start()
                return


class AdmissionServer(socketserver.ThreadingTCPServer):
    """Line-JSON TCP front of an :class:`AdmissionService`.

    ``read_timeout`` bounds how long an idle connection may hold a
    handler thread; ``max_line_bytes`` bounds a single request line;
    ``max_in_flight`` bounds concurrently-executing requests
    (backpressure — excess requests are refused as ``overloaded``, the
    scheduler's cue to retry with backoff rather than pile up)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service, *, read_timeout: float = 60.0,
                 max_line_bytes: int = 1 << 20, max_in_flight: int = 8,
                 faults=None, device: str = "cuda",
                 fleet_nodes: int | None = None,
                 fleet_hbm_gib: float | None = None):
        super().__init__(addr, _Handler)
        self.service = service
        self.device = device
        self.fleet_nodes = fleet_nodes
        self.fleet_hbm_gib = fleet_hbm_gib
        self.read_timeout = float(read_timeout)
        self.max_line_bytes = int(max_line_bytes)
        self.max_in_flight = int(max_in_flight)
        self.faults = faults
        self.draining = False
        # daemon counters live in the service's metrics registry:
        # daemon_stats(), health's "daemon"
        # block, and the "metrics" wire kind all read the same
        # objects, so the three surfaces cannot drift
        reg = service.obs.registry
        self._m_in_flight = reg.gauge(
            "xmem_daemon_in_flight", "Requests currently executing")
        self._m_rejected = reg.counter(
            "xmem_daemon_rejected_overload_total",
            "Requests shed at the in-flight cap")
        self._m_malformed = reg.counter(
            "xmem_daemon_malformed_total", "Unparseable request lines")
        self._m_oversized = reg.counter(
            "xmem_daemon_oversized_total",
            "Request lines over --max-line-bytes")
        reg.register_collector("xmem_daemon", self.daemon_stats)
        self._flight_lock = threading.Lock()
        self._idle = threading.Condition(self._flight_lock)

    # read-only legacy surface over the registry counters
    @property
    def in_flight(self) -> int:
        return self._m_in_flight.value

    @property
    def rejected_overload(self) -> int:
        return self._m_rejected.value

    @property
    def malformed(self) -> int:
        return self._m_malformed.value

    @property
    def oversized(self) -> int:
        return self._m_oversized.value

    def enter(self) -> bool:
        with self._flight_lock:
            if self._m_in_flight.value >= self.max_in_flight:
                return False
            self._m_in_flight.inc()
            return True

    def leave(self) -> None:
        with self._flight_lock:
            self._m_in_flight.dec()
            if self._m_in_flight.value == 0:
                self._idle.notify_all()

    def daemon_stats(self) -> dict:
        with self._flight_lock:
            return {"in_flight": self.in_flight,
                    "max_in_flight": self.max_in_flight,
                    "draining": self.draining,
                    "rejected_overload": self.rejected_overload,
                    "malformed": self.malformed,
                    "oversized": self.oversized,
                    "read_timeout_s": self.read_timeout,
                    "max_line_bytes": self.max_line_bytes}

    def graceful_shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Stop accepting work, let in-flight requests finish (bounded),
        then stop the accept loop. New requests on live connections are
        answered ``{"kind": "draining"}`` while this runs."""
        self.draining = True
        with self._idle:
            self._idle.wait_for(lambda: self.in_flight == 0,
                                timeout=drain_timeout_s)
        self.shutdown()


def request_once(host: str, port: int, d: dict, timeout: float = 60.0) -> dict:
    """Client helper: one request/response round trip."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(d) + "\n").encode())
        f.flush()
        return json.loads(f.readline())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7777)
    ap.add_argument("--workers", type=int, default=2,
                    help="service worker threads")
    ap.add_argument("--store-dir", default=None,
                    help="persistent trace store directory (content-"
                         "addressed; traces survive daemon restarts)")
    ap.add_argument("--store-max-entries", type=int, default=256)
    ap.add_argument("--once", action="store_true",
                    help="serve one request from stdin and exit")
    ap.add_argument("--device", default="cuda",
                    help="the card whose capacity a request without "
                         "hbm_gib is decided at; on the CPU every "
                         "request must give hbm_gib")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request answer budget; over-budget"
                         " estimates degrade (rung 2/3) instead of "
                         "blocking the scheduler")
    ap.add_argument("--read-timeout", type=float, default=60.0,
                    help="idle-connection read timeout (seconds)")
    ap.add_argument("--max-line-bytes", type=int, default=1 << 20,
                    help="maximum request line length")
    ap.add_argument("--max-in-flight", type=int, default=8,
                    help="max concurrently-executing requests before "
                         "answering 'overloaded'")
    ap.add_argument("--fleet-nodes", type=int, default=None,
                    help="fleet size for 'place'/'evacuate' requests "
                         "(default 4)")
    ap.add_argument("--fleet-hbm-gib", type=float, default=None,
                    help="per-node memory (GiB) for the fleet scheduler; "
                         "default the capacity of --device's card")
    ap.add_argument("--metrics", action="store_true",
                    help="enable observability (spans + correlation "
                         "IDs); the 'metrics' wire kind serves the "
                         "registry either way")
    ap.add_argument("--audit-dir", default=None,
                    help="append-only decision audit trail directory "
                         "(crash-safe JSONL; implies --metrics)")
    args = ap.parse_args(argv)

    obs = None
    if args.metrics or args.audit_dir:
        from ..obs import Observability
        obs = Observability(enabled=True, audit_dir=args.audit_dir)
    service = AdmissionService(workers=args.workers,
                               store_dir=args.store_dir,
                               store_max_entries=args.store_max_entries,
                               deadline_s=args.deadline_s, obs=obs)
    try:
        if args.once:
            d = json.loads(sys.stdin.readline())
            for key in ("fleet_nodes", "fleet_hbm_gib"):
                if getattr(args, key) is not None:
                    d.setdefault(key, getattr(args, key))
            print(json.dumps(handle_request(service, d,
                                            device=args.device)))
            return 0
        with AdmissionServer((args.host, args.port), service,
                             read_timeout=args.read_timeout,
                             max_line_bytes=args.max_line_bytes,
                             max_in_flight=args.max_in_flight,
                             device=args.device,
                             fleet_nodes=args.fleet_nodes,
                             fleet_hbm_gib=args.fleet_hbm_gib) as server:
            host, port = server.server_address[:2]
            store = f", store={args.store_dir}" if args.store_dir else ""
            print(f"[served] admission daemon on {host}:{port} "
                  f"({args.workers} workers{store})", flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
        return 0
    finally:
        service.close()


if __name__ == "__main__":
    raise SystemExit(main())

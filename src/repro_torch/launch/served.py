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
  config, to ``TRAIN_4K``'s otherwise), decided at ``hbm_gib`` GiB;
* ``serve`` — ``{"kind":"serve","arch":...,"smoke":bool,"max_len":64,
  "batch":8,"hbm_gib":0.25}`` (gates on max(prefill, decode));
* ``stats`` / ``ping`` / ``shutdown`` / ``metrics`` (the registry as
  JSON and Prometheus text);
* ``health`` — degradation/robustness diagnostics: rung counters,
  retry/timeout totals, store + quarantine state, queue depth, daemon
  in-flight/rejected counts.

Without ``hbm_gib`` a request is decided at the capacity of the
daemon's device (``--device``, default ``cuda``: what the card's
caching allocator can hold); a daemon on the CPU (``--device cpu``), or
a request with ``"device": "cpu"``, must give ``hbm_gib``.

Not ported yet, each answered with a structured ``{"ok": false, "kind":
"error"}`` naming its slice: the ``plan`` and ``serve_plan`` kinds and
a ``train`` request's ``offload`` object (the remediation planner and
host offload, slice 10), and the ``place`` and ``evacuate`` kinds (the
fleet scheduler, slice 11).

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
from ..service import AdmissionService
from ..train import TrainPolicy
from .serve import device_capacity, pick_batch
from .train import train_request

#: wire kinds that wait for a later slice of the port: kind -> (what, slice)
NOT_PORTED = {"plan": ("the remediation planner", 10),
              "serve_plan": ("serving counter-offers (the remediation "
                             "planner)", 10),
              "place": ("fleet placement (sched/)", 11),
              "evacuate": ("fleet evacuation (sched/)", 11)}


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


def build_train_request(d: dict, device: str = "cuda"):
    """AdmissionRequest from a wire-level train-job description."""
    if d.get("offload"):
        raise NotImplementedError(
            "host offload (a train request's offload object) is not "
            "ported yet (slice 10 of the port)")
    cfg, policy, shape = _train_job(d)
    deadline = d.get("deadline_s")
    req = train_request(
        cfg, policy, shape, request_capacity(d, device),
        probe_min_capacity=bool(d.get("probe_min_capacity", False)),
        deadline_s=float(deadline) if deadline is not None else None)
    req.job_id = str(d.get("id", f"{d['arch']}-b{shape.global_batch}"))
    return req


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
        if kind in NOT_PORTED:
            what, slice_no = NOT_PORTED[kind]
            raise NotImplementedError(
                f"the {kind!r} kind needs {what}, which is not ported "
                f"yet (slice {slice_no} of the port)")
        if kind == "train":
            decision = service.decide(build_train_request(d, device))
            return {"ok": True, **decision.to_json()}
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
                 faults=None, device: str = "cuda"):
        super().__init__(addr, _Handler)
        self.service = service
        self.device = device
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
            print(json.dumps(handle_request(service, d,
                                            device=args.device)))
            return 0
        with AdmissionServer((args.host, args.port), service,
                             read_timeout=args.read_timeout,
                             max_line_bytes=args.max_line_bytes,
                             max_in_flight=args.max_in_flight,
                             device=args.device) as server:
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

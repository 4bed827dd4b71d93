"""Estimator-driven searches (port of the JAX package's
``launch/hillclimb.py``): the largest training batch whose xMem estimate
fits the card (``--xmem-batch``), the cheapest mesh topology whose
per-device estimate fits (``--xmem-mesh``), and the remediation
planner's ranked counter-offers for a job that does not fit
(``--xmem-plan``).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-batch qwen3-32b --n-layers 4 --seq 4096 --max-batch 8
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-batch qwen3-32b --smoke --device cpu --capacity-gib 0.07
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-mesh qwen3-32b --smoke --device cpu --hbm-gib 0.089
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-plan qwen3-32b --smoke --device cpu --hbm-gib 0.089

The doubling grid goes to ``SweepService.estimate_many`` as one sweep:
three probe batches are traced on the CPU, the others synthesized from
the affine trace model (each checked, and traced for real when a check
fails), every point replayed through the CUDA caching allocator
simulation at the capacity. On a CUDA device the capacity is what the
card's caching allocator can hold (``serve.device_capacity``); on the
CPU it must be given (``--capacity-gib``). The result goes to
``<out>/xmem_batch__<arch>.json``. The CLI runs the search under an
enabled ``Observability`` handle: one correlation ID covers the whole
search (every trace and replay span under it carries it), printed and
written with the result.

``--xmem-mesh`` estimates every (pod, data, model, fsdp) topology of the
``--devices`` counts from ONE set of phase traces
(``SweepService.estimate_mesh_sweep``, spec-driven shard factors and
collective staging) at the budget and writes
``<out>/xmem_mesh__<arch>.json``; ``--xmem-plan`` runs
``plan.run_plan_search`` (batch, microbatch, remat, topology and host
offload offers) and writes ``<out>/xmem_plan__<arch>.json``. Each mode
takes the architecture's full config unless ``--smoke`` (``--n-layers``
cuts the depth). The budget is ``--hbm-gib`` (``--capacity-gib``); on a
CUDA device it defaults to what the card's caching allocator can hold.

Not ported: the JAX package's cells A/B/C, which lower XLA programs and
price them with a TPU's rates (XLA-only, as its ``hlo_analysis.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from ..configs import get_config, get_smoke
from ..configs.base import smoke_shape
from ..configs.registry import input_specs
from ..core.estimator import XMemEstimator
from ..core.sweep import SweepPoint, SweepService
from ..models import model as M
from ..obs import Observability
from ..train import TrainPolicy, make_estimator_hooks
from .serve import device_capacity


def batch_grid(max_batch: int, microbatches: int = 1) -> list[int]:
    """The doubling grid from ``microbatches`` up to ``max_batch``: every
    entry divides by the accumulation factor, as every probe the sweep
    traces must."""
    m = max(int(microbatches), 1)
    grid, b = [], m
    while b <= max_batch:
        grid.append(b)
        b *= 2
    return grid or [m]


def xmem_batch_hillclimb(arch: str, capacity: int, seq: int = 64,
                         max_batch: int = 512, smoke: bool = True,
                         verbose: bool = True, microbatches: int = 1,
                         timeline_out: str | None = None,
                         n_layers: int | None = None, obs=None) -> dict:
    """The largest batch of the grid whose estimate, replayed at
    ``capacity``, fits (no simulated OOM, peak reserved <= capacity),
    and its exact minimum feasible capacity from the estimate's own
    composition (``min_feasible_capacity``). With an enabled ``obs``
    (``repro_torch.obs.Observability``) the sweep runs under one
    correlation ID, returned as ``correlation_id``."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    m = max(int(microbatches), 1)
    policy = TrainPolicy(optimizer="adamw", microbatches=m)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    params = M.abstract_params(cfg)
    est = XMemEstimator.for_torch_gpu()
    svc = SweepService(est)            # hooks are closures: inline service
    grid = batch_grid(max_batch, m)
    points = [SweepPoint(fwd_bwd, params,
                         input_specs(cfg, smoke_shape(seq, gb)),
                         update_fn=update, opt_init_fn=opt_init,
                         capacity=capacity) for gb in grid]
    cid = None
    if obs is not None and obs.enabled:
        # one correlation ID covers the whole gated search: every
        # trace/replay span under it carries the same ID
        with obs.request("hillclimb", job_id=f"{cfg.name}-climb") as cid:
            result = svc.estimate_many(points)
    else:
        result = svc.estimate_many(points)
    probes, best = [], None
    for gb, p, rep, src in zip(grid, points, result.reports,
                               result.sources):
        fits = not rep.oom and rep.peak_bytes <= capacity
        probes.append({"batch": gb, "peak_bytes": rep.peak_bytes,
                       "tensor_bytes": rep.peak_tensor_bytes,
                       "fits": fits, "source": src,
                       "wall_s": rep.wall_time_s,
                       "cache_hits": rep.cache_stats.get("hits", 0)})
        if verbose:
            print(f"[xmem-hillclimb] batch={gb:4d} "
                  f"peak={rep.peak_bytes / 2**30:8.3f} GiB "
                  f"{'fits' if fits else 'OOM '} ({src})", flush=True)
        if fits and (best is None or gb > best[0]):
            best = (gb, p, rep)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "seq": seq,
           "capacity": capacity, "probes": probes, "microbatches": m,
           "sweep": {k: result.stats[k] for k in
                     ("points", "traced", "interpolated", "fallback",
                      "wall_s", "trace_cache")}}
    if cid is not None:
        out["correlation_id"] = cid
        if verbose:
            print(f"[xmem-hillclimb] correlation_id={cid}", flush=True)
    if timeline_out is not None:
        rep_tl = best[2] if best is not None else result.reports[-1]
        from ..obs.timeline import write_timeline
        out["timeline"] = write_timeline(rep_tl, timeline_out)
        if verbose:
            print(f"[xmem-hillclimb] timeline written to {timeline_out}",
                  flush=True)
    if verbose:
        s = out["sweep"]
        print(f"[xmem-hillclimb] sweep: {s['points']} points, "
              f"{s['traced']} traced, {s['interpolated']} interpolated, "
              f"{s['fallback']} fallback ({s['wall_s'] * 1e3:.0f} ms "
              f"total)", flush=True)
    if best is not None:
        gb, p, rep = best
        min_cap = est.min_feasible_capacity(
            fwd_bwd, params, p.batch, update_fn=update,
            opt_init_fn=opt_init, report=rep)
        out.update(best_batch=gb, best_peak_bytes=rep.peak_bytes,
                   min_feasible_capacity=min_cap)
        if verbose:
            print(f"[xmem-hillclimb] best batch={gb} min feasible "
                  f"capacity {min_cap / 2**30:.3f} GiB", flush=True)
    elif verbose:
        print("[xmem-hillclimb] no batch fits", flush=True)
    return out


def xmem_mesh_hillclimb(arch: str, capacity: int, seq: int = 64,
                        batch: int = 32, devices: tuple = (8, 16, 32),
                        smoke: bool = True, verbose: bool = True,
                        n_layers: int | None = None) -> dict:
    """Estimator-driven mesh-topology search: every (pod, data, model,
    fsdp) factorization of the candidate device counts estimated from
    ONE set of phase traces (``SweepService.estimate_mesh_sweep``), each
    replayed at ``capacity``, and the cheapest topology whose per-device
    estimate fits (fewest devices, then lowest peak)."""
    from ..core.sweep import topology_grid
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    policy = TrainPolicy(optimizer="adamw", microbatches=1)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    params = M.abstract_params(cfg)
    batch_specs = input_specs(cfg, smoke_shape(seq, batch))
    grid = [t for n in devices for t in topology_grid(n)]
    svc = SweepService(XMemEstimator.for_torch_gpu())
    result = svc.estimate_mesh_sweep(fwd_bwd, params, batch_specs, grid,
                                     update_fn=update,
                                     opt_init_fn=opt_init, cfg=cfg,
                                     capacity=capacity)
    rows = []
    for topo, rep in result:
        fits = not rep.oom and rep.fits(capacity)
        rows.append({"topology": topo.label, "devices": topo.n_devices,
                     "peak_bytes": rep.peak_bytes, "fits": fits})
        if verbose:
            print(f"[xmem-mesh] {topo.label:14s} dev={topo.n_devices:4d} "
                  f"peak={rep.peak_bytes / 2**20:8.2f} MiB "
                  f"{'fits' if fits else 'OOM '}", flush=True)
    out = {"arch": cfg.name, "kind": "xmem_mesh", "hbm_bytes": capacity,
           "n_layers": cfg.n_layers, "seq": seq, "batch": batch,
           "topologies": rows, "sweep": result.stats}
    best = result.best(capacity)
    if best is not None:
        topo, rep = best
        out.update(best_topology=topo.label, best_devices=topo.n_devices,
                   best_peak_bytes=rep.peak_bytes)
        if verbose:
            print(f"[xmem-mesh] best: {topo.label} "
                  f"({topo.n_devices} devices, "
                  f"{rep.peak_bytes / 2**20:.2f} MiB/device): "
                  f"{result.stats['topologies']} topologies from "
                  f"{result.stats['trace_cache']['misses']} traces in "
                  f"{result.stats['wall_s'] * 1e3:.0f} ms", flush=True)
    elif verbose:
        print("[xmem-mesh] no topology fits the budget", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--xmem-batch", metavar="ARCH",
                      help="the architecture whose training batch to "
                           "search")
    mode.add_argument("--xmem-mesh", metavar="ARCH",
                      help="the architecture whose mesh topology to "
                           "search")
    mode.add_argument("--xmem-plan", metavar="ARCH",
                      help="rank the remediation planner's counter-offers "
                           "(batch/microbatch/remat/topology/offload) for "
                           "a job of ARCH that misses the budget")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width is kept)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 64; 48 for "
                         "--xmem-plan)")
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch of the --xmem-mesh job and of the "
                         "rejected --xmem-plan job")
    ap.add_argument("--remat", default=None,
                    help="the rejected job's remat policy for --xmem-plan "
                         "(full|dots|none; default: the config's)")
    ap.add_argument("--devices", default="8,16,32",
                    help="comma-separated device counts of the topology "
                         "grid (--xmem-mesh, --xmem-plan)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation factor (the grid snaps "
                         "to its multiples)")
    ap.add_argument("--capacity-gib", "--hbm-gib", type=float,
                    default=None,
                    help="the budget; default on a CUDA device: what its "
                         "caching allocator can hold; required on the CPU")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeline-out", default=None,
                    help="write a Chrome-trace memory timeline of the "
                         "winning batch's estimate to this path")
    ap.add_argument("--out", default="artifacts/hillclimb")
    args = ap.parse_args(argv)

    if args.capacity_gib:
        capacity = int(args.capacity_gib * 2**30)
    elif torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("[xmem-hillclimb] no CUDA device; pass --device cpu and "
                  "--capacity-gib", file=sys.stderr)
            return 1
        capacity = device_capacity(args.device)
    else:
        ap.error("--device cpu needs --capacity-gib (the CPU has no card "
                 "to read a capacity from)")
    devices = tuple(int(d) for d in args.devices.split(","))
    os.makedirs(args.out, exist_ok=True)
    if args.xmem_mesh:
        r = xmem_mesh_hillclimb(args.xmem_mesh, capacity,
                                seq=args.seq or 64, batch=args.batch,
                                devices=devices, smoke=args.smoke,
                                n_layers=args.n_layers)
        path = os.path.join(args.out, f"xmem_mesh__{args.xmem_mesh}.json")
        with open(path, "w") as f:
            json.dump(r, f, indent=1)
        print(f"[xmem-mesh] wrote {path}")
        return 0 if "best_topology" in r else 2
    if args.xmem_plan:
        from ..plan import run_plan_search
        from ..service import AdmissionService
        svc = AdmissionService(workers=1, obs=Observability(enabled=True))
        try:
            r = run_plan_search(
                args.xmem_plan, capacity, seq=args.seq or 48,
                batch=args.batch, microbatches=args.microbatches,
                remat=args.remat, devices=devices,
                smoke=args.smoke, service=svc,
                n_layers=args.n_layers)
        finally:
            svc.close()
        path = os.path.join(args.out, f"xmem_plan__{args.xmem_plan}.json")
        with open(path, "w") as f:
            json.dump(r, f, indent=1)
        if r.get("correlation_id"):
            print(f"[xmem-plan] correlation_id={r['correlation_id']}")
        print(f"[xmem-plan] wrote {path}")
        return 0 if r["admit"] or r["counter_offers"] else 2
    r = xmem_batch_hillclimb(args.xmem_batch, capacity, seq=args.seq or 64,
                             max_batch=args.max_batch, smoke=args.smoke,
                             microbatches=args.microbatches,
                             timeline_out=args.timeline_out,
                             n_layers=args.n_layers,
                             obs=Observability(enabled=True))
    path = os.path.join(args.out, f"xmem_batch__{args.xmem_batch}.json")
    with open(path, "w") as f:
        json.dump(r, f, indent=1)
    print(f"[xmem-hillclimb] wrote {path}")
    return 0 if "best_batch" in r else 2


if __name__ == "__main__":
    raise SystemExit(main())

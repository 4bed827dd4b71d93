"""Estimator-driven batch-size search: the largest training batch whose
xMem estimate fits the card (port of the JAX package's
``launch/hillclimb.py:xmem_batch_hillclimb``).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-batch qwen3-32b --n-layers 4 --seq 4096 --max-batch 8
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --xmem-batch qwen3-32b --smoke --device cpu --capacity-gib 0.07

The doubling grid goes to ``SweepService.estimate_many`` as one sweep:
three probe batches are traced on the CPU, the others synthesized from
the affine trace model (each checked, and traced for real when a check
fails), every point replayed through the CUDA caching allocator
simulation at the capacity. On a CUDA device the capacity is what the
card's caching allocator can hold (``serve.device_capacity``); on the
CPU it must be given (``--capacity-gib``). The result goes to
``<out>/xmem_batch__<arch>.json``.

Not ported: the JAX package's cells A/B/C, which lower XLA programs and
price them with a TPU's rates (XLA-only, as its ``hlo_analysis.py``);
``--xmem-mesh`` and ``--xmem-plan``, which need the sharding module and
the planner; and the search's correlation ID, which waits for the
admission service's ``Observability``.
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
                         n_layers: int | None = None) -> dict:
    """The largest batch of the grid whose estimate, replayed at
    ``capacity``, fits (no simulated OOM, peak reserved <= capacity),
    and its exact minimum feasible capacity from the estimate's own
    composition (``min_feasible_capacity``)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--xmem-batch", metavar="ARCH", required=True,
                    help="the architecture whose training batch to search")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width is kept)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation factor (the grid snaps "
                         "to its multiples)")
    ap.add_argument("--capacity-gib", type=float, default=None,
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
    r = xmem_batch_hillclimb(args.xmem_batch, capacity, seq=args.seq,
                             max_batch=args.max_batch, smoke=args.smoke,
                             microbatches=args.microbatches,
                             timeline_out=args.timeline_out,
                             n_layers=args.n_layers)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"xmem_batch__{args.xmem_batch}.json")
    with open(path, "w") as f:
        json.dump(r, f, indent=1)
    print(f"[xmem-hillclimb] wrote {path}")
    return 0 if "best_batch" in r else 2


if __name__ == "__main__":
    raise SystemExit(main())

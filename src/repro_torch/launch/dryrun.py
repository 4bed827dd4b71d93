"""Sharded dry run: rank 0 of every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

Per cell:
  1. the production mesh (16x16 single-pod, 2x16x16 multi-pod) over a
     ``fake`` process group of its size, as rank 0 (``launch/mesh.py:
     fake_world``): its collectives return outputs of the right shape
     and move no data;
  2. params, optimizer state, batch and KV cache laid out by the rule
     engine (``param_shardings``, ``opt_state_shardings``,
     ``batch_shardings``, ``cache_shardings``) as DTensors, and the
     train, prefill or decode step as rank 0's local program
     (``distributed/program.py``);
  3. the xMem estimate of that program (``XMemEstimator.for_torch_gpu``,
     the counterpart of XLA's ``memory_analysis()``), traced on the CPU
     with fake local shards (nothing is allocated; a deep stack is
     composed from probes, ``core/depth.py``);
  4. its local FLOPs, bytes and collective operand bytes by kind
     (``launch/program_analysis.py``, the counterpart of
     ``cost_analysis()`` and the reference's HLO parse), beside the
     analytic per-device terms;
  5. on the card (``--device cuda``, the default) rank 0 of the same
     program runs with real local shards, the training steps the
     estimate composes (3) or one serving step, and the record gets its ``max_memory_reserved`` and
     ``max_memory_allocated``; with ``--device cpu`` nothing runs.

Serving cells attend through the attention kernel (``impl="flash"``, as
``launch/serve.py`` serves), on each rank's heads
(``act_sharding.local_heads``).

The record has the reference's keys: ``arch, shape, mesh, ok, devices,
memory, cost, collectives, hlo_ops, compile_s`` (``hlo_ops``: rank 0's
local ops; ``compile_s``: the cell's seconds). A failing cell is
recorded with its error. The fake group leaves out what a real one
adds: NCCL's buffers and the data the collectives move.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k [--multi-pod] --device cpu [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      phi3.5-moe-42b-a6.6b --both-meshes --device cpu   # every shape
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --xmem-gate qwen3-32b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import get_config
from ..configs.base import SHAPES_BY_NAME, supports_long_context
from ..distributed.act_sharding import DEFAULT_RULES
from ..distributed.sharding import ShardingPolicy
from ..models import model as M
from ..train.train_step import TrainPolicy
from .analytic import analytic_bytes, analytic_flops
from .mesh import fake_world, mesh_axis_sizes, production_shape
from .program_analysis import COLLECTIVES

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: a stack deeper than this many repeating units is counted from probes
#: at one and two units (the counts are affine in the units)
COUNT_FULL_UNITS = 2


# ---------------------------------------------------------------------------
def arch_train_policy(arch: str, cfg) -> TrainPolicy:
    """Per-arch training policy a real team would pick at this scale."""
    n = cfg.param_count()
    if n > 80e9:
        return TrainPolicy(optimizer="adafactor", microbatches=8,
                           clip_norm=1.0)
    if n > 8e9:
        return TrainPolicy(optimizer="adamw", microbatches=4, clip_norm=1.0)
    return TrainPolicy(optimizer="adamw", microbatches=1, clip_norm=1.0)


def arch_sharding_policy(cfg, mesh) -> ShardingPolicy:
    names = tuple(mesh_axis_sizes(mesh))
    axes = ("data", "pod") if "pod" in names else ("data",)
    fsdp = cfg.param_count() > 8e9     # ZeRO-3 for everything sizable
    return ShardingPolicy(fsdp=fsdp, fsdp_axes=axes,
                          batch_axes=tuple(a for a in ("pod", "data")
                                           if a in names))


def _with_moe_groups(cfg, mesh):
    if cfg.moe is None:
        return cfg
    sizes = mesh_axis_sizes(mesh)
    groups = sizes.get("data", 1) * sizes.get("pod", 1)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_groups=groups))


def policies(cfg, shape, mesh) -> tuple:
    """The cell's (sharding policy, training policy or None), chosen for
    ``cfg`` (a depth cut passes its full config)."""
    tpolicy = arch_train_policy(cfg.name, cfg) \
        if shape.kind == "train" else None
    return arch_sharding_policy(cfg, mesh), tpolicy


def mesh_tag(shape: tuple) -> str:
    return "pod" + "x".join(str(d) for d in shape)


# ---------------------------------------------------------------------------
def build_job(cfg, shape, mesh, spolicy=None, tpolicy=None):
    """The cell's ``ShardedJob`` (``distributed/program.py``)."""
    from ..distributed.program import sharded_job
    spolicy = spolicy or arch_sharding_policy(cfg, mesh)
    return sharded_job(cfg, shape, mesh, spolicy, shape.kind,
                       train_policy=tpolicy, rules=DEFAULT_RULES)


def _serving_args(job) -> list:
    return [job.local["params"], job.local["cache"], job.local["batch"]]


def estimate(job, est=None, capacity: int | None = None):
    """The xMem estimate of rank 0's program (an ``EstimateReport``)."""
    from ..core.estimator import XMemEstimator
    est = est or XMemEstimator.for_torch_gpu()
    p = job.programs
    if job.kind == "train":
        return est.estimate_training(
            p["fwd_bwd"].local, job.local["params"], job.local["batch"],
            update_fn=p["update"].local, opt_init_fn=p["opt_init"].local,
            capacity=capacity)
    return est.estimate_serving(p["step"].local, *_serving_args(job),
                                capacity=capacity)


def _count_job(job):
    """Rank 0's counts of one step of ``job`` on fake local shards."""
    from .program_analysis import count_local
    p = job.programs
    if job.kind != "train":
        return count_local(p["step"].local, *_serving_args(job))
    params = job.local["params"]
    return (count_local(p["fwd_bwd"].local, params, job.local["batch"])
            + count_local(p["opt_init"].local, params)
            + count_local(p["update"].local, params, params,
                          job.local["opt_state"]))


def count(cfg, shape, mesh, spolicy, tpolicy):
    """Rank 0's local counts of one step (``ProgramCounter``) and how
    they were made: a stack of more than ``COUNT_FULL_UNITS`` repeating
    units from two probes (one unit and two, with the remainder
    layers), extrapolated."""
    n_units, unit, rem = M.repeat_unit(cfg)
    if n_units <= COUNT_FULL_UNITS:
        return (_count_job(build_job(cfg, shape, mesh, spolicy, tpolicy)),
                {"source": "full", "units": n_units})
    probes = [_count_job(build_job(
        dataclasses.replace(cfg, n_layers=u * unit + rem), shape, mesh,
        spolicy, tpolicy)) for u in (1, 2)]
    return (probes[0].scaled(probes[1], n_units, 1),
            {"source": "probes", "units": n_units, "probe_units": [1, 2]})


def local_bytes(tree) -> int:
    from torch.utils import _pytree as pytree
    return int(sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(tree) if hasattr(t, "numel")))


def run_on_card(job, steps: int = 1, seed: int = 0) -> dict:
    """Rank 0 of ``job`` on the card with real local shards (random, from
    ``seed``): ``steps`` training steps (the optimizer state made after
    the first backward) or one serving step, between a reset of the
    card's peak statistics and a read of them; ``allocated_before``: what
    the process held before the run's tensors were made (counted in its
    peaks, not in an estimate)."""
    import torch
    from ..core.baselines.directprobe import (measured_peak,
                                              measured_training)
    from ..distributed.program import materialize
    mesh, p = job.mesh, job.programs
    # the run's resident tensors take segments of their own, as the
    # estimate's replay gives them
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    local = {name: _locals(materialize(job.layouts[name], job.trees[name],
                                       mesh, "cuda", seed + i))
             for i, name in enumerate(("params", "batch", "cache"))
             if name in job.trees}
    torch.cuda.synchronize()
    if job.kind == "train":
        batch = local["batch"]
        got = measured_training(p["fwd_bwd"].local, p["update"].local,
                                p["opt_init"].local, local["params"],
                                lambda _step: batch, steps=steps)
        out = {"losses": got.out.losses,
               "step_s": got.out.step_s}
    else:
        got = measured_peak(p["step"].local, local["params"],
                            local.get("cache", {}), local["batch"])
        out = {"step_s": [got.seconds]}
    out.update(reserved=got.reserved, allocated=got.allocated,
               allocated_before=before,
               segments_mib=[round(x / 2**20, 1) for x in got.segment_sizes])
    del local
    torch.cuda.empty_cache()
    return out


def _locals(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.to_local(), tree)


# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "artifacts/dryrun_torch",
             skip_existing: bool = True, device: str = "cuda",
             n_layers: int | None = None) -> dict:
    """One cell's record (written to ``out_dir``). ``device`` "cpu"
    estimates and counts only; "cuda" also runs rank 0 on the card.
    ``n_layers`` cuts the depth (the record says so)."""
    os.makedirs(out_dir, exist_ok=True)
    shape_dims, names = production_shape(multi_pod)
    tag = mesh_tag(shape_dims)
    cut = "" if n_layers is None else f"__L{n_layers}"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}{cut}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    full = cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES_BY_NAME[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": tag, "ok": False,
              "device": device}
    if n_layers is not None:
        record["n_layers"] = n_layers
    if shape.name == "long_500k" and not supports_long_context(cfg):
        record.update(skipped=True, reason="full-attention arch: "
                      "long_500k requires sub-quadratic family "
                      "(DESIGN.md §4)")
        _write(path, record)
        return record

    t0 = time.time()
    n_dev = 1
    for d in shape_dims:
        n_dev *= d
    try:
        with fake_world(n_dev):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", shape_dims, mesh_dim_names=names)
            run_mesh = None if device == "cpu" else init_device_mesh(
                device, shape_dims, mesh_dim_names=names)
            record.update(cell_record(cfg, shape, mesh, record, run_mesh,
                                      policy_cfg=full))
        record.update(ok=True, compile_s=time.time() - t0)
    except Exception as e:  # noqa: BLE001 — record the failure, move on
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:],
                      compile_s=time.time() - t0)
    _write(path, record)
    return record


def cell_record(cfg, shape, mesh, record: dict, run_mesh=None,
                policy_cfg=None) -> dict:
    """The record's fields of ``cfg`` at ``shape`` on ``mesh`` (a CPU
    ``DeviceMesh`` over rank 0 of a process group of its size: the
    estimate traces fake CPU shards, as every estimate does) and, with
    ``run_mesh`` (the same mesh on the card), the card's run (a training
    step as many times as the estimate composes iterations); the
    policies, chosen for ``policy_cfg`` (default ``cfg``; a depth cut
    keeps its full config's), are written into ``record``."""
    cfg = _with_moe_groups(cfg, mesh)
    if shape.kind != "train":
        # serving attends through the kernel, as ``launch/serve.py`` does
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, impl="flash"))
    spolicy, tpolicy = policies(policy_cfg or cfg, shape, mesh)
    record["sharding"] = {"fsdp": spolicy.fsdp}
    if tpolicy is not None:
        record["train_policy"] = {"optimizer": tpolicy.optimizer,
                                  "microbatches": tpolicy.microbatches}
    from ..core.estimator import XMemEstimator
    est = XMemEstimator.for_torch_gpu()
    job = build_job(cfg, shape, mesh, spolicy, tpolicy)
    t0 = time.time()
    rep = estimate(job, est)
    est_s = time.time() - t0
    t0 = time.time()
    counter, how = count(cfg, shape, mesh, spolicy, tpolicy)
    count_s = time.time() - t0
    sizes = mesh_axis_sizes(mesh)
    n_dev = 1
    for v in sizes.values():
        n_dev *= v
    micro = tpolicy.microbatches if tpolicy is not None else 1
    fsdp_shards = (sizes.get("data", 1) * sizes.get("pod", 1)
                   if spolicy.fsdp else 1)
    args = local_bytes(job.local)
    out = {
        "devices": int(n_dev),
        "memory": {
            "argument_bytes": args,
            "per_device_bytes": int(rep.peak_bytes),
            "peak_tensor_bytes": int(rep.peak_tensor_bytes),
            "persistent_bytes": int(rep.persistent_bytes),
            "oom": bool(rep.oom),
            "estimate_s": est_s,
            "depth": rep.depth,
        },
        "cost": {
            **counter.cost(),
            "analytic_flops_per_device": float(
                analytic_flops(cfg, shape) / n_dev),
            "analytic_bytes_per_device": float(analytic_bytes(
                cfg, shape, n_devices=n_dev,
                model_shards=sizes.get("model", 1),
                fsdp_shards=fsdp_shards, microbatches=micro)),
            "counted": how, "count_s": count_s,
        },
        "collectives": counter.collectives(),
        "hlo_ops": int(counter.ops),
    }
    if run_mesh is not None:
        card = run_on_card(build_job(cfg, shape, run_mesh, spolicy, tpolicy),
                           steps=est.iterations)
        card["rel_reserved"] = (rep.peak_bytes - card["reserved"]) \
            / card["reserved"]
        card["rel_allocated"] = (rep.peak_tensor_bytes - card["allocated"]) \
            / card["allocated"]
        out["card"] = card
    return out


def _write(path: str, record: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(path + ".tmp", path)


def iter_cells(archs=None):
    from ..configs.registry import ARCH_IDS
    for arch in archs or ARCH_IDS:
        for shape_name in SHAPE_NAMES:
            yield arch, shape_name


# ---------------------------------------------------------------------------
# the estimator-side gates (the reference's ``xmem_gate``,
# ``xmem_mesh_gate`` and ``--xmem-plan``), through the port's own sweep
# and planner at smoke scale
def xmem_gate(arch: str, hbm_gib: float = 0.25, seq: int = 64,
              batches: tuple = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64),
              out_dir: str = "artifacts/dryrun_torch",
              microbatches: int = 1) -> dict:
    """The admission service's batched decision over candidate batches
    (smoke scale), before any sharded run."""
    from ..configs import get_smoke
    from ..configs.base import smoke_shape
    from ..configs.registry import input_specs
    from ..service import AdmissionRequest, AdmissionService
    from ..train import make_estimator_hooks
    cfg = get_smoke(arch)
    m = max(int(microbatches), 1)
    batches = tuple(b for b in batches if b % m == 0) or (m,)
    fwd_bwd, update, opt_init = make_estimator_hooks(
        cfg, TrainPolicy(optimizer="adamw", microbatches=m))
    params = M.abstract_params(cfg)
    svc = AdmissionService(workers=1)
    hbm = int(hbm_gib * 2**30)
    reqs = [AdmissionRequest(
        job_id=f"{cfg.name}-b{b}", fwd_bwd_fn=fwd_bwd, params=params,
        batch=input_specs(cfg, smoke_shape(seq_len=seq, global_batch=b)),
        update_fn=update, opt_init_fn=opt_init, capacity=hbm)
        for b in batches]
    decisions = svc.decide_sweep(reqs)
    record = {
        "arch": cfg.name, "kind": "xmem_gate", "hbm_bytes": hbm,
        "seq": seq, "microbatches": m,
        "settings": [{"batch": b, "peak_bytes": d.peak_bytes,
                      "fits": d.admit} for b, d in zip(batches, decisions)],
    }
    record["admitted"] = [s["batch"] for s in record["settings"]
                          if s["fits"]]
    os.makedirs(out_dir, exist_ok=True)
    _write(os.path.join(out_dir, f"{arch}__xmem_gate.json"), record)
    return record


def xmem_mesh_gate(arch: str, hbm_gib: float = 0.25, seq: int = 64,
                   batch: int = 32, devices: tuple = (8, 16, 32),
                   out_dir: str = "artifacts/dryrun_torch") -> dict:
    """Per-device admission over mesh topologies from one cached trace
    (``launch/hillclimb.py:xmem_mesh_hillclimb``, smoke scale)."""
    from .hillclimb import xmem_mesh_hillclimb
    record = xmem_mesh_hillclimb(arch, int(hbm_gib * 2**30), seq=seq,
                                 batch=batch, devices=devices,
                                 verbose=False)
    record["kind"] = "xmem_mesh_gate"
    os.makedirs(out_dir, exist_ok=True)
    _write(os.path.join(out_dir, f"{arch}__xmem_mesh_gate.json"), record)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: also run rank 0 on the card; cpu: "
                         "estimate and count only")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (recorded)")
    ap.add_argument("--xmem-gate", metavar="ARCH")
    ap.add_argument("--xmem-mesh-gate", metavar="ARCH")
    ap.add_argument("--xmem-plan", metavar="ARCH")
    ap.add_argument("--plan-batch", type=int, default=32)
    ap.add_argument("--plan-seq", type=int, default=48)
    ap.add_argument("--devices", default="8,16,32")
    ap.add_argument("--hbm-gib", type=float, default=0.25)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    if args.xmem_plan:
        from ..plan import run_plan_search
        devices = tuple(int(d) for d in args.devices.split(","))
        r = run_plan_search(args.xmem_plan, int(args.hbm_gib * 2**30),
                            seq=args.plan_seq, batch=args.plan_batch,
                            microbatches=args.microbatches, devices=devices)
        os.makedirs(args.out, exist_ok=True)
        _write(os.path.join(args.out, f"{args.xmem_plan}__xmem_plan.json"),
               r)
        print(f"[xmem-plan] {r['arch']}: "
              + ("already fits" if r["admit"] else
                 f"{len(r['counter_offers'])} offers"))
        return 0
    if args.xmem_mesh_gate:
        devices = tuple(int(d) for d in args.devices.split(","))
        r = xmem_mesh_gate(args.xmem_mesh_gate, hbm_gib=args.hbm_gib,
                           devices=devices, out_dir=args.out)
        print(f"[xmem-mesh-gate] {args.xmem_mesh_gate}: best "
              f"{r.get('best_topology', '-')}")
        return 0
    if args.xmem_gate:
        r = xmem_gate(args.xmem_gate, hbm_gib=args.hbm_gib,
                      out_dir=args.out, microbatches=args.microbatches)
        print(f"[xmem-gate] {r['arch']}: admitted batches {r['admitted']}")
        return 0

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu to estimate only")
            return 1
    meshes = (False, True) if (args.both_meshes or args.all) \
        else (args.multi_pod,)
    cells = [(arch, shape) for arch, shape in iter_cells(
        None if args.all else [args.arch])
        if args.shape in (None, shape)]
    results = []
    for arch, shape_name in cells:
        for mp in meshes:
            r = run_cell(arch, shape_name, mp, args.out,
                         skip_existing=not args.force, device=args.device,
                         n_layers=args.n_layers)
            status = "OK " if r.get("ok") else ("SKIP" if r.get("skipped")
                                                else "FAIL")
            extra = ""
            if r.get("ok"):
                extra = (f" mem/dev={r['memory']['per_device_bytes']/2**30:.2f}"
                         f"GiB flops={r['cost']['flops']:.3g}"
                         f" coll={r['collectives']['total_bytes']/2**30:.2f}"
                         f"GiB t={r['compile_s']:.0f}s")
                if "card" in r:
                    extra += (f" card={r['card']['reserved']/2**30:.2f}GiB"
                              f" ({r['card']['rel_reserved']:+.2%})")
            elif r.get("error"):
                extra = " " + r["error"][:120]
            print(f"[{status}] {arch} {shape_name} "
                  f"{'2x16x16' if mp else '16x16'}{extra}", flush=True)
            results.append(r)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"== {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed ==")
    return 0 if n_ok + n_skip == len(results) or args.all else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher: the xMem admission gate, then the training loop.

Before a parameter is allocated, the xMem training estimator (traced on
the CPU under fake tensors, composed over 3 iterations, replayed through
the CUDA caching allocator simulation at the card's capacity) picks the
largest global batch of the candidates whose estimate fits. Then the
loop trains that batch: on the card every step runs inside the training
measurement (``measured_training``), which reads the real peaks beside
the estimate.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --n-layers 4 --seq 4096 --batch 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --smoke --device cpu --steps 6 --ckpt-dir ckpt --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --smoke --device cpu --steps 0 --batch 8 --capacity-gib 0.07

The gate decides through the admission service
(:mod:`repro_torch.service.admission`), whose exact rung is the
estimator's replay at the capacity. When it rejects the asked
``--batch``, the remediation planner's microbatch axis is searched
first (``replan_if_needed``): with a feasible offer the loop trains the
asked batch at the offer's microbatches; without one the gate halves
the batch. Capacity comes from the card
(``serve.device_capacity``: the free memory plus what the caching
allocator holds); a CPU run budgets nothing. With ``--ckpt-dir`` the
loop resumes from the newest valid checkpoint there, saves every
``--ckpt-every`` steps and at the end, and saves an emergency checkpoint
when a step raises (the JAX package's ``train_loop`` flow, in its
checkpoint format).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
from torch.utils import _pytree as pytree

from ..configs import get_config, get_smoke
from ..configs.base import ShapeSpec, smoke_shape
from ..configs.registry import input_specs
from ..core.baselines.directprobe import measured_training
from ..core.estimator import XMemEstimator
from ..core.loops import note as loops_note
from ..models import model as M
from ..train import (SyntheticDataset, TrainPolicy, TrainRun,
                     make_estimator_hooks, run_steps)
from ..train.checkpoint import CheckpointManager
from ..train.elastic import StragglerMonitor
from ..service import AdmissionRequest, AdmissionService, JobContext
from .serve import device_capacity, gate_provenance


def gate_service(est: XMemEstimator | None = None) -> AdmissionService:
    """A one-worker admission service whose estimators have ``est``'s
    settings and share its trace cache (default: a fresh
    ``for_torch_gpu`` estimator's), so traces ``est`` made ahead are
    hits."""
    est = est or XMemEstimator.for_torch_gpu()
    return AdmissionService(est.with_cache, workers=1,
                            cache=est.trace_cache)


def train_request(cfg, policy: TrainPolicy, shape: ShapeSpec,
                  capacity: int, **kw) -> AdmissionRequest:
    """The admission request of a training job: its estimator hooks,
    abstract parameters and input specs, and the job itself as
    ``meta["job"]`` (the analytic rung's configuration bound)."""
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    return AdmissionRequest(
        job_id=f"{cfg.name}/b{shape.global_batch}/s{shape.seq_len}"
               f"/mb{policy.microbatches}",
        fwd_bwd_fn=fwd_bwd, params=M.abstract_params(cfg),
        batch=input_specs(cfg, shape), update_fn=update,
        opt_init_fn=opt_init, capacity=capacity,
        meta={"job": JobContext(cfg, policy, shape)}, **kw)


def admission_check(cfg, policy: TrainPolicy, shape: ShapeSpec,
                    capacity: int, est: XMemEstimator | None = None,
                    service: AdmissionService | None = None,
                    return_decision: bool = False):
    """xMem gate: estimate the job's peak device memory on the CPU and
    admit it when the replay at ``capacity`` neither ran out of memory
    nor reserved more than ``capacity``. Decides through ``service``
    (default: ``gate_service(est)``). Returns ``(admit, report)``, and
    the ``AdmissionDecision`` too with ``return_decision`` (the report
    is None when a degraded rung answered)."""
    if service is None:
        service = gate_service(est)
    decision = service.decide(train_request(cfg, policy, shape, capacity))
    if return_decision:
        return decision.admit, decision.report, decision
    return decision.admit, decision.report


def replan_if_needed(cfg, policy: TrainPolicy, shape: ShapeSpec,
                     capacity: int, service: AdmissionService | None = None,
                     est: XMemEstimator | None = None):
    """Admit the job as asked, or replan it through the remediation
    planner's microbatch axis. Returns ``(policy, report, decision)``:
    the asked policy and its admitting decision, the offer's policy and
    report with ``decision`` None, or the asked policy and its rejection
    when no microbatch count fits.

    Candidates are the accumulation factors that still divide the global
    batch (``m0`` doubled up to three times), probed cheapest modeled
    cost first; ``early_stop`` ends the search at the first feasible
    offer. Batch, remat and offload stay the caller's; the gate's own
    rejection is the planner's baseline, so it is not estimated
    again."""
    from ..plan import PlanSpace, RemediationPlanner
    if service is None:
        service = gate_service(est)
    ok, rep, decision = admission_check(cfg, policy, shape, capacity,
                                        service=service,
                                        return_decision=True)
    if ok:
        return policy, rep, decision
    space = PlanSpace(batches=(), remat=(), mb_doublings=3,
                      early_stop=True, max_offers=1)
    res = RemediationPlanner(service).plan(
        cfg, policy, shape, capacity=capacity, space=space,
        job_id=f"{cfg.name}/{shape.name}", baseline=decision)
    offer = res.best()
    if offer is not None:
        p = dataclasses.replace(policy, microbatches=offer.microbatches)
        print(f"[xmem] replanning: microbatches -> {p.microbatches} "
              f"(peak {offer.peak_bytes/2**30:.2f} GiB, modeled "
              f"slowdown x{offer.slowdown:.2f})")
        return p, offer.report, None
    return policy, rep, decision


def pick_train_batch(cfg, policy: TrainPolicy, seq_len: int,
                     capacity: int | None = None,
                     candidates=(8, 4, 2, 1),
                     est: XMemEstimator | None = None,
                     service: AdmissionService | None = None):
    """Largest global batch of ``candidates`` whose training estimate,
    replayed at ``capacity`` (default: ``device_capacity()``), fits.

    Every candidate is decided through one admission service
    (``service``, default ``gate_service(est)``: estimators over
    ``est``'s trace cache, a fresh ``for_torch_gpu()`` one's without
    ``est``), so the cache gives the batch-independent optimizer phases
    to all but the first candidate, and every phase traced before
    (``est.trace_phases`` ahead of the capacity) to all. Returns
    ``(batch, gate)``; ``gate`` holds every candidate tried (with its
    decision's ``source`` and ``rung``; ``decisions`` maps each batch
    tried to its ``AdmissionDecision``), the admitting report and
    decision, the CPU seconds and the trace cache's counts, or
    ``(None, gate)`` when no candidate fits."""
    if capacity is None:
        capacity = device_capacity()
    if service is None:
        service = gate_service(est)
    gate: dict = {"capacity": capacity, "candidates": []}
    t0 = time.perf_counter()
    batch = None
    for b in candidates:
        if b % policy.microbatches:
            continue
        ok, rep, decision = admission_check(
            cfg, policy, smoke_shape(seq_len, b), capacity,
            service=service, return_decision=True)
        gate.setdefault("decisions", {})[b] = decision
        gate["candidates"].append(
            {"batch": b, "estimate": decision.peak_bytes,
             "tensor": decision.peak_tensor_bytes,
             "oom": rep.oom if rep is not None else None, "fits": ok,
             **gate_provenance(decision)})
        if ok:
            batch = b
            gate.update(batch=b, report=rep, decision=decision)
            break
    gate["seconds"] = time.perf_counter() - t0
    gate["trace_cache"] = {"hits": service.cache.hits,
                           "misses": service.cache.misses}
    return batch, gate


def train_loop(cfg, shape: ShapeSpec, policy: TrainPolicy, *, steps: int,
               device="cuda", seed: int = 0, params=None,
               history: bool = False, ckpt_dir: str | None = None,
               ckpt_every: int = 20):
    """Train up to step ``steps`` of ``shape``'s batch from random
    weights (``seed``) on synthetic data. On a CUDA device the steps run
    inside ``measured_training`` (``history``: with the allocator's
    request history) and the result is its ``MeasuredPeak`` (the
    ``TrainRun`` in ``out``); on the CPU the result is the ``TrainRun``.
    Each step's time goes to a one-worker ``StragglerMonitor`` as
    worker 0's.

    With ``ckpt_dir``: first restore the newest valid checkpoint there
    into ``params`` and the optimizer state (and go on from its step);
    save every ``ckpt_every`` steps and after the last; when a step
    raises, save an emergency checkpoint at that step and re-raise. An
    exception that cuts the in-place update short leaves parameters and
    state partly updated, and then nothing is saved. The restore and
    the final save lie outside the measured window; a save between
    steps copies the tensors to the host and allocates nothing on the
    card. ``ckpt_dir=None`` writes nothing."""
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    if params is None:
        params = M.init_params(cfg, seed, device=device)
    monitor = StragglerMonitor(n_workers=1)
    ds = SyntheticDataset(cfg, shape)
    run = TrainRun([], [])
    ckpt = None
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir)
        meta = M.abstract_params(cfg)
        restored = ckpt.restore_latest(
            {"params": meta, "opt_state": opt_init(meta)}, device="cpu")
        if restored is not None:
            run.step, state = restored
            with torch.no_grad():
                for p, r in zip(pytree.tree_leaves(params),
                                pytree.tree_leaves(state["params"])):
                    p.copy_(r)
            run.opt_state = pytree.tree_map(lambda t: t.to(device),
                                            state["opt_state"])
            print(f"[ckpt] resumed from step {run.step}")

    def state():
        opt_state = run.opt_state
        if opt_state is None:     # no update yet: the state it would make
            opt_state = opt_init(pytree.tree_map(
                lambda p: torch.empty(p.shape, dtype=p.dtype), params))
        return {"params": params, "opt_state": opt_state}

    def on_step(run):
        monitor.record(0, run.step_s[-1])
        if ckpt is not None and run.step % ckpt_every == 0:
            ckpt.save(run.step, state())

    def batch_fn(step):
        return ds.device_batch(step, device)

    try:
        if torch.device(device).type == "cuda":
            got = measured_training(fwd_bwd, update, opt_init, params,
                                    batch_fn, steps, device, history, run,
                                    on_step)
        else:
            got = run_steps(fwd_bwd, update, opt_init, params, batch_fn,
                            steps, run, on_step)
    except BaseException:
        if ckpt is not None and not run.torn:
            ckpt.emergency(run.step, state())
            print(f"[ckpt] emergency checkpoint at step {run.step}")
        raise
    if ckpt is not None:
        ckpt.save(steps, state())
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width is kept)")
    ap.add_argument("--steps", type=int, default=3,
                    help="0: gate only, allocate nothing")
    ap.add_argument("--batch", type=int, default=4,
                    help="largest global batch the gate tries; it halves "
                         "down to 1")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--capacity-gib", type=float, default=None,
                    help="default: what the card's allocator can hold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=20)
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("[xmem] no CUDA device; pass --device cpu to train on the CPU",
              file=sys.stderr)
        return 1
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.n_layers or cfg.n_layers)
    policy = TrainPolicy(optimizer=args.optimizer, learning_rate=args.lr,
                         microbatches=args.microbatches)
    if args.capacity_gib:
        capacity = int(args.capacity_gib * 2**30)
    elif on_card:
        capacity = device_capacity(args.device)
    else:
        capacity = 1 << 62          # a CPU run budgets nothing
    service = gate_service()
    policy, rep, decision = replan_if_needed(
        cfg, policy, smoke_shape(args.seq, args.batch), capacity,
        service=service)
    if decision is None:
        # the planner's offer: the asked batch at its microbatches
        batch, gate = args.batch, {"report": rep}
        print(f"[xmem] batch {batch} x {policy.microbatches} microbatches:"
              f" estimate {rep.peak_bytes / 2**20:.1f} MiB (tensors "
              f"{rep.peak_tensor_bytes / 2**20:.1f}) -> ADMIT")
        return _train_main(cfg, policy, batch, gate, args, on_card)
    candidates, b = [], args.batch
    while b >= 1:
        candidates.append(b)
        b //= 2
    batch, gate = pick_train_batch(cfg, policy, args.seq, capacity,
                                   candidates, service=service)
    for c in gate["candidates"]:
        trace = "".join(f", trace {d['source']}: {d['units_traced']} of "
                        f"{d['units']} units traced{loops_note(d)}"
                        for d in c.get("depth", ()))
        print(f"[xmem] batch {c['batch']}: estimate "
              f"{c['estimate'] / 2**20:.1f} MiB (tensors "
              f"{c['tensor'] / 2**20:.1f}{', out of memory' if c['oom'] else ''}"
              f"{trace}) -> {'ADMIT' if c['fits'] else 'REJECT'}")
    print(f"[xmem] capacity {capacity / 2**20:.0f} MiB, gate "
          f"{gate['seconds']:.2f} s, trace cache "
          f"{gate['trace_cache']['hits']}h/{gate['trace_cache']['misses']}m")
    if batch is None:
        print("[xmem] no batch fits -> rejected")
        return 2
    return _train_main(cfg, policy, batch, gate, args, on_card)


def _train_main(cfg, policy: TrainPolicy, batch: int, gate: dict, args,
                on_card: bool) -> int:
    """``main``'s training half: ``args.steps`` steps of ``batch`` under
    ``policy`` and the result line beside the gate's report."""
    if args.steps == 0:
        return 0
    shape = smoke_shape(args.seq, batch)
    got = train_loop(cfg, shape, policy, steps=args.steps,
                     device=args.device, seed=args.seed,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    run = got.out if on_card else got
    first = run.step - len(run.losses)
    for step, (loss, s) in enumerate(zip(run.losses, run.step_s), first):
        print(f"step {step:3d} loss {loss:.4f} ({s * 1e3:.0f} ms)")
    result = {"device": args.device, "batch": batch, "losses": run.losses,
              "step_ms": [s * 1e3 for s in run.step_s],
              "estimate": gate["report"].peak_bytes,
              "tensor_estimate": gate["report"].peak_tensor_bytes}
    if on_card:
        result["measured"] = got.to_json()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

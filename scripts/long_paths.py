#!/usr/bin/env python3
"""Measurements of the long-sequence paths on one NVIDIA GPU, beside
``chip_smoke.py`` (whose helpers and constants they use):

    python3 scripts/long_paths.py [--beside] [uncapped] [edge] [dense_long] [nest]

Each named part runs in turn (all four without arguments), each in a
process of its own, as a job starts on a card, one JSON line each; with
``--beside``, while another process holds a CUDA context on the card
(and cuBLAS's workspace), as ``chip_smoke.py``'s processes do:

* ``nest`` — on the CPU, one training estimate composed at one level
  against two (``core/loops.py``'s ``NEST_MIN`` moved): xlstm-1.3b at 8
  layers (16 chunks a sLSTM) and qwen3-32b at 4 layers and 16,384
  positions (32 query chunks), each in a process of its own, two at a
  time: trace, probe, synthesis and replay seconds, and the bytes.
* ``edge`` — jamba's cut (``chip_smoke.path_config``) prefilling 32,768
  tokens at batch 2: the trace composed from probes against the trace in
  full, column by column; the estimate at the card's capacity and
  unbounded; then the card's own prefill, its reserved and allocated
  peaks, its request stream against the trace's, and that stream
  replayed through the allocator simulation.
* ``uncapped`` — ``chip_smoke``'s ``hybrid_long_`` serving path without
  the allocator cap, its gate at the card's whole capacity; the path's
  own check on the reserved peak may fail, and is reported.
* ``dense_long`` — qwen3-32b at 4 layers and 16,384 positions trained:
  the training gate over batches 2 and 1 at the card's capacity, 3
  AdamW steps, the estimate beside the card's peaks.

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (arch, depth, chip_smoke job whose policy it takes, batch, sequence,
#: NEST_MIN): each estimate of ``nest``, at one level and at two
NEST_CASES = (("xlstm-1.3b", 8, "ssm", 16, 4096, 32),
              ("xlstm-1.3b", 8, "ssm", 16, 4096, 16),
              ("qwen3-32b", 4, "dense", 1, 16384, 32),
              ("qwen3-32b", 4, "dense", 1, 16384, 64))
EDGE_BATCH = 2
LONG_TRAIN_CANDIDATES = (2, 1)


def emit(part: str, **kw) -> None:
    print(json.dumps({"part": part, **kw}), flush=True)


def nest_case(i: int) -> None:
    """One estimate of ``NEST_CASES[i]``, on the CPU."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core import loops as L
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    arch, n_layers, job, batch, seq, nest_min = NEST_CASES[i]
    torch.set_num_threads(2)
    L.NEST_MIN = nest_min
    cfg = cs.path_config(arch, n_layers)
    fwd, upd, init = make_estimator_hooks(cfg, cs.train_policy(job))
    params, specs = M.abstract_params(cfg), input_specs(
        cfg, smoke_shape(seq, batch))
    est = XMemEstimator.for_torch_gpu()
    t0 = time.perf_counter()
    phases = est.trace_phases(fwd, params, specs, upd, init)
    t1 = time.perf_counter()
    rep = est.estimate_from_phases(*phases)
    lp = rep.depth.get("loops", {})
    emit("nest", arch=arch, n_layers=n_layers, seq=seq, nest_min=nest_min,
         estimate=rep.peak_bytes, trace_s=t1 - t0,
         replay_s=time.perf_counter() - t1, probes=lp.get("probes"),
         probe_s=lp.get("probe_s"), synth_s=lp.get("synth_s"),
         signatures=lp.get("signatures"),
         steps_traced=lp.get("steps_traced"))


def nest() -> None:
    for pair in ((0, 1), (2, 3)):
        procs = [subprocess.Popen([sys.executable, __file__, "--nest-case",
                                   str(i)]) for i in pair]
        for p in procs:
            if p.wait() != 0:
                raise AssertionError(f"nest case failed: exit {p.returncode}")


def edge() -> None:
    import torch
    from torch.utils import _pytree as pytree
    import chip_smoke as cs
    from repro_torch.core import depth as D
    from repro_torch.core.allocator import (CUDA_CACHING_TORCH,
                                            CachingAllocatorSim,
                                            DeviceAllocatorSim)
    from repro_torch.core.baselines.directprobe import measured_peak
    from repro_torch.core.estimator import XMemEstimator, trace_entry
    from repro_torch.core.events import BlockKind, Phase
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    cfg = cs.path_config(cs.HYBRID_ARCH, cs.HYBRID_PERIOD, impl="flash")
    capacity = srv.device_capacity()
    fn = srv.make_prefill_fn(cfg)
    params_abs = M.abstract_params(cfg)
    cache = M.init_cache(cfg, EDGE_BATCH, cs.LONG_MAX_LEN, device="meta")
    prompts = srv.prompt_specs(cfg, EDGE_BATCH, cs.LONG_PROMPT)
    awk = [(params_abs, BlockKind.PARAM, "params"),
           (cache, BlockKind.CACHE, "cache"),
           (prompts, BlockKind.INPUT, "batch")]
    est = XMemEstimator.for_torch_gpu()
    t0 = time.perf_counter()
    at_cap = est.estimate_serving(fn, params_abs, cache, prompts,
                                  capacity=capacity)
    t1 = time.perf_counter()
    unbounded = est.estimate_serving(fn, params_abs, cache, prompts)
    composed = est._trace_phase(fn, awk, Phase.DECODE, tag="serve")
    t2 = time.perf_counter()
    full, _ = trace_entry(fn, awk, Phase.DECODE)
    t3 = time.perf_counter()
    traced = [(b.size, b.op) for b in sorted(composed.lifecycles,
                                             key=lambda b: b.alloc_t)
              if b.op != "input"]
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    prompt = srv.device_prompts(cfg, EDGE_BATCH, cs.LONG_PROMPT, seed=300)
    got = measured_peak(make_prefill_step(cfg), params, prompt,
                        history=True)
    card_only, trace_only = cs.align_requests(traced, got.allocs)
    sim = CachingAllocatorSim(CUDA_CACHING_TORCH, DeviceAllocatorSim(
        capacity, CUDA_CACHING_TORCH.device_page))
    for t in pytree.tree_leaves(params):
        sim.malloc(t.untyped_storage().nbytes())
    handles = {}
    for action, addr, size in got.events:
        if action == "alloc":
            handles[addr] = sim.malloc(size)
        elif addr in handles:
            sim.free(handles.pop(addr))
    emit("edge", batch=EDGE_BATCH, prompt=cs.LONG_PROMPT, capacity=capacity,
         composed_equals_full=D.phases_equal(composed, full),
         events=len(composed.trace.columnar()),
         composed_estimate_s=t1 - t0, full_trace_s=t3 - t2,
         loops=at_cap.depth.get("loops"),
         estimate_at_capacity=at_cap.peak_bytes,
         tensor_estimate=at_cap.peak_tensor_bytes,
         estimate_unbounded=unbounded.peak_bytes,
         measured_reserved=got.reserved, measured_allocated=got.allocated,
         card_alloc_retries=got.n_alloc_retries,
         rel_err_reserved=(at_cap.peak_bytes - got.reserved) / got.reserved,
         card_requests=len(got.allocs), trace_requests=len(traced),
         card_only=card_only[:12], trace_only=trace_only[:12],
         card_stream_sim={"reserved": sim.peak_reserved,
                          "allocated": sim.peak_allocated},
         memory=cs.device_memory())


def uncapped() -> None:
    import chip_smoke as cs
    rows: list = []
    for arch, (prefix, n_layers, cands) in cs.LONG_SERVING.items():
        try:
            cs.phase_serving(rows, arch, prefix, n_layers=n_layers,
                             max_len=cs.LONG_MAX_LEN,
                             prompt_len=cs.LONG_PROMPT, candidates=cands,
                             kernel_rows=False, long=True)
            failed = None
        except AssertionError as e:
            failed = str(e)
        emit("uncapped", config=arch, failed=failed)


def dense_long() -> None:
    import math
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.launch import serve as srv
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    cfg = cs.path_config("qwen3-32b", 4)
    policy = cs.train_policy("dense")
    seq = cs.LONG_TRAIN_SEQ
    est = XMemEstimator.for_torch_gpu()
    trace_s = {}
    for b in LONG_TRAIN_CANDIDATES:
        fwd, upd, init = make_estimator_hooks(cfg, policy)
        t0 = time.perf_counter()
        est.trace_phases(fwd, M.abstract_params(cfg),
                         input_specs(cfg, smoke_shape(seq, b)), upd, init)
        trace_s[b] = time.perf_counter() - t0
    capacity = srv.device_capacity()
    batch, gate = trn.pick_train_batch(
        cfg, policy, seq, capacity, LONG_TRAIN_CANDIDATES,
        service=trn.gate_service(est))
    if batch is None:
        emit("dense_long", capacity=capacity, batch=None,
             candidates=gate["candidates"])
        return
    rep = gate["report"]
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    got = trn.train_loop(cfg, smoke_shape(seq, batch), policy,
                         steps=cs.TRAIN_STEPS, device="cuda", params=params)
    run = got.out
    emit("dense_long", config=cfg.name, n_layers=cfg.n_layers, seq_len=seq,
         capacity=capacity, batch=batch, candidates=gate["candidates"],
         gate_seconds=gate["seconds"], trace_seconds=trace_s,
         losses=run.losses,
         finite=all(math.isfinite(x) for x in run.losses),
         step_ms=[x * 1e3 for x in run.step_s], estimate=rep.peak_bytes,
         tensor_estimate=rep.peak_tensor_bytes,
         measured_reserved=got.reserved, measured_allocated=got.allocated,
         rel_err_reserved=(rep.peak_bytes - got.reserved) / got.reserved,
         rel_err_allocated=(rep.peak_tensor_bytes - got.allocated)
         / got.allocated, card_alloc_retries=got.n_alloc_retries,
         memory=cs.device_memory())


PARTS = {"uncapped": uncapped, "edge": edge, "dense_long": dense_long,
         "nest": nest}


def hold_context() -> None:
    """A CUDA context and cuBLAS's workspace on the card, held until
    stdin closes."""
    import torch
    a = torch.ones(64, 64, device="cuda")
    torch.cuda.synchronize()
    print("held", flush=True)
    sys.stdin.read()
    del a


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--nest-case"]:
        nest_case(int(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("long_paths: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--part"]:
        PARTS[sys.argv[2]]()
        return 0
    if sys.argv[1:2] == ["--hold"]:
        hold_context()
        return 0
    import chip_smoke as cs
    args = sys.argv[1:]
    beside = "--beside" in args
    names = [a for a in args if a != "--beside"] or list(PARTS)
    emit("device", nvidia_smi=cs.nvidia_smi(),
         name=torch.cuda.get_device_name(0), beside=beside)
    for name in names:
        if name not in PARTS:
            raise SystemExit(f"long_paths: no part {name!r}")
        holder = None
        if beside:
            holder = subprocess.Popen(
                [sys.executable, __file__, "--hold"], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
            holder.stdout.readline()
        t0 = time.perf_counter()
        try:
            rc = subprocess.call([sys.executable, __file__, "--part", name])
        finally:
            if holder is not None:
                holder.stdin.close()
                holder.wait()
        emit("seconds", of=name, seconds=time.perf_counter() - t0, exit=rc)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

0. the training jobs of phases 9-14 start at once, each in a
   process of its own that traces its gate's first two candidates on
   the CPU (no CUDA call) while this process uses the card, on the
   other half of the CPU cores (``cpus``), then waits for its turn on
   the card;
1. device  — the card (``nvidia-smi`` name and power limit), torch/CUDA;
2. build   — every kernel under ``src/repro_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card
   (the cases of ``tests/test_kernels.py``, head dim 256, gemma3-4b's
   attention shape with and without its window, each through the kernel
   that ``route`` picks; then both kernels at qwen3-32b's serving shape,
   the sm90 kernel at phi3.5-moe's, and at kimi-k2's head dim 112
   through the model-layout wrapper, which pads it to 128), and their
   times beside the plain version, a library call and the bound;
4. main    — qwen3-32b at full width, depth cut to 8 layers: the xMem
   serving gate (``pick_batch``, traced on the CPU and decided through
   the admission service, as every gate below is: each candidate's
   ``source`` and ``rung``), then ``serve`` on
   the card (two requests of 2048-token prompts, 16 decoded tokens
   each), the launch counts by kernel (all on sm90), each phase's
   estimate beside the
   measured peak, the card's allocator requests during one prefill
   aligned with the trace's (``requests``), the device time of one warm
   prefill by kernel (``profile``), the kernel path's logits against
   the dense path's (``parity``), and ``serving_sweep``: the
   request-driven serving estimate over a knob grid (page size x
   concurrency x KV dtype) from one decode trace, its monolithic
   composition at the admitted batch beside the card's decode peak, and
   ``serve_mix``: the request-driven gate (``pick_serving``) for the
   same requests, held to the sweep's row at its knobs to the byte;
5. moe_layer — one phi3.5-moe MoE layer at full width: the card's
   allocator requests (with the ATen function that made each) against
   the trace's, for the serving forward and for a training forward and
   backward: what the CPU trace misses inside the dispatch's ops; and
   attn_layer, the same for the chunked attention's training forward
   and backward at a 4096-token sequence;
6. moe_main — the same serving path for phi3.5-moe-42b-a6.6b at full
   width, depth cut to 8 layers (``moe_gate``, ``moe_main``,
   ``moe_requests``, ``moe_profile``, ``moe_parity``), and the tokens
   each expert took and dropped at the prefill (``moe_experts``);
7. vlm_main — the same for internvl2-1b at full width and full depth
   (24 layers): 256 patch embeddings before a 2048-token prompt, the
   gate over batches 256 down to 1 (``vlm_*``), the sm90 kernel held
   against the plain version at the admitted batch's shape
   (``vlm_kernel``);
8. audio_main — the same for musicgen-medium at full width and full
   depth (48 layers): prompts of 2048 codes of 4 codebooks, greedy
   decoding per codebook (``audio_*``);
8a. hybrid_main — the same for jamba-1.5-large-398b at full width, cut
   to one period of ``attn_every=2`` (``path_config``: one attention
   layer with a dense MLP, one Mamba layer with the 16-expert MoE;
   23.8 GB), the sm90 kernel held against the plain version at the
   admitted batch's shape (``hybrid_kernel``), flash against dense, and
   ``hybrid_recurrent_parity`` for one full-width Mamba layer;
8b. ssm_main — the same for xlstm-1.3b at full width (``ssm_*``, depth
   in ``SSM_SERVING_LAYERS``, whole periods of 7 mLSTM + 1 sLSTM): no
   attention, so no kernel launch; its decode state is the mLSTM and
   sLSTM recurrent state. In place of the flash-against-dense parity,
   ``ssm_recurrent_parity``: one mLSTM and one sLSTM block at full
   width in f32 on the card, the chunked forms against the one-step
   decode recurrence;
9. train   — in a child process of its own (``--train dense ROWS``,
   which writes its baselines' row to the file ROWS), as a training job
   runs: qwen3-32b at full width, depth cut to 4 layers,
   sequences of 4096: the xMem training gate (``pick_train_batch`` over
   batches 8, 4, 2, 1, traced on the CPU; ``train_gate``), then 3 AdamW
   steps on the card inside the training measurement (``train``:
   losses, step times, the estimate beside ``max_memory_reserved`` and
   ``max_memory_allocated``, requests and segments, and the card's own
   request stream replayed through the allocator simulation), and the
   window's allocator requests set against the trace's
   (``train_requests``); then the paper's baselines for that job
   (``dense_baselines``): TensorSum and DNNMem from the
   forward+backward trace the gate cached for the admitted batch, and
   DirectProbe's two 2-step runs on the card at a quarter and a half of
   the batch, each beside the measured reserved peak; then
   ``dense_sweep``: the sweep service over batches 1-8 (its probes traced
   ahead with the gate's, the other batches synthesized from the affine
   trace model), the synthesized report at the gate's batch held to the
   gate's real-trace report to the byte, and, when the sweep admits a
   larger batch than the gate's candidates did, ``dense_sweep_train``:
   that batch trained on the card against its estimate; and
   ``dense_sweep_reject``: the smallest batch the sweep rejects above
   the admitted ones, run on the card (does it run out of memory too?);
   and ``admission_degraded``: batches 1, 2, 4, 5 and 8 decided on the
   degradation ladder's lower rungs (the tracer and replay failing with
   the gate's decision log; the tracer hanging past a 2 s deadline; no
   evidence, the analytic bound), each answer held to the card's truth
   there: no admitted batch may need more than its safe threshold, and
   none the card cannot run may be admitted;
9a. dense_sgd_train — the same job with SGD (``--train dense_sgd``):
   the paper's optimizer axis, where DNNMem's estimate stays put;
10. moe_train — the same in a child of its own (``--train moe``) for
   phi3.5-moe at full width, sequences of 4096, depth cut to 3 layers
   (``moe_train_gate``, ``moe_train``, ``moe_train_requests``);
11. vlm_train — the same for internvl2-1b at full width and depth
   (``--train vlm``), then ``vlm_ckpt``: its final parameters and AdamW
   state saved with the port's ``CheckpointManager`` to a temporary
   directory, restored into fresh card tensors and held to the trained
   ones byte for byte; its gate's traces write through to a persistent
   trace store, and ``admission_daemon``: the admission daemon on a
   local port answers the admitted batch as the wire's ``train``
   request, equal to the gate's decision from memory, then, restarted
   over the same store, from disk with no trace; the wire's other kinds;
   the run's measured peaks ingested as telemetry against the
   decision;
12. audio_train — the same for musicgen-medium at full width, depth cut
   to 24 layers (``--train audio``). The training paths launch neither
   attention kernel: they train through the chunked attention, as the
   JAX package does;
13. ssm_train — the same for xlstm-1.3b at full width, depth cut to
   whole periods (``--train ssm``), with no DirectProbe (the reference
   probes the transformer families only);
14. hybrid_train_gate — the training gate alone for the jamba cut
   (``--train hybrid``, batch 1): traced on the CPU, replayed at the
   card's capacity, where it must reject; the estimate without a
   capacity beside it. Nothing is allocated.
15. baselines — the paper's comparison: SchedTune fitted on the dense
   and moe families' measured peaks (each job's truth and its probes),
   then xMem and the four baselines against every job's measured
   reserved peak: MRE, PEF, MCP and mean runtime per estimator, each
   model's quadrant, xMem's improvement over the best baseline.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result when no
CUDA device is present.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# dense peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

N_LAYERS = 8
MAX_LEN = 2064
PROMPT_LEN = 2048
DECODE_TOKENS = 16
REQUESTS = 2
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
VLM_ARCH = "internvl2-1b"
AUDIO_ARCH = "musicgen-medium"
SSM_ARCH = "xlstm-1.3b"
HYBRID_ARCH = "jamba-1.5-large-398b"
# jamba's period of 8 layers (4 with 16 experts) is 90.48 GB of bf16,
# over the card's 85 GB: the card serves a period of attn_every=2, one
# attention layer (dense MLP) and one Mamba layer (MoE), at full width
HYBRID_PERIOD = 2
# xlstm-1.3b serving depth, in whole periods of 8: one prefill estimate
# at 48 layers took 58.0 and 81.6 s of the chip machine's CPU at seq 2048
# in two runs (PERF.md section 4), over the 60 s allowed in the second;
# 24 rather than 32 layers keeps the whole run well inside its limit
SSM_SERVING_LAYERS = 24
# serving paths: arch -> (B, H, Hkv, S, d) of its prefill attention, and
# the kernels held against the plain version at that shape
SERVING_SHAPES = {"qwen3-32b": ((8, 64, 8, PROMPT_LEN, 128), ("sm90", "simt")),
                  MOE_ARCH: ((8, 32, 8, PROMPT_LEN, 128), ("sm90",))}
# the 1B serving paths at full depth: arch -> (phase prefix, max_len,
# prompt positions). internvl2's prompt is its 256 patches and 2048
# tokens; its cache holds them and the decoded tokens. Their kernel rows
# are taken at the batch their gate admits, from these candidates
FULL_DEPTH_SERVING = {VLM_ARCH: ("vlm_", 2320, 2304),
                      AUDIO_ARCH: ("audio_", MAX_LEN, PROMPT_LEN)}
# the recurrent families' serving paths: arch -> (phase prefix, depth)
RECURRENT_SERVING = {HYBRID_ARCH: ("hybrid_", HYBRID_PERIOD),
                     SSM_ARCH: ("ssm_", SSM_SERVING_LAYERS)}
WIDE_CANDIDATES = (256, 128, 64, 32, 16, 8, 4, 2, 1)
GEMMA_SHAPE = (2, 8, 4, 4096, 256)            # gemma3-4b, head dim 256
GEMMA_WINDOW = 1024                           # its local layers' window
KIMI_SHAPE = (8, 64, 8, PROMPT_LEN, 112)      # kimi-k2, head dim 112
# kernel -> (source, timed launches at the serving shape)
KERNELS = {"sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu", 20),
           "simt": ("src/repro_torch/csrc/flash_attention.cu", 3)}
# the plain version runs over at most this many sequences at once (its
# f32 scores at the 1B paths' admitted batches would not fit the card)
PLAIN_BATCH = 8
# training jobs: name -> (arch, depth, candidates), each list chosen with
# the CPU gate CLI so that its first candidate is rejected (phi3.5-moe's
# admits its first) and the second admitted. phi3.5-moe at 4 layers fits
# only with 0.27 GB to spare, and its gate rejects every batch 0.5 GB
# lower. One musicgen estimate at 48 layers takes about 180 s of CPU
# (PERF.md section 4), over the 60 s allowed, so it trains 24. xLSTM's
# least depth, one period of 8, already takes about 250 s (its sLSTM's
# 4096 steps, three times forward and once backward under the trace);
# its gate starts at 16, which it admitted after rejecting 32 (PERF.md)
TRAIN_JOBS = {"dense": ("qwen3-32b", 4, (8, 4, 2, 1)),
              "dense_sgd": ("qwen3-32b", 4, (8, 4, 2, 1)),
              "moe": (MOE_ARCH, 3, (8, 4, 2, 1)),
              "vlm": (VLM_ARCH, 24, (16, 8, 4, 2, 1)),
              "audio": (AUDIO_ARCH, 24, (64, 32, 16, 8, 4, 2, 1)),
              "ssm": (SSM_ARCH, 8, (16, 8, 4, 2, 1)),
              "hybrid": (HYBRID_ARCH, HYBRID_PERIOD, (1,))}
# each job's optimizer (default AdamW): dense_sgd is the paper's
# optimizer axis, on which DNNMem's estimate cannot move
OPTIMIZERS = {"dense_sgd": "sgd"}
# optimizer states a parameter has, SchedTune's feature (the table of
# the reference's benchmark, benchmarks/common.py:build_job)
OPTIMIZER_STATES = {"sgd": 0, "adamw": 2}
# the families DirectProbe probes: the transformer families, as in the
# reference's benchmark (LLMem supports no other)
PROBED_FAMILIES = ("dense", "moe", "vlm", "audio")
# SchedTune's history: the measured peaks of these families' jobs; the
# other families are its cold start (benchmarks/common.py:fit_schedtune)
SCHEDTUNE_FAMILIES = ("dense", "moe")
# jobs whose gate must reject every candidate: they allocate nothing
GATE_ONLY = ("hybrid",)
# jobs whose measured window records no allocator history: xLSTM's sLSTM
# step loop makes about 1.4 million requests in 3 steps at 8 layers, and
# recording each one's stack takes longer than the run may
UNRECORDED = ("ssm",)
TRAIN_SEQ = 4096            # TRAIN_4K's sequence length
TRAIN_STEPS = 3             # the estimator composes 3 iterations
TRACED_AHEAD = 2            # candidates a training job traces before its turn
# the dense job's batch sweep, and the batches it traces before its turn
# beside the gate's 8 and 4: the sweep's probes 1 and 5 (min and median
# of the grid; 8 is its max), and 2, the probe that repairs batch 1,
# whose trace differs from the others' (size-1 dims make some copies
# no-ops: tests/test_torch_sweep.py)
DENSE_SWEEP = tuple(range(1, 9))
DENSE_SWEEP_AHEAD = (1, 5, 2)
# the serving knob grid at the admitted batch b: page sizes, concurrency
# as multiples of b, KV bytes per element
SERVING_PAGES = (16, 64, 256)
SERVING_CONCURRENCY = (0.5, 1, 2)
SERVING_KV_BYTES = (1, 2)
CKPT_JOB = "vlm"            # the job whose final state goes through a checkpoint
# the job whose traces write through to a persistent trace store and
# whose admitted batch the admission daemon answers over a socket, then
# again from disk after a restart
DAEMON_JOB = "vlm"
# the dense job's batches decided on the degradation ladder's lower rungs
# and held to the card: the run's truth at the gate's batch (4),
# DirectProbe's probe peaks (1, 2), the sweep's rejection the card ran
# out of memory at (5), and the gate's rejection (8)
DEGRADED_BATCHES = (1, 2, 4, 5, 8)
HANG_DEADLINE_S = 2.0       # the exact rung's budget in the hang pass
# |flash - dense| / max|dense| on the batch-1 prefill logits, bf16 model:
# both paths do f32 attention math from the same bf16 q/k/v and round
# the output to bf16, so they differ by output roundings carried
# through 8 layers
LOGITS_REL_TOL = 5e-2
# the estimate against the card: |estimate - max_memory_reserved| and
# |peak_tensor_bytes - max_memory_allocated| over the measured value (the
# paper's 5 % band; a training job's live tensors are held tighter)
RESERVED_TOL = 0.05
ALLOCATED_TOL = 0.01
SERVING_ALLOCATED_TOL = 0.05
# requests ``align_requests`` aligns in order; longer differing stretches
# are compared as multisets of sizes
ALIGN_LIMIT = 20_000
# the recurrent blocks' chunked forms against their one-step decode in
# f32 on the card: |chunked - stepped| / max|stepped|
RECURRENT_REL_TOL = 1e-3


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t`` is the seconds since this process started."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - _T0, **kw}),
          flush=True)


def within(what: str, rel: float, tol: float) -> None:
    if not abs(rel) <= tol:
        raise AssertionError(f"{what}: estimate off by {rel:+.4%}, "
                             f"beyond {tol:.0%}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_memory() -> dict:
    """The card's memory now: what ``cudaMemGetInfo`` reports free, what
    the caching allocator holds (reserved) and lends out (allocated),
    and what neither accounts for (the CUDA context, libraries' own
    buffers)."""
    import torch
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    return {"free": free, "reserved": reserved,
            "allocated": torch.cuda.memory_allocated(),
            "outside_allocator": total - free - reserved}


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bhd: int, s: int, window, tensors) -> dict:
    """The least time of causal attention over ``s`` positions for
    ``bhd`` = B * H * d: its operations (two products over the pairs the
    mask lets through) at the bf16 tensor-core rate, or its bytes (each
    tensor once) at the memory rate, whichever is larger."""
    flops = 4.0 * bhd * attended_pairs(s, s, True, window)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attended_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, per head."""
    import numpy as np
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), dtype=bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= (q - k) < window
    return int(ok.sum())


def path_config(arch: str, n_layers: int | None = None,
                impl: str | None = None):
    """``arch``'s full-width config at ``n_layers`` (``None``: its own
    depth), jamba's period cut to ``HYBRID_PERIOD`` layers; ``impl``
    sets the attention implementation."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    att = cfg.attention
    if arch == HYBRID_ARCH:
        att = dataclasses.replace(att, attn_every=HYBRID_PERIOD)
    if impl is not None:
        att = dataclasses.replace(att, impl=impl)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               attention=att)


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that attend: each launches the kernel once
    per prefill."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attention.attn_every
    return cfg.n_layers


# ---------------------------------------------------------------------------
def phase_device() -> dict:
    import torch
    smi = nvidia_smi()
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(0)
    # the process's first matmul allocates cuBLAS's workspace through
    # the caching allocator and holds it for good; the CPU tracer cannot
    # see it. Made here, it sits in a segment of its own rather than in
    # one the main path has cached. A first bf16 matmul shows whether a
    # second workspace follows.
    workspace = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones(64, 64, device="cuda", dtype=dtype)
        before = torch.cuda.memory_allocated()
        b = a @ a
        torch.cuda.synchronize()
        workspace[str(dtype)] = torch.cuda.memory_allocated() - before \
            - b.untyped_storage().nbytes()
        del a, b
    info = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "first_matmul_extra_bytes": workspace,
            "count": torch.cuda.device_count(),
            "total_memory": int(props.total_memory),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "memory": device_memory()}
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build_all()
    ptxas = {name: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "C75" in ln]
             for name, v in info.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: v["seconds"] for n, v in info.items()}, ptxas=ptxas)


def phase_kernels() -> list[dict]:
    """Each kernel against the plain version on the card; returns the
    summary rows, one a kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models.layers import dense_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 2e-2}
    cases = []
    for dtype in (f32, bf16):
        for B, H, Hkv, S, d in [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64),
                                (1, 8, 2, 128, 128), (2, 2, 1, 192, 32),
                                (2, 4, 2, 64, 16), (1, 4, 2, 256, 256)]:
            cases.append((f"b{B}h{H}kv{Hkv}s{S}d{d}", B, H, Hkv, S, d,
                          dtype, True, None))
        for w in (32, 64, 100):
            cases.append((f"window{w}", 1, 4, 2, 256, 64, dtype, True, w))
        cases.append(("non_causal", 1, 2, 2, 128, 64, dtype, False, None))

    results = []
    for name, B, H, Hkv, S, d, dtype, causal, window in cases:
        q = rand(B, H, S, d, dtype=dtype)
        k = rand(B, Hkv, S, d, dtype=dtype)
        v = rand(B, Hkv, S, d, dtype=dtype)
        out = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        results.append({"case": name, "dtype": str(dtype),
                        "kernel": fa.route(dtype, d), "err": err,
                        "tol": tol[dtype]})
        if not err < tol[dtype]:
            raise AssertionError(f"kernel case {name} {dtype}: max error "
                                 f"{err} >= {tol[dtype]}")
    # the ragged S=100 case through the model-layout wrapper
    for dtype in (f32, bf16):
        q, k, v = (rand(2, 100, 4, 64, dtype=dtype),
                   rand(2, 100, 2, 64, dtype=dtype),
                   rand(2, 100, 2, 64, dtype=dtype))
        out = ops.flash_attention(q, k, v, causal=True)
        err = (out.float() - dense_attention(q.float(), k.float(), v.float(),
                                             causal=True)).abs().max().item()
        results.append({"case": "ragged_s100_wrapper", "dtype": str(dtype),
                        "kernel": fa.route(dtype, 64), "err": err,
                        "tol": tol[dtype]})
        if not err < tol[dtype]:
            raise AssertionError(f"ragged wrapper case {dtype}: max error "
                                 f"{err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # gemma3-4b's attention shape (head dim 256), global and local layers
    gemma = []
    for window in (None, GEMMA_WINDOW):
        B, H, Hkv, S, d = GEMMA_SHAPE
        q = rand(B, S, H, d, dtype=bf16)
        k = rand(B, S, Hkv, d, dtype=bf16)
        v = rand(B, S, Hkv, d, dtype=bf16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(qt, kt, vt, causal=True, window=window)
        err = (out.transpose(1, 2).float() - ref.float()).abs().max().item()
        del ref
        name = f"gemma3_b{B}h{H}kv{Hkv}s{S}d{d}_window{window}"
        results.append({"case": name, "dtype": str(bf16),
                        "kernel": fa.route(bf16, d), "err": err,
                        "tol": tol[bf16]})
        if not err < tol[bf16]:
            raise AssertionError(f"{name}: max error {err}")
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 window=window), reps=20)
        row = {"window": window, "shape": [B, H, Hkv, S, d], "ms": ms,
               "max_abs_err": err,
               **bound(B * H * d, S, window, (q, k, v, out))}
        if window is None:
            torch.cuda.empty_cache()
            row["library_ms"] = cuda_ms(lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
        gemma.append(row)
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()

    # each serving path's shape, in the model layout the path passes: its
    # kernels against the plain version, their times, the library call's
    rows, shapes = [], {}
    # kimi-k2 has no path on one card (a layer's experts are 33.8 GB):
    # its row is the shape alone, and no main path counts its launches
    for path, (shape, kernels) in (*SERVING_SHAPES.items(),
                                   ("kimi-k2-1t-a32b",
                                    (KIMI_SHAPE, ("sm90",)))):
        got, cases, lim = serving_shape_rows(path, shape, kernels, rand,
                                             sdpa)
        rows += got
        results += cases
        shapes[path] = shape_summary(shape, got, lim)
    emit("kernels", cases=results, shapes=shapes, rows=rows, gemma3=gemma,
         memory=device_memory())
    return rows


def shape_summary(shape, rows, lim) -> dict:
    return {"shape": list(shape), "flops": lim["flops"],
            "bytes": lim["bytes"],
            "tflops": {r["name"]: lim["flops"] / r["ms"] / 1e9
                       for r in rows}}


def serving_shape_rows(path: str, shape, kernels, rand, sdpa):
    """``kernels`` at a serving path's prefill shape (bf16, causal)
    against the plain version: the summary rows, the cases and the
    bound. A head dim no kernel takes goes through the model-layout
    wrapper, which pads it (its row is the kernel ``route`` picks for
    the padded head dim, timed with the padding); the bound counts the
    work at the true head dim. The plain version runs over
    ``PLAIN_BATCH`` sequences at a time."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    bf16, tol = torch.bfloat16, 2e-2
    B, H, Hkv, S, d = shape
    q = rand(B, S, H, d, dtype=bf16)
    k = rand(B, S, Hkv, d, dtype=bf16)
    v = rand(B, S, Hkv, d, dtype=bf16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    padded = fa.padded_head_dim(bf16, d) != d

    def run(kernel):
        if padded:
            if kernel != fa.route(bf16, fa.padded_head_dim(bf16, d)):
                raise AssertionError(f"{kernel} is not the padded route")
            return ops.flash_attention(q, k, v, causal=True).transpose(1, 2)
        return fa.launch(kernel, qt, kt, vt, causal=True)

    def plain():
        outs = [attention_ref(qt[i:i + PLAIN_BATCH], kt[i:i + PLAIN_BATCH],
                              vt[i:i + PLAIN_BATCH], causal=True)
                for i in range(0, B, PLAIN_BATCH)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)
    ref = plain()
    plain_ms = cuda_ms(plain, reps=2)
    errs, cases = {}, []
    for kernel in kernels:
        out = run(kernel)
        torch.cuda.synchronize()
        errs[kernel] = (out.float() - ref.float()).abs().max().item()
        del out
        cases.append({"case": f"serving_b{B}h{H}kv{Hkv}s{S}d{d}",
                      "dtype": str(bf16), "kernel": kernel,
                      "err": errs[kernel], "tol": tol})
        if not errs[kernel] < tol:
            raise AssertionError(f"{path} serving-shape case, {kernel}: max "
                                 f"error {errs[kernel]}")
    del ref
    torch.cuda.empty_cache()
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), reps=10)
    lim = bound(B * H * d, S, None, (q, k, v, q))   # q: the out
    rows = []
    for kernel in kernels:
        source, reps = KERNELS[kernel]
        ms = cuda_ms(lambda: run(kernel), reps=reps)
        rows.append({"name": f"flash_attention_{kernel}", "route": "cuda",
                     "source": source,
                     "replaces": "src/repro/kernels/flash_attention.py:93",
                     "path": path, "shape": list(shape),
                     "launches": None, "max_abs_err": errs[kernel],
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": lim["bound_ms"], "bound_by": lim["bound_by"],
                     "library_ms": library_ms})
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows, cases, lim


def phase_serving(rows: list[dict], arch: str, prefix: str = "", *,
                  n_layers: int | None = N_LAYERS, max_len: int = MAX_LEN,
                  prompt_len: int = PROMPT_LEN, candidates=(8, 4, 2, 1),
                  kernel_rows: bool = False,
                  serving_sweep: bool = False) -> None:
    """The serving main path of ``arch`` at full width, ``n_layers``
    deep (``None``: the config's depth), prompts of ``prompt_len``
    positions into a cache of ``max_len``, the gate over
    ``candidates``; its phases' names start with ``prefix``. With
    ``kernel_rows`` the path's kernel is first held against the plain
    version at the admitted batch's prefill shape (``kernel`` phase),
    and its rows join ``rows``; with ``serving_sweep`` the served
    decode is set beside the request-driven estimate's knob grid
    (``phase_serving_sweep``)."""
    import torch
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    cfg = path_config(arch, n_layers, impl="flash")
    capacity = srv.device_capacity()
    t0 = time.perf_counter()
    # decided through the admission service (its exact rung: the
    # estimator's replay at the capacity)
    batch, gate = srv.pick_batch(cfg, max_len, capacity,
                                 candidates=candidates)
    gate_s = time.perf_counter() - t0
    if batch is None:
        raise AssertionError(f"no batch fits: {gate['candidates']}")
    # the estimates at the shapes the run below uses (the gate traces
    # the prefill at a max_len prompt), replayed at the card's capacity
    # as the gate's are: near the ceiling the simulated allocator, as
    # the card's, frees its cached blocks and retries; ``phase_requests``
    # takes the prefill's trace from this estimator's cache
    est = XMemEstimator.for_torch_gpu()
    prefill_fn = srv.make_prefill_fn(cfg)
    cache_abs = M.init_cache(cfg, batch, max_len, device="meta")
    t0 = time.perf_counter()
    pre_est = est.estimate_serving(
        prefill_fn, M.abstract_params(cfg), cache_abs,
        srv.prompt_specs(cfg, batch, prompt_len), capacity=capacity)
    pre_est_s = time.perf_counter() - t0
    dec_est = gate["decode"].report
    emit(f"{prefix}gate", config=cfg.name, n_layers=cfg.n_layers,
         capacity=capacity, seconds=gate_s, prefill_estimate_seconds=pre_est_s,
         batch=batch,
         candidates=gate["candidates"],
         prefill_estimate=pre_est.peak_bytes,
         prefill_tensor_estimate=pre_est.peak_tensor_bytes,
         decode_estimate=dec_est.peak_bytes,
         decode_tensor_estimate=dec_est.peak_tensor_bytes,
         persistent=pre_est.breakdown["persistent_by_kind"])
    if kernel_rows:
        gen = torch.Generator(device="cuda").manual_seed(1)

        def rand(*shape, dtype):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        shape = (batch, cfg.n_heads, cfg.n_kv_heads, prompt_len, cfg.hd)
        got, cases, lim = serving_shape_rows(
            arch, shape, (fa.route(cfg.dtype, cfg.hd),), rand,
            torch.nn.functional.scaled_dot_product_attention)
        rows += got
        emit(f"{prefix}kernel", cases=cases,
             shape=shape_summary(shape, got, lim), rows=got,
             memory=device_memory())

    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    fa.reset_launches()
    res = srv.serve(cfg, batch, max_len, prompt_len, DECODE_TOKENS, "cuda",
                    requests=REQUESTS, params=params)
    launches = fa.launches
    by_kernel = dict(fa.launches_by_kernel)
    for row in rows:
        if row["path"] == arch:
            row["launches"] = by_kernel[row["name"].rsplit("_", 1)[1]]
    want = attention_layers(cfg) * REQUESTS
    if launches != want or by_kernel["sm90"] != want:
        raise AssertionError(f"kernel launched {by_kernel}, expected "
                             f"{want} (attention layers per prefill), all "
                             f"sm90")
    # audio: one logit row and one greedy code per codebook
    per_step = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    for lg in res.prefill_logits:
        if tuple(lg.shape) != (batch, 1, *per_step, cfg.padded_vocab):
            raise AssertionError(f"prefill logits shape {tuple(lg.shape)}")
        if not torch.isfinite(lg).all().item():
            raise AssertionError("non-finite prefill logits")
    toks = res.tokens
    if toks.shape != (REQUESTS, batch, DECODE_TOKENS, *per_step) \
            or toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"bad decoded tokens {toks.shape}")

    def mib(sizes):
        return sorted(round(x / 2**20, 1) for x in sizes)

    def vs(measured, estimate):
        # segments held after the step: the card's snapshot against the
        # simulated allocator's final segment map
        return {"measured_reserved": measured.reserved,
                "measured_allocated": measured.allocated,
                "segments_mib": mib(measured.segment_sizes),
                "sim_segments_mib": mib(s["size"]
                                        for s in estimate.sim.segments),
                # allocator requests: the card's count over the measured
                # run (prefill: one step; decode: the whole loop) and the
                # trace's for one step
                "card_allocs": measured.n_allocs,
                "trace_allocs": estimate.breakdown["step_allocs"],
                "card_segments_created": measured.n_segments_created,
                "estimate": estimate.peak_bytes,
                "tensor_estimate": estimate.peak_tensor_bytes,
                "rel_err_reserved": (estimate.peak_bytes - measured.reserved)
                / measured.reserved,
                "rel_err_allocated": (estimate.peak_tensor_bytes
                                      - measured.allocated)
                / measured.allocated}

    phases = {"prefill": vs(res.peaks["prefill"], pre_est),
              "decode": vs(res.peaks["decode"], dec_est)}
    emit(f"{prefix}main", batch=batch, n_layers=cfg.n_layers,
         prompt_len=prompt_len, max_len=max_len,
         tokens=DECODE_TOKENS, requests=REQUESTS, kernel_launches=launches,
         launches_by_kernel=by_kernel,
         prefill_ms=[s * 1e3 for s in res.prefill_s],
         decode_s=res.decode_s,
         decode_tok_per_s=[res.decode_tok_per_s(r)
                           for r in range(REQUESTS)],
         **phases, finite_logits=True, first_tokens=toks[-1][:2, :8].tolist(),
         memory=device_memory())
    for name, got in phases.items():
        within(f"{cfg.name} {name} reserved", got["rel_err_reserved"],
               RESERVED_TOL)
        within(f"{cfg.name} {name} allocated", got["rel_err_allocated"],
               SERVING_ALLOCATED_TOL)
    if serving_sweep:
        at = phase_serving_sweep(cfg, batch, max_len, prompt_len, capacity,
                                 res.peaks["decode"])
        phase_serve_mix(cfg, batch, max_len, prompt_len, capacity, at)
    del res
    torch.cuda.empty_cache()
    phase_requests(cfg, params, batch, prefix, max_len, prompt_len, est,
                   prefill_fn)
    phase_profile(cfg, params, batch, prefix, prompt_len)
    if cfg.moe is not None:
        phase_experts(cfg, params, batch, prefix)
    if cfg.family in ("ssm", "hybrid"):
        phase_recurrent_parity(cfg, prefix)
    if not attention_layers(cfg):
        return

    # the kernel path against the dense path at batch 1, same weights
    # (the same argmax per codebook for audio)
    dense = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="dense"))
    prompt = srv.device_prompts(cfg, 1, prompt_len, seed=100)
    lf = make_prefill_step(cfg)(params, prompt).float()
    ld = make_prefill_step(dense)(params, prompt).float()
    rel = ((lf - ld).abs().max() / ld.abs().max()).item()
    top_f, top_d = lf.argmax(-1, keepdim=True), ld.argmax(-1, keepdim=True)
    same = bool((top_f == top_d).all().item())
    # where the argmax differs: the dense path's lead of its own top
    # token over the flash path's (a flip needs a lead within twice the
    # largest logit difference)
    flips = (ld.gather(-1, top_d) - ld.gather(-1, top_f))[top_f != top_d]
    emit(f"{prefix}parity", flash_vs_dense_rel=rel, tol=LOGITS_REL_TOL,
         same_argmax=same, max_abs_diff=(lf - ld).abs().max().item(),
         flip_leads=flips.tolist(),
         finite=bool(torch.isfinite(lf).all().item()),
         memory=device_memory())
    if not rel < LOGITS_REL_TOL:
        raise AssertionError(f"flash vs dense logits: rel {rel}")


def phase_serving_sweep(cfg, batch: int, max_len: int, prompt_len: int,
                        capacity: int, decode) -> None:
    """The request-driven serving estimate of ``cfg`` at full width over
    a knob grid (page size x concurrency x KV bytes), from one decode
    trace (``SweepService.estimate_serving_sweep``): ``batch`` requests
    of ``prompt_len`` prompt and ``DECODE_TOKENS`` decoded positions,
    one arriving each tick. At ``max_concurrent = batch`` and 2-byte KV
    the monolithic composition (parameters + the decode step's
    transient + the whole cache) stands beside ``decode``, the card's
    measured decode peak at ``batch``, and the step's transient beside
    the card's (its live peak above the parameters and the cache): a
    comparison, not a gate. Fails if the grid cost more than 2 traces.
    Returns the estimate at page size 16, ``max_concurrent = batch`` and
    2-byte KV."""
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.core.orchestrator import ServingKnobs
    from repro_torch.core.sweep import SweepService
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M

    kv_tok, resident = srv.serving_cache_profile(cfg, max_len)
    stream = srv.parse_mix(f"{prompt_len}:{DECODE_TOKENS}:{batch}").stream()
    grid = [ServingKnobs(page_size=p, max_concurrent=max(int(batch * c), 1),
                         kv_dtype_bytes=d)
            for p in SERVING_PAGES for c in SERVING_CONCURRENCY
            for d in SERVING_KV_BYTES]
    cache = M.init_cache(cfg, batch, max_len, device="meta")
    res = SweepService(XMemEstimator.for_torch_gpu()).estimate_serving_sweep(
        srv.make_decode_fn(cfg), M.abstract_params(cfg), cache,
        srv.decode_input(cfg, batch), stream=stream, knob_grid=grid,
        kv_bytes_per_token=kv_tok, resident_bytes_per_request=resident,
        capacity=capacity)
    knobs = [{"page_size": k.page_size, "max_concurrent": k.max_concurrent,
              "kv_dtype_bytes": k.kv_dtype_bytes,
              "worst": e.worst_case_peak_bytes,
              "steady": e.steady_state_peak_bytes,
              "paged_peak": e.paged_kv_peak_bytes,
              "paged_steady": e.paged_kv_steady_bytes,
              "monolithic": e.monolithic_cache_bytes,
              "step_transient": e.step_transient_bytes,
              "ticks": e.breakdown["ticks"],
              "evictions": e.breakdown["evictions"],
              "fits": e.fits(capacity)} for k, e in res]
    at = next(e for k, e in res
              if k.max_concurrent == batch and k.kv_dtype_bytes == 2)
    composed = (at.persistent_bytes + at.step_transient_bytes
                + at.monolithic_cache_bytes)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    card_transient = decode.allocated - at.persistent_bytes - cache_bytes
    emit("serving_sweep", config=cfg.name, n_layers=cfg.n_layers,
         batch=batch, requests=len(stream), prompt_len=prompt_len,
         decode_tokens=DECODE_TOKENS, kv_bytes_per_token=kv_tok,
         resident_bytes_per_request=resident, capacity=capacity,
         knobs=knobs, trace_cache=res.stats["trace_cache"],
         wall_s=res.stats["wall_s"],
         card={"max_concurrent": batch, "kv_dtype_bytes": 2,
               "persistent": at.persistent_bytes,
               "step_transient": at.step_transient_bytes,
               "monolithic_cache": at.monolithic_cache_bytes,
               "cache_bytes": cache_bytes, "composed": composed,
               "measured_decode_allocated": decode.allocated,
               "rel_err": (composed - decode.allocated) / decode.allocated,
               "card_decode_transient": card_transient,
               "step_transient_bounds_card": (at.step_transient_bytes
                                              >= card_transient)})
    if len(grid) < 12 or res.stats["trace_cache"]["misses"] > 2:
        raise AssertionError(f"serving sweep: {len(grid)} knobs cost "
                             f"{res.stats['trace_cache']} traces")
    return next(e for k, e in res if k.page_size == 16
                and k.max_concurrent == batch and k.kv_dtype_bytes == 2)


def phase_serve_mix(cfg, batch: int, max_len: int, prompt_len: int,
                    capacity: int, swept) -> None:
    """The request-driven serving gate (``pick_serving``, through the
    admission service) for ``batch`` requests of ``prompt_len`` prompt
    and ``DECODE_TOKENS`` decoded positions at page size 16,
    ``max_concurrent = batch`` and 2-byte KV, held to ``swept``, the
    serving sweep's estimate at the same knobs, to the byte. Fails if
    they differ, if the gate rejects, or if it cost more than one
    trace. Beside it, the reference's way: the decode step traced at
    batch 1 and its transient scaled to the concurrency (a comparison,
    not a gate)."""
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.core.orchestrator import ServingKnobs
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M

    knobs = ServingKnobs(page_size=16, max_concurrent=batch,
                         kv_dtype_bytes=2)
    mix = srv.parse_mix(f"{prompt_len}:{DECODE_TOKENS}:{batch}")
    decision, gate = srv.pick_serving(cfg, mix, capacity, knobs=knobs,
                                      max_len=max_len)
    want = swept.to_json()
    equal = gate["serving"] == want
    misses = decision.provenance["trace_cache"]["misses"]
    one = XMemEstimator.for_torch_gpu().estimate_request_stream(
        srv.make_decode_fn(cfg), M.abstract_params(cfg),
        M.init_cache(cfg, 1, max_len, device="meta"),
        srv.decode_input(cfg, 1), stream=mix.stream(), knobs=knobs,
        kv_bytes_per_token=gate["kv_bytes_per_token"],
        resident_bytes_per_request=gate["resident_bytes_per_request"],
        capacity=capacity)
    emit("serve_mix", config=cfg.name, n_layers=cfg.n_layers, batch=batch,
         capacity=capacity, admit=decision.admit, rung=decision.rung,
         source=decision.provenance["source"], wall_s=decision.wall_s,
         trace_cache=decision.provenance["trace_cache"],
         serving=gate["serving"], equal_to_serving_sweep=equal,
         batch1_trace={"worst": one.worst_case_peak_bytes,
                       "step_transient": one.step_transient_bytes,
                       "under_by": want["worst_case_peak_bytes"]
                       - one.worst_case_peak_bytes},
         kv_bytes_per_token=gate["kv_bytes_per_token"],
         resident_bytes_per_request=gate["resident_bytes_per_request"])
    if not equal or not decision.admit or misses > 1:
        raise AssertionError(f"serve_mix: equal {equal}, admit "
                             f"{decision.admit}, misses {misses}: "
                             f"{gate['serving']} vs {want}")


def phase_recurrent_parity(cfg, prefix: str) -> None:
    """The recurrent blocks of ``cfg`` at full width, f32 weights from a
    seed, on the card: each block's chunked form over a sequence of one
    chunk and a part (the mLSTM pads it) against its one-step decode
    recurrence run over the same sequence from the initial state.
    xLSTM: one mLSTM and one sLSTM block; jamba: one Mamba block."""
    import torch
    from repro_torch.models import mamba as mam
    from repro_torch.models import xlstm as xl

    f32, D, H = torch.float32, cfg.d_model, cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(2)
    B = 2
    chunk = cfg.xlstm.chunk if cfg.family == "ssm" else cfg.mamba.chunk
    S = chunk + 44
    x = torch.randn((B, S, D), generator=gen, device="cuda")

    def stepped(step, state):
        outs = []
        for t in range(S):
            out, state = step(x[:, t:t + 1], state)
            outs.append(out)
        return torch.cat(outs, dim=1)

    blocks = {}
    with torch.no_grad():
        if cfg.family == "ssm":
            mp = xl.mlstm_params(gen, D, H, cfg.xlstm, f32, device="cuda")
            sp = xl.slstm_params(gen, D, H, f32, device="cuda")
            blocks["mlstm"] = (
                xl.mlstm_block(x, mp, H, cfg.xlstm),
                stepped(lambda xt, st: xl.mlstm_decode_step(xt, st, mp, H),
                        xl.mlstm_init_state(B, D, H, cfg.xlstm,
                                     device="cuda")))
            blocks["slstm"] = (
                xl.slstm_block(x, sp, H, chunk=chunk)[0],
                stepped(lambda xt, st: xl.slstm_block(xt, sp, H, chunk=1,
                                                      state=st),
                        xl.slstm_init_state(B, D, device="cuda")))
        else:
            mp = mam.mamba_params(gen, D, cfg.mamba, f32, device="cuda")
            blocks["mamba"] = (
                mam.mamba_block(x, mp, cfg.mamba)[0],
                stepped(lambda xt, st: mam.mamba_decode_step(xt, st, mp,
                                                             cfg.mamba),
                        mam.mamba_init_state(B, D, cfg.mamba, device="cuda")))
    rel = {name: ((a - b).abs().max() / b.abs().max()).item()
           for name, (a, b) in blocks.items()}
    finite = all(bool(torch.isfinite(a).all().item())
                 for a, _ in blocks.values())
    emit(f"{prefix}recurrent_parity", batch=B, seq_len=S, chunk=chunk,
         rel_err=rel, tol=RECURRENT_REL_TOL, finite=finite,
         memory=device_memory())
    del blocks, x
    torch.cuda.empty_cache()
    if not finite or not all(r < RECURRENT_REL_TOL for r in rel.values()):
        raise AssertionError(f"chunked vs stepped recurrence: {rel}")


def phase_requests(cfg, params, batch: int, prefix: str, max_len: int,
                   prompt_len: int, est, prefill_fn) -> None:
    """The card's allocator requests during one prefill against the
    trace's, aligned by size: what the CPU trace misses or adds. The
    trace is the one ``est`` made of ``prefill_fn`` at these shapes."""
    from repro_torch.core.baselines.directprobe import measured_peak
    from repro_torch.core.events import BlockKind, Phase
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    entry = est._trace_phase(
        prefill_fn,
        [(M.abstract_params(cfg), BlockKind.PARAM, "params"),
         (M.init_cache(cfg, batch, max_len, device="meta"), BlockKind.CACHE,
          "cache"),
         (srv.prompt_specs(cfg, batch, prompt_len), BlockKind.INPUT,
          "batch")], Phase.DECODE, tag="serve")
    traced = [(b.size, b.op)   # requested bytes, as the card reports
              for b in sorted(entry.lifecycles, key=lambda b: b.alloc_t)
              if b.op != "input"]
    prompt = srv.device_prompts(cfg, batch, prompt_len, seed=300)
    got = measured_peak(make_prefill_step(cfg), params, prompt, history=True)
    card_only, trace_only = align_requests(traced, got.allocs)
    emit(f"{prefix}requests", card=len(got.allocs), trace=len(traced),
         card_only=len(card_only), trace_only=len(trace_only),
         card_only_bytes=sum(s for s, _ in card_only),
         trace_only_bytes=sum(s for s, _ in trace_only),
         card_only_first=card_only[:12], trace_only_first=trace_only[:12],
         memory=device_memory())


def align_requests(traced, card) -> tuple[list, list]:
    """Two request streams, ``(bytes, where)`` each, aligned by size:
    the card's requests the trace lacks, and the trace's the card does
    not make. The common head and tail match without a search; the
    rest is aligned by ``difflib`` (quadratic in the worst case, so a
    middle of more than ``ALIGN_LIMIT`` requests is compared as two
    multisets of sizes instead)."""
    import difflib
    n = min(len(traced), len(card))
    head = next((i for i in range(n) if traced[i][0] != card[i][0]), n)
    tail = next((i for i in range(n - head)
                 if traced[-1 - i][0] != card[-1 - i][0]), n - head)
    traced = traced[head:len(traced) - tail]
    card = card[head:len(card) - tail]
    if max(len(traced), len(card)) > ALIGN_LIMIT:
        return surplus(card, traced), surplus(traced, card)
    card_only, trace_only = [], []
    matcher = difflib.SequenceMatcher(None, [s for s, _ in traced],
                                      [s for s, _ in card], autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag != "equal":
            trace_only += traced[i1:i2]
            card_only += card[j1:j2]
    return card_only, trace_only


def surplus(a, b) -> list:
    """The requests of ``a`` beyond those of the same size in ``b``."""
    left = collections.Counter(size for size, _ in a)
    left.subtract(size for size, _ in b)
    out = []
    for r in a:
        if left[r[0]] > 0:
            left[r[0]] -= 1
            out.append(r)
    return out


def phase_experts(cfg, params, batch: int, prefix: str) -> None:
    """The tokens each expert took, and the assignments dropped over
    capacity, in each MoE layer of a prefill of the first request's
    prompt: counted from the dispatch's own token map (an unmeasured
    run; the count adds device work the measured runs do not have)."""
    import torch
    from repro_torch.launch import serve as srv
    from repro_torch.models import moe
    from repro_torch.train.train_step import make_prefill_step

    dispatch = moe._dispatch_one_group
    taken = []

    def counting(xg, topi, topv, n_experts, capacity):
        out = dispatch(xg, topi, topv, n_experts, capacity)
        taken.append((out[1] < xg.shape[0]).sum(dim=1))
        return out
    prompt = srv.device_prompts(cfg, batch, PROMPT_LEN, seed=0)
    moe._dispatch_one_group = counting
    try:
        make_prefill_step(cfg)(params, prompt)
    finally:
        moe._dispatch_one_group = dispatch
    per_layer = torch.stack(taken).cpu().tolist()
    assigned = batch * PROMPT_LEN * cfg.moe.top_k
    dropped = [assigned - sum(t) for t in per_layer]
    emit(f"{prefix}experts", batch=batch, tokens=batch * PROMPT_LEN,
         top_k=cfg.moe.top_k, capacity=moe.expert_capacity(
             batch * PROMPT_LEN, cfg.moe),
         taken_per_layer=per_layer, dropped_per_layer=dropped,
         dropped_share=sum(dropped) / (assigned * len(per_layer)))


def phase_moe_layer() -> None:
    """One phi3.5-moe MoE layer at full width: the card's allocator
    requests, each with the ATen function that made it, against the
    trace's, for the serving forward (the prefill's tokens) and for a
    training forward and backward (a training batch's tokens)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.baselines.directprobe import measured_peak
    from repro_torch.core.events import peak_live_bytes
    from repro_torch.core.tracer import trace_fn
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lp = moe.moe_params(gen, cfg.d_model, cfg.d_ff, cfg.moe.num_experts,
                        cfg.dtype, device="cuda")

    def serve(x, p):
        with torch.no_grad():
            return moe.moe_ffn(x, p, cfg.moe)

    def train(x, p):
        x = x.detach().requires_grad_()
        p = {n: t.detach().requires_grad_() for n, t in p.items()}
        y = moe.moe_ffn(x, p, cfg.moe)
        return torch.autograd.grad(y.float().square().mean(),
                                   [x, *p.values()])
    out = {}
    for name, fn, tokens in (("serve", serve, 8 * PROMPT_LEN),
                             ("train", train, 2 * TRAIN_SEQ)):
        x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                        device="cuda", dtype=cfg.dtype)
        _, tr, _ = trace_fn(fn, x, lp, grad=name == "train")
        traced = [(b.size, b.op) for b in sorted(tr.blocks.values(),
                                                 key=lambda b: b.alloc_t)
                  if b.op != "input"]
        got = measured_peak(fn, x, lp, history=True, stacks="all")
        card_only, trace_only = align_requests(traced, got.allocs)
        out[name] = {"tokens": tokens, "card": len(got.allocs),
                     "trace": len(traced), "card_only": card_only,
                     "trace_only": trace_only,
                     "measured_allocated": got.allocated,
                     "trace_peak": peak_live_bytes(tr.lifecycles())}
        del x, got
    # the dispatch's sort alone, at lengths around and beyond the path's:
    # the card's requests inside the op against the tracer's
    # (``tracer._sort_temps``)
    sorts = []
    for n in (4096, 4097, 65536, 100_003):
        keys = torch.randint(0, cfg.moe.num_experts, (n,), generator=gen,
                             device="cuda")
        for stable in (True, False):
            def sort(k, stable=stable):
                return torch.sort(k, stable=stable)
            _, tr, _ = trace_fn(sort, keys)
            traced = sorted(b.size for b in tr.blocks.values()
                            if b.op != "input")
            card = sorted(size for size, _ in measured_peak(
                sort, keys, history=True).allocs)
            sorts.append({"n": n, "stable": stable, "card": card,
                          "trace": traced, "match": card == traced})
    emit("moe_layer", config=cfg.name, **out, sort=sorts,
         memory=device_memory())
    if not all(s["match"] for s in sorts):
        raise AssertionError("the tracer's sort buffers differ from the "
                             "card's (tracer._sort_temps)")
    del lp
    torch.cuda.empty_cache()


def phase_attention_layer() -> None:
    """The chunked attention's training forward and backward at a
    training sequence (``TRAIN_SEQ``; one sequence of 4 heads, head dim
    64): the card's allocator requests, with the ATen function that made
    each, against the trace's. The trace runs the step under a Python
    dispatch mode, and with one active the autograd engine sums
    gradients out of place where it would sum them in place."""
    import torch
    from repro_torch.core.baselines.directprobe import measured_peak
    from repro_torch.core.tracer import trace_fn
    from repro_torch.models.layers import chunked_attention

    def step(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = chunked_attention(q, k, v)
        return torch.autograd.grad(o.float().square().mean(), [q, k, v])
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, TRAIN_SEQ, 4, 64), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    _, tr, _ = trace_fn(step, q, k, v, grad=True)
    traced = [(b.size, b.op) for b in sorted(tr.blocks.values(),
                                             key=lambda b: b.alloc_t)
              if b.op != "input"]
    got = measured_peak(step, q, k, v, history=True, stacks="all")
    card_only, trace_only = align_requests(traced, got.allocs)
    emit("attn_layer", seq_len=TRAIN_SEQ, heads=4, head_dim=64,
         card=len(got.allocs), trace=len(traced),
         trace_only_by_op=collections.Counter(op for _, op in trace_only),
         trace_only_bytes=sum(size for size, _ in trace_only),
         card_only=card_only, trace_only_first=trace_only[:12],
         memory=device_memory())


def phase_profile(cfg, params, batch: int, prefix: str = "",
                  prompt_len: int = PROMPT_LEN) -> None:
    """Device time of one warm prefill at the admitted batch, by kernel,
    from ``torch.profiler``; busy share = kernel time / wall time. Only
    the device's activity is recorded: xlstm's prefill runs hundreds of
    thousands of host ops, whose records cost the profiler more than
    the prefill itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as srv
    from repro_torch.train.train_step import make_prefill_step

    prompt = srv.device_prompts(cfg, batch, prompt_len, seed=200)
    step = make_prefill_step(cfg)
    step(params, prompt)                       # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, prompt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
    device_ms = sum(ms for ms, _ in kernels.values())
    if not device_ms > 0:
        raise AssertionError(f"{prefix}profile: no device time recorded")

    def bucket(name):
        low = name.lower()
        if "attn_fwd_kernel" in low or "attn_fwd_sm90_kernel" in low:
            return "flash_attention"
        if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass")):
            return "matmul"
        return "other"
    buckets: dict = {}
    for name, (ms, _) in kernels.items():
        buckets[bucket(name)] = buckets.get(bucket(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    emit(f"{prefix}profile", batch=batch, wall_ms=wall_ms,
         device_ms=device_ms,
         busy_share=device_ms / wall_ms if wall_ms else None,
         by_bucket_ms=buckets,
         top=[{"kernel": k[:90], "ms": ms, "count": n}
              for k, (ms, n) in top], memory=device_memory())


def train_policy(job: str):
    """``job``'s policy: its optimizer, clip_norm 1.0, 1 microbatch."""
    from repro_torch.train import TrainPolicy
    return TrainPolicy(optimizer=OPTIMIZERS.get(job, "adamw"))


def job_spec(job: str, batch: int):
    """The ``JobSpec`` of training job ``job`` at ``batch``: the hooks,
    abstract parameters and input specs its gate estimates, and the meta
    SchedTune's features read."""
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core.baselines import JobSpec
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    arch, n_layers, _ = TRAIN_JOBS[job]
    cfg = path_config(arch, n_layers)
    policy = train_policy(job)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    return JobSpec(job, fwd_bwd, M.abstract_params(cfg),
                   input_specs(cfg, smoke_shape(TRAIN_SEQ, batch)), update,
                   opt_init, meta={
                       "family": cfg.family, "optimizer": policy.optimizer,
                       "batch_size": batch, "seq_len": TRAIN_SEQ,
                       "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                       "optimizer_states": OPTIMIZER_STATES[
                           policy.optimizer]})


def phase_train(job: str, rows_path: str) -> None:
    """The training path of ``TRAIN_JOBS[job]``, in a process of its own
    as a training job is: the gate's first ``TRACED_AHEAD`` candidates
    traced on the CPU before any CUDA call, then, once a line on stdin
    says it is this job's turn on the card, the gate at the card's
    capacity (the traces from the cache), the steps on the card, and
    the baselines (``phase_baselines``, whose row goes to
    ``rows_path``). Its phases' names start with ``<job>_`` except for
    the dense job's."""
    import math

    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    prefix = "" if job == "dense" else f"{job}_"
    arch, n_layers, candidates = TRAIN_JOBS[job]
    cfg = path_config(arch, n_layers)
    policy = train_policy(job)
    store_dir = None
    if job == DAEMON_JOB:
        # the gate's traces write through to a store the daemon reads
        from repro_torch.core.cache import TraceCache
        from repro_torch.service import TraceStore
        store_dir = str(Path(rows_path).parent / f"{job}_store")
        est = XMemEstimator.for_torch_gpu(
            trace_cache=TraceCache(store=TraceStore(store_dir)))
    else:
        est = XMemEstimator.for_torch_gpu()
    trace_s, fwd_s = {}, {}
    ahead = list(candidates[:TRACED_AHEAD])
    if job == "dense":
        ahead += [b for b in DENSE_SWEEP_AHEAD if b not in ahead]
    for b in ahead:
        fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
        params, specs = M.abstract_params(cfg), input_specs(
            cfg, smoke_shape(TRAIN_SEQ, b))
        t0 = time.perf_counter()
        est.trace_phases(fwd_bwd, params, specs)    # the forward+backward
        fwd_s[b] = time.perf_counter() - t0
        est.trace_phases(fwd_bwd, params, specs, update, opt_init)
        trace_s[b] = time.perf_counter() - t0
    if sys.stdin.readline().strip() != "go":
        raise AssertionError(f"training job {job}: no turn on the card")
    memory = device_memory()
    capacity = srv.device_capacity()
    # decided through the admission service over the traces made ahead
    service = trn.gate_service(est)
    batch, gate = trn.pick_train_batch(cfg, policy, TRAIN_SEQ, capacity,
                                       candidates, service=service)
    emit(f"{prefix}train_gate", config=cfg.name, n_layers=cfg.n_layers,
         seq_len=TRAIN_SEQ, optimizer=policy.optimizer,
         clip_norm=policy.clip_norm, microbatches=policy.microbatches,
         capacity=capacity, seconds=gate["seconds"],
         trace_seconds={str(b): x for b, x in trace_s.items()},
         trace_cache=gate["trace_cache"], candidates=gate["candidates"],
         batch=batch, memory=memory, **(
             gate_only_estimate(cfg, policy, candidates[0], est)
             if job in GATE_ONLY else {}))
    if job in GATE_ONLY:
        if batch is not None:
            raise AssertionError(f"{cfg.name} at {n_layers} layers: the gate "
                                 f"admitted batch {batch}")
        return
    if batch is None:
        raise AssertionError(f"no training batch fits {cfg.name} at "
                             f"{n_layers} layers")
    if batch not in trace_s:
        raise AssertionError(f"{job}: batch {batch} was not traced ahead, "
                             f"so no estimate has a trace time")
    rep = gate["report"]
    shape = smoke_shape(TRAIN_SEQ, batch)
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    fa.reset_launches()
    history = job not in UNRECORDED
    got = trn.train_loop(cfg, shape, policy, steps=TRAIN_STEPS,
                         device="cuda", params=params, history=history)
    launches = dict(fa.launches_by_kernel)
    run = got.out
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"non-finite training loss {run.losses}")
    rel_reserved = (rep.peak_bytes - got.reserved) / got.reserved
    rel_allocated = (rep.peak_tensor_bytes - got.allocated) / got.allocated
    comp = rep.composition      # requests of the composed iterations
    traced = collections.Counter()
    for blocks, n in ((comp.prefix, 1), (comp.cycle, comp.n_cycles),
                      (comp.suffix, 1)):
        for b in blocks:
            if b.op != "init":
                traced[b.size] += n
    emit(f"{prefix}train", config=cfg.name, n_layers=cfg.n_layers,
         batch=batch, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         kernel_launches=launches, losses=run.losses,
         step_ms=[x * 1e3 for x in run.step_s],
         tokens_per_s=batch * TRAIN_SEQ * TRAIN_STEPS / sum(run.step_s),
         estimate=rep.peak_bytes, tensor_estimate=rep.peak_tensor_bytes,
         persistent=rep.persistent_bytes,
         measured_reserved=got.reserved, measured_allocated=got.allocated,
         rel_err_reserved=rel_reserved, rel_err_allocated=rel_allocated,
         card_allocs=got.n_allocs, trace_allocs=sum(traced.values()),
         card_alloc_retries=got.n_alloc_retries,
         card_stream_sim=replay_card_stream(
             got.events, pytree.tree_leaves(params), capacity)
         if history else None,
         card_segments_created=got.n_segments_created,
         segments_mib=sorted(round(x / 2**20, 1) for x in got.segment_sizes),
         sim_segments_mib=sorted(round(s["size"] / 2**20, 1)
                                 for s in rep.sim.segments),
         phase_peaks=rep.breakdown["phase_peaks"], memory=device_memory())
    if history:
        emit_train_requests(got.allocs, traced, prefix)
    within(f"{cfg.name} training reserved", rel_reserved, RESERVED_TOL)
    within(f"{cfg.name} training allocated", rel_allocated, ALLOCATED_TOL)
    if job == CKPT_JOB:
        phase_checkpoint({"params": params, "opt_state": run.opt_state},
                         run.step, prefix)
    truth, truth_allocated = got.reserved, got.allocated
    # DirectProbe's runs start from a card that holds none of this run's
    # tensors: parameters, optimizer state, the window's record
    del params, run, got
    torch.cuda.empty_cache()
    row = phase_baselines(job_spec(job, batch), cfg, capacity, truth, rep,
                          est, trace_s[batch] + rep.wall_time_s, fwd_s,
                          rows_path)
    if job == "dense":
        reject, reject_truth = phase_dense_sweep(
            cfg, policy, est, capacity, gate, fwd_s, row["probes"] or ())
        # the card's truths: the run's reserved peak at the gate's batch,
        # the probes' peaks, the sweep's rejection as the card ran it,
        # and the batches it cannot run (None): the gate's rejections
        truths = {batch: truth, **dict(row["probes"] or ())}
        if reject is not None:
            truths[reject] = reject_truth
        truths.update({c["batch"]: None for c in gate["candidates"]
                       if not c["fits"]})
        phase_admission_degraded(cfg, policy, est, service, capacity,
                                 truths)
    if job == DAEMON_JOB:
        phase_admission_daemon(cfg, policy, est, store_dir, capacity, gate,
                               truth, truth_allocated, rel_reserved)


def phase_baselines(spec, cfg, capacity: int, truth: int, rep, est,
                    xmem_s: float, fwd_s: dict, rows_path: str) -> dict:
    """The paper's baselines for a training job, ``spec`` at the batch
    its gate admitted (``rep``, xMem's estimate): TensorSum and DNNMem from
    the forward+backward trace ``est`` cached for that batch (their
    runtimes count the trace's seconds, ``fwd_s`` by batch, as xMem's
    ``xmem_s`` does), then, for the transformer families, DirectProbe's
    two runs on the card, each against ``truth``, the reserved peak the
    training window read. A probe at a batch whose trace is cached too
    gets DNNMem's estimate there beside its peak (``dnnmem_at_probes``):
    a second measured point, at no trace's cost. The row is emitted,
    written to ``rows_path`` for the parent's comparison, and returned. A baseline
    that raises fails the job, except DirectProbe running out of
    memory, which is its own outcome."""
    from repro_torch.core.baselines import (DirectProbeEstimator,
                                            DNNMemEstimator, ProbeOOMError,
                                            TensorSumEstimator)
    job, batch = spec.name, spec.meta["batch_size"]
    hits = est.trace_cache.hits
    fwd, _, _ = est.trace_phases(spec.fwd_bwd_fn, spec.params, spec.batch)
    if est.trace_cache.hits != hits + 1:
        raise AssertionError(f"{job}: the baselines' trace was not the "
                             f"cached one")
    found = {"xmem": (rep.peak_bytes, xmem_s)}
    tensorsum, dnnmem = TensorSumEstimator(), DNNMemEstimator()
    found["tensorsum"] = (tensorsum.estimate(spec, trace=fwd.trace),
                          tensorsum.last_runtime_s + fwd_s[batch])
    found["dnnmem"] = (dnnmem.estimate(spec, capacity, trace=fwd.trace),
                       dnnmem.last_runtime_s + fwd_s[batch])
    oom_prediction = dnnmem.last_oom_prediction
    probes = probe_oom = None
    dnnmem_at_probes = {}
    if cfg.family in PROBED_FAMILIES:
        probe = DirectProbeEstimator(capacity=capacity)
        try:
            found["directprobe"] = (probe.estimate(spec),
                                    probe.last_runtime_s)
        except ProbeOOMError as e:
            probe_oom = str(e)
        probes = probe.last_probes
        for b, peak in probes:
            if b in fwd_s:
                at = job_spec(job, b)
                fwd_b, _, _ = est.trace_phases(at.fwd_bwd_fn, at.params,
                                               at.batch)
                dnnmem_at_probes[b] = {
                    "estimate": dnnmem.estimate(at, trace=fwd_b.trace),
                    "probe_peak": peak}
    row = {"job": job, "config": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "optimizer": spec.meta["optimizer"],
           "batch": batch, "capacity": capacity,
           "measured_reserved": truth, "trace_seconds": fwd_s[batch],
           "estimators": {name: {"estimate": value,
                                 "rel_err": (value - truth) / truth,
                                 "runtime_s": seconds}
                          for name, (value, seconds) in found.items()},
           "dnnmem_oom_prediction": oom_prediction,
           "probes": probes, "probe_oom": probe_oom,
           "dnnmem_at_probes": dnnmem_at_probes}
    emit(f"{job}_baselines", **row, memory=device_memory())
    Path(rows_path).write_text(json.dumps(row))
    return row


def phase_dense_sweep(cfg, policy, est, capacity: int, gate: dict,
                      fwd_s: dict, probes) -> None:
    """The sweep service over the dense job's ``DENSE_SWEEP`` batches at
    ``capacity``, through one set of hooks and the job's estimator
    ``est``, whose cache holds the probes' traces (made ahead, through
    other but identical hooks: the key is their content). The report
    the sweep synthesized at the gate's batch is held to the gate's
    real-trace report to the byte (fails if not; the line says where
    that batch's report came from). xMem's estimates at DirectProbe's
    ``probes`` stand beside their peaks. Then the card: the largest
    admitted batch when it is above the gate's (``dense_sweep_train``),
    and the smallest rejected one above it (``dense_sweep_reject``)."""
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core.sweep import SweepPoint, SweepService
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    params = M.abstract_params(cfg)
    res = SweepService(est).estimate_many([
        SweepPoint(fwd_bwd, params, input_specs(cfg, smoke_shape(TRAIN_SEQ,
                                                                 b)),
                   update_fn=update, opt_init_fn=opt_init, capacity=capacity)
        for b in DENSE_SWEEP])
    reports = dict(zip(DENSE_SWEEP, res.reports))
    sources = dict(zip(DENSE_SWEEP, res.sources))
    fits = {b: not r.oom and r.peak_bytes <= capacity
            for b, r in reports.items()}
    gate_b, gate_rep = gate["batch"], gate["report"]
    swept = reports[gate_b]
    fields = {k: (getattr(swept, k), getattr(gate_rep, k)) for k in
              ("peak_bytes", "peak_tensor_bytes", "persistent_bytes", "oom")}
    fields["phase_peaks"] = (swept.breakdown["phase_peaks"],
                             gate_rep.breakdown["phase_peaks"])
    exact = all(a == b for a, b in fields.values())
    probed = [b for b in DENSE_SWEEP if sources[b] == "probe"]
    mean_fwd = sum(fwd_s.values()) / len(fwd_s)
    best = max((b for b in DENSE_SWEEP if fits[b]), default=None)
    emit("dense_sweep", config=cfg.name, n_layers=cfg.n_layers,
         seq_len=TRAIN_SEQ, capacity=capacity,
         batches=[{"batch": b, "estimate": reports[b].peak_bytes,
                   "tensor_estimate": reports[b].peak_tensor_bytes,
                   "fits": fits[b], "source": sources[b]}
                  for b in DENSE_SWEEP],
         **{k: res.stats[k] for k in ("traced", "interpolated", "fallback",
                                      "wall_s", "model")},
         trace_cache=res.stats["trace_cache"],
         fwd_trace_s={str(b): x for b, x in fwd_s.items()},
         # the CPU the sweep cost (its own seconds, and its probes'
         # forward+backward traces where they were made ahead) against
         # what the sequential gate would pay for the same grid: a trace
         # at every batch (the mean of this job's measured traces) and
         # the same replays
         sweep_cpu_s=res.stats["wall_s"] + sum(fwd_s[b] for b in probed
                                               if b in fwd_s),
         sequential_cpu_s=len(DENSE_SWEEP) * mean_fwd
         + sum(r.wall_time_s for r in res.reports),
         gate_batch=gate_b, gate_batch_source=sources[gate_b],
         gate_batch_equal=exact,
         gate_batch_fields={k: list(v) for k, v in fields.items()},
         xmem_vs_probes=[{"batch": b, "xmem": reports[b].peak_bytes,
                          "probe_peak": peak,
                          "rel": (reports[b].peak_bytes - peak) / peak}
                         for b, peak in probes],
         admitted=best, trains=best is not None and best != gate_b)
    if not exact:
        raise AssertionError(f"the sweep's report at batch {gate_b} "
                             f"({sources[gate_b]}) differs from the gate's: "
                             f"{fields}")
    if best is not None and best != gate_b:
        dense_sweep_train(cfg, policy, best, reports[best], sources[best])
    reject = min((b for b in DENSE_SWEEP if not fits[b]
                  and (best is None or b > best)), default=None)
    if reject is not None:
        return reject, dense_sweep_reject(cfg, policy, est, reject,
                                          reports[reject], sources[reject])
    return None, None


def dense_sweep_train(cfg, policy, batch: int, rep, source: str) -> None:
    """``batch``, which the sweep admitted above the gate's batch, trained
    ``TRAIN_STEPS`` steps on the card against ``rep``, its estimate, held
    to ``RESERVED_TOL`` and ``ALLOCATED_TOL`` as every training job is."""
    import math

    import torch
    from repro_torch.configs.base import smoke_shape
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M

    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    got = trn.train_loop(cfg, smoke_shape(TRAIN_SEQ, batch), policy,
                         steps=TRAIN_STEPS, device="cuda", params=params)
    run = got.out
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"non-finite training loss {run.losses}")
    rel_reserved = (rep.peak_bytes - got.reserved) / got.reserved
    rel_allocated = (rep.peak_tensor_bytes - got.allocated) / got.allocated
    emit("dense_sweep_train", config=cfg.name, n_layers=cfg.n_layers,
         batch=batch, source=source, seq_len=TRAIN_SEQ,
         steps=TRAIN_STEPS, losses=run.losses,
         step_ms=[x * 1e3 for x in run.step_s],
         estimate=rep.peak_bytes, tensor_estimate=rep.peak_tensor_bytes,
         measured_reserved=got.reserved, measured_allocated=got.allocated,
         rel_err_reserved=rel_reserved, rel_err_allocated=rel_allocated,
         card_alloc_retries=got.n_alloc_retries,
         segments_mib=sorted(round(x / 2**20, 1) for x in got.segment_sizes),
         sim_segments_mib=sorted(round(x["size"] / 2**20, 1)
                                 for x in rep.sim.segments),
         phase_peaks=rep.breakdown["phase_peaks"], memory=device_memory())
    del params, run, got
    torch.cuda.empty_cache()
    within(f"{cfg.name} sweep batch {batch} training reserved",
           rel_reserved, RESERVED_TOL)
    within(f"{cfg.name} sweep batch {batch} training allocated",
           rel_allocated, ALLOCATED_TOL)


def dense_sweep_reject(cfg, policy, est, batch: int, rep,
                       source: str) -> int | None:
    """The sweep's verdict at ``batch``, the smallest batch above the
    admitted ones that it rejects (its replay at the card's capacity
    ran out of memory), on the card (returns the card's reserved peak,
    None when it ran out of memory there): ``TRAIN_STEPS`` steps there
    either
    run out of memory too (the verdict holds) or run (a false
    rejection; then the unbounded estimate stands beside the measured
    peak). ``dense_sweep_reject`` has the card's reserved peak up to
    the failure beside the simulated one (``rep``). A comparison, not a
    gate."""
    import torch
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    unbounded = est.estimate_training(
        fwd_bwd, M.abstract_params(cfg),
        input_specs(cfg, smoke_shape(TRAIN_SEQ, batch)), update_fn=update,
        opt_init_fn=opt_init)
    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    card_oom = None
    try:
        got = trn.train_loop(cfg, smoke_shape(TRAIN_SEQ, batch), policy,
                             steps=TRAIN_STEPS, device="cuda", params=params)
        reserved, allocated = got.reserved, got.allocated
        del got
    except torch.OutOfMemoryError as e:
        card_oom = str(e).splitlines()[0]
        # the window's peaks up to the failure (measured_training reset
        # them when it started)
        reserved = torch.cuda.max_memory_reserved()
        allocated = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    emit("dense_sweep_reject", config=cfg.name, n_layers=cfg.n_layers,
         batch=batch, source=source, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         estimate_oom=rep.oom, estimate_at_capacity=rep.peak_bytes,
         unbounded_estimate=unbounded.peak_bytes,
         unbounded_tensor_estimate=unbounded.peak_tensor_bytes,
         card_oom=card_oom is not None, card_error=card_oom,
         measured_reserved=reserved, measured_allocated=allocated,
         verdict_holds=card_oom is not None, memory=device_memory())
    return None if card_oom is not None else reserved


def phase_admission_degraded(cfg, policy, est, service, capacity: int,
                             truths: dict) -> None:
    """The degradation ladder's answers for the dense job's
    ``DEGRADED_BATCHES`` held to the card's ``truths`` (batch -> measured
    reserved peak, or None for a batch the card cannot run), in three
    passes: the gate's ``service`` with the tracer and the replay
    raising (rung 2 from the gate's decision log), a service with that
    log over an empty cache whose tracer hangs past ``HANG_DEADLINE_S``
    (the hang fires before any trace work), and a fresh service with no
    evidence (rung 3, the analytic bound). Every answer that admits must
    have ``safe_threshold`` at or above the card's truth, and none may
    admit a batch the card cannot run: such an answer is the
    reference's ``ChaosSafetyViolation``, and fails the run. A batch
    with no truth is listed with the truth "unmeasured". Beside each
    answer, what the reference's rules give on the same evidence (a
    comparison, not a gate): rung 2 without the monotone floor, rung 3
    from the request's avals alone."""
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.cache import TraceCache
    from repro_torch.launch import train as trn
    from repro_torch.service import (AdmissionService, ChaosSafetyViolation,
                                     FaultPlan, FaultSpec, plan_raising_at)
    from repro_torch.service.degrade import (analytic_request_bound,
                                             request_family, request_scalar)

    def fresh(log=None):
        svc = AdmissionService(est.with_cache, workers=1,
                               cache=TraceCache())
        if log is not None:
            svc.log = log
        return svc
    hang = FaultPlan([FaultSpec("tracer", "hang", hang_s=600.0,
                                times=None)])
    passes = [("sweep_log", service, plan_raising_at("tracer", "replay"),
               None),
              ("hang", fresh(service.log), hang, HANG_DEADLINE_S),
              ("analytic", fresh(), plan_raising_at("tracer", "replay"),
               None)]
    out, violations = {}, []
    for name, svc, plan, deadline in passes:
        rows = []
        t0 = time.perf_counter()
        with svc.inject_faults(plan):
            for b in DEGRADED_BATCHES:
                req = trn.train_request(cfg, policy,
                                        smoke_shape(TRAIN_SEQ, b), capacity,
                                        deadline_s=deadline)
                d = svc.decide(req)
                truth = truths.get(b, "unmeasured")
                # the reference's rule at the rung that answered
                if d.rung == "sweep":
                    raw = svc.log.lookup(request_family(req),
                                         request_scalar(req))[0]
                else:
                    req.meta = {}
                    raw = analytic_request_bound(req, svc.log)
                ref = math.ceil(raw * d.margin)
                row = {"batch": b, "admit": d.admit, "rung": d.rung,
                       "margin": d.margin, "derived":
                           d.provenance.get("derived"),
                       "raw_peak_bytes": d.raw_peak_bytes,
                       "safe_threshold": d.safe_threshold,
                       "wall_s": d.wall_s, "truth": truth,
                       "card_runs": truth is not None,
                       "headroom": (d.safe_threshold - truth
                                    if isinstance(truth, int) else None),
                       "reference_rule": {
                           "safe_threshold": ref,
                           "admit": ref <= capacity,
                           "unsafe": ref <= capacity and (
                               truth is None or (isinstance(truth, int)
                                                 and ref < truth))},
                       "rung_errors": d.provenance["rung_errors"][:2]}
                if not d.degraded:
                    violations.append(f"{name} batch {b}: not degraded")
                elif d.admit and (truth is None or (
                        isinstance(truth, int) and d.safe_threshold < truth)):
                    violations.append(f"{name} batch {b}: admits at "
                                      f"{d.safe_threshold} B, card {truth}")
                rows.append(row)
        out[name] = {"seconds": time.perf_counter() - t0, "answers": rows,
                     "health": {k: svc.health()[k] for k in
                                ("rungs", "timeouts", "abandoned_rungs")}}
    # the abandoned rungs stop at their next checkpoint once the hang's
    # scope has cancelled it: none may stay behind
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline and any(
            t.name == "xmem-rung" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.1)
    stranded = sum(t.name == "xmem-rung" and t.is_alive()
                   for t in threading.enumerate())
    emit("admission_degraded", config=cfg.name, n_layers=cfg.n_layers,
         seq_len=TRAIN_SEQ, capacity=capacity,
         truths={str(b): t for b, t in truths.items()},
         decision_log=service.log.stats(), passes=out,
         stranded_rung_threads=stranded, violations=violations,
         memory=device_memory())
    if violations or stranded:
        raise ChaosSafetyViolation(f"degraded answers against the card: "
                                   f"{violations}; {stranded} rung "
                                   f"threads stranded")


def phase_admission_daemon(cfg, policy, est, store_dir: str, capacity: int,
                           gate: dict, reserved: int, allocated: int,
                           rel_reserved: float) -> None:
    """The training job's admitted batch through the admission daemon:
    an ``AdmissionServer`` on a local port over a service that shares
    the job's trace cache answers the wire's ``train`` request for the
    same job (built by the wire from ``{"arch", "smoke": false, "seq",
    "batch", "hbm_gib"}``); it must equal the gate's decision, from
    memory, with no trace. The wire's other kinds on the same connection:
    ``health``, ``metrics`` (JSON and Prometheus text, parsed back),
    ``stats``, a malformed line and a ``plan`` request (structured
    errors on a live connection). Then the daemon drains and stops, a
    second one starts over a fresh service on the same store directory,
    and the same request must come back with the same bytes from disk,
    with no trace. Last, the run's measured peaks go to the telemetry
    ingestor against the job's digest and family, and the residual read
    back must be the ``train`` line's error."""
    import hashlib
    import socket

    from repro_torch.core.cache import fn_digest
    from repro_torch.launch import served
    from repro_torch.launch import train as trn
    from repro_torch.obs import parse_prometheus
    from repro_torch.obs.ingest import GPUMemorySnapshot, TelemetryIngestor
    from repro_torch.service import AdmissionService
    from repro_torch.service.degrade import request_family

    batch, decision = gate["batch"], gate["decision"]
    wire = {"kind": "train", "arch": TRAIN_JOBS[DAEMON_JOB][0],
            "smoke": False,
            "seq": TRAIN_SEQ, "batch": batch, "hbm_gib": capacity / 2**30}

    def start(svc):
        server = served.AdmissionServer(("127.0.0.1", 0), svc)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread

    def stop(server, thread):
        host, port = server.server_address[:2]
        resp = served.request_once(host, port, {"kind": "shutdown"})
        thread.join(timeout=120)
        server.server_close()
        if not resp.get("shutdown") or thread.is_alive():
            raise AssertionError(f"the daemon did not stop: {resp}")

    def lines(server, payloads):
        host, port = server.server_address[:2]
        with socket.create_connection((host, port), timeout=600) as s:
            f = s.makefile("rwb")
            out = []
            for p in payloads:
                f.write(p if isinstance(p, bytes)
                        else (json.dumps(p) + "\n").encode())
                f.flush()
                out.append(json.loads(f.readline()))
            return out

    fields = ("peak_bytes", "peak_tensor_bytes", "persistent_bytes")
    want = {f: getattr(decision, f) for f in fields}
    svc = AdmissionService(workers=1, cache=est.trace_cache)
    server, thread = start(svc)
    t0 = time.perf_counter()
    first, health, metrics, stats, bad, plan = lines(server, [
        wire, {"kind": "health"}, {"kind": "metrics"}, {"kind": "stats"},
        b"{not json\n", dict(wire, kind="plan")])
    first_s = time.perf_counter() - t0
    stop(server, thread)
    svc.close()
    save = est.trace_cache.store.stats()
    disk_bytes = sum(f.stat().st_size for f in Path(store_dir).iterdir()
                     if f.is_file())
    svc2 = AdmissionService(workers=1, store_dir=store_dir)
    server, thread = start(svc2)
    t0 = time.perf_counter()
    (second,) = lines(server, [wire])
    second_s = time.perf_counter() - t0
    stop(server, thread)
    load = svc2.cache.store.stats()
    svc2.close()
    prom = parse_prometheus(metrics.get("prometheus", ""))

    # telemetry: the run's peaks against the job's digest and family
    req = trn.train_request(cfg, policy,
                            served._train_job(wire)[2], capacity)
    digest = fn_digest(req.fwd_bwd_fn)
    family = hashlib.sha256(repr(request_family(req)).encode()).hexdigest()
    ing = TelemetryIngestor(str(Path(store_dir) / "telemetry"))
    ing.ingest(digest, family, decision.peak_bytes,
               snapshot=GPUMemorySnapshot(
                   timestamp=time.time(), reserved_mb=reserved / 2**20,
                   allocated_mb=allocated / 2**20))
    summary = ing.summary()[f"{digest}/{family}"]
    ing.close()
    residual = summary["mean_residual_bytes"]
    residual_rel = -residual / reserved

    checks = {
        "first_equals_gate": all(first.get(f) == want[f] for f in fields),
        "first_from_memory": first.get("provenance", {}).get("source")
        == "memory" and first["provenance"]["trace_cache"]["misses"] == 0,
        "second_equals_gate": all(second.get(f) == want[f]
                                  for f in fields),
        "second_from_disk": second.get("provenance", {}).get("source")
        == "disk" and second["provenance"]["trace_cache"]["misses"] == 0
        and second["provenance"]["trace_cache"]["store_hits"] > 0,
        "health": health.get("ok") and health["health"]["status"] == "ok",
        "metrics": prom.get("xmem_service_requests_total") == 1.0
        and metrics["metrics"]["counters"][
            "xmem_service_requests_total"] == 1,
        "stats": stats.get("stats", {}).get("requests_served") == 1,
        "malformed": bad.get("kind") == "error" and not bad["ok"],
        "plan_not_ported": plan.get("kind") == "error"
        and "slice 10" in plan.get("error", ""),
        "residual_is_train_error": residual == reserved
        - decision.peak_bytes and residual_rel == rel_reserved,
    }
    emit("admission_daemon", config=cfg.name,
         n_layers=cfg.n_layers, batch=batch, capacity=capacity,
         hbm_gib=wire["hbm_gib"], gate=want,
         first={k: first.get(k) for k in (*fields, "admit", "provenance",
                                           "wall_s", "rung")},
         first_s=first_s,
         second={k: second.get(k) for k in (*fields, "admit", "provenance",
                                            "wall_s", "rung")},
         second_s=second_s,
         store={"entries": load["entries"], "disk_bytes": disk_bytes,
                "saves": save["saves"], "save_s": save["save_s"],
                "loads": load["loads"], "load_s": load["load_s"]},
         health=health.get("health", {}).get("rungs"),
         prometheus_series=len(prom), malformed=bad, plan=plan,
         telemetry={"model_digest": digest, "family": family,
                    "summary": summary, "residual_rel": residual_rel,
                    "train_rel_err_reserved": rel_reserved},
         checks=checks, memory=device_memory())
    if not all(checks.values()):
        raise AssertionError(f"admission daemon: {checks}")


def gate_only_estimate(cfg, policy, batch: int, est) -> dict:
    """The training estimate of ``batch`` with no capacity (the cached
    traces replayed unbounded): the whole peak the gate rejected, and
    its persistent part (parameters, AdamW state)."""
    from repro_torch.configs.base import smoke_shape
    from repro_torch.launch import train as trn
    _, rep = trn.admission_check(cfg, policy, smoke_shape(TRAIN_SEQ, batch),
                                 1 << 62, est)
    return {"unbounded_estimate": rep.peak_bytes,
            "unbounded_tensor_estimate": rep.peak_tensor_bytes,
            "persistent": rep.persistent_bytes}


def phase_checkpoint(state: dict, step: int, prefix: str) -> None:
    """``state`` through the port's ``CheckpointManager``: saved to a
    temporary directory (after a check that its disk has room), restored
    into fresh card tensors and held to ``state`` byte for byte; the
    directory is deleted."""
    import shutil
    import tempfile

    import torch
    from repro_torch.train import CheckpointManager
    from repro_torch.train.checkpoint import _flatten

    leaves = dict(_flatten(state))
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        need = nbytes + (64 << 20)          # the npz's headers and manifest
        if free < need:
            raise AssertionError(f"checkpoint needs {need} bytes of disk in "
                                 f"{root}, {free} free")
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(step, state)
        save_s = time.perf_counter() - t0
        file_bytes = sum(f.stat().st_size for f in Path(root).iterdir())
        t0 = time.perf_counter()
        got_step, restored = mgr.restore_latest(state, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = dict(_flatten(restored))
        same = got_step == step and back.keys() == leaves.keys() and all(
            back[p].dtype == t.dtype and back[p].shape == t.shape
            and back[p].data_ptr() != t.data_ptr()
            and torch.equal(back[p].reshape(-1).view(torch.uint8),
                            t.reshape(-1).view(torch.uint8))
            for p, t in leaves.items())
        del restored, back
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(f"{prefix}ckpt", step=step, leaves=len(leaves), tensor_bytes=nbytes,
         file_bytes=file_bytes, disk_free=free, save_s=save_s,
         restore_s=restore_s, byte_equal=same, memory=device_memory())
    if not same:
        raise AssertionError("the restored checkpoint differs from the "
                             "trained state")


def replay_card_stream(events, resident, capacity: int) -> dict:
    """The card's own allocator requests of a measured window, replayed
    through the port's allocator simulation at ``capacity`` after the
    ``resident`` tensors (allocated first, in order, as the window found
    them): the simulation's error on the card's stream, apart from the
    trace's."""
    from repro_torch.core.allocator import (CUDA_CACHING, CachingAllocatorSim,
                                            DeviceAllocatorSim)
    sim = CachingAllocatorSim(CUDA_CACHING, DeviceAllocatorSim(
        capacity, CUDA_CACHING.device_page))
    for t in resident:
        sim.malloc(t.untyped_storage().nbytes())
    handles = {}
    for action, addr, size in events:
        if action == "alloc":
            handles[addr] = sim.malloc(size)
        elif addr in handles:
            sim.free(handles.pop(addr))
    return {"reserved": sim.peak_reserved, "allocated": sim.peak_allocated}


def emit_train_requests(card_allocs, traced, prefix: str = "") -> None:
    """The request sizes the card made in the measured window that the
    composed trace did not, and the reverse (multisets of sizes: a
    window is too long to align), with where the card made them."""
    card = collections.Counter(size for size, _ in card_allocs)
    where = {}
    for size, at in card_allocs:
        where.setdefault(size, at)

    def top(diff, with_where):
        rows = sorted(diff.items(), key=lambda kv: -kv[0] * kv[1])[:12]
        return [[size, n, where.get(size, "?")] if with_where
                else [size, n] for size, n in rows]
    card_only, trace_only = card - traced, traced - card
    emit(f"{prefix}train_requests", card=sum(card.values()),
         trace=sum(traced.values()),
         card_only=sum(card_only.values()),
         trace_only=sum(trace_only.values()),
         card_only_bytes=sum(k * n for k, n in card_only.items()),
         trace_only_bytes=sum(k * n for k, n in trace_only.items()),
         card_only_top=top(card_only, True),
         trace_only_top=top(trace_only, False))


def phase_comparison(rows: dict, info: dict) -> None:
    """The paper's comparison on the card: SchedTune fitted on the
    measured (``JobSpec``, reserved peak) pairs of the dense and moe
    families' jobs (each job's truth and its probes), then every
    estimator's ``RunRecord`` of every job against the truth its window
    read, at the capacity its gate read: MRE, PEF, MCP and mean runtime
    per estimator (``core/metrics.py``), each model's quadrant, and
    xMem's improvement over the best baseline. ``info``: the
    ``device`` phase's."""
    from repro_torch.core import metrics as mt
    from repro_torch.core.baselines import SchedTuneEstimator

    history, peaks = [], []
    for job, row in rows.items():
        if row["family"] in SCHEDTUNE_FAMILIES:
            for batch, peak in [(row["batch"], row["measured_reserved"]),
                                *(row["probes"] or ())]:
                history.append(job_spec(job, batch))
                peaks.append(peak)
    schedtune = SchedTuneEstimator()
    t0 = time.perf_counter()
    schedtune.fit(history, peaks)
    fit_s = time.perf_counter() - t0
    records = []
    for job, row in rows.items():
        found = {name: (e["estimate"], e["runtime_s"])
                 for name, e in row["estimators"].items()}
        found["schedtune"] = (schedtune.estimate(job_spec(job, row["batch"])),
                              schedtune.last_runtime_s)
        records += [mt.RunRecord(job, row["family"], name, info["name"],
                                 row["capacity"], value,
                                 row["measured_reserved"], seconds)
                    for name, (value, seconds) in found.items()]
    summary = {name: {"n": len(recs), "mre": mt.mre(recs),
                      "pef": mt.pef(recs), "mcp": mt.mcp(recs),
                      "mean_runtime": mt.mean_runtime(recs),
                      "quadrant": {r.config: mt.quadrant([r]) for r in recs}}
               for name, recs in mt.group_by(records, "estimator").items()}
    emit("baselines", nvidia_smi=info["nvidia_smi"],
         schedtune_history=len(history),
         schedtune_fit_s=fit_s, estimators=summary,
         improvement_vs_best_baseline=mt.improvement_vs_best_baseline(
             records),
         probe_oom={job: row["probe_oom"] for job, row in rows.items()
                    if row["probe_oom"]},
         records=[{"job": r.config, "estimator": r.estimator,
                   "estimate": r.estimate, "truth": r.truth,
                   "rel_err": (r.estimate - r.truth) / r.truth,
                   "runtime_s": r.runtime_s, "c2": r.c2} for r in records])


def main() -> int:
    import shutil
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout
    if sys.argv[1:2] == ["--train"] and len(sys.argv) == 4:
        phase_train(sys.argv[2], sys.argv[3])
        return 0
    # each training job gets a process of its own, as it would: a fresh
    # allocator whose first iteration makes cuBLAS's workspaces. They
    # start now and trace their gates on the CPU while this process
    # serves; each takes the card in turn at the end. The jobs get half
    # the cores and this process the other half, so that the serving
    # paths' host-side numbers are not taken under the tracing's load
    # (each writes its baselines' row to a file of ``rows_dir``)
    cores = sorted(os.sched_getaffinity(0))
    mine, theirs = cores[:len(cores) // 2], cores[len(cores) // 2:]
    rows_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_rows_"))
    jobs = {}
    for job in TRAIN_JOBS:
        jobs[job] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--train", job,
             str(rows_dir / f"{job}.json")],
            stdin=subprocess.PIPE, text=True)
        if mine:
            os.sched_setaffinity(jobs[job].pid, theirs)
    if mine:
        for tid in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(tid), mine)
        torch.set_num_threads(len(mine))
    emit("cpus", serving=mine, training_jobs=theirs)
    try:
        info = phase_device()
        phase_build()
        rows = phase_kernels()
        phase_serving(rows, "qwen3-32b", serving_sweep=True)
        phase_moe_layer()
        phase_attention_layer()
        phase_serving(rows, MOE_ARCH, "moe_")
        for arch, (prefix, max_len, prompt_len) in FULL_DEPTH_SERVING.items():
            phase_serving(rows, arch, prefix, n_layers=None, max_len=max_len,
                          prompt_len=prompt_len, candidates=WIDE_CANDIDATES,
                          kernel_rows=True)
        for arch, (prefix, n_layers) in RECURRENT_SERVING.items():
            phase_serving(rows, arch, prefix, n_layers=n_layers,
                          candidates=WIDE_CANDIDATES,
                          kernel_rows=arch == HYBRID_ARCH)
        # this process keeps only its context and workspace on the card
        torch.cuda.empty_cache()
        for job, child in jobs.items():
            if child.poll() is None:        # still waiting for its turn
                child.stdin.write("go\n")
                child.stdin.close()
            if child.wait(timeout=600) != 0:
                raise AssertionError(f"training job {job} failed: exit "
                                     f"{child.returncode}")
        phase_comparison({job: json.loads((rows_dir / f"{job}.json")
                                          .read_text())
                          for job in TRAIN_JOBS if job not in GATE_ONLY},
                         info)
    finally:
        for child in jobs.values():
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(rows_dir, ignore_errors=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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
0a. sharded_ahead — two processes beside them, from the start
   (``--sharded-ahead GROUPS OUT``, no card): each of ``dense_sharded``'s
   and ``moe_sharded``'s runs estimated as rank 0's program on the CPU
   (the xMem estimate of its local trace, composed past 9 layers; its
   local counts) and the mesh sweep's row for its topology;
0b. depth_compose — in a process of its own beside them, from the start
   (``--depth-compose OUT``, no card): the vlm and audio training
   estimates (24 and 16 layers) from traces composed of probes at 2, 3
   and 4 layers (``core/depth.py``), and the ssm one (8 layers) from a
   trace whose sLSTM step loops ran 6 and 7 steps in its probes
   (``core/loops.py``), beside the estimates from the full traces,
   equal to the byte, each with its wall and CPU seconds split between
   the trace (the loops' probes and synthesis apart) and the replay;
   then qwen3-32b (64 layers, batch 8), musicgen-medium (48, batch 32),
   phi3.5-moe (32, batch 8) and xlstm-1.3b (48, batch 16) at their
   published depths, and qwen3-32b's 4 layers at 16,384 and 32,768
   positions (batch 1), whose chunked attention's 32 (64) query chunks
   over 16 (32) key chunks a layer compose at two levels: estimate,
   source, seconds, and admit or reject at the serving capacity, and
   xlstm-1.3b's prefill at 48 layers (batch 256);
   its line is printed when the training jobs end. Every estimate below
   whose step is deeper than its probes (9 units), or has loops of 14
   or more bodies (the sLSTM's and Mamba's chunks and steps, chunked
   attention's query and key chunks), comes from a composed trace, to
   the byte the full trace's;
0c. serving_ahead — in a process of its own on this process's cores,
   from the start (``--serving-ahead STORE``, no card, one thread): the
   xlstm-1.3b and 32k serving gates' candidates (``SERVING_AHEAD``)
   traced into a trace store, which those gates read from disk;
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
   then ``serve_plan``, in a process of its own on the training jobs'
   cores that uses no card (``--serve-plan OUT``), started with
   ``serve_mix``'s capacity: the remediation planner's serving search
   for a burst of 2048 such requests at ``max_concurrent`` 2048 (page
   size 16 and 64 x concurrency 1024, 512, 256 x 1- and 2-byte KV), held
   to its trace budget, its best offer decided again to the byte; its
   line is printed when the serving half ends;
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
8c. hybrid_long_main — jamba's cut again with 32,768-token prompts into
   a cache of 32,784 positions (``hybrid_long_*``), 16 greedy tokens,
   under an allocator cap ``LONG_HEADROOM`` under the card's capacity
   (``allocator_cap``), at which its gate decides: each Mamba layer's
   prefill is 128 chunks of 256 steps, the sm90 kernel launches at
   ``(B, 64, 8, 32768, 128)`` and is held against the plain version
   there (one sequence's one head at a time), and the kernel path's
   logits against the chunked attention's (dense scores at this length
   do not fit); no request alignment, profile or recurrent parity (the
   2048-token path has them);
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
   none the card cannot run may be admitted; and ``plan_offers``: the
   remediation planner on the gate's rejection at batch 8 (batch,
   microbatch and remat axes, host offload), every candidate listed,
   each offer the port's step can run held to the card's truth at its
   batch or, for the cheapest without one, run for 3 steps (batch 8 at
   4 microbatches), each offer's request decided again to the byte; its
   topology axis (2 and 4 devices) replays the gate's traces, and each
   topology offer is held to ``dense_mesh_sweep``'s row to the byte;
   ``dense_mesh_sweep`` before it: the admission service's mesh sweep
   of the gate's rejected batch over every topology of 2 and 4 devices
   at the card's capacity (each per-device estimate, persistent and
   injected collective bytes, fit), from the gate's cached trace; and
   ``dense_sharded``: rank 0 of qwen3-32b's sharded programs run
   sharded under DTensor (``launch/dryrun.py``, ``distributed/
   program.py``), each under a ``fake`` process group of its mesh's
   size (its collectives return buffers of the right shape and move no
   data; NCCL's buffers are absent) with real local shards on the card:
   the pure tensor-parallel 1x1x2 and 1x1x4 (4 layers, batch 8, 3 AdamW
   steps), TRAIN_4K on the 16x16 production mesh (fsdp, AdamW, 4
   microbatches, 64 layers cut to 4, 3 steps), and the serving cut's 8
   layers at PREFILL_32K (the sm90 kernel on each rank's heads) and
   DECODE_32K; each run's estimate was made ahead on the CPU
   (``--sharded-ahead``, processes from the start) from rank 0's
   local trace, and each is printed beside the card's reserved and
   allocated peaks, with the mesh sweep's row for its topology, the
   local FLOPs beside the analytic count, and the collective bytes by
   kind (``dense_sharded_run``); the sm90 kernel at the prefill's local
   shape (2, 4, 1, 32768, 128) against its plain version
   (``dense_sharded_kernel``, a row of the ``kernels`` line);
9a. dense_sgd_train — the same job with SGD (``--train dense_sgd``):
   the paper's optimizer axis, where DNNMem's estimate stays put;
10. moe_train — the same in a child of its own (``--train moe``) for
   phi3.5-moe at full width, sequences of 4096, depth cut to 3 layers
   (``moe_train_gate``, ``moe_train``, ``moe_train_requests``), then
   ``moe_sharded``: rank 0 of phi3.5-moe's sharded programs, as
   ``dense_sharded`` runs qwen3-32b's, expert-parallel over ``model``
   (each rank routes its own tokens over all experts, gathers only its
   own experts' capacity rows and combines them in f32, one all-reduce
   over ``model``; no all-to-all): 1x1x4 (4 experts and 8 of 32 query
   heads a rank; the moe job's 3 layers, batch 8, 3 AdamW steps), 16x16
   TRAIN_4K (the dry run's policies: fsdp, 4 microbatches, 16 dispatch
   groups; 32 layers cut to 8, 3 steps), PREFILL_32K and DECODE_32K (8
   layers), each beside the estimate of its local trace made ahead
   (``moe_sharded_run``), and the sm90 kernel at the prefill's local
   shape (2, 2, 1, 32768, 128) (``moe_sharded_kernel``, a row of the
   ``kernels`` line);
11. vlm_train — the same for internvl2-1b at full width and depth
   (``--train vlm``), then ``vlm_ckpt``: its final parameters and AdamW
   state saved with the port's ``CheckpointManager`` to a temporary
   directory, restored into fresh card tensors and held to the trained
   ones byte for byte; its gate's traces write through to a persistent
   trace store, and ``admission_daemon``: the admission daemon on a
   local port answers the admitted batch as the wire's ``train``
   request, equal to the gate's decision from memory, then, restarted
   over the same store, from disk with no trace; the wire's other kinds;
   a third start places the job on the daemon's fleet of two nodes at
   the card's capacity (``place``, from disk, no trace, the gate's safe
   threshold) and fails its node (``evacuate``: it moves to the other);
   the run's measured peaks ingested as telemetry against the
   decision; then ``fleet_colocate``: the port's fleet scheduler
   places the job at batches 4 (A), 2 (B) and its gate's batch (C) on a
   fleet whose node000 is this card, at the capacity one process has
   while two more processes hold CUDA contexts on it, beside three
   simulated H100s; the jobs it puts on node000 (A and B) run their 3
   AdamW steps side by side, each in a worker process of its own
   (``--colocate-worker vlm``, started together at one barrier), each
   held to its own estimate; meanwhile node000 fails in the scheduler's
   books, on the CPU, and every displaced job is re-placed or accounted
   lost, with no trace;
12. audio_train — the same for musicgen-medium at full width, depth cut
   to 16 layers, batch 8 (``--train audio``). The training paths launch
   neither attention kernel: they train through the chunked attention,
   as the JAX package does;
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
import contextlib
import dataclasses
import json
import os
import signal
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
# xlstm-1.3b serving depth, in whole periods of 8. One prefill estimate
# at 48 layers takes about 21 s of the chip machine's CPU with its loops
# composed (core/loops.py; 58.0-81.6 s traced in full), but at 48 layers
# the path took 190-205 s of the run, its serving on the card most of
# it, and the run ended at 1,096 and 1,176 s (PERF.md section 6): 32
# kept the run under 1,150 s until the MoE family's sharded runs
# (``moe_sharded``) needed the time; 16, the depth it had before 32,
# pays for them. At 8 the estimate is off the card beyond the limits
# (prefill +6.77 % reserved, decode -11.00 %: PERF.md section 6)
SSM_SERVING_LAYERS = 16
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
# the long-sequence serving path (PREFILL_32K's prompts,
# configs/base.py): jamba's cut with 32,768-token prompts into a cache
# of LONG_MAX_LEN positions, 16 greedy tokens; each Mamba layer's prefill
# is 128 chunks of 256 steps, which the gate's traces compose at two
# levels (core/loops.py). Its candidates start at the first batch the
# CPU gate rejects (PERF.md section 6)
LONG_PROMPT = 32768
LONG_MAX_LEN = LONG_PROMPT + DECODE_TOKENS
LONG_SERVING = {HYBRID_ARCH: ("hybrid_long_", HYBRID_PERIOD, (4, 2, 1))}
# the long path runs with the caching allocator capped
# (``set_per_process_memory_fraction``) this far under the capacity it
# reads, and gates at the cap: its admitted batch's prefill reserves to
# within megabytes of the capacity (PERF.md section 6), and the kernel
# modules the path loads lazily take some of them after the gate has
# read it. Under the cap the allocator releases its cache and retries
# by its own count, as the simulation does
LONG_HEADROOM = 1 << 30
# a plain attention over this many positions runs one sequence and one
# head at a time: a head's f32 scores at 32,768 positions are 4.3 GB
PLAIN_HEAD_AT_ONCE = 8192
# serving gates traced ahead (``--serving-ahead STORE``: a process of its
# own on this process's cores from the start, no card, one thread) into a
# trace store the gates then read from disk: (phase prefix, the
# candidates its gate tried in earlier runs, the last admitted). A
# candidate the gate tries beyond them is traced then, as before; the
# bytes are the same either way. xlstm-1.3b's gate traced for 42 s of
# the serving half; the cheaper gates before it run in this process, so
# that it need not wait for the tracing at the first of them (PERF.md
# section 5)
SERVING_AHEAD = {"ssm_": (256,), "hybrid_long_": (4, 2)}
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
# lower. One musicgen estimate at 48 layers took 177.59 s of CPU in full
# and 47.97 s composed from probes of 2, 3 and 4 layers (PERF.md section
# 6); it trains 16 all the same: its turn is bound by its 3 steps
# on the card (about 56 s each at 24 layers), at 24 its turn (272-281 s)
# left the run no room for the fleet phase (1,185.6 s with it; PERF.md
# section 5). At 16 layers its gate rejected 64 and admitted 32, whose
# steps took 37-39 s each and DirectProbe's runs 57 s: the whole script
# ran past 1,200 s on a slower card machine, so its gate starts at 8,
# which it admits, as phi3.5-moe's admits its first. xLSTM trains its
# least depth, one period of 8 (too few to compose by depth): one
# estimate took about 50 s beside the other children with its sLSTM's 16
# chunks of 256 steps composed (core/loops.py; 204 s in full, PERF.md
# section 6); its gate starts at 16, which it admitted after rejecting 32
TRAIN_JOBS = {"dense": ("qwen3-32b", 4, (8, 4, 2, 1)),
              "dense_sgd": ("qwen3-32b", 4, (8, 4, 2, 1)),
              "moe": (MOE_ARCH, 3, (8, 4, 2, 1)),
              "vlm": (VLM_ARCH, 24, (16, 8, 4, 2, 1)),
              "audio": (AUDIO_ARCH, 16, (8, 4, 2, 1)),
              "ssm": (SSM_ARCH, 8, (16, 8, 4, 2, 1)),
              "hybrid": (HYBRID_ARCH, HYBRID_PERIOD, (1,))}
TRAIN_SEQ = 4096            # TRAIN_4K's sequence length
# the dense job at 16,384 positions (``dense_long``), 32 query chunks
# over 16 key chunks a layer: estimated in ``depth_compose``, not run.
# On the card (scripts/long_paths.py, PERF.md section 6) its gate
# rejects 2 and admits 1, whose 3 steps take 53 s and its gate 25 s
# after 170 s of traces ahead: the run would end near 1,200 s
LONG_TRAIN_SEQ = 16384
# ``depth_compose`` (a process of its own, ``--depth-compose OUT``): the
# training jobs the card runs that compose, each at its gate's admitted
# batch (internvl2-1b rejects 16 and admits 8, musicgen-medium at 16
# layers admits 8: deeper than the depth probes; xlstm-1.3b at 8 layers
# rejects 32 and admits 16: its sLSTM's loops):
# (job, batch, sequence), estimated from the composed trace and from the
# full one, to the byte; and estimates no job runs: (arch, depth or None
# for the published one, the job whose policy it takes, batch,
# sequence), with xlstm-1.3b's 48 layers, whose 6 periods are too few to
# compose by depth but whose loops compose, and qwen3-32b's 4 layers at
# LONG_TRAIN_SEQ and twice it, batch 1 (32 and 64 query chunks over 16
# and 32 key chunks, nested; at LONG_TRAIN_SEQ its trace in full, 224 s
# of the depth child's CPU, took the run past 1,150 s: PERF.md section
# 6); and xlstm-1.3b's prefill at 48 layers: (batch, prompt positions),
# into a MAX_LEN cache
DEPTH_FULL_JOBS = (("vlm", 8, TRAIN_SEQ), ("audio", 8, TRAIN_SEQ),
                   ("ssm", 16, TRAIN_SEQ))
DEPTH_ESTIMATES = (("qwen3-32b", None, "dense", 8, TRAIN_SEQ),
                   (AUDIO_ARCH, None, "audio", 32, TRAIN_SEQ),
                   (MOE_ARCH, None, "moe", 8, TRAIN_SEQ),
                   (SSM_ARCH, None, "ssm", 16, TRAIN_SEQ),
                   ("qwen3-32b", 4, "dense", 1, LONG_TRAIN_SEQ),
                   ("qwen3-32b", 4, "dense", 1, 2 * LONG_TRAIN_SEQ))
LOOPS_PREFILL = (256, 2048)
# the xlstm-1.3b rows, the longest (one estimate at 48 layers is about 7
# minutes of the child's CPU), run in a process of the child's own
# (``--depth-compose-loops OUT``), beside the others
LOOP_ARCHS = (SSM_ARCH,)
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
# the dense job's remediation search (``plan_offers``): its gate's
# rejection at the first candidate searched over batch, microbatches,
# remat and host offload; the microbatch candidates (the default grid:
# the batch at 2 and 4 microbatches) traced ahead with the gate's
PLAN_MICROBATCHES = (2, 4)
PLAN_OFFLOAD_ACTIVATIONS = (0.5,)
# the dense job's mesh sweep (``dense_mesh_sweep``, the planner's
# topology axis in ``plan_offers``) over every topology of these device
# counts
DENSE_MESH_DEVICES = (2, 4)
# ``dense_sharded`` and ``moe_sharded``: rank 0 of qwen3-32b's and
# phi3.5-moe's sharded programs on the card, each under a ``fake``
# process group of the mesh's size, at the end of the training job the
# first column names (its ``TRAIN_JOBS`` config). Each run: (job, label,
# layers, shape (seq, global batch, kind), mesh dims, axis names, group
# of the process that estimates it ahead, steps on the card). Groups "a"
# and "d": a topology's own policies (pure tensor and expert
# parallelism: "a" the topologies ``dense_mesh`` ran, the dense job's 4
# layers and batch 8; "d" 1x1x4, the moe job's 3 layers, 4 experts and 8
# of 32 query heads a rank), AdamW. "b" and "e": TRAIN_4K on the
# production 16x16 mesh with the dry run's policies (fsdp, AdamW, 4
# microbatches, dispatch groups 16), cut for the script's run time: a
# step takes about a second a layer on the card, and its estimate traces
# every layer up to 9. The dense run had 16 layers, composed, until the
# MoE runs needed the time: with 8 layers each and the estimates in four
# processes the script took 1,351 s. Dense runs 4; the MoE run 8, where
# its estimate holds closer to the card than at 4 (PERF.md section 6).
# "c" and
# "f": the serving cut's 8 layers at PREFILL_32K (the sm90 kernel on
# each rank's heads) and DECODE_32K
SHARDED_RUNS = (
    ("dense", "1x1x2", 4, (4096, 8, "train"), (1, 1, 2),
     ("pod", "data", "model"), "a", 3),
    ("dense", "1x1x4", 4, (4096, 8, "train"), (1, 1, 4),
     ("pod", "data", "model"), "a", 3),
    ("dense", "16x16 train_4k", 4, (4096, 256, "train"), (16, 16),
     ("data", "model"), "b", 3),
    ("dense", "16x16 prefill_32k", 8, (32768, 32, "prefill"), (16, 16),
     ("data", "model"), "c", 1),
    ("dense", "16x16 decode_32k", 8, (32768, 128, "decode"), (16, 16),
     ("data", "model"), "c", 1),
    ("moe", "moe 1x1x4", 3, (4096, 8, "train"), (1, 1, 4),
     ("pod", "data", "model"), "d", 3),
    ("moe", "moe 16x16 train_4k", 8, (4096, 256, "train"), (16, 16),
     ("data", "model"), "e", 3),
    ("moe", "moe 16x16 prefill_32k", 8, (32768, 32, "prefill"), (16, 16),
     ("data", "model"), "f", 1),
    ("moe", "moe 16x16 decode_32k", 8, (32768, 128, "decode"), (16, 16),
     ("data", "model"), "f", 1),
)
# the groups whose policies are their topology's own
TOPOLOGY_GROUPS = ("a", "d")
# the processes that estimate them ahead, on the CPU, from the start, in
# this order: two, as many as the serving half's run time allows beside
# the training jobs' traces (on an 8-core card machine)
SHARDED_AHEAD = ("a,c,d,f", "b,e")
SHARDED_AHEAD_TIMEOUT_S = 600
# each job's sharded prefill kernel at rank 0's local shape (B, H, Hkv,
# S, d): 2 of 32 sequences; qwen3-32b 4 of 64 query heads and the 1 kv
# head they group over; phi3.5-moe 2 of 32 query heads and their 1 of 8
# kv heads
SHARDED_KERNEL_SHAPES = {"dense": (2, 4, 1, 32768, 128),
                         "moe": (2, 2, 1, 32768, 128)}
# the serving search (``serve_plan``, a process of its own): a burst of
# SERVE_PLAN_REQUESTS requests of PROMPT_LEN + DECODE_TOKENS positions,
# all queued at tick 0 (a batch-inference job's prompts), at page 16,
# 2-byte KV and max_concurrent SERVE_PLAN_REQUESTS: 138.5 GB of paged
# KV at qwen3-32b's 32,768 B a token, which the card rejects; the
# search's knob grid
SERVE_PLAN_REQUESTS = 2048
SERVE_PLAN_PAGES = (16, 64)
SERVE_PLAN_CONCURRENCY = (1024, 512, 256)
SERVE_PLAN_KV_BYTES = (1, 2)
CKPT_JOB = "vlm"            # the job whose final state goes through a checkpoint
# the job whose traces write through to a persistent trace store and
# whose admitted batch the admission daemon answers over a socket, then
# again from disk after a restart
DAEMON_JOB = "vlm"
# the daemon's fleet for its ``place`` and ``evacuate`` requests: nodes at
# the card's capacity (the daemon's default without --fleet-hbm-gib)
DAEMON_FLEET_NODES = 2
# ``fleet_colocate``: the job whose arrivals the fleet scheduler places,
# after its own turn. A and B are its largest batches of its gate's grid
# whose estimates together fit the card shared by two more processes (the
# CPU gate CLI at 77.73 GiB: batch 4 42,602.0 MiB, batch 2 21,982.0 MiB;
# 4 and 4 are 85,204 MiB, over the card); C arrives at the gate's
# admitted batch, which the hole A and B leave cannot take. The job traces
# A's and B's batches ahead with its gate's, so no decision traces
FLEET_JOB = "vlm"
FLEET_BATCHES = {"A": 4, "B": 2}
# nodes beside the card's (node000): other H100s at its capacity, each in
# a failure domain of its own (``build_fleet``'s round robin over 4)
FLEET_SIM_NODES = 3
# seconds the workers have to open their contexts, run and answer
FLEET_TIMEOUT_S = 300
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
    if causal and window is None and sq == sk:
        return sq * (sq + 1) // 2
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
    ``PLAIN_BATCH`` sequences at a time, or, past ``PLAIN_HEAD_AT_ONCE``
    positions, over one sequence's one head."""
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
        if S > PLAIN_HEAD_AT_ONCE:
            out = torch.empty_like(qt)
            G = H // Hkv
            for b in range(B):
                for h in range(H):
                    g = h // G
                    out[b:b + 1, h:h + 1] = attention_ref(
                        qt[b:b + 1, h:h + 1], kt[b:b + 1, g:g + 1],
                        vt[b:b + 1, g:g + 1], causal=True)
            return out
        outs = [attention_ref(qt[i:i + PLAIN_BATCH], kt[i:i + PLAIN_BATCH],
                              vt[i:i + PLAIN_BATCH], causal=True)
                for i in range(0, B, PLAIN_BATCH)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)
    if S <= PLAIN_HEAD_AT_ONCE:
        ref = plain()
        plain_ms = cuda_ms(plain, reps=2)
    else:                       # seconds a call: the one that makes ``ref``
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = plain()
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
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
                  serving_sweep: bool = False, after_serve_mix=None,
                  long: bool = False, capacity: int | None = None,
                  store_dir: str | None = None) -> None:
    """The serving main path of ``arch`` at full width, ``n_layers``
    deep (``None``: the config's depth), prompts of ``prompt_len``
    positions into a cache of ``max_len``, the gate over
    ``candidates``; its phases' names start with ``prefix``. With
    ``kernel_rows`` the path's kernel is first held against the plain
    version at the admitted batch's prefill shape (``kernel`` phase),
    and its rows join ``rows`` (their ``path``: ``arch``, and the
    prompt length on a ``long`` path); with ``serving_sweep`` the
    served decode is set beside the request-driven estimate's knob grid
    (``phase_serving_sweep``), then the request-driven gate
    (``phase_serve_mix``), after which ``after_serve_mix`` is called
    with the capacity the gates used. A ``long`` path skips the
    request alignment, the profile and the recurrent parity (its
    2048-token path runs them), and holds the kernel path's logits to
    the chunked attention's: dense scores at its length do not fit. The
    gates decide at ``capacity`` (default: what the card can hold), over
    the trace store ``store_dir`` when given (``SERVING_AHEAD``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    cfg = path_config(arch, n_layers, impl="flash")
    path = f"{arch} at {prompt_len}" if long else arch
    if capacity is None:
        capacity = srv.device_capacity()
    t0 = time.perf_counter()
    # decided through the admission service (its exact rung: the
    # estimator's replay at the capacity)
    batch, gate = srv.pick_batch(cfg, max_len, capacity,
                                 candidates=candidates, store_dir=store_dir)
    gate_s = time.perf_counter() - t0
    if batch is None:
        raise AssertionError(f"no batch fits: {gate['candidates']}")
    # the estimates at the shapes the run below uses (the gate traces
    # the prefill at a max_len prompt), replayed at the card's capacity
    # as the gate's are: near the ceiling the simulated allocator, as
    # the card's, frees its cached blocks and retries; ``phase_requests``
    # takes the prefill's trace from this estimator's cache
    est = serving_estimator(store_dir)
    prefill_fn = srv.make_prefill_fn(cfg)
    cache_abs = M.init_cache(cfg, batch, max_len, device="meta")
    t0 = time.perf_counter()
    pre_est = est.estimate_serving(
        prefill_fn, M.abstract_params(cfg), cache_abs,
        srv.prompt_specs(cfg, batch, prompt_len), capacity=capacity)
    pre_est_s = time.perf_counter() - t0
    dec_est = gate["decode"].report
    emit(f"{prefix}gate", config=cfg.name, n_layers=cfg.n_layers,
         capacity=capacity, seconds=gate_s,
         prefill_estimate_seconds=pre_est_s,
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
            path, shape, (fa.route(cfg.dtype, cfg.hd),), rand,
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
        if row["path"] == path:
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
        if after_serve_mix is not None:
            after_serve_mix(capacity)
    del res
    torch.cuda.empty_cache()
    if not long:
        phase_requests(cfg, params, batch, prefix, max_len, prompt_len, est,
                       prefill_fn)
        phase_profile(cfg, params, batch, prefix, prompt_len)
    if cfg.moe is not None:
        phase_experts(cfg, params, batch, prefix)
    if cfg.family in ("ssm", "hybrid") and not long:
        phase_recurrent_parity(cfg, prefix)
    if not attention_layers(cfg):
        return

    # the kernel path against the dense path (the chunked one on a long
    # path) at batch 1, same weights (the same argmax per codebook for
    # audio)
    against = "chunked" if long else "dense"
    dense = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl=against))
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
    emit(f"{prefix}parity", against=against, flash_vs_dense_rel=rel,
         tol=LOGITS_REL_TOL,
         same_argmax=same, max_abs_diff=(lf - ld).abs().max().item(),
         flip_leads=flips.tolist(),
         finite=bool(torch.isfinite(lf).all().item()),
         memory=device_memory())
    if not rel < LOGITS_REL_TOL:
        raise AssertionError(f"flash vs {against} logits: rel {rel}")


def serving_estimator(store_dir: str | None):
    """The estimator of a serving path's prefill estimate: over the
    trace store ``store_dir`` when given."""
    from repro_torch.core.cache import TraceCache
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.service import TraceStore
    if store_dir is None:
        return XMemEstimator.for_torch_gpu()
    return XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store_dir)))


def serving_paths() -> dict:
    """Each serving path after qwen3-32b's and phi3.5-moe's: phase
    prefix -> (arch, depth, max_len, prompt length)."""
    out = {}
    for arch, (prefix, max_len, prompt_len) in FULL_DEPTH_SERVING.items():
        out[prefix] = (arch, None, max_len, prompt_len)
    for arch, (prefix, n_layers) in RECURRENT_SERVING.items():
        out[prefix] = (arch, n_layers, MAX_LEN, PROMPT_LEN)
    for arch, (prefix, n_layers, _c) in LONG_SERVING.items():
        out[prefix] = (arch, n_layers, LONG_MAX_LEN, LONG_PROMPT)
    return out


def phase_serving_ahead(store_dir: str) -> None:
    """The serving gates of ``SERVING_AHEAD`` traced into the trace
    store ``store_dir``, in the order the paths run: each candidate's
    decode and prefill through the admission service over the store (at
    no capacity: the traces are the same at any), then the admitted
    batch's prefill at the path's prompt length, as ``phase_serving``
    estimates it. Uses no card."""
    import torch
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M

    torch.set_num_threads(1)
    paths = serving_paths()
    for prefix, candidates in SERVING_AHEAD.items():
        arch, n_layers, max_len, prompt_len = paths[prefix]
        cfg = path_config(arch, n_layers, impl="flash")
        for b in candidates:
            srv.pick_batch(cfg, max_len, 1 << 62, candidates=(b,),
                           store_dir=store_dir)
        b = candidates[-1]
        serving_estimator(store_dir).estimate_serving(
            srv.make_prefill_fn(cfg), M.abstract_params(cfg),
            M.init_cache(cfg, b, max_len, device="meta"),
            srv.prompt_specs(cfg, b, prompt_len))


@contextlib.contextmanager
def allocator_cap(headroom: int):
    """The caching allocator capped ``headroom`` under the card's
    capacity (``set_per_process_memory_fraction``), yielding the cap;
    uncapped again on exit."""
    import torch
    from repro_torch.launch import serve as srv
    total = torch.cuda.get_device_properties(0).total_memory
    fraction = (srv.device_capacity() - headroom) / total
    torch.cuda.set_per_process_memory_fraction(fraction)
    try:
        yield int(fraction * total)     # the allocator's own count
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)


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

    def counting(xg, topi, topv, n_experts, capacity, *experts):
        out = dispatch(xg, topi, topv, n_experts, capacity, *experts)
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
    if job == FLEET_JOB:
        ahead += [b for b in FLEET_BATCHES.values() if b not in ahead]
    for b in ahead:
        fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
        params, specs = M.abstract_params(cfg), input_specs(
            cfg, smoke_shape(TRAIN_SEQ, b))
        t0 = time.perf_counter()
        est.trace_phases(fwd_bwd, params, specs)    # the forward+backward
        fwd_s[b] = time.perf_counter() - t0
        est.trace_phases(fwd_bwd, params, specs, update, opt_init)
        trace_s[b] = time.perf_counter() - t0
    plan_ahead_s = {}
    if job == "dense":
        # the remediation search's microbatch candidates at the gate's
        # first batch: each a program of its own (f32 gradient sums)
        specs = input_specs(cfg, smoke_shape(TRAIN_SEQ, candidates[0]))
        for m in PLAN_MICROBATCHES:
            t0 = time.perf_counter()
            fwd_bwd, update, opt_init = make_estimator_hooks(
                cfg, dataclasses.replace(policy, microbatches=m))
            est.trace_phases(fwd_bwd, M.abstract_params(cfg), specs, update,
                             opt_init)
            plan_ahead_s[m] = time.perf_counter() - t0
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
        mesh = phase_dense_mesh_sweep(cfg, policy, service, capacity, gate)
        phase_plan_offers(cfg, policy, service, capacity, gate, truths,
                          plan_ahead_s, mesh)
        torch.cuda.empty_cache()
        phase_sharded("dense", Path(rows_path).parent, mesh)
    if job == "moe":
        torch.cuda.empty_cache()
        phase_sharded("moe", Path(rows_path).parent)
    if job == FLEET_JOB:
        # the workers import while the daemon phase runs on the CPU; each
        # waits on stdin, and exits when this process does
        workers = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--colocate-worker", job], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True) for _ in FLEET_BATCHES]
    if job == DAEMON_JOB:
        phase_admission_daemon(cfg, policy, est, store_dir, capacity, gate,
                               truth, truth_allocated, rel_reserved)
    if job == FLEET_JOB:
        phase_fleet_colocate(est, gate, workers)


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


class _RecordingService:
    """An admission service that keeps every decision by job id (the
    planner's candidates, feasible or not)."""

    def __init__(self, service):
        self.service, self.decisions, self.sweeps = service, {}, []
        self.cache, self.obs = service.cache, service.obs

    def decide(self, req):
        d = self.service.decide(req)
        self.decisions[req.job_id] = (req, d)
        return d

    def decide_sweep(self, reqs):
        out = self.service.decide_sweep(reqs)
        self.decisions.update((r.job_id, (r, d)) for r, d in zip(reqs, out))
        return out

    def mesh_sweep(self, *args, **kw):
        self.sweeps.append(self.service.mesh_sweep(*args, **kw))
        return self.sweeps[-1]


def mesh_grid(devices) -> list:
    from repro_torch.core.sweep import topology_grid
    return [t for n in devices for t in topology_grid(n)]


def collective_bytes(rep) -> dict:
    """The staging buffers the mesh sweep injected into a report's first
    iteration, by name (per device)."""
    from repro_torch.core.events import BlockKind
    return {b.scope: b.size for b in rep.composition.prefix
            if b.block_kind is BlockKind.COLLECTIVE}


def phase_dense_mesh_sweep(cfg, policy, service, capacity: int, gate: dict):
    """The admission service's mesh sweep of the gate's rejected batch
    over every topology of ``DENSE_MESH_DEVICES`` devices at the card's
    capacity, from the gate's cached trace: each topology's per-device
    estimate, persistent bytes, injected collective bytes and fit.
    Fails if the sweep traced."""
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks
    b0 = gate["candidates"][0]["batch"]
    fwd, upd, init = make_estimator_hooks(cfg, policy)
    res = service.mesh_sweep(
        fwd, M.abstract_params(cfg), input_specs(
            cfg, smoke_shape(TRAIN_SEQ, b0)), mesh_grid(DENSE_MESH_DEVICES),
        update_fn=upd, opt_init_fn=init, cfg=cfg, capacity=capacity)
    emit("dense_mesh_sweep", config=cfg.name, n_layers=cfg.n_layers,
         seq_len=TRAIN_SEQ, batch=b0, capacity=capacity,
         single_device=gate["decisions"][b0].peak_bytes,
         stats=res.stats, rows=[{
             "topology": t.label, "devices": t.n_devices, "model": t.model,
             "fsdp": t.fsdp, "peak": r.peak_bytes,
             "tensor_peak": r.peak_tensor_bytes,
             "persistent": r.persistent_bytes, "oom": r.oom,
             "fits": not r.oom and r.peak_bytes <= capacity,
             "collectives": collective_bytes(r)} for t, r in res])
    if res.stats["trace_cache"]["misses"]:
        raise AssertionError(f"dense_mesh_sweep traced: {res.stats}")
    return res


def sharded_specs(groups=None, job: str | None = None) -> list[dict]:
    """``SHARDED_RUNS`` (those of ``groups``, default all, and of
    ``job``, default every job) with their configs, shapes and policies:
    ``TOPOLOGY_GROUPS`` a topology's own (``MeshTopology.
    sharding_policy``, the training job's optimizer), the others the dry
    run's for the job's full config. A MoE config dispatches in as many
    groups as the batch axes have ranks (the dry run's
    ``_with_moe_groups``). Serving attends through the kernel, as
    ``launch/serve.py`` serves."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.sweep import MeshTopology
    from repro_torch.launch import dryrun
    out = []
    for run_job, label, layers, (seq, batch, kind), dims, names, group, \
            steps in SHARDED_RUNS:
        if (groups is not None and group not in groups
                or job is not None and run_job != job):
            continue
        arch = TRAIN_JOBS[run_job][0]
        full = get_config(arch)
        sizes = dict(zip(names, dims))
        cfg = dryrun._with_moe_groups(path_config(
            arch, layers, impl=None if kind == "train" else "flash"), sizes)
        if group in TOPOLOGY_GROUPS:
            topo = MeshTopology(sizes.get("pod", 1), sizes.get("data", 1),
                                sizes["model"])
            spolicy, tpolicy = topo.sharding_policy(), train_policy(run_job)
        else:
            topo = MeshTopology(sizes.get("pod", 1), sizes["data"],
                                sizes["model"], fsdp=True)
            spolicy = dryrun.arch_sharding_policy(full, sizes)
            tpolicy = dryrun.arch_train_policy(full.name, full)
        out.append({"job": run_job, "label": label, "cfg": cfg,
                    "kind": kind, "dims": dims,
                    "names": names, "group": group, "steps": steps,
                    "shape": ShapeSpec(label, seq, batch, kind),
                    "topology": topo, "spolicy": spolicy,
                    "tpolicy": tpolicy if kind == "train" else None})
    return out


def sweep_row(spec, est) -> dict:
    """The mesh sweep's per-device estimate of ``spec``'s topology, from
    one device's trace of the global step (``SpecShardFactors`` and the
    collective staging; training through ``estimate_mesh_sweep``, as
    ``dense_mesh_sweep`` sweeps)."""
    from repro_torch.configs.registry import (abstract_cache,
                                              decode_input_specs,
                                              input_specs)
    from repro_torch.core.sweep import SweepService
    from repro_torch.distributed.program import _prefill_step
    from repro_torch.distributed.sharding import shard_factor_fn
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks
    from repro_torch.train.train_step import make_serve_step
    cfg, shape, topo = spec["cfg"], spec["shape"], spec["topology"]
    params = M.abstract_params(cfg)
    t0 = time.perf_counter()
    if spec["kind"] == "train":
        fwd, upd, init = make_estimator_hooks(cfg, spec["tpolicy"])
        res = SweepService(est).estimate_mesh_sweep(
            fwd, params, input_specs(cfg, shape), [topo], update_fn=upd,
            opt_init_fn=init, cfg=cfg)
        rep = list(res)[0][1]
        coll = collective_bytes(rep)
    else:
        if spec["kind"] == "prefill":
            step, cache = _prefill_step(cfg), {}
            batch = input_specs(cfg, shape)
        else:
            step = make_serve_step(cfg, shape.seq_len - 1)
            cache = abstract_cache(cfg, shape)
            batch = decode_input_specs(cfg, shape)
        rep = est.estimate_serving(step, params, cache, batch,
                                   shard_factor_fn=shard_factor_fn(
                                       cfg, topo.axis_sizes,
                                       topo.sharding_policy(),
                                       params=params, batch=batch,
                                       cache=cache or None))
        coll = {}
    return {"topology": topo.label, "peak": rep.peak_bytes,
            "tensor_peak": rep.peak_tensor_bytes,
            "persistent": rep.persistent_bytes, "collectives": coll,
            "seconds": time.perf_counter() - t0}


def sharded_ahead(groups: str, out_path: str) -> None:
    """On the CPU, no card: each run of ``groups`` (``SHARDED_RUNS``)
    estimated as rank 0's program (``launch/dryrun.py``: the xMem
    estimate of the local trace, its local counts) under a ``fake``
    process group of the mesh's size, and the mesh sweep's row for its
    topology; written to ``out_path`` as each run ends."""
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from torch.distributed.device_mesh import init_device_mesh
    _quiet_dtensor()
    out = {}
    for spec in sharded_specs(groups.split(",")):
        n = 1
        for d in spec["dims"]:
            n *= d
        row = {}
        with fake_world(n):
            mesh = init_device_mesh("cpu", spec["dims"],
                                    mesh_dim_names=spec["names"])
            job = dryrun.build_job(spec["cfg"], spec["shape"], mesh,
                                   spec["spolicy"], spec["tpolicy"])
            t0 = time.perf_counter()
            rep = dryrun.estimate(job)
            row["estimate_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            counter, how = dryrun.count(spec["cfg"], spec["shape"], mesh,
                                        spec["spolicy"], spec["tpolicy"])
            row.update(count_s=time.perf_counter() - t0, counted=how)
        row.update(estimate=rep.peak_bytes,
                   sim_segments_mib=sorted(round(x["size"] / 2**20, 1)
                                           for x in rep.sim.segments),
                   tensor_estimate=rep.peak_tensor_bytes,
                   persistent=rep.persistent_bytes, depth=rep.depth,
                   argument_bytes=dryrun.local_bytes(job.local),
                   flops=counter.flops, bytes_accessed=counter.bytes_accessed,
                   flops_by_op=dict(counter.flops_by_op),
                   ops=counter.ops, collectives=counter.collectives())
        row["sweep"] = sweep_row(spec, XMemEstimator.for_torch_gpu())
        out[spec["label"]] = row
        Path(out_path + ".tmp").write_text(json.dumps(out))
        os.replace(out_path + ".tmp", out_path)


def ahead_path(rows_dir: Path, group: str) -> Path:
    """The file the ``--sharded-ahead`` process of ``group`` writes."""
    groups = next(g for g in SHARDED_AHEAD if group in g.split(","))
    return Path(rows_dir) / f"sharded_{groups.replace(',', '')}.json"


def _quiet_dtensor() -> None:
    """DTensor warns at every redistribution that runs more than one
    collective (a partial over two mesh dims): keep them off stderr."""
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def _wait_for(path: Path, label: str) -> dict:
    deadline = time.monotonic() + SHARDED_AHEAD_TIMEOUT_S
    while True:
        if path.exists():
            got = json.loads(path.read_text())
            if label in got:
                return got[label]
        if time.monotonic() > deadline:
            raise AssertionError(f"no sharded estimate of {label} in "
                                 f"{path}")
        time.sleep(1.0)


def phase_sharded(job: str, rows_dir: Path, mesh=None,
                  groups=None) -> None:
    """Rank 0 of ``job``'s sharded programs (its ``SHARDED_RUNS``: qwen3-32b
    for "dense", phi3.5-moe for "moe") on the card, the ``<job>_sharded``
    phase: each under a ``fake`` process group of its mesh's size (its
    collectives move no data, and NCCL's buffers are absent), with real
    local shards on the card, its training steps or one serving step,
    beside its estimate made ahead (``--sharded-ahead``). Fails on an out
    of memory, an estimate outside ``RESERVED_TOL`` reserved or outside
    ``ALLOCATED_TOL`` (training) / ``SERVING_ALLOCATED_TOL`` (serving)
    allocated, a run of group "a" whose mesh-sweep row is more than
    ``RESERVED_TOL`` under the card's reserved peak (the sharded estimate
    safety rule), a sharded prefill that launched no kernel, or a kernel
    at rank 0's local shape that differs from its plain version. The
    other runs' sweep rows are reported. ``mesh``: the dense job's
    ``dense_mesh_sweep`` rows, each "a" row held to the ahead sweep's."""
    import torch
    _quiet_dtensor()
    phase = f"{job}_sharded"
    specs = sharded_specs(groups, job)
    swept = {t.label: r.peak_bytes for t, r in mesh} if mesh else {}
    runs, violations = [], []
    # the serving runs' processes import while the training runs use the
    # card; each waits for a line on stdin before its first CUDA call
    serving = {spec["label"]: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-serving",
         spec["label"], str(rows_dir)], stdin=subprocess.PIPE, text=True)
        for spec in specs if spec["kind"] != "train"}
    try:
        for spec in specs:
            label = spec["label"]
            ahead = _wait_for(ahead_path(rows_dir, spec["group"]), label)
            if spec["kind"] == "train":
                torch.cuda.empty_cache()
                card = sharded_card_run(spec)
            else:
                # a serving job's process of its own: its cuBLAS workspace
                # is made at its first matmul, as its estimate has it
                # (this one holds the training runs' two from the start)
                child = serving.pop(label)
                child.stdin.write("go\n")
                child.stdin.close()
                if child.wait(timeout=600) != 0:
                    raise AssertionError(f"{phase} {label}: exit "
                                         f"{child.returncode}")
                card = json.loads(card_path(rows_dir, label).read_text())
            if "oom" in card:
                violations.append(f"{label}: {card['oom']}")
                continue
            run = sharded_record(spec, ahead, card, swept.get(label),
                                 violations)
            runs.append(run)
            emit(f"{phase}_run", **run)
            with open(Path(rows_dir) / f"{phase}_runs.jsonl", "a") as f:
                f.write(json.dumps(run) + "\n")
    finally:
        for child in serving.values():      # not reached: a run failed
            child.kill()
            child.wait()
    emit(phase, config=TRAIN_JOBS[job][0], runs=[r["run"] for r in runs],
         note="under the fake process group the collectives move no data "
              "and NCCL's buffers are absent; their bytes are what rank 0 "
              "would move", violations=violations, memory=device_memory())
    if violations:
        raise AssertionError(f"{phase}: {violations}")


def sharded_record(spec, ahead: dict, card: dict, swept, violations: list
                   ) -> dict:
    """One ``<job>_sharded`` run's line: the card's run beside its
    estimate made ahead, the mesh sweep's row (and ``swept``,
    ``dense_mesh_sweep``'s row for the topology, which must equal it),
    the local counts; each broken rule appended to ``violations``."""
    import math
    from repro_torch.launch import dryrun
    label, train = spec["label"], spec["kind"] == "train"
    launches = card.pop("launches")
    rel_r = (ahead["estimate"] - card["reserved"]) / card["reserved"]
    rel_a = (ahead["tensor_estimate"] - card["allocated"]) / card["allocated"]
    sweep = ahead["sweep"]
    sweep_rel = (sweep["peak"] - card["reserved"]) / card["reserved"]
    run = {"run": label, "mesh": dict(zip(spec["names"], spec["dims"])),
           "layers": spec["cfg"].n_layers, "kind": spec["kind"],
           "seq_len": spec["shape"].seq_len,
           "global_batch": spec["shape"].global_batch,
           "fsdp": spec["spolicy"].fsdp,
           "microbatches": spec["tpolicy"].microbatches if train else None,
           "steps": spec["steps"], **card,
           **{k: ahead[k] for k in ("estimate", "tensor_estimate",
                                    "persistent", "argument_bytes",
                                    "estimate_s", "depth", "collectives",
                                    "counted")},
           "rel_reserved": rel_r, "rel_allocated": rel_a,
           "sweep": sweep, "sweep_rel_reserved": sweep_rel,
           "local_flops": ahead["flops"],
           "local_flops_by_op": ahead["flops_by_op"],
           "local_ops": ahead["ops"],
           "analytic_flops": dryrun.analytic_flops(
               spec["cfg"], spec["shape"]) / spec["topology"].n_devices,
           "kernel_launches": launches}
    if swept is not None:
        run["dense_mesh_sweep_row"] = swept
        if swept != sweep["peak"]:
            violations.append(f"{label}: the sweep row ahead "
                              f"{sweep['peak']} B, dense_mesh_sweep's "
                              f"{swept} B")
    if train and not all(math.isfinite(x) for x in card["losses"]):
        run["losses_note"] = ("the fake group's collectives return "
                              "unwritten buffers: losses not checked")
    if abs(rel_r) > RESERVED_TOL:
        violations.append(f"{label}: estimate {rel_r:+.4%} reserved")
    if abs(rel_a) > (ALLOCATED_TOL if train else SERVING_ALLOCATED_TOL):
        violations.append(f"{label}: estimate {rel_a:+.4%} allocated")
    if spec["group"] == "a" and sweep_rel < -RESERVED_TOL:
        violations.append(f"{label}: the mesh sweep's estimate "
                          f"{sweep_rel:+.4%} under the card's reserved peak")
    if spec["kind"] == "prefill" and not launches["sm90"]:
        violations.append(f"{label}: the sharded prefill launched no sm90 "
                          f"kernel ({launches})")
    return run


def card_path(rows_dir, label: str) -> Path:
    """Where a ``--sharded-serving`` process writes its card run."""
    return Path(rows_dir) / f"card_{label.replace(' ', '_')}.json"


def sharded_card_run(spec) -> dict:
    """Rank 0 of ``spec``'s program on the card (``dryrun.run_on_card``)
    under a ``fake`` process group of its mesh's size, with its kernel
    launches (``launches``), or ``{"oom": ...}``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for d in spec["dims"]:
        n *= d
    fa.reset_launches()
    try:
        with fake_world(n):
            mesh = init_device_mesh("cuda", spec["dims"],
                                    mesh_dim_names=spec["names"])
            card = dryrun.run_on_card(dryrun.build_job(
                spec["cfg"], spec["shape"], mesh, spec["spolicy"],
                spec["tpolicy"]), steps=spec["steps"])
    except torch.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return {"oom": f"out of memory: {str(e).splitlines()[0]}"}
    card["launches"] = dict(fa.launches_by_kernel)
    return card


def sharded_serving(label: str, rows_dir: str) -> None:
    """A serving run of ``SHARDED_RUNS`` (``label``) in a process of its
    own, once a line on stdin says it is its turn: its card run and, for
    the prefill, the kernel's row at rank 0's local shape; to
    ``rows_dir``/card_<label>.json."""
    _quiet_dtensor()
    spec = next(s for s in sharded_specs() if s["label"] == label)
    # imported before the turn: the import is most of a start
    from repro_torch.launch import dryrun  # noqa: F401
    if sys.stdin.readline().strip() != "go":
        raise AssertionError(f"{label}: no turn on the card")
    card = sharded_card_run(spec)
    if spec["kind"] == "prefill" and "oom" not in card:
        card["kernel"] = sharded_kernel_row(Path(rows_dir), spec["job"],
                                            card["launches"]["sm90"])
    card_path(rows_dir, label).write_text(json.dumps(card))


def sharded_kernel_row(rows_dir: Path, job: str, launches: int) -> dict:
    """The sm90 kernel at ``job``'s sharded prefill's local shape
    (``SHARDED_KERNEL_SHAPES``) against its plain version, its time, bound
    and SDPA's; ``launches`` from the sharded prefill. Written to
    ``rows_dir`` (``kernel_row_path``) for the parent's ``kernels``
    line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    shape = SHARDED_KERNEL_SHAPES[job]
    got, cases, lim = serving_shape_rows(
        f"{job}_sharded prefill_32k", shape, ("sm90",), rand,
        torch.nn.functional.scaled_dot_product_attention)
    row = dict(got[0], launches=launches)
    kernel_row_path(rows_dir, job).write_text(json.dumps(row))
    emit(f"{job}_sharded_kernel", cases=cases, row=row,
         shape=shape_summary(shape, got, lim))
    return row


def kernel_row_path(rows_dir: Path, job: str) -> Path:
    """Where ``job``'s sharded prefill kernel row is written."""
    return Path(rows_dir) / f"{job}_sharded_kernel.json"


def phase_plan_offers(cfg, policy, service, capacity: int, gate: dict,
                      truths: dict, ahead_s: dict, mesh) -> None:
    """The remediation planner on the dense job's rejection: the gate's
    decision at its first candidate is the baseline of
    ``RemediationPlanner.plan`` at the card's capacity over the default
    batch, microbatch and remat axes, the topologies of
    ``DENSE_MESH_DEVICES`` devices and host offload (optimizer state,
    and half the activations on top). Every candidate is listed with its
    decision; each topology offer is held to ``mesh``'s row (the
    ``dense_mesh_sweep`` phase's) to the byte. Each offer the port's
    step can run (not offload, which neither step executes; not a
    topology, a device's share) is held to the card: at a batch the card
    measured at 1 microbatch (``truths``: the train run, DirectProbe's
    probes) against that truth, and the cheapest runnable offer without
    one run for ``TRAIN_STEPS`` steps (at most one run). Fails if an
    offer ran out of memory on the card, reserved more than the
    capacity, missed its truth by more than ``RESERVED_TOL``, if an
    offer's ``admission_request`` decided again differs from it, if a
    topology offer differs from its row, or if the search traced more
    than its microbatch and remat candidates."""
    import math

    import torch
    from repro_torch.configs.base import smoke_shape
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M
    from repro_torch.plan import PlanSpace, RemediationPlanner

    b0 = gate["candidates"][0]["batch"]
    baseline = gate["decisions"][b0]
    shape = smoke_shape(TRAIN_SEQ, b0)
    space = PlanSpace(devices=DENSE_MESH_DEVICES, offload_opt_state=True,
                      offload_activations=PLAN_OFFLOAD_ACTIVATIONS,
                      max_offers=64)
    recording = _RecordingService(service)
    res = RemediationPlanner(recording).plan(
        cfg, policy, shape, capacity=capacity, space=space,
        job_id=f"{cfg.name}-plan", baseline=baseline)
    candidates = []
    for job_id, (req, d) in recording.decisions.items():
        candidates.append({
            "job_id": job_id, "admit": d.admit, "peak": d.peak_bytes,
            "safe_threshold": d.safe_threshold, "source":
                d.provenance["source"], "rung": d.rung,
            "oom": d.report.oom if d.report is not None else None,
            "space_peaks": d.breakdown.get("space_peaks"),
            "offload": d.breakdown.get("offload")})
    for res_mesh in recording.sweeps:
        candidates.extend({
            "job_id": f"topology/{t.label}", "peak": r.peak_bytes,
            "admit": not r.oom and r.peak_bytes <= capacity,
            "source": "mesh-sweep", "oom": r.oom} for t, r in res_mesh)
    rows_mesh = {t.label: r for t, r in mesh}
    violations = []
    rows, ran = [], False
    for rank, o in enumerate(res.offers, 1):
        again = service.decide(o.admission_request(cfg, policy, shape,
                                                   capacity=capacity))
        row = {"rank": rank, **o.to_json(),
               "reproduced": again.admit and again.peak_bytes
               == o.peak_bytes}
        if not row["reproduced"]:
            violations.append(f"offer {rank}: decided again "
                              f"{again.admit} {again.peak_bytes}")
        if o.topology is not None:
            swept = rows_mesh[o.topology.label].peak_bytes
            row["sweep_row"] = swept
            if swept != o.peak_bytes:
                violations.append(f"offer {rank}: {o.peak_bytes} B, its "
                                  f"sweep row {swept} B")
        runnable = o.knob in ("batch", "microbatch", "remat")
        truth = truths.get(o.global_batch) if o.microbatches == 1 \
            and o.remat == cfg.remat else None
        if o.knob == "topology":
            row["card"] = "a device's share: dense_sharded runs rank 0"
        elif not runnable:
            row["card"] = "an estimate only: neither step executes host " \
                "offload"
        elif isinstance(truth, int):
            row.update(card="measured before", truth=truth)
        elif not ran:
            ran = True
            cfg2, pol2, shape2 = o.apply(cfg, policy, shape)
            torch.cuda.empty_cache()
            params = M.init_params(cfg2, 0, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                got = trn.train_loop(cfg2, shape2, pol2, steps=TRAIN_STEPS,
                                     device="cuda", params=params)
                truth = got.reserved
                losses = got.out.losses
                row.update(card="run here", truth=truth,
                           allocated=got.allocated,
                           losses=losses, step_ms=[x * 1e3 for x in
                                                   got.out.step_s],
                           run_s=time.perf_counter() - t0)
                if not all(math.isfinite(x) for x in losses):
                    violations.append(f"offer {rank}: loss {losses}")
                del got
            except torch.OutOfMemoryError as e:
                row.update(card="out of memory",
                           error=str(e).splitlines()[0])
                violations.append(f"offer {rank} ran out of memory")
                truth = None
            del params
            torch.cuda.empty_cache()
        else:
            row["card"] = "not run (one new run a search)"
        if runnable and isinstance(truth, int):
            rel = (o.peak_bytes - truth) / truth
            row["rel_err_reserved"] = rel
            if truth > capacity:
                violations.append(f"offer {rank}: reserved {truth} > "
                                  f"capacity {capacity}")
            if abs(rel) > RESERVED_TOL:
                violations.append(f"offer {rank}: {rel:+.4%} off the card")
        rows.append(row)
    singles = res.stats["axes"].get("microbatch", 0) \
        + res.stats["axes"].get("remat", 0)
    if res.stats["fresh_traces"] > singles:
        violations.append(f"{res.stats['fresh_traces']} fresh traces for "
                          f"{singles} microbatch and remat candidates")
    if res.baseline.admit or not res.offers:
        violations.append(f"no search: admit {res.baseline.admit}, "
                          f"{len(res.offers)} offers")
    emit("plan_offers", config=cfg.name, n_layers=cfg.n_layers,
         seq_len=TRAIN_SEQ, batch=b0, capacity=capacity,
         baseline={"peak": baseline.peak_bytes, "admit": baseline.admit,
                   "oom": baseline.report.oom},
         fresh_traces=res.stats["fresh_traces"],
         baseline_traces=res.stats["baseline_traces"],
         wall_s=res.stats["wall_s"], stats=res.stats,
         traced_ahead_s={str(m): x for m, x in ahead_s.items()},
         candidates=candidates, offers=rows,
         truths={str(b): t for b, t in truths.items()},
         violations=violations, memory=device_memory())
    if violations:
        raise AssertionError(f"plan_offers: {violations}")


def phase_depth_compose(out_path: str, loops: bool = False) -> None:
    """Depth and loop composition at full width, in a process of its
    own that uses no card: for each job of ``DEPTH_FULL_JOBS``, the
    estimate from its composed trace (``core/depth.py``: probes of 2, 3
    and 4 units; ``core/loops.py``: each long loop run 6 and 7 steps, a
    loop nested in a long loop's steps too) beside the estimate from the
    full trace, each with its wall and CPU seconds, split between the
    trace (its probes and synthesis apart) and the replay; then each
    estimate of ``DEPTH_ESTIMATES``: its bytes, source and seconds, and,
    once ``go CAPACITY`` arrives on stdin, the decision replayed at that
    capacity (the parent's serving capacity; the traces from the cache):
    admit or reject; and xlstm-1.3b's prefill at its published depth
    (``LOOPS_PREFILL``). The rows of ``LOOP_ARCHS`` run in a process of
    their own (``loops``), started first, which reads the same ``go
    CAPACITY`` line and whose rows join this one's. Writes one JSON
    object to ``out_path``; fails if any composed estimate differs from
    its full one by a byte, or any trace was not composed where its
    stack is deeper than the depth probes or its step has a loop of
    ``MIN_STEPS`` or more bodies."""
    from repro_torch.configs.base import smoke_shape
    from repro_torch.configs.registry import input_specs
    from repro_torch.core.depth import PROBE_UNITS
    from repro_torch.core.estimator import XMemEstimator, trace_fwd_in_full
    from repro_torch.core.loops import MIN_STEPS
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train import make_estimator_hooks

    def timed(fn):
        w0, c0 = time.perf_counter(), time.process_time()
        out = fn()
        return out, time.perf_counter() - w0, time.process_time() - c0

    def job_args(arch, n_layers, job, batch, seq):
        cfg = path_config(arch, n_layers)
        fwd, upd, init = make_estimator_hooks(cfg, train_policy(job))
        return cfg, (fwd, M.abstract_params(cfg),
                     input_specs(cfg, smoke_shape(seq, batch)),
                     upd, init)

    def row(rep) -> dict:
        loops = rep.depth.get("loops", {})
        return {"estimate": rep.peak_bytes, "tensor": rep.peak_tensor_bytes,
                "persistent": rep.persistent_bytes, "oom": rep.oom,
                "depth": rep.depth,
                # the loops' probes and synthesis, inside the trace
                "probe_s": loops.get("probe_s"),
                "synth_s": loops.get("synth_s")}

    def composed(cfg, seq, rep) -> bool:
        """Composed where it should be: by depth past the probes'
        units, by steps where the step has a loop of ``MIN_STEPS`` or
        more bodies (the recurrent blocks' loops; chunked attention's
        query and key loops)."""
        d = rep.depth
        if M.repeat_unit(cfg)[0] > sum(PROBE_UNITS) \
                and d.get("source") != "composed":
            return False
        att = cfg.attention
        long_attention = cfg.family != "ssm" and seq > att.dense_threshold \
            and -(-seq // min(att.chunk_q, att.chunk_kv)) >= MIN_STEPS
        return not (cfg.family in ("ssm", "hybrid") or long_attention) \
            or d.get("loops", {}).get("source") == "composed"

    def split(trace, replay) -> dict:
        """An estimate's trace and replay, each timed (wall, CPU s), and
        when in this process's run it began (``at_s``)."""
        at = time.perf_counter() - _T0
        phases, trace_s, trace_cpu = timed(trace)
        rep, replay_s, replay_cpu = timed(lambda: replay(phases))
        return rep, {"at_s": at, "seconds": trace_s + replay_s,
                     "cpu_s": trace_cpu + replay_cpu, "trace_s": trace_s,
                     "trace_cpu_s": trace_cpu, "replay_s": replay_s,
                     "replay_cpu_s": replay_cpu}

    def mine(arch) -> bool:
        return (arch in LOOP_ARCHS) == loops

    child = None
    if not loops:
        loops_out = f"{out_path}.loops"
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--depth-compose-loops", loops_out], stdin=subprocess.PIPE,
            text=True)
    try:
        bad = []
        ahead = []
        for arch, n_layers, job, batch, seq in DEPTH_ESTIMATES:
            if not mine(arch):
                continue
            cfg, args = job_args(arch, n_layers, job, batch, seq)
            fwd, params, specs, upd, init = args
            est = XMemEstimator.for_torch_gpu()
            rep, t = split(
                lambda: est.trace_phases(fwd, params, specs, upd, init),
                lambda phases: est.estimate_from_phases(*phases))
            ahead.append((cfg, job, batch, seq, args, est, rep, t))
        prefill = None
        if loops:
            # xlstm-1.3b's serving estimate at its published depth: the
            # prefill its gate traces at the batch it admits
            cfg = path_config(SSM_ARCH)
            batch, prompt = LOOPS_PREFILL
            est = XMemEstimator.for_torch_gpu()
            step, params = srv.make_prefill_fn(cfg), M.abstract_params(cfg)
            cache = M.init_cache(cfg, batch, MAX_LEN, device="meta")
            prompts = srv.prompt_specs(cfg, batch, prompt)
            at = time.perf_counter() - _T0
            first, first_s, first_cpu = timed(lambda: est.estimate_serving(
                step, params, cache, prompts))
            _again, replay_s, replay_cpu = timed(lambda: est.estimate_serving(
                step, params, cache, prompts))
            prefill = {"config": cfg.name, "n_layers": cfg.n_layers,
                       "batch": batch, "prompt": prompt, "max_len": MAX_LEN,
                       **row(first), "at_s": at, "seconds": first_s,
                       "cpu_s": first_cpu,
                       "trace_s": first_s - replay_s, "replay_s": replay_s,
                       "replay_cpu_s": replay_cpu, "events": first.num_events}
            if not composed(cfg, prompt, first):
                bad.append(f"{cfg.name} prefill")
        full_rows = []
        for job, batch, seq in DEPTH_FULL_JOBS:
            arch, n_layers, _ = TRAIN_JOBS[job]
            if not mine(arch):
                continue
            cfg, (fwd, params, specs, upd, init) = job_args(
                arch, n_layers, job, batch, seq)
            est = XMemEstimator.for_torch_gpu()
            comp, comp_t = split(
                lambda: est.trace_phases(fwd, params, specs, upd, init),
                lambda phases: est.estimate_from_phases(*phases))
            ref = XMemEstimator.for_torch_gpu()
            full, full_t = split(
                lambda: ref.trace_phases(
                    fwd, params, specs, upd, init,
                    fwd=trace_fwd_in_full(fwd, params, specs)),
                lambda phases: ref.estimate_from_phases(*phases))
            equal = all(getattr(comp, f) == getattr(full, f) for f in (
                "peak_bytes", "peak_tensor_bytes", "persistent_bytes", "oom"))
            full_rows.append({"job": job, "config": cfg.name,
                              "n_layers": cfg.n_layers, "batch": batch,
                              "seq_len": seq,
                              "composed": {**row(comp), **comp_t},
                              "full": {**row(full), **full_t},
                              "events": comp.num_events,
                              "equal_bytes": equal})
            if not equal or not composed(cfg, seq, comp):
                bad.append(job)
        line = sys.stdin.readline()
        if child is not None:
            child.stdin.write(line)
            child.stdin.close()
        word, capacity = line.split()
        if word != "go":
            raise AssertionError("depth_compose: no capacity")
        capacity = int(capacity)
        published = []
        for cfg, job, batch, seq, args, est, rep, t in ahead:
            fwd, params, specs, upd, init = args
            # an unbounded replay whose peak fits never asks for more than
            # the capacity, so a replay at the capacity is the same one: it
            # admits; past the capacity the allocator frees its cache and
            # retries, which only a replay at the capacity shows
            at, decide_s = rep, 0.0
            if rep.peak_bytes > capacity:
                at, decide_s, _ = timed(lambda: est.estimate_training(
                    fwd, params, specs, update_fn=upd, opt_init_fn=init,
                    capacity=capacity))
            published.append({
                "config": cfg.name, "n_layers": cfg.n_layers, "job": job,
                "batch": batch, "seq_len": seq, **row(rep), **t,
                "events": rep.num_events,
                "admit": not at.oom and at.peak_bytes <= capacity,
                "decide_seconds": decide_s})
            if not composed(cfg, seq, rep):
                bad.append(f"{cfg.name} {cfg.n_layers} layers at {seq}")
        if child is not None:
            if child.wait(timeout=900) != 0:
                raise AssertionError(f"depth_compose: its loops process "
                                     f"failed: exit {child.returncode}")
            got = json.loads(Path(loops_out).read_text())
            full_rows += got["against_full"]
            published += got["published"]
            prefill = got["prefill"]
        Path(out_path).write_text(json.dumps({
            "capacity": capacity, "against_full": full_rows,
            "published": published, "prefill": prefill}))
        if bad:
            raise AssertionError(f"depth_compose: {bad} not composed or not "
                                 f"equal to the full trace")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()


def phase_serve_plan(out_path: str) -> None:
    """The serving remediation search, in a process of its own that
    uses no card: it waits for a line ``go CAPACITY`` (the main
    process's serving capacity, sent after ``serve_mix``), then runs
    ``pick_serving`` for qwen3-32b's 8-layer serving cell on a burst of
    ``SERVE_PLAN_REQUESTS`` requests at ``max_concurrent`` as many, page
    16 and 2-byte KV, with the serving knob grid as its plan space. It
    writes the ``serve_plan`` line's fields to ``out_path``, for the
    main process to print. Fails if the search and its baseline traced
    more than ``serving_trace_budget`` (1 + the grid's concurrencies),
    if the best offer decided again through ``decide_serving`` with its
    ``serving_knobs()`` differs from it, or if an offer's worst case is
    over the capacity."""
    from repro_torch.core.cache import TraceCache
    from repro_torch.core.orchestrator import (RequestSpec, RequestStream,
                                               ServingKnobs)
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.plan import PlanSpace, serving_trace_budget
    from repro_torch.service import AdmissionService

    line = sys.stdin.readline().split()
    if line[:1] != ["go"]:
        raise AssertionError(f"serve_plan: no capacity ({line})")
    capacity = int(line[1])
    cfg = path_config("qwen3-32b", N_LAYERS, impl="flash")
    stream = RequestStream(tuple(
        RequestSpec(arrival_t=0, prompt_len=PROMPT_LEN,
                    decode_len=DECODE_TOKENS)
        for _ in range(SERVE_PLAN_REQUESTS)))
    knobs = ServingKnobs(page_size=16, max_concurrent=SERVE_PLAN_REQUESTS,
                         kv_dtype_bytes=2)
    space = PlanSpace(page_sizes=SERVE_PLAN_PAGES,
                      max_concurrents=SERVE_PLAN_CONCURRENCY,
                      kv_dtypes=SERVE_PLAN_KV_BYTES)
    budget = serving_trace_budget(space, knobs)
    svc = AdmissionService(workers=1, cache=TraceCache())
    t0 = time.perf_counter()
    decision, gate = srv.pick_serving(cfg, stream, capacity, knobs=knobs,
                                      space=space, max_len=MAX_LEN,
                                      service=svc)
    search_s = time.perf_counter() - t0
    plan = decision.provenance.get("plan", {})
    traces = decision.provenance["trace_cache"]["misses"] \
        + plan.get("fresh_traces", 0)
    offers = decision.counter_offers or []
    violations = []
    if decision.admit or not offers or "error" in plan:
        violations.append(f"no offers: admit {decision.admit}, {plan}")
    if traces > budget:
        violations.append(f"{traces} traces over the budget {budget}")
    over = [o.peak_bytes for o in offers if o.peak_bytes > capacity]
    if over:
        violations.append(f"offers over the capacity: {over}")
    again = None
    if offers:
        best = offers[0]
        k = best.serving_knobs()
        t1 = time.perf_counter()
        kv_tok = gate["kv_bytes_per_token"]
        again = svc.decide_serving(
            f"{cfg.name}-best-again", srv.make_decode_fn(cfg),
            M.abstract_params(cfg),
            M.init_cache(cfg, k.max_concurrent, MAX_LEN, device="meta"),
            srv.decode_input(cfg, k.max_concurrent), capacity=capacity,
            mix=stream, knobs=k, kv_bytes_per_token=kv_tok,
            resident_bytes_per_request=gate["resident_bytes_per_request"])
        again_s = time.perf_counter() - t1
        if not (again.admit and again.peak_bytes == best.peak_bytes
                and again.breakdown["serving"] == best.serving):
            violations.append(f"best offer decided again: {again.admit} "
                              f"{again.peak_bytes} vs {best.peak_bytes}")
    Path(out_path).write_text(json.dumps({
        "config": cfg.name, "n_layers": cfg.n_layers,
        "requests": SERVE_PLAN_REQUESTS, "prompt_len": PROMPT_LEN,
        "decode_tokens": DECODE_TOKENS, "arrival": "all at tick 0",
        "capacity": capacity, "knobs": dataclasses.asdict(knobs),
        "kv_bytes_per_token": gate["kv_bytes_per_token"],
        "baseline": {"admit": decision.admit,
                     "worst": decision.peak_bytes,
                     "serving": gate["serving"]},
        "trace_budget": budget, "traces": traces,
        "baseline_traces": decision.provenance["trace_cache"]["misses"],
        "stats": plan, "search_s": search_s,
        "offers": [{"rank": i, **o.to_json()}
                   for i, o in enumerate(offers, 1)],
        "best_again": None if again is None else {
            "admit": again.admit, "peak": again.peak_bytes,
            "traces": again.provenance["trace_cache"]["misses"],
            "seconds": again_s},
        "violations": violations}))
    if violations:
        raise AssertionError(f"serve_plan: {violations}")


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
    ``stats``, a malformed line (a structured error on a live
    connection) and a ``plan`` request for the admitted batch (it
    already fits: no offers, no trace). Then the daemon drains and stops, a
    second one starts over a fresh service on the same store directory,
    and the same request must come back with the same bytes from disk,
    with no trace. A third start over the store, with a fleet of
    ``DAEMON_FLEET_NODES`` nodes at the card's capacity, answers a
    ``place`` request for the same job from disk with no trace, charging
    the gate's safe threshold, and an ``evacuate`` of the node it landed
    on, which moves it to the other node. Last, the run's measured peaks
    go to the telemetry ingestor against the job's digest and family,
    and the residual read back must be the ``train`` line's error."""
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

    def start(svc, **kw):
        server = served.AdmissionServer(("127.0.0.1", 0), svc, **kw)
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
    # the wire's fleet kinds on a third start over the store: the job at
    # the admitted batch placed on the daemon's fleet (nodes at the
    # card's capacity), decided from disk; then its node fails and the
    # job moves to the other node
    svc3 = AdmissionService(workers=1, store_dir=store_dir)
    server, thread = start(svc3, fleet_nodes=DAEMON_FLEET_NODES)
    place = {k: v for k, v in wire.items() if k != "hbm_gib"}
    place.update(kind="place", id=f"{DAEMON_JOB}-b{batch}")
    (placed,) = lines(server, [place])
    home = (placed.get("nodes") or [None])[0]
    (evacuated,) = lines(server, [{"kind": "evacuate", "node": home,
                                   "event": "node.fail"}])
    stop(server, thread)
    svc3.close()
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
        "plan_already_fits": plan.get("ok") and plan.get("admit")
        and plan.get("counter_offers") == []
        and plan["stats"]["already_fits"]
        and plan["stats"]["baseline_traces"] == 0,
        "residual_is_train_error": residual == reserved
        - decision.peak_bytes and residual_rel == rel_reserved,
        "place_from_disk": bool(placed.get("placed"))
        and placed["provenance"]["source"] == "disk"
        and placed["provenance"]["trace_cache"]["misses"] == 0,
        "place_charges_the_gates_threshold":
        placed.get("safe_threshold") == decision.safe_threshold
        == placed.get("shares", {}).get(home),
        "evacuate_re_places_on_the_other_node": bool(evacuated.get("ok"))
        and evacuated["displaced"] == evacuated.get("replaced")
        == [place["id"]] and [n for n, v in evacuated["fleet"]["nodes"]
                              .items() if place["id"] in v["residents"]]
        == [n for n in evacuated["fleet"]["nodes"] if n != home],
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
         place={k: placed.get(k) for k in (
             "placed", "kind", "nodes", "shares", "peak_bytes",
             "safe_threshold", "rung", "provenance")},
         evacuate={k: evacuated.get(k) for k in (
             "node", "event", "displaced", "replaced", "lost", "wall_s")},
         daemon_fleet=evacuated.get("fleet"),
         checks=checks, memory=device_memory())
    if not all(checks.values()):
        raise AssertionError(f"admission daemon: {checks}")


def phase_fleet_colocate(est, gate: dict, workers: list) -> None:
    """The fleet scheduler's placement on the card: ``FLEET_JOB``'s
    arrivals A and B (``FLEET_BATCHES``) and C (the gate's admitted
    batch), placed by the port's ``FleetScheduler`` over an
    ``AdmissionService`` that shares this job's trace cache, on a fleet
    whose ``node000`` is this card and ``node001``... are
    ``FLEET_SIM_NODES`` other H100s at its capacity. That capacity, C2,
    is what one process may hold while the processes that share the
    card have their contexts open: ``workers`` (one for each of A and
    B, started before this phase, each waiting on stdin) open theirs one
    at a time, each answering the card's free memory, and the last one's
    free memory plus what it holds is C2. The scheduler decides each
    arrival at the best capacity its fleet can give and picks the nodes;
    the phase fails unless two jobs land on ``node000``. Each of those
    runs its 3 AdamW steps in a worker, both started at one barrier,
    each held to its own estimate (``RESERVED_TOL``, ``ALLOCATED_TOL``)
    with finite losses. While they run, ``node000`` fails in the
    scheduler's books, on the CPU: every displaced job is re-placed or
    accounted lost, the invariant holds, and the node is restored. No
    decision may trace."""
    import math

    import torch
    from repro_torch.launch import served
    from repro_torch.sched import FleetScheduler, build_fleet
    from repro_torch.service import AdmissionService

    arch = TRAIN_JOBS[FLEET_JOB][0]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # a worker that fails or hangs fails the phase: at the deadline every
    # worker is killed, and the reads below see their pipes close
    watchdog = threading.Timer(FLEET_TIMEOUT_S,
                               lambda: [w.kill() for w in workers])
    watchdog.start()

    def tell(w, line: str) -> None:
        w.stdin.write(line + "\n")
        w.stdin.flush()

    def answer(w) -> dict:
        while True:
            line = w.stdout.readline()
            if not line:
                raise AssertionError(f"fleet worker {w.pid} ended: exit "
                                     f"{w.wait()}")
            if line.startswith("fleet "):
                return json.loads(line[len("fleet "):])
            print(line, end="", file=sys.stderr)

    try:
        free0 = torch.cuda.mem_get_info()[0]
        ups = []
        for w in workers:       # one context at a time: each one's bytes
            tell(w, "ctx")
            ups.append(answer(w))
        capacity, total = ups[-1]["capacity"], ups[-1]["total"]
        frees = [free0] + [u["free"] for u in ups]
        contexts = [a - b for a, b in zip(frees, frees[1:])]

        misses0 = est.trace_cache.stats()["misses"]
        service = AdmissionService(workers=1, cache=est.trace_cache)
        fleet = build_fleet(1 + FLEET_SIM_NODES, capacity)
        sched = FleetScheduler(service, fleet)
        batches = {**FLEET_BATCHES, "C": gate["batch"]}
        outs = {name: sched.place(served.build_fleet_arrival({
            "arch": arch, "smoke": False, "seq": TRAIN_SEQ, "batch": b,
            "hbm_gib": capacity / 2**30, "id": name}))
            for name, b in batches.items()}
        placements = {name: out.to_json() for name, out in outs.items()}
        on_card = [a.job_id for a in fleet.residents("node000")]
        if len(on_card) != len(workers):
            emit("fleet_colocate", capacity=capacity, placements=placements,
                 fleet=fleet.snapshot())
            raise AssertionError(f"fleet: the scheduler put {on_card} on "
                                 f"the card's node, not two jobs")
        for w, name in zip(workers, on_card):
            tell(w, f"run {batches[name]}")
        for w in workers:
            answer(w)           # its parameters are on the card
        t_steps = time.perf_counter()
        for w in workers:       # the barrier: every worker starts now
            tell(w, "start")
        charged = fleet.committed("node000")
        # while they run, the card's node fails in the scheduler's books
        # (on the CPU; the card's jobs run on): its jobs move
        evac = sched.evacuate_node("node000", "node.fail")
        fleet.check_invariant()
        moved = {j: sorted(fleet.assignments[j].shares)
                 for j in evac.replaced}
        fleet.restore("node000")
        fleet.check_invariant()
        runs = [answer(w) for w in workers]
        steps_s = time.perf_counter() - t_steps
        for w in workers:
            if w.wait(timeout=60) != 0:
                raise AssertionError(f"fleet worker {w.pid}: exit "
                                     f"{w.returncode}")
    finally:
        watchdog.cancel()
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()

    jobs, errors = {}, []
    for name, run in zip(on_card, runs):
        d = outs[name].decision
        rel_reserved = (d.peak_bytes - run["reserved"]) / run["reserved"]
        rel_allocated = ((d.peak_tensor_bytes - run["allocated"])
                         / run["allocated"])
        jobs[name] = {"batch": batches[name],
                      "charged": outs[name].assignment.shares["node000"],
                      "estimate": d.peak_bytes,
                      "tensor_estimate": d.peak_tensor_bytes,
                      "safe_threshold": d.safe_threshold,
                      "source": d.provenance["source"],
                      **run, "rel_err_reserved": rel_reserved,
                      "rel_err_allocated": rel_allocated}
        if not all(math.isfinite(x) for x in run["losses"]):
            errors.append(f"{name}: non-finite loss {run['losses']}")
        for what, rel, tol in (("reserved", rel_reserved, RESERVED_TOL),
                               ("allocated", rel_allocated, ALLOCATED_TOL)):
            if abs(rel) > tol:
                errors.append(f"{name}: {what} error {rel:+.4%} over "
                              f"{tol:.0%}")
    reserved_sum = sum(j["reserved"] for j in jobs.values())
    fresh = est.trace_cache.stats()["misses"] - misses0
    service.close()
    checks = {
        "two_on_the_card": len(on_card) == 2,
        "c_elsewhere": "C" not in on_card,
        "jobs_hold": not errors,
        "displaced_accounted": set(evac.displaced)
        == set(evac.replaced) | set(evac.lost)
        and set(evac.displaced) == set(on_card),
        "no_fresh_traces": fresh == 0,
    }
    emit("fleet_colocate", config=arch, seq_len=TRAIN_SEQ,
         steps=TRAIN_STEPS, capacity=capacity, total_memory=total,
         contexts_bytes=total - capacity, worker_context_bytes=contexts,
         worker_up=ups, placements=placements, on_card=on_card, jobs=jobs,
         reserved_sum=reserved_sum, headroom=capacity - reserved_sum,
         charged=charged,
         steps_s=steps_s, evacuation=evac.to_json(), moved=moved,
         fresh_traces=fresh, stats=sched.stats(), checks=checks,
         errors=errors, seconds=time.perf_counter() - t0,
         memory=device_memory())
    if not all(checks.values()):
        raise AssertionError(f"fleet_colocate: {checks} {errors}")


def colocate_worker(job: str) -> None:
    """One job of ``fleet_colocate`` on the card, in a process of its
    own with a CUDA context of its own, driven by lines on stdin and
    answering each with a ``fleet {json}`` line: ``ctx`` opens the
    context (answers the card's free and total memory and this
    process's capacity, free plus reserved); ``run B`` puts ``job``'s
    parameters on the card for batch B (answers when they are there);
    ``start`` runs the 3 AdamW steps inside the training measurement
    (answers the losses, step times, ``max_memory_reserved`` and
    ``max_memory_allocated``). It exits non-zero on anything else,
    including the end of its input."""
    import torch
    from repro_torch.configs.base import smoke_shape
    from repro_torch.launch import serve as srv
    from repro_torch.launch import train as trn
    from repro_torch.models import model as M

    def expect(word: str) -> list:
        line = sys.stdin.readline().split()
        if not line or line[0] != word:
            raise AssertionError(f"fleet worker: expected {word!r}, got "
                                 f"{line}")
        return line[1:]

    def say(**kw) -> None:
        print("fleet " + json.dumps(kw), flush=True)

    arch, n_layers, _ = TRAIN_JOBS[job]
    cfg = path_config(arch, n_layers)
    expect("ctx")
    torch.cuda.synchronize()            # opens this process's context
    free, total = torch.cuda.mem_get_info()
    say(free=free, total=total, capacity=srv.device_capacity())
    (batch,) = expect("run")
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    say(ready=True)
    expect("start")
    got = trn.train_loop(cfg, smoke_shape(TRAIN_SEQ, int(batch)),
                         train_policy(job), steps=TRAIN_STEPS, device="cuda",
                         params=params)
    say(losses=got.out.losses, step_s=got.out.step_s, reserved=got.reserved,
        allocated=got.allocated, alloc_retries=got.n_alloc_retries,
        memory=device_memory())


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
    if sys.argv[1:2] == ["--serve-plan"] and len(sys.argv) == 3:
        phase_serve_plan(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--serving-ahead"] and len(sys.argv) == 3:
        phase_serving_ahead(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--depth-compose"] and len(sys.argv) == 3:
        phase_depth_compose(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--depth-compose-loops"] and len(sys.argv) == 3:
        phase_depth_compose(sys.argv[2], loops=True)
        return 0
    if sys.argv[1:2] == ["--colocate-worker"] and len(sys.argv) == 3:
        colocate_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--sharded-ahead"] and len(sys.argv) == 4:
        sharded_ahead(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--sharded-serving"] and len(sys.argv) == 4:
        sharded_serving(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] in (["--dense-sharded"], ["--moe-sharded"]) \
            and len(sys.argv) in (3, 4):
        # the job's phase alone (of GROUPS, default all), its estimates
        # made first in this process
        job = sys.argv[1][2:-len("-sharded")]
        out = Path(sys.argv[2])
        out.mkdir(parents=True, exist_ok=True)
        groups = sys.argv[3].split(",") if len(sys.argv) == 4 else \
            sorted({spec["group"] for spec in sharded_specs(job=job)})
        for ahead in SHARDED_AHEAD:
            mine = [g for g in ahead.split(",") if g in groups]
            if mine:
                sharded_ahead(",".join(mine), str(ahead_path(out, mine[0])))
        phase_sharded(job, out, groups=groups)
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
    # the serving remediation search needs no card: a process of its own
    # on the training jobs' cores, started with the serving capacity once
    # serve_mix has read it, while this process serves the other models
    serve_plan_out = rows_dir / "serve_plan.json"
    serve_plan = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--serve-plan",
         str(serve_plan_out)], stdin=subprocess.PIPE, text=True)
    if mine:
        os.sched_setaffinity(serve_plan.pid, theirs)
    # the later serving paths' gates trace ahead on this process's cores
    # (it drives the card from one of them) into a store the gates read
    serving_store = str(rows_dir / "serving_store")
    ahead = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--serving-ahead",
         serving_store])
    if mine:
        os.sched_setaffinity(ahead.pid, mine)

    # rank 0's sharded programs are estimated ahead on the CPU, from the
    # start, for the dense and moe jobs' ``<job>_sharded`` phases
    sharded = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-ahead",
         groups, str(ahead_path(rows_dir, groups[0]))])
        for groups in SHARDED_AHEAD]
    if mine:
        for child in sharded:
            os.sched_setaffinity(child.pid, theirs)

    def store_for(prefix: str):
        """The serving store, once the process tracing into it ends."""
        if prefix not in SERVING_AHEAD:
            return None
        if ahead.wait(timeout=600) != 0:
            raise AssertionError(f"serving_ahead failed: exit "
                                 f"{ahead.returncode}")
        return serving_store

    # the depth composition at full width needs no card either: a process
    # of its own beside the training jobs, from the start
    depth_out = rows_dir / "depth_compose.json"
    # (a session of its own: its loops process is stopped with it)
    depth = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--depth-compose",
         str(depth_out)], stdin=subprocess.PIPE, text=True,
        start_new_session=True)
    if mine:
        os.sched_setaffinity(depth.pid, theirs)

    def start_serve_plan(capacity: int) -> None:
        for child in (serve_plan, depth):
            child.stdin.write(f"go {capacity}\n")
            child.stdin.close()
    if mine:
        for tid in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(tid), mine)
        torch.set_num_threads(len(mine))
    emit("cpus", serving=mine, training_jobs=theirs)
    try:
        info = phase_device()
        phase_build()
        rows = phase_kernels()
        phase_serving(rows, "qwen3-32b", serving_sweep=True,
                      after_serve_mix=start_serve_plan)
        phase_moe_layer()
        phase_attention_layer()
        phase_serving(rows, MOE_ARCH, "moe_")
        for arch, (prefix, max_len, prompt_len) in FULL_DEPTH_SERVING.items():
            phase_serving(rows, arch, prefix, n_layers=None, max_len=max_len,
                          prompt_len=prompt_len, candidates=WIDE_CANDIDATES,
                          kernel_rows=True, store_dir=store_for(prefix))
        for arch, (prefix, n_layers) in RECURRENT_SERVING.items():
            phase_serving(rows, arch, prefix, n_layers=n_layers,
                          candidates=WIDE_CANDIDATES,
                          kernel_rows=arch == HYBRID_ARCH,
                          store_dir=store_for(prefix))
        for arch, (prefix, n_layers, cands) in LONG_SERVING.items():
            with allocator_cap(LONG_HEADROOM) as capacity:
                phase_serving(rows, arch, prefix, n_layers=n_layers,
                              max_len=LONG_MAX_LEN, prompt_len=LONG_PROMPT,
                              candidates=cands, kernel_rows=True, long=True,
                              capacity=capacity, store_dir=store_for(prefix))
        # this process keeps only its context and workspace on the card
        torch.cuda.empty_cache()
        if serve_plan.wait(timeout=600) != 0:
            raise AssertionError(f"serve_plan failed: exit "
                                 f"{serve_plan.returncode}")
        emit("serve_plan", **json.loads(serve_plan_out.read_text()))
        for job, child in jobs.items():
            if child.poll() is None:        # still waiting for its turn
                child.stdin.write("go\n")
                child.stdin.close()
            if child.wait(timeout=600) != 0:
                raise AssertionError(f"training job {job} failed: exit "
                                     f"{child.returncode}")
        if depth.wait(timeout=600) != 0:
            raise AssertionError(f"depth_compose failed: exit "
                                 f"{depth.returncode}")
        emit("depth_compose", **json.loads(depth_out.read_text()))
        for child in sharded:
            if child.wait(timeout=60) != 0:
                raise AssertionError(f"sharded_ahead failed: exit "
                                     f"{child.returncode}")
        # the sm90 kernel at each sharded prefill's local shape, its
        # launches from that job's sharded prefill
        rows += [json.loads(kernel_row_path(rows_dir, job).read_text())
                 for job in SHARDED_KERNEL_SHAPES]
        phase_comparison({job: json.loads((rows_dir / f"{job}.json")
                                          .read_text())
                          for job in TRAIN_JOBS if job not in GATE_ONLY},
                         info)
    finally:
        for child in (*jobs.values(), serve_plan, depth, ahead, *sharded):
            if child.poll() is None:
                child.kill()
                child.wait()
        try:
            os.killpg(depth.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        shutil.rmtree(rows_dir, ignore_errors=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

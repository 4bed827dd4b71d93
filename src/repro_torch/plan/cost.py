"""Throughput cost model for remediation plans (port of
``repro.plan.cost``, priced for the H100).

"Cheapest feasible" must mean *lowest modeled slowdown*, not smallest
memory: a counter-offer that fits by quartering the batch is worthless
if a microbatch split would have fit at a fraction of the cost. The
planner scores every candidate plan with the analytic roofline terms of
``launch/analytic.py``:

* compute time = analytic FLOPs / peak FLOP/s (remat-aware: full remat
  pays the re-forward);
* memory time = analytic HBM traffic / HBM bandwidth (microbatch-aware:
  every microbatch re-reads the parameters; remat-aware: fewer
  activation passes without remat);
* transfer time = host-offload bytes / host-link bandwidth;
* step time = the largest of the three (the roofline);
* **cost = device-seconds per trained token**: step time x device count
  / tokens per step, so a smaller batch pays for amortizing the fixed
  parameter and optimizer traffic over fewer tokens.

Offers are ranked by this cost; ``slowdown`` is the ratio against the
rejected plan's cost, so ``slowdown=1.12`` reads as "12% more
device-time per token than what you asked for".

The constants are the H100 SXM5's (the card ``chip_smoke.py`` reports as
``NVIDIA H100 80GB HBM3``), not the reference's: its compute/memory
crossover sits at 295 FLOP/B, so an offer can rank differently than in
the JAX package, whose v5e constants cross at 240.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeSpec
from ..launch.analytic import analytic_bytes, analytic_flops

# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor-core peak,
# 3.35 TB/s HBM3 (the values chip_smoke.py's kernel bounds use)
PEAK_FLOPS, HBM_BW = 989e12, 3.35e12

# Host<->device bandwidth charged for offload transfers: PCIe Gen5 x16,
# one direction (64 GB/s). Offload staging overlaps compute, so it
# enters the roofline as a third ceiling rather than a serial add: an
# offload plan is "free" until its transfer time binds.
PCIE_BW = 64e9

# HBM passes over materialized activations per remat policy: full remat
# writes, rewrites on the re-forward, and reads; no remat writes + reads
ACT_PASSES = {"full": 3.0, "dots": 2.5, "none": 2.0}


def plan_cost(cfg: ModelConfig, shape: ShapeSpec, *,
              microbatches: int = 1, topology=None,
              offload_transfer_bytes: int = 0) -> dict:
    """Roofline terms + device-seconds-per-token for one plan.

    ``topology`` is a mesh topology (``n_devices``, ``model``, ``pod``,
    ``data``, ``fsdp``), or None for the single-device plan;
    ``cfg.remat`` selects the re-forward FLOPs and activation traffic;
    ``microbatches`` multiplies the parameter re-reads;
    ``offload_transfer_bytes`` is the per-device host<->device traffic
    one iteration moves (the orchestrator's offload stats), charged over
    the host link as a third roofline ceiling.
    """
    n_dev = topology.n_devices if topology is not None else 1
    model_shards = topology.model if topology is not None else 1
    fsdp_shards = (topology.pod * topology.data
                   if topology is not None and topology.fsdp else 1)
    refwd = cfg.remat == "full"
    flops_dev = analytic_flops(cfg, shape, remat_refwd=refwd) / n_dev
    bytes_dev = analytic_bytes(
        cfg, shape, n_devices=n_dev, model_shards=model_shards,
        fsdp_shards=max(fsdp_shards, 1),
        microbatches=max(int(microbatches), 1),
        act_passes=ACT_PASSES.get(cfg.remat, 3.0))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_transfer = max(int(offload_transfer_bytes), 0) / PCIE_BW
    t_step = max(t_compute, t_memory, t_transfer)
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "step_time_s": t_step,
        "device_s_per_token": n_dev * t_step / max(shape.tokens, 1),
    }
    if offload_transfer_bytes:
        out["t_transfer_s"] = t_transfer
    return out


def serving_cost(*, params_bytes: int, kv_bytes_per_token: int, knobs,
                 avg_seq_len: float, shared_prefix_len: int = 0,
                 flops_per_token: float | None = None) -> dict:
    """Roofline terms + device-seconds-per-token for one serving plan.

    A decode step over ``c = knobs.max_concurrent`` sequences streams
    the parameters once plus every active sequence's paged KV cache:
    page-quantized (larger pages waste tail bytes), dtype-scaled (1-byte
    KV halves the traffic), prefix-shared pages counted once instead of
    per sequence, and speculative drafts adding ``k`` extra KV columns
    per sequence. The step emits ``c`` tokens, so concurrency amortizes
    the fixed parameter read: bigger ``c`` lowers device-s/token until
    the KV traffic term (or capacity) binds.
    """
    c = max(int(knobs.max_concurrent), 1)
    page = max(int(knobs.page_size), 1)
    tok_b = max(int(kv_bytes_per_token), 1) * knobs.kv_dtype_bytes / 2.0
    pages_per_seq = -(-max(avg_seq_len, 1.0) // page)
    seq_bytes = pages_per_seq * page * tok_b
    shared_bytes = 0.0
    if knobs.prefix_cache and shared_prefix_len > 0:
        shared_pages = int(shared_prefix_len) // page
        shared_bytes = shared_pages * page * tok_b
    kv_traffic = c * (seq_bytes - shared_bytes) + shared_bytes \
        + c * knobs.speculative_k * tok_b
    if flops_per_token is None:
        # bf16 params: n_params ~ params_bytes/2; ~2 FLOPs per param
        # per token, the standard dense-decoder estimate
        flops_per_token = float(params_bytes)
    t_compute = c * flops_per_token / PEAK_FLOPS
    t_memory = (params_bytes + kv_traffic) / HBM_BW
    t_step = max(t_compute, t_memory)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "step_time_s": t_step,
        "device_s_per_token": t_step / c,
        "kv_traffic_bytes": kv_traffic,
    }

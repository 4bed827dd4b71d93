#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch/CUDA;
2. build   — every kernel under ``src/repro_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card
   (the cases of ``tests/test_kernels.py`` plus the serving shape), and
   its time beside the plain version, a library call and its bound;
4. main    — qwen3-32b at full width, depth cut to 8 layers: the xMem
   serving gate (``pick_batch``, traced on the CPU), then ``serve`` on
   the card (two requests of 2048-token prompts, 16 decoded tokens
   each), the kernel's launch count, each phase's estimate beside the
   measured peak, the card's allocator requests during one prefill
   aligned with the trace's (``requests``), the device time of one warm
   prefill by kernel (``profile``), and the kernel path's logits against
   the dense path's (``parity``).

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result when no
CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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
# |flash - dense| / max|dense| on the batch-1 prefill logits, bf16 model:
# both paths do f32 attention math from the same bf16 q/k/v and round
# the output to bf16, so they differ by output roundings carried
# through 8 layers
LOGITS_REL_TOL = 5e-2


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
            "python": sys.version.split()[0]}
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build_all()
    ptxas = {name: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, v in info.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: v["seconds"] for n, v in info.items()}, ptxas=ptxas)


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns the summary row."""
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
                                (2, 4, 2, 64, 16)]:
            cases.append((f"b{B}h{H}kv{Hkv}s{S}d{d}", B, H, Hkv, S, d,
                          dtype, True, None))
    for w in (32, 64, 100):
        cases.append((f"window{w}", 1, 4, 2, 256, 64, f32, True, w))
    cases.append(("non_causal", 1, 2, 2, 128, 64, f32, False, None))

    results = []
    for name, B, H, Hkv, S, d, dtype, causal, window in cases:
        q = rand(B, H, S, d, dtype=dtype)
        k = rand(B, Hkv, S, d, dtype=dtype)
        v = rand(B, Hkv, S, d, dtype=dtype)
        out = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        results.append({"case": name, "dtype": str(dtype), "err": err,
                        "tol": tol[dtype]})
        if not err < tol[dtype]:
            raise AssertionError(f"kernel case {name} {dtype}: max error "
                                 f"{err} >= {tol[dtype]}")
    # the ragged S=100 case through the model-layout wrapper
    q, k, v = rand(2, 100, 4, 64), rand(2, 100, 2, 64), rand(2, 100, 2, 64)
    out = ops.flash_attention(q, k, v, causal=True)
    err = (out - dense_attention(q, k, v, causal=True)).abs().max().item()
    results.append({"case": "ragged_s100_wrapper", "dtype": "torch.float32",
                    "err": err, "tol": 2e-5})
    if not err < 2e-5:
        raise AssertionError(f"ragged wrapper case: max error {err}")

    # the serving shape, in the model layout the main path passes
    B, H, Hkv, S, d = 8, 64, 8, PROMPT_LEN, 128
    q = rand(B, S, H, d, dtype=bf16)
    k = rand(B, S, Hkv, d, dtype=bf16)
    v = rand(B, S, Hkv, d, dtype=bf16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(qt, kt, vt, causal=True)
    err = (out.transpose(1, 2).float() - ref.float()).abs().max().item()
    results.append({"case": f"serving_b{B}h{H}kv{Hkv}s{S}d{d}",
                    "dtype": str(bf16), "err": err, "tol": tol[bf16]})
    if not err < tol[bf16]:
        raise AssertionError(f"serving-shape case: max error {err}")
    del ref
    torch.cuda.empty_cache()

    kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                        reps=5)
    plain_ms = cuda_ms(lambda: attention_ref(qt, kt, vt, causal=True),
                       reps=2)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), reps=10)
    flops = 4.0 * B * H * d * attended_pairs(S, S, True, None)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    t_ops = flops / PEAK_FLOPS[str(bf16)] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:93",
           "launches": None, "max_abs_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms}
    emit("kernels", cases=results, shape=[B, H, Hkv, S, d],
         flops=flops, bytes=nbytes, max_abs_err=err, kernel_ms=kernel_ms,
         **{key: row[key] for key in ("plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
         tflops=flops / kernel_ms / 1e9)
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    return row


def phase_main(row: dict) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    base = get_config("qwen3-32b")
    cfg = dataclasses.replace(
        base, n_layers=N_LAYERS,
        attention=dataclasses.replace(base.attention, impl="flash"))
    capacity = srv.device_capacity()
    t0 = time.perf_counter()
    batch, gate = srv.pick_batch(cfg, MAX_LEN, capacity,
                                 candidates=(8, 4, 2, 1))
    gate_s = time.perf_counter() - t0
    if batch is None:
        raise AssertionError(f"no batch fits: {gate['candidates']}")
    # the estimates at the shapes the run below uses (the gate traces
    # the prefill at a max_len prompt)
    est = XMemEstimator.for_torch_gpu()
    cache_abs = M.init_cache(cfg, batch, MAX_LEN, device="meta")
    pre_est = est.estimate_serving(
        srv.make_prefill_fn(cfg), M.abstract_params(cfg), cache_abs,
        srv.prompt_specs(cfg, batch, PROMPT_LEN))
    dec_est = gate["decode"]
    emit("gate", config=cfg.name, n_layers=cfg.n_layers, capacity=capacity,
         seconds=gate_s, batch=batch, candidates=gate["candidates"],
         prefill_estimate=pre_est.peak_bytes,
         prefill_tensor_estimate=pre_est.peak_tensor_bytes,
         decode_estimate=dec_est.peak_bytes,
         decode_tensor_estimate=dec_est.peak_tensor_bytes,
         persistent=pre_est.breakdown["persistent_by_kind"])

    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    fa.launches = 0
    res = srv.serve(cfg, batch, MAX_LEN, PROMPT_LEN, DECODE_TOKENS, "cuda",
                    requests=REQUESTS, params=params)
    launches = fa.launches
    row["launches"] = launches
    want = cfg.n_layers * REQUESTS
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, "
                             f"expected {want} (n_layers per prefill)")
    for lg in res.prefill_logits:
        if tuple(lg.shape) != (batch, 1, cfg.padded_vocab):
            raise AssertionError(f"prefill logits shape {tuple(lg.shape)}")
        if not torch.isfinite(lg).all().item():
            raise AssertionError("non-finite prefill logits")
    toks = res.tokens
    if toks.shape != (REQUESTS, batch, DECODE_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.padded_vocab:
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

    emit("main", batch=batch, prompt_len=PROMPT_LEN, tokens=DECODE_TOKENS,
         requests=REQUESTS, kernel_launches=launches,
         prefill_ms=[s * 1e3 for s in res.prefill_s],
         decode_s=res.decode_s,
         decode_tok_per_s=[res.decode_tok_per_s(r)
                           for r in range(REQUESTS)],
         prefill=vs(res.peaks["prefill"], pre_est),
         decode=vs(res.peaks["decode"], dec_est),
         finite_logits=True, first_tokens=toks[-1][:2, :8].tolist())
    del res
    torch.cuda.empty_cache()
    phase_requests(cfg, params, batch)
    phase_profile(cfg, params, batch)

    # the kernel path against the dense path at batch 1, same weights
    dense = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="dense"))
    prompt = torch.from_numpy(
        srv.make_prompts(cfg, 1, PROMPT_LEN, seed=100)).cuda()
    lf = make_prefill_step(cfg)(params, {"tokens": prompt}).float()
    ld = make_prefill_step(dense)(params, {"tokens": prompt}).float()
    rel = ((lf - ld).abs().max() / ld.abs().max()).item()
    same = bool((lf.argmax(-1) == ld.argmax(-1)).all().item())
    emit("parity", flash_vs_dense_rel=rel, tol=LOGITS_REL_TOL,
         same_argmax=same, finite=bool(torch.isfinite(lf).all().item()))
    if not rel < LOGITS_REL_TOL:
        raise AssertionError(f"flash vs dense logits: rel {rel}")


def phase_requests(cfg, params, batch: int) -> None:
    """The card's allocator requests during one prefill against the
    trace's, aligned by size: what the CPU trace misses or adds."""
    import difflib

    import torch
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.core.baselines.directprobe import measured_peak
    from repro_torch.core.events import BlockKind, Phase
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step

    entry = XMemEstimator.for_torch_gpu()._trace_phase(
        srv.make_prefill_fn(cfg),
        [(M.abstract_params(cfg), BlockKind.PARAM, "params"),
         (M.init_cache(cfg, batch, MAX_LEN, device="meta"), BlockKind.CACHE,
          "cache"),
         (srv.prompt_specs(cfg, batch, PROMPT_LEN), BlockKind.INPUT,
          "batch")], Phase.DECODE)
    traced = [(b.size, b.op)   # requested bytes, as the card reports
              for b in sorted(entry.lifecycles, key=lambda b: b.alloc_t)
              if b.op != "input"]
    prompt = torch.from_numpy(
        srv.make_prompts(cfg, batch, PROMPT_LEN, seed=300)).cuda()
    got = measured_peak(make_prefill_step(cfg), params, {"tokens": prompt},
                        history=True)
    card_only, trace_only = [], []
    matcher = difflib.SequenceMatcher(None, [s for s, _ in traced],
                                      [s for s, _ in got.allocs],
                                      autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag != "equal":
            trace_only += traced[i1:i2]
            card_only += got.allocs[j1:j2]
    emit("requests", card=len(got.allocs), trace=len(traced),
         card_only=len(card_only), trace_only=len(trace_only),
         card_only_bytes=sum(s for s, _ in card_only),
         trace_only_bytes=sum(s for s, _ in trace_only),
         card_only_first=card_only[:12], trace_only_first=trace_only[:12])


def phase_profile(cfg, params, batch: int) -> None:
    """Device time of one warm prefill at the admitted batch, by kernel,
    from ``torch.profiler``; busy share = kernel time / wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as srv
    from repro_torch.train.train_step import make_prefill_step

    prompt = torch.from_numpy(
        srv.make_prompts(cfg, batch, PROMPT_LEN, seed=200)).cuda()
    step = make_prefill_step(cfg)
    step(params, {"tokens": prompt})           # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, {"tokens": prompt})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
    device_ms = sum(ms for ms, _ in kernels.values())

    def bucket(name):
        low = name.lower()
        if "attn_fwd_kernel" in low:
            return "flash_attention"
        if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass")):
            return "matmul"
        return "other"
    buckets: dict = {}
    for name, (ms, _) in kernels.items():
        buckets[bucket(name)] = buckets.get(bucket(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    emit("profile", batch=batch, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms if wall_ms else None,
         by_bucket_ms=buckets,
         top=[{"kernel": k[:90], "ms": ms, "count": n}
              for k, (ms, n) in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout
    info = phase_device()
    phase_build()
    row = phase_kernels()
    phase_main(row)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

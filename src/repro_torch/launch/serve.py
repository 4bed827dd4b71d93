"""Serving launcher: xMem batch gate, then prefill + greedy decode.

Before the KV cache is allocated, the xMem serving estimator (traced on
the CPU, replayed through the CUDA caching allocator simulation) picks
the largest batch whose prefill AND decode peaks fit the card: gating on
the decode step alone admits batches that run out of memory during
prefill, before a token decodes. Then the server runs the steps on the
card and reads each phase's real peak (``measured_peak``) beside its
estimate.

Two gates live here, both deciding through the admission service
(:mod:`repro_torch.service.admission`), so repeated gate decisions are
warm (content-addressed trace cache) and, with ``--store-dir``, survive
restarts:

* ``pick_batch`` — the static gate: the largest fixed batch whose
  monolithic-cache prefill/decode estimates fit;
* ``pick_serving`` — the request-driven gate (``--serve-mix``): a
  continuous-batching runtime over a ``RequestMix`` (paged KV cache,
  prefix sharing, speculative scratch) gated on the worst-case peak of
  the scripted timeline; with ``--plan`` a rejection comes back with
  the remediation planner's ranked serving counter-offers.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --n-layers 8 --max-len 2064 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
      --max-len 2320 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --max-len 2064 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --smoke --device cpu --capacity-gib 0.25 \
      --serve-mix 48:16:8,16:48:8 --max-concurrent 8 --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --smoke --device cpu --capacity-gib 0.04 \
      --serve-mix 48:16:8,16:48:8 --max-concurrent 8 --plan

``--max-len`` counts every position of the cache: a VLM's patches, the
prompt and the decoded tokens.

As in the JAX package, prefill returns the last position's logits and
does not fill the decode state (a KV cache, or the hybrid and SSM
families' recurrent state); decoding starts at cache position 0 from
``init_cache``'s state.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..configs.base import smoke_shape
from ..configs.registry import decode_input_specs, input_specs
from ..core.baselines.directprobe import measured_peak
from ..core.orchestrator import RequestMix, ServingKnobs
from ..models import model as M
from ..service import RUNGS, AdmissionService
from ..train.data import to_device
from ..core.depth import with_depth_plan
from ..train.train_step import (make_prefill_step, make_serve_step,
                                serving_args_at)


def decode_input(cfg, b: int) -> dict:
    """One-token decode batch for ``M.decode_step`` (meta tensors):
    codes ``[b, 1, K]`` for audio, else a token ``[b, 1]``."""
    return decode_input_specs(cfg, smoke_shape(1, b))


def prompt_specs(cfg, b: int, seq: int) -> dict:
    """Full-prompt prefill batch of ``seq`` positions as meta tensors:
    the training batch's inputs without its labels (a VLM's patch
    embeddings and then its tokens, audio codes ``[b, seq, K]``, else
    tokens ``[b, seq]``)."""
    specs = input_specs(cfg, smoke_shape(seq, b))
    del specs["labels"]
    return specs


def make_prompts(cfg, b: int, seq: int, seed: int = 0) -> dict:
    """A random prompt batch with :func:`prompt_specs`' keys and shapes,
    as numpy arrays from a numpy seed: int32 tokens or codes below the
    vocabulary, f32 patch embeddings drawn N(0, 0.02^2) as the data
    pipeline draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in prompt_specs(cfg, b, seq).items():
        if spec.dtype.is_floating_point:
            out[name] = rng.standard_normal(
                tuple(spec.shape)).astype(np.float32) * 0.02
        else:
            out[name] = rng.integers(0, cfg.vocab, size=tuple(spec.shape),
                                     dtype=np.int32)
    return out


def device_prompts(cfg, b: int, seq: int, seed: int = 0,
                   device="cuda") -> dict:
    """:func:`make_prompts` as tensors on ``device``; floats take
    ``cfg.dtype``."""
    return to_device(cfg, make_prompts(cfg, b, seq, seed), device)


def decode_batch(cfg, tok) -> dict:
    """The decode step's batch for the last tokens ``tok`` (``[B, 1]``,
    or ``[B, 1, K]`` codes for audio)."""
    return {"codes": tok} if cfg.family == "audio" else {"tokens": tok}


def make_decode_fn(cfg):
    """(params, cache, batch) one-token decode at cache position 0; the
    step's shapes, and so its memory, do not depend on the position."""
    return make_serve_step(cfg, 0)


def make_prefill_fn(cfg):
    """(params, cache, batch) prefill wrapper: the KV cache rides along
    as persistent state so the prefill estimate includes it."""
    step = make_prefill_step(cfg)

    def prefill(params, cache, batch):
        return step(params, batch), cache
    return with_depth_plan(prefill, cfg, make_prefill_fn, serving_args_at)


def serving_cache_profile(cfg, max_len: int,
                          probe_delta: int = 8) -> tuple[int, int]:
    """(kv_bytes_per_token, resident_bytes_per_request) of ``cfg``'s
    decode cache: the finite difference of ``init_cache`` totals on
    ``meta`` tensors at two max lengths (batch 1). The slope is the
    KV footprint each position adds; the intercept is the per-request
    state that does not grow with the length (the recurrent state of
    the ssm and hybrid families)."""
    def total(n):
        return sum(t.numel() * t.element_size() for t in
                   M.init_cache(cfg, 1, n, device="meta").values())
    lo, hi = total(max_len), total(max_len + probe_delta)
    kv_tok = max((hi - lo) // probe_delta, 0)
    return kv_tok, max(lo - kv_tok * max_len, 0)


def parse_mix(spec: str, arrival_period: int = 1,
              shared_prefix_len: int = 0) -> RequestMix:
    """``prompt:decode:count[,prompt:decode:count...]`` -> RequestMix."""
    buckets = []
    for part in spec.split(","):
        p, d, c = (int(x) for x in part.split(":"))
        buckets.append((p, d, c))
    return RequestMix(buckets=tuple(buckets),
                      arrival_period=max(int(arrival_period), 1),
                      shared_prefix_len=max(int(shared_prefix_len), 0))


def device_capacity(device="cuda") -> int:
    """Bytes of device memory the gate budgets against: what this
    process's caching allocator can hold, i.e. what it holds now plus
    what ``cudaMemGetInfo`` still reports free. Less than
    ``total_memory`` by the CUDA contexts and whatever other processes
    hold."""
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device))


def _gate_service(service, store_dir):
    """The admission service a gate call runs against: ``service``, or
    a one-worker service over ``store_dir``'s persistent trace store
    (the process-global trace cache without one)."""
    if service is not None:
        return service
    return AdmissionService(workers=1, store_dir=store_dir)


_SOURCE_ORDER = ("traced", "disk", "memory", "degraded")


def gate_provenance(*decisions) -> dict:
    """One gate candidate's ``source`` and ``rung`` from its decisions:
    the coldest source (``traced`` before ``disk`` before ``memory``)
    and the lowest rung that answered any of them; and, where a step's
    trace has a depth plan, how each was made (``depth``: composed or
    traced, the units, the units traced)."""
    sources = [d.provenance["source"] for d in decisions]
    out = {"source": min(sources, key=_SOURCE_ORDER.index),
           "rung": max((d.rung for d in decisions), key=RUNGS.index)}
    depths = [d.provenance["depth"] for d in decisions
              if "depth" in d.provenance]
    if depths:
        out["depth"] = depths
    return out


def pick_batch(cfg, max_len: int, capacity: int | None = None,
               candidates=(64, 32, 16, 8, 4, 2, 1), service=None,
               store_dir=None):
    """Largest batch whose serving estimates fit ``capacity`` (default:
    what the card's caching allocator can hold, ``device_capacity``).

    Gates on ``max(prefill, decode)`` peak, the prefill traced at a
    ``max_len`` prompt, each decided through ``service`` (default: a
    one-worker ``AdmissionService`` over ``store_dir``). Returns
    ``(batch, gate)``; ``gate`` holds every candidate tried (with its
    decisions' ``source`` and ``rung``) and the admitting decisions
    (``prefill``, ``decode``), or ``(None, gate)`` when no candidate
    fits."""
    if capacity is None:
        capacity = device_capacity()
    svc = _gate_service(service, store_dir)
    params = M.abstract_params(cfg)
    decode_fn = make_decode_fn(cfg)
    prefill_fn = make_prefill_fn(cfg)
    gate: dict = {"capacity": capacity, "candidates": []}
    for b in candidates:
        cache = M.init_cache(cfg, b, max_len, device="meta")
        dec = svc.decide_serving(
            f"{cfg.name}-b{b}-decode", decode_fn, params, cache,
            decode_input(cfg, b), capacity=capacity)
        pre = svc.decide_serving(
            f"{cfg.name}-b{b}-prefill", prefill_fn, params, cache,
            prompt_specs(cfg, b, max_len), capacity=capacity)
        peak = max(pre.peak_bytes, dec.peak_bytes)
        # replayed at ``capacity``, the simulated allocator frees its
        # cache and retries before it gives up, as the real one does: a
        # candidate fits when neither replay ran out of memory and both
        # peaks fit (each decision's ``admit``)
        fits = pre.admit and dec.admit
        gate["candidates"].append(
            {"batch": b, "prefill_peak": pre.peak_bytes,
             "decode_peak": dec.peak_bytes, "peak": peak, "fits": fits,
             **gate_provenance(pre, dec)})
        if fits:
            gate.update(batch=b, prefill=pre, decode=dec, peak=peak)
            return b, gate
    return None, gate


def pick_serving(cfg, mix, capacity: int, *, knobs=None, space=None,
                 max_len: int | None = None, service=None,
                 store_dir=None):
    """Request-driven serving gate: admit or reject a request mix under
    a continuous-batching runtime at ``capacity`` bytes.

    Returns ``(decision, gate)``. ``gate["serving"]`` carries the
    :class:`~repro_torch.core.estimator.ServingEstimate` summary
    (worst-case vs steady-state peak, paged-vs-monolithic cache bytes).

    The decode step is traced at ``knobs.max_concurrent`` sequences,
    where the reference traces batch 1 and scales the step's transient
    to the concurrency: the scaling is linear in the traced batch, and a
    batch-1 trace is not linear (its size-1 dims make copies views). For
    qwen3-32b at full width, 8 layers and a 2064-position cache, eight
    times the batch-1 trace's transient is 110,477,312 B where the
    batch-8 trace's is 177,967,104 B. Traced at the concurrency, the
    gate's step is the one the server runs, and repeated gates at one
    concurrency share the cached trace. With ``space`` (a
    :class:`~repro_torch.plan.PlanSpace` with serving axes) a rejection
    comes back with ``decision.counter_offers``; each candidate's
    decode step is traced at its own concurrency, so the search costs
    at most 1 + the grid's distinct concurrencies traces
    (``repro_torch.plan.serving_trace_budget``)."""
    svc = _gate_service(service, store_dir)
    knobs = knobs or ServingKnobs()
    stream = mix.stream() if hasattr(mix, "stream") else mix
    if max_len is None:
        max_len = max(stream.max_seq_len, 8)
    kv_tok, resident = serving_cache_profile(cfg, max_len)
    params = M.abstract_params(cfg)
    decode_fn = make_decode_fn(cfg)

    def step_inputs(b):
        return M.init_cache(cfg, b, max_len, device="meta"), \
            decode_input(cfg, b)
    cache, batch = step_inputs(knobs.max_concurrent)
    plan = None
    if space is not None:
        from ..plan import ServingPlanContext
        plan = ServingPlanContext(
            decode_fn, params, cache, batch, mix, knobs=knobs,
            kv_bytes_per_token=kv_tok, resident_bytes_per_request=resident,
            space=space, step_inputs=step_inputs)
    decision = svc.decide_serving(
        f"{cfg.name}-mix", decode_fn, params, cache, batch,
        capacity=capacity, mix=mix, knobs=knobs,
        kv_bytes_per_token=kv_tok, resident_bytes_per_request=resident,
        plan=plan)
    gate = {"serving": decision.breakdown.get("serving", {}),
            "kv_bytes_per_token": kv_tok,
            "resident_bytes_per_request": resident,
            "max_len": max_len}
    return decision, gate


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray            # [requests, batch, n_tokens(, K)] greedy
    prefill_logits: list          # per request, [batch, 1(, K), vocab], host
    prefill_s: list[float]        # per request, synchronized wall time
    decode_s: list[float]         # per request, all decode steps
    peaks: dict | None            # {"prefill"/"decode": MeasuredPeak}

    def decode_tok_per_s(self, r: int = -1) -> float:
        """Decode steps of all sequences per second (an audio step
        emits one code per codebook)."""
        n = self.tokens.shape[1] * self.tokens.shape[2]
        return n / self.decode_s[r]


def serve(cfg, batch: int, max_len: int, prompt_len: int, tokens: int,
          device="cuda", *, seed: int = 0, requests: int = 1,
          params=None) -> ServeResult:
    """Serve ``requests`` prompt batches one after another: prefill a
    random prompt of ``prompt_len`` positions (``make_prompts``; a VLM's
    patches count), take its last-position argmax (per codebook for
    audio) as the first token, then decode ``tokens`` tokens greedily.

    On a CUDA device every prefill and every decode loop runs through
    ``measured_peak``; ``peaks`` holds each phase's largest reading,
    without the step's output. Prefill logits go to the host before
    decoding: a device tensor kept across phases would pin its allocator
    segment under the next step."""
    if prompt_len > max_len:
        raise ValueError(f"prompt_len {prompt_len} > max_len {max_len}")
    on_card = torch.device(device).type == "cuda"
    if params is None:
        params = M.init_params(cfg, seed, device=device)
    cache = M.init_cache(cfg, batch, max_len, device=device)
    prefill = make_prefill_step(cfg)
    peaks = {} if on_card else None

    def run(phase, fn, *args):
        """``fn(*args)`` and its wall time; on the card through
        ``measured_peak``, which synchronizes around the step."""
        if not on_card:
            t0 = time.perf_counter()
            return fn(*args), time.perf_counter() - t0
        got = measured_peak(fn, *args, device=device)
        out, got.out = got.out, None    # a kept reading pins no output
        if phase not in peaks or got.reserved > peaks[phase].reserved:
            peaks[phase] = got
        return out, got.seconds

    @torch.no_grad()
    def decode_loop(tok):
        out = []
        for i in range(tokens):
            logits, _ = M.decode_step(params, cache, decode_batch(cfg, tok),
                                      i, cfg)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            del logits
            out.append(tok)
        return torch.cat(out, dim=1) if out else tok[:, :0]

    all_tokens, all_logits, pre_s, dec_s = [], [], [], []
    for r in range(requests):
        prompt = device_prompts(cfg, batch, prompt_len, seed + r, device)
        M.reset_cache(cache)
        logits, seconds = run("prefill", prefill, params, prompt)
        pre_s.append(seconds)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        all_logits.append(logits.cpu())
        del logits, prompt
        gen, seconds = run("decode", decode_loop, tok)
        dec_s.append(seconds)
        all_tokens.append(gen.cpu().numpy())
    return ServeResult(tokens=np.stack(all_tokens), prefill_logits=all_logits,
                       prefill_s=pre_s, decode_s=dec_s, peaks=peaks)


def serve_mix_main(cfg, args, capacity: int, service=None) -> int:
    """``--serve-mix`` entry: the request-driven gate for the mix and
    knobs of ``args`` at ``capacity`` bytes, with ``--plan`` the ranked
    serving counter-offers of a rejection (page sizes 8/16/32, half,
    the same and twice the concurrency, 1- and 2-byte KV); exits 0 when
    it admits, 2 when it rejects."""
    mix = parse_mix(args.serve_mix, args.arrival_period, args.shared_prefix)
    knobs = ServingKnobs(page_size=args.page_size,
                         max_concurrent=args.max_concurrent,
                         kv_dtype_bytes=args.kv_dtype_bytes,
                         prefix_cache=not args.no_prefix_cache,
                         speculative_k=args.speculative_k)
    space = None
    if args.plan:
        from ..plan import PlanSpace
        space = PlanSpace(
            page_sizes=(8, 16, 32),
            max_concurrents=tuple(sorted({max(args.max_concurrent // 2, 1),
                                          args.max_concurrent,
                                          args.max_concurrent * 2})),
            kv_dtypes=(1, 2))
    decision, gate = pick_serving(cfg, mix, capacity, knobs=knobs,
                                  space=space, max_len=args.max_len,
                                  service=service, store_dir=args.store_dir)
    s = gate["serving"]
    verdict = "admitted" if decision.admit else "rejected"
    print(f"[xmem] serve-mix {cfg.name}: {verdict} — worst-case "
          f"{s.get('worst_case_peak_bytes', decision.peak_bytes) / 2**20:.1f}"
          f" MiB / steady "
          f"{s.get('steady_state_peak_bytes', 0) / 2**20:.1f} MiB vs "
          f"{capacity / 2**30:.2f} GiB "
          f"(paged {s.get('paged_kv_peak_bytes', 0) / 2**20:.1f} MiB vs "
          f"monolithic {s.get('monolithic_cache_bytes', 0) / 2**20:.1f} "
          f"MiB; source {decision.provenance['source']})")
    for i, o in enumerate(decision.counter_offers or ()):
        k = o.serving["knobs"]
        print(f"[xmem]   offer #{i+1}: page={k['page_size']} "
              f"c={k['max_concurrent']} kv{8*k['kv_dtype_bytes']} "
              f"prefix={'on' if k['prefix_cache'] else 'off'} "
              f"peak={o.peak_bytes/2**20:.1f} MiB "
              f"slowdown=x{o.slowdown:.2f}")
    return 0 if decision.admit else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width is kept)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--capacity-gib", type=float, default=None,
                    help="default: what the card's allocator can hold")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store-dir", default=None,
                    help="persistent trace store for the serving gate")
    ap.add_argument("--serve-mix", default=None,
                    help="request-driven gate: prompt:decode:count[,...]")
    ap.add_argument("--arrival-period", type=int, default=1)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-concurrent", type=int, default=8)
    ap.add_argument("--kv-dtype-bytes", type=int, default=2)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--speculative-k", type=int, default=0)
    ap.add_argument("--plan", action="store_true",
                    help="on rejection, search serving counter-offers")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.n_layers or cfg.n_layers,
        attention=dataclasses.replace(cfg.attention, impl="flash"))
    on_card = torch.device(args.device).type == "cuda"
    if args.capacity_gib:
        capacity = int(args.capacity_gib * 2**30)
    elif on_card:
        capacity = device_capacity(args.device)
    elif args.serve_mix:
        ap.error("--serve-mix on the CPU needs --capacity-gib (the CPU "
                 "has no card to read a capacity from)")
    else:
        capacity = 1 << 62          # a CPU run budgets nothing

    if args.serve_mix:
        return serve_mix_main(cfg, args, capacity)
    batch, gate = pick_batch(cfg, args.max_len, capacity,
                             store_dir=args.store_dir)
    if batch is None:
        print(f"[xmem] no serving batch fits {capacity / 2**30:.2f} GiB "
              f"-> rejected")
        return 2
    print(f"[xmem] serving batch={batch} (peak {gate['peak'] / 2**20:.1f} "
          f"MiB = max(prefill {gate['prefill'].peak_bytes / 2**20:.1f}, "
          f"decode {gate['decode'].peak_bytes / 2**20:.1f}); gate source "
          f"{gate['candidates'][-1]['source']})")
    res = serve(cfg, batch, args.max_len, args.max_len - args.tokens,
                args.tokens, args.device)
    print(json.dumps({
        "device": args.device, "batch": batch,
        "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "decode_tok_per_s": res.decode_tok_per_s(),
        "peaks": {k: v.to_json() for k, v in (res.peaks or {}).items()},
        "tokens": res.tokens[-1][:, :8].tolist()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

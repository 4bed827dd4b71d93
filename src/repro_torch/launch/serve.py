"""Serving launcher: xMem batch gate, then prefill + greedy decode.

Before the KV cache is allocated, the xMem serving estimator (traced on
the CPU, replayed through the CUDA caching allocator simulation) picks
the largest batch whose prefill AND decode peaks fit the card: gating on
the decode step alone admits batches that run out of memory during
prefill, before a token decodes. Then the server runs the steps on the
card and reads each phase's real peak (``measured_peak``) beside its
estimate.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --n-layers 8 --max-len 2064 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
      --smoke --device cpu

As in the JAX package, prefill returns the last position's logits and
does not fill the KV cache; decoding starts at cache position 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..core.baselines.directprobe import measured_peak
from ..core.estimator import XMemEstimator
from ..models import model as M
from ..train.train_step import make_prefill_step, make_serve_step


def decode_input(cfg, b: int) -> dict:
    """One-token decode batch for ``M.decode_step`` (meta tensors)."""
    return {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                  device="meta")}


def prompt_specs(cfg, b: int, seq: int) -> dict:
    """Full-prompt prefill batch (no labels — serving, not training)."""
    return {"tokens": torch.empty((b, seq), dtype=torch.int32,
                                  device="meta")}


def make_prompts(cfg, b: int, seq: int, seed: int = 0) -> np.ndarray:
    """Random prompt tokens ``[b, seq]`` int32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, seq), dtype=np.int32)


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
    return prefill


def device_capacity(device="cuda") -> int:
    """Bytes of device memory the gate budgets against."""
    return int(torch.cuda.get_device_properties(device).total_memory)


def pick_batch(cfg, max_len: int, capacity: int | None = None,
               candidates=(64, 32, 16, 8, 4, 2, 1)):
    """Largest batch whose serving estimates fit ``capacity`` (default:
    the card's total memory).

    Gates on ``max(prefill, decode)`` peak, the prefill traced at a
    ``max_len`` prompt. Returns ``(batch, gate)``; ``gate`` holds every
    candidate tried and the admitting reports, or ``(None, gate)`` when
    no candidate fits."""
    if capacity is None:
        capacity = device_capacity()
    est = XMemEstimator.for_torch_gpu()
    params = M.abstract_params(cfg)
    decode_fn = make_decode_fn(cfg)
    prefill_fn = make_prefill_fn(cfg)
    gate: dict = {"capacity": capacity, "candidates": []}
    for b in candidates:
        cache = M.init_cache(cfg, b, max_len, device="meta")
        dec = est.estimate_serving(decode_fn, params, cache,
                                   decode_input(cfg, b), capacity=capacity)
        pre = est.estimate_serving(prefill_fn, params, cache,
                                   prompt_specs(cfg, b, max_len),
                                   capacity=capacity)
        peak = max(pre.peak_bytes, dec.peak_bytes)
        # replayed at ``capacity``, the simulated allocator frees its
        # cache and retries before it gives up, as the real one does: a
        # candidate fits when neither replay ran out of memory
        fits = not (pre.oom or dec.oom) and peak <= capacity
        gate["candidates"].append(
            {"batch": b, "prefill_peak": pre.peak_bytes,
             "decode_peak": dec.peak_bytes, "peak": peak, "fits": fits})
        if fits:
            gate.update(batch=b, prefill=pre, decode=dec, peak=peak)
            return b, gate
    return None, gate


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray            # [requests, batch, n_tokens] greedy ids
    prefill_logits: list          # per request, [batch, 1, vocab], host
    prefill_s: list[float]        # per request, synchronized wall time
    decode_s: list[float]         # per request, all decode steps
    peaks: dict | None            # {"prefill"/"decode": MeasuredPeak}

    def decode_tok_per_s(self, r: int = -1) -> float:
        n = self.tokens.shape[1] * self.tokens.shape[2]
        return n / self.decode_s[r]


def serve(cfg, batch: int, max_len: int, prompt_len: int, tokens: int,
          device="cuda", *, seed: int = 0, requests: int = 1,
          params=None) -> ServeResult:
    """Serve ``requests`` prompt batches one after another: prefill a
    random ``[batch, prompt_len]`` prompt, take its last-position argmax
    as the first token, then decode ``tokens`` tokens greedily.

    On a CUDA device every prefill and every decode loop runs through
    ``measured_peak``; ``peaks`` holds each phase's largest reading.
    Prefill logits go to the host before decoding: a device tensor kept
    across phases would pin its allocator segment under the next step."""
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
        if phase not in peaks or got.reserved > peaks[phase].reserved:
            peaks[phase] = got
        return got.out, got.seconds

    @torch.no_grad()
    def decode_loop(tok):
        out = []
        for i in range(tokens):
            logits, _ = M.decode_step(params, cache, {"tokens": tok}, i, cfg)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            del logits
            out.append(tok)
        return torch.cat(out, dim=1) if out else tok[:, :0]

    all_tokens, all_logits, pre_s, dec_s = [], [], [], []
    for r in range(requests):
        prompt = torch.from_numpy(
            make_prompts(cfg, batch, prompt_len, seed + r)).to(device)
        cache["k"].zero_()
        cache["v"].zero_()
        logits, seconds = run("prefill", prefill, params, {"tokens": prompt})
        pre_s.append(seconds)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        all_logits.append(logits.cpu())
        del logits, prompt
        gen, seconds = run("decode", decode_loop, tok)
        dec_s.append(seconds)
        all_tokens.append(gen.cpu().numpy())
    return ServeResult(tokens=np.stack(all_tokens), prefill_logits=all_logits,
                       prefill_s=pre_s, decode_s=dec_s, peaks=peaks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width is kept)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--capacity-gib", type=float, default=None,
                    help="default: the card's total memory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.n_layers or cfg.n_layers,
        attention=dataclasses.replace(cfg.attention, impl="flash"))
    if args.capacity_gib:
        capacity = int(args.capacity_gib * 2**30)
    elif torch.device(args.device).type == "cuda":
        capacity = device_capacity(args.device)
    else:
        capacity = 1 << 62          # a CPU run budgets nothing

    batch, gate = pick_batch(cfg, args.max_len, capacity)
    if batch is None:
        print(f"[xmem] no serving batch fits {capacity / 2**30:.2f} GiB "
              f"-> rejected")
        return 2
    print(f"[xmem] serving batch={batch} (peak {gate['peak'] / 2**20:.1f} "
          f"MiB = max(prefill {gate['prefill'].peak_bytes / 2**20:.1f}, "
          f"decode {gate['decode'].peak_bytes / 2**20:.1f}))")
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

"""A training estimate from a composed trace beside the full trace's.

The estimator traces a deep stack at a few units (probes of 2, 3 and 4
repeating units) and synthesizes the trace at the real depth exactly
(``core/depth.py``); this prints that estimate beside the one made from
the trace of every layer, with each one's source and seconds, on the
CPU at smoke width:

  PYTHONPATH=src python -m repro_torch.examples.depth --arch qwen3-32b \\
      --n-layers 32

Exits 1 when the two estimates differ by a byte.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..configs import get_smoke
from ..configs.base import smoke_shape
from ..configs.registry import input_specs
from ..core.estimator import XMemEstimator, trace_fwd_in_full
from ..models import model as M
from ..train import TrainPolicy, make_estimator_hooks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--n-layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_smoke(args.arch), n_layers=args.n_layers)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = M.abstract_params(cfg)
    batch = input_specs(cfg, smoke_shape(args.seq, args.batch))

    t0 = time.perf_counter()
    est = XMemEstimator.for_torch_gpu()
    composed = est.estimate_training(fwd, params, batch, update_fn=upd,
                                     opt_init_fn=init)
    t1 = time.perf_counter()
    ref = XMemEstimator.for_torch_gpu()
    full = ref.estimate_from_phases(*ref.trace_phases(
        fwd, params, batch, upd, init,
        fwd=trace_fwd_in_full(fwd, params, batch)))
    t2 = time.perf_counter()

    d = composed.depth
    units, traced = d["units"], d["units_traced"]
    print(f"{cfg.name} at {cfg.n_layers} layers ({units} units), batch "
          f"{args.batch} x {args.seq}")
    print(f"  composed: {composed.peak_bytes:>14,d} B (tensors "
          f"{composed.peak_tensor_bytes:,d}), source {d.get('source')}, "
          f"{traced} units traced, {t1 - t0:.2f} s")
    print(f"  full    : {full.peak_bytes:>14,d} B (tensors "
          f"{full.peak_tensor_bytes:,d}), {units} units traced, "
          f"{t2 - t1:.2f} s")
    same = all(getattr(composed, f) == getattr(full, f) for f in (
        "peak_bytes", "peak_tensor_bytes", "persistent_bytes", "oom"))
    print(f"  equal to the byte: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())

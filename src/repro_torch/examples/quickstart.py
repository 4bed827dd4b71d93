"""Quickstart: estimate a training job's peak GPU memory with xMem.

The estimate runs entirely on the CPU in seconds: the real eager step
is traced under fake tensors, nothing is allocated and no card is
touched, which is the paper's whole point. The job is the qwen3-family
smoke model with AdamW. Then, on a CUDA device, the same three steps
run on the card and ``torch.cuda.max_memory_reserved`` is the ground
truth the estimate is held to.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

With ``--device cpu`` the estimate is printed and nothing is measured:
the CPU has no caching allocator to compare with.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_smoke
from ..configs.base import smoke_shape
from ..configs.registry import input_specs
from ..core.baselines.directprobe import measured_training
from ..core.estimator import XMemEstimator
from ..models import model as M
from ..train import SyntheticDataset, TrainPolicy, make_estimator_hooks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke("qwen3-32b")
    shape = smoke_shape(seq_len=128, global_batch=8)
    policy = TrainPolicy(optimizer="adamw", clip_norm=None)

    # the estimator consumes the real step functions of the port
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    params = M.abstract_params(cfg)          # meta tensors: no allocation
    batch = input_specs(cfg, shape)
    est = XMemEstimator.for_torch_gpu()
    report = est.estimate_training(fwd_bwd, params, batch,
                                   update_fn=update, opt_init_fn=opt_init)
    print(f"xMem estimate        : {report.peak_bytes/2**20:8.2f} MiB")
    print(f"  persistent (P+opt) : {report.persistent_bytes/2**20:8.2f} MiB")
    print(f"  tensor peak        : {report.peak_tensor_bytes/2**20:8.2f} MiB")
    print(f"  estimation time    : {report.wall_time_s*1e3:8.1f} ms "
          f"({report.num_events} memory events)")

    if torch.device(args.device).type != "cuda":
        print("no ground truth on the CPU: run with a CUDA device to "
              "measure max_memory_reserved")
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the estimate alone")
        return 1
    # ground truth: the CUDA caching allocator's reservation over the
    # same three steps, from resident parameters
    ds = SyntheticDataset(cfg, shape)
    got = measured_training(
        fwd_bwd, update, opt_init, M.init_params(cfg, 0, device=args.device),
        lambda step: ds.device_batch(step, args.device), est.iterations,
        args.device)
    err = (report.peak_bytes - got.reserved) / got.reserved
    print(f"{torch.cuda.get_device_name(args.device)} max_memory_reserved: "
          f"{got.reserved/2**20:8.2f} MiB")
    print(f"relative error       : {err*100:+8.2f} %")
    print(f"losses               : {got.out.losses}")
    cap = int(got.reserved * 1.1)
    print(f"fits in {cap/2**20:.1f} MiB?  -> {report.fits(cap)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

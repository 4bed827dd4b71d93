"""Training and serving step factories, optimizers and data of the port."""
from .data import DataConfig, SyntheticDataset
from .optimizer import OPTIMIZERS, Optimizer, clip_by_global_norm, get_optimizer
from .train_step import (TrainPolicy, TrainRun, make_estimator_hooks,
                         make_fwd_bwd, make_prefill_step, make_serve_step,
                         make_train_step, run_steps)

__all__ = ["DataConfig", "SyntheticDataset", "OPTIMIZERS", "Optimizer",
           "clip_by_global_norm", "get_optimizer", "TrainPolicy", "TrainRun",
           "run_steps", "make_estimator_hooks", "make_fwd_bwd",
           "make_prefill_step", "make_serve_step", "make_train_step"]

"""Training and serving step factories, optimizers, data, checkpoints,
elastic re-carving and straggler detection of the port."""
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticDataset
from .elastic import (ElasticReplan, MeshPlan, StragglerMonitor,
                      replan_mesh, reshard_batch_size, shrink_and_replan)
from .optimizer import OPTIMIZERS, Optimizer, clip_by_global_norm, get_optimizer
from .train_step import (TrainPolicy, TrainRun, make_estimator_hooks,
                         make_fwd_bwd, make_prefill_step, make_serve_step,
                         make_train_step, run_steps)

__all__ = ["CheckpointManager", "DataConfig", "SyntheticDataset",
           "ElasticReplan", "MeshPlan", "StragglerMonitor", "replan_mesh",
           "reshard_batch_size", "shrink_and_replan",
           "OPTIMIZERS", "Optimizer",
           "clip_by_global_norm", "get_optimizer", "TrainPolicy", "TrainRun",
           "run_steps", "make_estimator_hooks", "make_fwd_bwd",
           "make_prefill_step", "make_serve_step", "make_train_step"]

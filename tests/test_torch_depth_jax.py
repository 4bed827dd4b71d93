"""Persistent bytes at the published depth against the JAX package.

For the 10 archs at smoke width with ``n_layers`` at the published
depth, the port's training estimate, made from composed traces
(``core/depth.py``), holds parameters, gradients and optimizer state
equal to the JAX package's: its estimate's persistent bytes are the JAX
estimate's plus the 4 bytes of each ``count`` scalar of the optimizer
state (the JAX trace folds them into literals; the card allocates
them), and its parameter inputs and gradient outputs have the JAX
parameters' bytes. The JAX package's estimator runs as its own tests run
it, on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.models import model as JM
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.events import BlockKind
from repro_torch.models import model as M
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks

S, B = 8, 2


def _bytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.dtype.itemsize
               for t in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_persistent_bytes_at_published_depth_match_jax(arch):
    depth = reg.get_config(arch).n_layers
    # remat moves no persistent byte, and "none" traces the least
    jcfg = dataclasses.replace(jreg.get_smoke(arch), n_layers=depth,
                               remat="none")
    tcfg = dataclasses.replace(reg.get_smoke(arch), n_layers=depth,
                               remat="none")
    jfwd, jupd, jinit = jax_hooks(jcfg, JaxTrainPolicy())
    jrep = JaxEstimator.for_torch_gpu().estimate_training(
        jfwd, JM.abstract_params(jcfg),
        jreg.input_specs(jcfg, jax_smoke_shape(S, B)), update_fn=jupd,
        opt_init_fn=jinit)
    fn, upd, init = make_estimator_hooks(tcfg, TrainPolicy())
    params = M.abstract_params(tcfg)
    batch = reg.input_specs(tcfg, smoke_shape(S, B))
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fn, params, batch, update_fn=upd,
                                opt_init_fn=init)
    assert rep.depth["source"] == "composed"
    assert rep.depth["units"] == M.repeat_unit(tcfg)[0] > 4
    fwd, _, init_phase = est.trace_phases(fn, params, batch, upd, init)
    counts = 4 * sum(1 for t in pytree.tree_leaves(init_phase.out_shape)
                     if t.ndim == 0)
    assert rep.persistent_bytes == jrep.persistent_bytes + counts
    param_bytes = _bytes(JM.abstract_params(jcfg))
    assert sum(b.size for b in fwd.input_blocks
               if b.kind is BlockKind.PARAM) == param_bytes
    assert sum(b.size for b in fwd.output_blocks
               if b.kind is BlockKind.GRAD) == param_bytes

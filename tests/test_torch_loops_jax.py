"""Step-loop composition against the JAX package.

For xlstm-smoke and jamba-smoke at a sequence of 4 chunks, the port's
training estimate, made with its step loops composed
(``core/loops.py``), holds parameters, gradients and optimizer state
equal to the JAX package's estimate (its persistent bytes are the JAX
estimate's plus the 4 bytes of each ``count`` scalar of the optimizer
state, as ``test_torch_depth_jax.py`` states); and the sLSTM and Mamba
blocks, whose step loops the composition marks, give the JAX functions'
outputs on the same numpy-seeded inputs and weights, at the tolerances
of ``test_torch_xlstm.py`` and ``test_torch_mamba.py``: the composition
moved no numerics. The reference's capped scan unroll is approximate,
so its peak is not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.models import mamba as jmam
from repro.models import model as JM
from repro.models import xlstm as jxl
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.events import BlockKind
from repro_torch.models import mamba as tmam
from repro_torch.models import model as M
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import tree_from_numpy
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_loops_jobs import JAMBA, SEQ, XLSTM

B = 2
RTOL, ATOL = 1e-4, 1e-5


def _bytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.dtype.itemsize
               for t in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_persistent_bytes_of_a_loop_composed_estimate_match_jax(arch):
    # remat moves no persistent byte, and "none" traces the least
    jcfg = dataclasses.replace(jreg.get_smoke(arch), remat="none")
    tcfg = dataclasses.replace(reg.get_smoke(arch), remat="none")
    jfwd, jupd, jinit = jax_hooks(jcfg, JaxTrainPolicy())
    jrep = JaxEstimator.for_torch_gpu().estimate_training(
        jfwd, JM.abstract_params(jcfg),
        jreg.input_specs(jcfg, jax_smoke_shape(SEQ, B)), update_fn=jupd,
        opt_init_fn=jinit)
    fn, upd, init = make_estimator_hooks(tcfg, TrainPolicy())
    params = M.abstract_params(tcfg)
    batch = reg.input_specs(tcfg, smoke_shape(SEQ, B))
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fn, params, batch, update_fn=upd,
                                opt_init_fn=init)
    assert rep.depth["loops"]["source"] == "composed"
    assert rep.depth["loops"]["signatures"][0][0] == 16   # 4 chunks each
    fwd, _, init_phase = est.trace_phases(fn, params, batch, upd, init)
    counts = 4 * sum(1 for t in pytree.tree_leaves(init_phase.out_shape)
                     if t.ndim == 0)
    assert rep.persistent_bytes == jrep.persistent_bytes + counts
    param_bytes = _bytes(JM.abstract_params(jcfg))
    assert sum(b.size for b in fwd.input_blocks
               if b.kind is BlockKind.PARAM) == param_bytes
    assert sum(b.size for b in fwd.output_blocks
               if b.kind is BlockKind.GRAD) == param_bytes


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_slstm_block_over_four_chunks_matches_jax():
    cfg = jreg.get_smoke(XLSTM)
    D, H, chunk = cfg.d_model, cfg.n_heads, cfg.xlstm.chunk
    jp = jxl.slstm_params(jax.random.key(0), D, H, jnp.float32)
    x = _rand(B, SEQ, D, seed=9)
    jout, jst = jxl.slstm_block(jnp.asarray(x), jp, H, chunk=chunk)
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tout, tst = txl.slstm_block(torch.from_numpy(x), tp, H, chunk=chunk)
    _close(tout, jout, "out")
    for name, a, b in zip("hcnm", tst, jst):
        _close(a, b, name)


def test_mamba_block_over_four_chunks_matches_jax():
    jm, tm = jreg.get_smoke(JAMBA).mamba, reg.get_smoke(JAMBA).mamba
    D = jreg.get_smoke(JAMBA).d_model
    jp = jmam.mamba_params(jax.random.key(0), D, jm, jnp.float32)
    x = _rand(B, SEQ, D, seed=3)
    jout = jmam.mamba_block(jnp.asarray(x), jp, jm)[0]
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tout, _ = tmam.mamba_block(torch.from_numpy(x), tp, tm)
    _close(tout, jout, "out")

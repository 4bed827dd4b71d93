"""Nested loops against the JAX package.

The blocks whose chunk loops now nest their step loops in a probe
(``models/steps.py``: the sLSTM's and Mamba's chunk loops over their
step loops, chunked attention's query loop over its key loop) give the
JAX functions' outputs on the same numpy-seeded inputs and weights at
16 and 17 chunks of 16 (the last shorter, or padded), at the tolerances
of ``test_torch_xlstm.py``, ``test_torch_mamba.py`` and
``test_torch_model.py``: marking the loops moved no numerics. And a
training estimate made with its loops composed at two levels holds
parameters, gradients and optimizer state equal to the JAX package's
estimate (its persistent bytes are the JAX estimate's plus the 4 bytes
of each ``count`` scalar of the optimizer state, as
``test_torch_depth_jax.py`` states). The reference's capped scan unroll
is approximate, so its peak is not compared.
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
from repro.models import layers as jl
from repro.models import mamba as jmam
from repro.models import model as JM
from repro.models import xlstm as jxl
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import loops as L
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.events import BlockKind
from repro_torch.models import layers as tl
from repro_torch.models import mamba as tmam
from repro_torch.models import model as M
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import tree_from_numpy
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_loops_jobs import JAMBA, NESTED_SEQ, XLSTM, nested


@pytest.fixture(autouse=True)
def _nest_16_chunks(monkeypatch):
    # the smoke configs' 16 chunks nest (the default NEST_MIN is 32, so
    # that each case traces 16 chunks in full, not 32)
    monkeypatch.setattr(L, "NEST_MIN", 16)


B = 2
RTOL, ATOL = 1e-4, 1e-5         # test_torch_xlstm.py, test_torch_mamba.py
ATTN_ATOL = 1e-4                # test_torch_model.py


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(port, ref, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _port_tree(jp):
    return tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


@pytest.mark.parametrize("S", [NESTED_SEQ, NESTED_SEQ + 8])
@pytest.mark.parametrize("grad", [False, True])
def test_chunked_attention_over_16_by_16_chunks_matches_jax(S, grad):
    # under grad mode each query chunk is checkpointed
    q, k, v = (_rand(B, S, 4, 16, seed=i) for i in range(3))
    want = jl.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk_q=16,
                                chunk_kv=16)
    with torch.set_grad_enabled(grad):
        got = tl.chunked_attention(
            *(torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)),
            chunk_q=16, chunk_kv=16)
    _close(got, want, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("S", [NESTED_SEQ, NESTED_SEQ + 8])
def test_slstm_block_over_16_chunks_matches_jax(S):
    cfg = jreg.get_smoke(XLSTM)
    D, H = cfg.d_model, cfg.n_heads
    jp = jxl.slstm_params(jax.random.key(0), D, H, jnp.float32)
    x = _rand(B, S, D, seed=9)
    jout, jst = jxl.slstm_block(jnp.asarray(x), jp, H, chunk=16)
    tout, tst = txl.slstm_block(torch.from_numpy(x), _port_tree(jp), H,
                                chunk=16)
    _close(tout, jout, "out")
    for name, a, b in zip("hcnm", tst, jst):
        _close(a, b, name)


@pytest.mark.parametrize("S", [NESTED_SEQ, NESTED_SEQ + 8])
def test_mamba_block_over_16_chunks_matches_jax(S):
    jm, tm = jreg.get_smoke(JAMBA).mamba, reg.get_smoke(JAMBA).mamba
    assert jm.chunk == tm.chunk == 16
    D = jreg.get_smoke(JAMBA).d_model
    jp = jmam.mamba_params(jax.random.key(0), D, jm, jnp.float32)
    x = _rand(B, S, D, seed=3)
    jout = jmam.mamba_block(jnp.asarray(x), jp, jm)[0]
    tout, _ = tmam.mamba_block(torch.from_numpy(x), _port_tree(jp), tm)
    _close(tout, jout, "out")


def _bytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.dtype.itemsize
               for t in jax.tree_util.tree_leaves(tree))


def test_persistent_bytes_of_a_nested_composed_estimate_match_jax():
    # remat moves no persistent byte, and "none" traces the least
    tcfg = nested(JAMBA, remat="none")
    base = jreg.get_smoke(JAMBA)
    jcfg = dataclasses.replace(
        base, n_layers=tcfg.n_layers, remat="none",
        attention=dataclasses.replace(base.attention, attn_every=2))
    jfwd, jupd, jinit = jax_hooks(jcfg, JaxTrainPolicy())
    jrep = JaxEstimator.for_torch_gpu().estimate_training(
        jfwd, JM.abstract_params(jcfg),
        jreg.input_specs(jcfg, jax_smoke_shape(NESTED_SEQ, B)),
        update_fn=jupd, opt_init_fn=jinit)
    fn, upd, init = make_estimator_hooks(tcfg, TrainPolicy())
    params = M.abstract_params(tcfg)
    batch = reg.input_specs(tcfg, smoke_shape(NESTED_SEQ, B))
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fn, params, batch, update_fn=upd,
                                opt_init_fn=init)
    loops = rep.depth["loops"]
    assert loops["source"] == "composed" and len(loops["by_level"]) == 2
    fwd, _, init_phase = est.trace_phases(fn, params, batch, upd, init)
    counts = 4 * sum(1 for t in pytree.tree_leaves(init_phase.out_shape)
                     if t.ndim == 0)
    assert rep.persistent_bytes == jrep.persistent_bytes + counts
    param_bytes = _bytes(JM.abstract_params(jcfg))
    assert sum(b.size for b in fwd.input_blocks
               if b.kind is BlockKind.PARAM) == param_bytes
    assert sum(b.size for b in fwd.output_blocks
               if b.kind is BlockKind.GRAD) == param_bytes

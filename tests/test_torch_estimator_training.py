"""The port's training estimate against the JAX package.

* Persistent bytes are byte-exact: parameters and optimizer state for
  all seven optimizers. The JAX trace folds the optimizer's zero
  ``count`` scalar into a jaxpr literal, so its estimate misses those
  4 bytes, which the card does allocate; the port counts them.
* Composition and replay are bit-identical: the JAX package's traced
  phases, converted, give the same report through the port's
  ``estimate_from_phases`` under the same ``OrchestratorPolicy``.
* Tensor peaks are not held: the op graphs differ. For qwen3-32b smoke,
  AdamW, clip 1.0, batch 2 x 64 tokens, the JAX package's
  ``for_torch_gpu`` estimate has a 3,814,400 B tensor peak (its update
  returns new parameters and state, and its preset adds f32 copies of
  every gradient); the port's has 2,242,048 B (in-place update, no
  synthetic copies, the CUDA kernels' own buffers), and 69,350,912 B
  with the two 32 MiB cuBLAS workspaces of its preset.
"""
import dataclasses
import resource
import time

import jax
import numpy as np
import pytest
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import events as tev
from repro_torch.core.analyzer import classify_blocks
from repro_torch.core.cache import BlockInfo, TracedPhase
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.orchestrator import MemoryOrchestrator
from repro_torch.core.orchestrator import OrchestratorPolicy
from repro_torch.models import model as TM
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks

ARCH = "qwen3-32b"
B, S = 2, 64


def _jax_job(opt="adamw", clip=1.0):
    cfg = jreg.get_smoke(ARCH)
    fwd, upd, init = jax_hooks(cfg, JaxTrainPolicy(optimizer=opt,
                                                   clip_norm=clip))
    return (fwd, JM.abstract_params(cfg),
            jreg.input_specs(cfg, jax_smoke_shape(S, B)), upd, init)


def _port_job(opt="adamw", clip=1.0, cfg=None, shape=None):
    cfg = cfg or treg.get_smoke(ARCH)
    fwd, upd, init = make_estimator_hooks(
        cfg, TrainPolicy(optimizer=opt, clip_norm=clip))
    return (fwd, TM.abstract_params(cfg),
            treg.input_specs(cfg, shape or smoke_shape(S, B)), upd, init)


def _estimate(est, job):
    fwd, params, batch, upd, init = job
    return est.estimate_training(fwd, params, batch, update_fn=upd,
                                 opt_init_fn=init)


def _bytes(tree):
    return sum(int(np.prod(t.shape)) * t.dtype.itemsize
               for t in jax.tree_util.tree_leaves(tree))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", sorted(jopt.OPTIMIZERS))
def test_persistent_bytes_match_jax(opt):
    jcfg, tcfg = jreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    jstate = jax.eval_shape(jopt.get_optimizer(opt).init,
                            JM.abstract_params(jcfg))
    tstate = topt.get_optimizer(opt).init(TM.abstract_params(tcfg))
    state_bytes = _bytes(jstate)
    assert sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tstate)) == state_bytes
    jax_rep = _estimate(JaxEstimator.for_torch_gpu(), _jax_job(opt))
    port = _estimate(XMemEstimator.for_torch_gpu(), _port_job(opt))
    counts = 4 * sum(1 for t in pytree.tree_leaves(tstate) if t.ndim == 0)
    assert port.persistent_bytes == jax_rep.persistent_bytes + counts
    assert port.persistent_bytes == \
        _bytes(JM.abstract_params(jcfg)) + state_bytes


def _to_port_phase(entry) -> TracedPhase:
    """A JAX ``TracedPhase`` in the port's types (schema-v5 columns,
    lifecycles and blocks with the port's enums)."""
    cols = tev.ColumnarTrace.from_json(entry.trace.columnar().to_json())
    trace = tev.Trace.from_columnar(cols, meta=dict(entry.trace.meta))

    def kind(k):
        return tev.BlockKind(k.value)
    lifecycles = tuple(tev.BlockLifecycle(
        b.block_id, b.size, b.alloc_t, b.free_t, b.iteration,
        tev.Phase(b.phase.value), b.op, b.scope, kind(b.block_kind),
        b.shard_factor, b.shape, tev.MemorySpace(b.space.value))
        for b in entry.lifecycles)

    def blocks(bs):
        return tuple(BlockInfo(b.bid, b.size, kind(b.kind), b.shape)
                     for b in bs)
    return TracedPhase(trace, lifecycles, blocks(entry.input_blocks),
                       blocks(entry.output_blocks))


@pytest.mark.parametrize("iterations", [2, 3, 5])
def test_composition_and_replay_are_bit_identical(iterations):
    jest = JaxEstimator.for_torch_gpu(iterations=iterations)
    fwd, params, batch, upd, init = _jax_job()
    phases = jest.trace_phases(fwd, params, batch, upd, init)
    want = jest.estimate_from_phases(*phases)
    jp = jest.orchestrator.policy
    policy = OrchestratorPolicy(**{f.name: getattr(jp, f.name)
                                   for f in dataclasses.fields(jp)})
    est = XMemEstimator(orchestrator_policy=policy, iterations=iterations)
    got = est.estimate_from_phases(*(_to_port_phase(p) for p in phases))
    assert got.peak_bytes == want.peak_bytes
    assert got.peak_tensor_bytes == want.peak_tensor_bytes
    assert got.persistent_bytes == want.persistent_bytes
    assert got.oom == want.oom
    assert got.breakdown == want.breakdown
    # the capacity sweep over the same composition
    assert est.min_feasible_capacity(None, None, None, report=got) == \
        jest.min_feasible_capacity(None, None, None, report=want)


def test_second_estimate_is_a_cache_hit_and_identical():
    est = XMemEstimator.for_torch_gpu()
    first = _estimate(est, _port_job())
    assert first.cache_stats["misses"] == 3 and first.cache_stats["hits"] == 0
    second = _estimate(est, _port_job())     # re-created hooks: same content
    assert second.cache_stats == {"hits": 3, "misses": 0,
                                  "global": est.trace_cache.stats()}
    for f in ("peak_bytes", "peak_tensor_bytes", "persistent_bytes", "oom",
              "breakdown", "num_events"):
        assert getattr(second, f) == getattr(first, f), f
    # another batch re-traces only the forward+backward
    third = _estimate(est, _port_job(shape=smoke_shape(S, 2 * B)))
    assert third.cache_stats["hits"] == 2 and \
        third.cache_stats["misses"] == 1


def test_port_preset_keeps_grads_through_the_update_without_upcasts():
    est = XMemEstimator.for_torch_gpu()
    rep = _estimate(est, _port_job())
    comp = rep.composition
    blocks = comp.prefix + comp.cycle + comp.suffix
    assert not [b for b in blocks if b.op == "grad_upcast"]
    params = sum(b.size for b in comp.prefix if b.op == "init")
    # each iteration's gradients (the parameters' bytes) die when its
    # update has finished, after every update-phase block was allocated
    for it in {b.iteration for b in blocks}:
        last_upd = max(b.alloc_t for b in blocks if b.iteration == it
                       and b.phase is tev.Phase.OPTIMIZER)
        alive = [b for b in blocks if b.iteration == it
                 and b.block_kind is tev.BlockKind.GRAD
                 and b.free_t is not None and b.free_t > last_upd]
        assert sum(b.size for b in alive) == params


def test_after_update_release_in_fused_and_unfused_passes():
    blocks = [tev.BlockLifecycle(i, 64 * (i + 1), i, None, it,
                                 tev.Phase.FORWARD_BACKWARD, "op", "",
                                 tev.BlockKind.GRAD)
              for it in (0, 1) for i in range(3)]
    orch = MemoryOrchestrator(OrchestratorPolicy(
        grad_release="after_update", donate_params=False,
        donate_opt_state=False, fusion_folding=False,
        optimizer_upcast_coexist=False))
    kw = dict(iteration_ends={0: 10, 1: 20}, update_start={0: 5, 1: 15},
              next_bwd_start={0: 5, 1: 15})
    fused, unfused = orch.run(blocks, **kw), orch.run_unfused(blocks, **kw)
    assert fused == unfused
    assert [b.free_t for b in fused] == [10] * 3 + [20] * 3


def test_backward_blocks_are_classified_as_gradient_candidates():
    est = XMemEstimator.for_torch_gpu()
    fwd, params, batch, upd, init = _port_job()
    phase, _, _ = est.trace_phases(fwd, params, batch)
    sizes = frozenset(b.size for b in phase.input_blocks
                      if b.kind is tev.BlockKind.PARAM)
    got = classify_blocks(phase.lifecycles, sizes)
    assert any(b.block_kind is tev.BlockKind.GRAD and b.free_t is not None
               for b in got)


def test_full_width_estimate_is_fast_and_allocates_nothing():
    # qwen3-32b at full width, 4 layers, batch 1 x 4096 tokens: the gate's
    # fourth candidate in chip_smoke's train phase
    cfg = dataclasses.replace(treg.get_config(ARCH), n_layers=4)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # KiB
    t0 = time.perf_counter()
    rep = _estimate(XMemEstimator.for_torch_gpu(),
                    _port_job(cfg=cfg, shape=smoke_shape(4096, 1)))
    seconds = time.perf_counter() - t0
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    params = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves(TM.abstract_params(cfg)))
    # param_count() leaves out the qk-norm scales (4 layers x 2 x 128)
    assert params == (cfg.param_count() + 1024) * 2          # bf16
    assert rep.persistent_bytes == params + 2 * 2 * params + 4   # m, v f32
    assert rep.peak_tensor_bytes > rep.persistent_bytes + params  # + grads
    assert not rep.oom
    assert grown < 2 * 2**30          # 42 GB of tensors, none allocated
    assert seconds < 60


def test_preset_adds_the_two_cublas_workspaces_to_the_first_iteration():
    # the job's thread at its first forward matmul, the autograd
    # engine's at its first backward one; held for good
    rep = _estimate(XMemEstimator.for_torch_gpu(), _port_job())
    comp = rep.composition
    ws = [b for b in comp.prefix + comp.cycle + comp.suffix
          if b.op == "cublas_workspace"]
    assert [(b.scope, b.size, b.free_t, b.iteration) for b in ws] == [
        ("", 32 << 20, None, 0), ("backward", 32 << 20, None, 0)]
    mm = {scope: min(b.alloc_t for b in comp.prefix if b.scope == scope
                     and b.op in ("aten::mm", "aten::bmm"))
          for scope in ("", "backward")}
    assert [b.alloc_t for b in ws] == [mm[""], mm["backward"]]
    bare = _estimate(XMemEstimator.for_torch_gpu(cublas_workspace=0),
                     _port_job())
    assert rep.peak_tensor_bytes == bare.peak_tensor_bytes + (64 << 20)
    assert rep.persistent_bytes == bare.persistent_bytes

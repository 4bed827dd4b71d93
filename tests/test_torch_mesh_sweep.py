"""The port's per-device estimates of sharded jobs and its mesh-topology
sweep, against the JAX package's and against themselves, on the CPU.

* Bit-identical to the reference on the same trace dump: the JAX
  package's traced phases, converted (schema v5 columns), give the same
  ``estimate_mesh_sweep`` reports (peaks, persistent bytes, OOM,
  breakdown, events) through the port's sweep as through the
  reference's, over 1-, 2-, 4- and 8-device grids with a pod axis, for
  the reference's MLP job and for the dense and MoE smoke jobs.
* The reference's own cases (``tests/test_mesh_sweep.py``), ported: the
  fast path equals ``fastpath=False`` under sharding and collectives,
  one trace serves a grid, the sweep equals pointwise estimates, the
  divisibility properties, collective staging sized from per-device
  blocks, spec factors across an interpolated batch sweep, the decode
  state's cache factors.
* The sweep equals pointwise ``estimate_training`` for six families at
  smoke size, and a mesh sweep after a store restart equals the one
  before, from the disk.
"""
import dataclasses

import jax
import pytest
import torch
from torch.utils import _pytree as pytree

import test_mesh_sweep as ref
from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.cache import TraceCache as JaxTraceCache
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.core.sweep import SweepService as JaxSweepService
from repro.core.sweep import topology_grid as jax_topology_grid
from repro.models import model as JM
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.cache import TraceCache
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.events import BlockKind, BlockLifecycle, Phase
from repro_torch.core.orchestrator import (CollectiveSpec, MemoryOrchestrator,
                                           OrchestratorPolicy)
from repro_torch.core.sweep import (MeshTopology, SweepPoint, SweepService,
                                    topology_grid)
from repro_torch.distributed.sharding import (ShardingPolicy,
                                              SpecShardFactors,
                                              mesh_collective_specs,
                                              shard_factor_fn, spec_factor,
                                              spec_for_path)
from repro_torch.models import model as TM
from repro_torch.service import AdmissionService
from repro_torch.train import TrainPolicy, make_estimator_hooks
from test_torch_estimator_training import _to_port_phase

L, D, H = ref.L, ref.D, ref.H
SEQ, BATCH = 32, 4


# -- the reference's MLP job in torch -----------------------------------------
def _loss(p, b):
    h = b["x"]
    for i in range(L):
        h = torch.tanh(h @ p[f"w{i}"])
    return ((h - b["y"]) ** 2).mean()


def _fwd_bwd(p, b):
    leaves, spec = pytree.tree_flatten(p)
    leaves = [t.detach().requires_grad_() for t in leaves]
    value = _loss(pytree.tree_unflatten(leaves, spec), b)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), pytree.tree_unflatten(list(grads), spec)


def _adam_init(p):
    return {k: (torch.zeros_like(x), torch.zeros_like(x))
            for k, x in p.items()}


@torch.no_grad()
def _adam(p, g, s):
    for k, x in p.items():
        m, v = s[k]
        m.mul_(0.9).add_(g[k], alpha=0.1)
        v.mul_(0.999).addcmul_(g[k], g[k], value=0.001)
        x.sub_(1e-3 * m / (v.sqrt() + 1e-8))
    return p, s


def _workload(batch=16):
    params = {f"w{i}": torch.empty((D, H) if i % 2 == 0 else (H, D),
                                   device="meta") for i in range(L)}
    data = {"x": torch.empty((batch, D), device="meta"),
            "y": torch.empty((batch, D), device="meta")}
    return params, data


def _factor_fn(params, batch, mesh=None, policy=None, opt_state=None):
    return shard_factor_fn(
        None, mesh or {"data": 4, "model": 2},
        policy or ShardingPolicy(fsdp=True, batch_axes=("data",)),
        params=params, batch=batch, opt_state=opt_state)


def _report_tuple(rep):
    return (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.oom, rep.breakdown, rep.num_events)


def _full(rep):
    return _report_tuple(rep) + (rep.sim.peak_reserved,
                                 rep.sim.peak_allocated)


def _estimate(est, params, batch, **kw):
    return est.estimate_training(_fwd_bwd, params, batch, update_fn=_adam,
                                 opt_init_fn=_adam_init, **kw)


# -- bit-identical to the reference on the same trace dump ----------------------
def _port_phases(jphases):
    """The reference's phases in the port's types, with their abstract
    outputs as meta tensors (the sweep resolves the optimizer state's
    factors from the init phase's outputs)."""
    out = []
    for ph in jphases:
        if ph is None:
            out.append(None)
            continue
        out.append(dataclasses.replace(
            _to_port_phase(ph),
            out_shape=[torch.empty(tuple(leaf.shape), device="meta")
                       for leaf in jax.tree_util.tree_leaves(ph.out_shape)]))
    return tuple(out)


def _port_estimator(jest):
    jp = jest.orchestrator.policy
    policy = OrchestratorPolicy(**{f.name: getattr(jp, f.name)
                                   for f in dataclasses.fields(jp)})
    return XMemEstimator(orchestrator_policy=policy,
                         iterations=jest.iterations,
                         trace_cache=TraceCache())


def _jax_grid():
    return (jax_topology_grid(1) + jax_topology_grid(2)
            + jax_topology_grid(4) + jax_topology_grid(8, pods=(2,)))


def _port_grid():
    return (topology_grid(1) + topology_grid(2) + topology_grid(4)
            + topology_grid(8, pods=(2,)))


def _jax_job(arch):
    if arch is None:
        params, batch = ref._workload()
        return ref._fwd_bwd, params, batch, ref._adam, ref._adam_init, None
    cfg = jreg.get_smoke(arch)
    fwd, upd, init = jax_hooks(cfg, JaxTrainPolicy())
    return (fwd, JM.abstract_params(cfg),
            jreg.input_specs(cfg, jax_smoke_shape(SEQ, BATCH)), upd, init,
            cfg)


def _port_trees(arch):
    if arch is None:
        return _workload()
    cfg = treg.get_smoke(arch)
    return (TM.abstract_params(cfg),
            treg.input_specs(cfg, smoke_shape(SEQ, BATCH)))


@pytest.mark.parametrize("arch", [None, "qwen3-32b", "phi3.5-moe-42b-a6.6b"])
def test_mesh_sweep_is_bit_identical_to_the_reference(arch):
    fwd, jparams, jbatch, upd, init, jcfg = _jax_job(arch)
    jest = JaxEstimator.for_torch_gpu(trace_cache=JaxTraceCache())
    want = JaxSweepService(jest).estimate_mesh_sweep(
        fwd, jparams, jbatch, _jax_grid(), update_fn=upd, opt_init_fn=init,
        cfg=jcfg)
    phases = _port_phases(jest.trace_phases(fwd, jparams, jbatch, upd,
                                            init))
    est = _port_estimator(jest)
    est.trace_phases = lambda *a, **k: phases
    params, batch = _port_trees(arch)
    got = SweepService(est).estimate_mesh_sweep(
        None, params, batch, _port_grid(), update_fn=None, opt_init_fn=None)
    assert [t.label for t in got.topologies] == \
        [t.label for t in want.topologies]
    for t, g, w in zip(got.topologies, got.reports, want.reports):
        assert _full(g) == _full(w), t.label
    # the grid spans real differences: per-device peaks and collectives
    assert len({r.peak_tensor_bytes for r in got.reports}) > 3
    assert any(b["num_blocks"] > got.reports[0].breakdown["num_blocks"]
               for b in (r.breakdown for r in got.reports))
    # and the same admission verdicts at a capacity between them
    cap = sorted(r.peak_bytes for r in want.reports)[len(want.reports) // 2]
    assert [t.label for t in got.admitted(cap)] == \
        [t.label for t in want.admitted(cap)]
    assert got.best(cap)[0].label == want.best(cap)[0].label


# -- the reference's cases, ported --------------------------------------------
@pytest.mark.parametrize("iterations", [1, 3, 8])
@pytest.mark.parametrize("collectives", [False, True])
def test_fastpath_equals_the_reference_pipeline_sharded(iterations,
                                                        collectives):
    params, batch = _workload()
    factor = _factor_fn(params, batch)
    specs = mesh_collective_specs(
        {"data": 4, "model": 2},
        ShardingPolicy(fsdp=True, batch_axes=("data",))) \
        if collectives else ()
    fast = XMemEstimator.for_torch_gpu(iterations=iterations,
                                       trace_cache=TraceCache())
    slow = XMemEstimator.for_torch_gpu(iterations=iterations,
                                       fastpath=False)
    r_fast = _estimate(fast, params, batch, shard_factor_fn=factor,
                       collective_specs=specs)
    r_slow = _estimate(slow, params, batch, shard_factor_fn=factor,
                       collective_specs=specs)
    assert _full(r_fast) == _full(r_slow)
    if collectives and iterations > 1:
        plain = _estimate(fast, params, batch, shard_factor_fn=factor)
        assert r_fast.breakdown["num_blocks"] > plain.breakdown["num_blocks"]


def test_sharding_reduces_per_device_estimate():
    params, batch = _workload()
    est = XMemEstimator.for_torch_gpu(trace_cache=TraceCache(),
                                      cublas_workspace=0)
    base = _estimate(est, params, batch)
    sharded = _estimate(est, params, batch,
                        shard_factor_fn=_factor_fn(params, batch))
    # (the reserved peak is one 2 MiB segment either way at this size)
    assert sharded.peak_tensor_bytes < base.peak_tensor_bytes
    assert sharded.persistent_bytes < base.persistent_bytes
    # shard factors do not enter the trace key
    assert est.trace_cache.stats()["misses"] == 3


def test_grid_from_single_trace():
    params, batch = _workload()
    svc = SweepService(XMemEstimator.for_torch_gpu(trace_cache=TraceCache()))
    grid = topology_grid(8) + topology_grid(16, pods=(2,))
    assert len(grid) >= 8 and len(set(grid)) == len(grid)
    assert not any(t.fsdp and t.data * t.pod == 1 for t in grid)
    res = svc.estimate_mesh_sweep(_fwd_bwd, params, batch, grid,
                                  update_fn=_adam, opt_init_fn=_adam_init)
    assert res.stats["topologies"] == len(grid) == len(res)
    assert res.stats["trace_cache"] == {"hits": 0, "misses": 3}
    again = svc.estimate_mesh_sweep(_fwd_bwd, params, batch, grid[:2],
                                    update_fn=_adam, opt_init_fn=_adam_init)
    assert again.stats["trace_cache"] == {"hits": 3, "misses": 0}
    assert [_full(r) for r in again.reports] == \
        [_full(r) for r in res.reports[:2]]


def test_topology_grid_equals_the_references():
    for n in (1, 2, 4, 6, 8, 16):
        for pods in ((1,), (2,), (1, 2, 3)):
            for fsdp in ((False, True), (False,), (True,)):
                got = [dataclasses.astuple(t) + (t.label, t.n_devices)
                       for t in topology_grid(n, pods=pods, fsdp=fsdp)]
                want = [dataclasses.astuple(t) + (t.label, t.n_devices)
                        for t in jax_topology_grid(n, pods=pods, fsdp=fsdp)]
                assert got == want
    t = MeshTopology(pod=2, data=2, model=4, fsdp=True)
    assert t.axis_sizes == {"pod": 2, "data": 2, "model": 4}
    assert t.sharding_policy() == ShardingPolicy(
        fsdp=True, fsdp_axes=("data", "pod"), batch_axes=("pod", "data"))


def test_sweep_matches_pointwise_exactly_with_opt_state():
    params, batch = _workload()
    svc = SweepService(XMemEstimator.for_torch_gpu(trace_cache=TraceCache()))
    grid = [MeshTopology(data=4, model=2, fsdp=True),
            MeshTopology(data=4, model=2),
            MeshTopology(data=2, model=4, fsdp=True),
            MeshTopology(pod=2, data=2, model=2)]
    res = svc.estimate_mesh_sweep(_fwd_bwd, params, batch, grid,
                                  update_fn=_adam, opt_init_fn=_adam_init)
    opt_state = _adam_init(params)
    for topo, rep in res:
        pol = topo.sharding_policy()
        want = _estimate(
            XMemEstimator.for_torch_gpu(trace_cache=TraceCache()), params,
            batch, shard_factor_fn=shard_factor_fn(
                None, topo.axis_sizes, pol, params=params,
                opt_state=opt_state, batch=batch),
            collective_specs=mesh_collective_specs(topo.axis_sizes, pol))
        assert _full(rep) == _full(want), topo.label


def test_admitted_and_best():
    params, batch = _workload()
    svc = SweepService(XMemEstimator.for_torch_gpu(trace_cache=TraceCache()))
    res = svc.estimate_mesh_sweep(_fwd_bwd, params, batch, topology_grid(8),
                                  update_fn=_adam, opt_init_fn=_adam_init)
    cap = max(r.peak_bytes for r in res.reports)
    assert len(res.admitted(cap)) == len(res.reports)
    best = res.best(cap)
    assert best is not None and best[1].peak_bytes <= cap
    assert res.best(0) is None
    # replayed at a capacity, an out-of-memory replay is not admitted
    low = min(r.peak_bytes for r in res.reports) - 1
    at = svc.estimate_mesh_sweep(_fwd_bwd, params, batch, topology_grid(8),
                                 update_fn=_adam, opt_init_fn=_adam_init,
                                 capacity=low)
    assert all(r.oom for r in at.reports)
    assert at.admitted(low) == [] and at.best(low) is None


def test_heuristic_mode_available():
    params, batch = _workload()
    svc = SweepService(XMemEstimator.for_torch_gpu(trace_cache=TraceCache()))
    res = svc.estimate_mesh_sweep(
        _fwd_bwd, params, batch, [MeshTopology(data=4, model=2)],
        update_fn=_adam, opt_init_fn=_adam_init,
        shard_factors="heuristic", collectives=False)
    assert res.stats["shard_factors"] == "heuristic"


def test_nondivisible_param_spec_vs_heuristic():
    mesh = {"data": 4, "model": 16}
    pol = ShardingPolicy(batch_axes=("data",))
    params = {"embed": torch.empty((151655, 898), dtype=torch.bfloat16,
                                   device="meta")}
    spec = shard_factor_fn(None, mesh, pol, params=params)
    heur = shard_factor_fn(None, mesh, pol, mode="heuristic")
    blk = BlockLifecycle(0, 151655 * 898 * 2, 0, None,
                         block_kind=BlockKind.PARAM, shape=(151655, 898))
    assert heur(blk) == 16.0       # the documented underestimate
    assert spec(blk) == 1.0        # replicated: 151655 % 16 != 0


def test_spec_factor_exact_division():
    mesh = {"data": 4, "model": 8}
    shape = (64, 512)
    spec = spec_for_path("['layers']['attn']['wq']", shape, mesh,
                         ShardingPolicy(fsdp=True, batch_axes=("data",)))
    f = spec_factor(spec, shape, mesh)
    nbytes = 64 * 512 * 4
    assert (nbytes / f) == nbytes // f


@pytest.mark.parametrize("shape", ref._PROPERTY_SHAPES)
@pytest.mark.parametrize("mesh", ref._PROPERTY_MESHES)
def test_no_fractional_shards(shape, mesh):
    elems = 1
    for d in shape:
        elems *= d
    for fsdp in (False, True):
        pol = ShardingPolicy(fsdp=fsdp, batch_axes=("data",))
        for path in ("['embed']", "['layers']['attn']['wq']",
                     "['layers']['moe']['we_gate']", "['unmatched']"):
            f = spec_factor(spec_for_path(path, shape, mesh, pol), shape,
                            mesh)
            assert f >= 1.0 and elems % int(f) == 0 and float(int(f)) == f


def test_monotone_when_divisible_and_replicated_past_it():
    pol = ShardingPolicy(fsdp=True, batch_axes=("data",))
    for shape in ((64, 512), (128, 256)):
        prev = None
        for m in (1, 2, 4, 8):
            mesh = {"data": m, "model": m}
            f = spec_factor(spec_for_path("['layers']['attn']['wq']", shape,
                                          mesh, pol), shape, mesh)
            per_dev = shape[0] * shape[1] * 4 / f
            assert prev is None or per_dev <= prev
            prev = per_dev
    pol = ShardingPolicy(batch_axes=("data",))
    shape = (6, 130)
    f2, f4 = (spec_factor(spec_for_path("['layers']['attn']['wq']", shape,
                                        {"model": m}, pol), shape,
                          {"model": m}) for m in (2, 4))
    assert f2 == 2.0 and f4 == 1.0


class TestCollectiveInjection:
    def _bounds(self):
        return {(0, "fwd_bwd"): (2, 10), (0, "optimizer"): (10, 14)}

    def _blocks(self):
        return [
            BlockLifecycle(1, 4096, 0, None, 0, Phase.INIT, "init",
                           "params", BlockKind.PARAM, 1.0, (32, 32)),
            BlockLifecycle(2, 2048, 3, 10, 0, Phase.FORWARD_BACKWARD,
                           "aten::mm", "", BlockKind.GRAD, 1.0, (16, 32)),
            BlockLifecycle(3, 1024, 4, 8, 0, Phase.FORWARD_BACKWARD,
                           "aten::mm", "", BlockKind.ACTIVATION, 1.0,
                           (8, 32)),
        ]

    def _coll(self, specs, **kw):
        out = MemoryOrchestrator().inject_collectives(
            self._blocks(), specs, self._bounds(), 1, **kw)
        return {b.scope: b for b in out
                if b.block_kind is BlockKind.COLLECTIVE}

    def test_dynamic_specs_sized_from_actual_blocks(self):
        specs = mesh_collective_specs({"data": 4, "model": 1},
                                      ShardingPolicy(batch_axes=("data",)))
        assert {s.name for s in specs} == {"grad_allreduce[data]"}
        ar = self._coll(specs)["grad_allreduce[data]"]
        assert ar.size == 2048 and ar.alloc_t == 9 and ar.free_t == 10

    def test_fsdp_reduce_scatter_replaces_allreduce(self):
        specs = mesh_collective_specs(
            {"data": 4, "model": 1},
            ShardingPolicy(fsdp=True, fsdp_axes=("data",),
                           batch_axes=("data",)))
        names = {s.name for s in specs}
        assert "grad_allreduce[data]" not in names
        assert {"param_allgather[data]", "grad_reducescatter[data]"} <= names
        coll = self._coll(specs)
        assert coll["grad_reducescatter[data]"].size == 2048
        assert coll["param_allgather[data]"].size == 4096 * 4

    def test_dynamic_sizing_uses_per_device_factors(self):
        params = {"w": torch.empty((16, 32), device="meta")}
        mesh = {"data": 4, "model": 1}
        pol = ShardingPolicy(fsdp=True, fsdp_axes=("data",),
                             batch_axes=("data",))
        coll = self._coll(mesh_collective_specs(mesh, pol),
                          shard_factor_fn=shard_factor_fn(None, mesh, pol,
                                                          params=params))
        assert coll["grad_reducescatter[data]"].size == 2048 // 4

    def test_fixed_specs_unchanged(self):
        coll = [b for b in MemoryOrchestrator().inject_collectives(
            self._blocks(), [CollectiveSpec("bucket", 12345,
                                            Phase.FORWARD_BACKWARD)],
            self._bounds(), 1) if b.block_kind is BlockKind.COLLECTIVE]
        assert len(coll) == 1 and coll[0].size == 12345
        assert coll[0].alloc_t == 2 and coll[0].free_t == 10


def test_interpolated_sweep_with_spec_factors():
    """Spec factors across an interpolated batch sweep equal per-point
    estimates: a synthesized phase carries each block's shape."""
    params, _ = _workload()
    mesh = {"data": 4, "model": 2}
    pol = ShardingPolicy(fsdp=True, batch_axes=("data",))

    def mk(b):
        return shard_factor_fn(None, mesh, pol, params=params,
                               batch=_workload(b)[1])
    grids = [4, 8, 12, 16, 20, 24]
    pts = [SweepPoint(_fwd_bwd, params, _workload(b)[1], update_fn=_adam,
                      opt_init_fn=_adam_init, shard_factor_fn=mk(b),
                      collective_specs=mesh_collective_specs(mesh, pol))
           for b in grids]
    res = SweepService(XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache())).estimate_many(pts)
    assert res.stats["interpolated"] > 0
    for b, rep in zip(grids, res.reports):
        want = _estimate(XMemEstimator.for_torch_gpu(trace_cache=TraceCache()),
                         params, _workload(b)[1], shard_factor_fn=mk(b),
                         collective_specs=mesh_collective_specs(mesh, pol))
        assert _full(rep) == _full(want), b


def test_decode_state_sharded_by_cache_specs():
    cache = {"k": torch.empty((2, 8, 64, 4, 16), device="meta"),
             "v": torch.empty((2, 8, 64, 4, 16), device="meta")}
    params = {"w": torch.empty((64, 64), device="meta")}
    batch = {"tok": torch.empty((8, 1), dtype=torch.int64, device="meta")}

    def decode(p, c, b):
        x = p["w"][b["tok"][:, 0]]
        return x.sum() + (c["k"] + 0.0).sum(), c

    factor = shard_factor_fn(None, {"data": 4, "model": 2},
                             ShardingPolicy(batch_axes=("data",)),
                             params=params, cache=cache)
    est = XMemEstimator.for_torch_gpu(trace_cache=TraceCache())
    base = est.estimate_serving(decode, params, cache, batch)
    sharded = est.estimate_serving(decode, params, cache, batch,
                                   shard_factor_fn=factor)
    assert sharded.persistent_bytes < base.persistent_bytes
    assert sharded.breakdown["persistent_by_kind"]["cache"] * 8 == \
        base.breakdown["persistent_by_kind"]["cache"]


def test_resolver_details():
    params = {"w": torch.empty((256, 512), device="meta")}
    f = SpecShardFactors({"data": 4, "model": 8},
                         ShardingPolicy(fsdp=True, batch_axes=("data",)),
                         params=params)
    assert f(BlockLifecycle(0, 256 * 512 * 4, 0, None,
                            block_kind=BlockKind.OPT_STATE,
                            shape=(256, 512))) == 32.0
    assert f(BlockLifecycle(1, 4, 0, None, block_kind=BlockKind.OPT_STATE,
                            shape=())) == 1.0
    amb = SpecShardFactors(
        {"data": 2, "model": 4}, ShardingPolicy(batch_axes=("data",)),
        params={"layers": {"moe": {"router": torch.empty((64, 128),
                                                         device="meta")}},
                "attn": {"wq": torch.empty((64, 128), device="meta")}})
    assert amb(BlockLifecycle(0, 64 * 128 * 4, 0, None,
                              block_kind=BlockKind.GRAD,
                              shape=(64, 128))) == 1.0


# -- six families: the sweep equals pointwise estimates ------------------------
FAMILIES = ["qwen3-32b", "phi3.5-moe-42b-a6.6b", "internvl2-1b",
            "musicgen-medium", "xlstm-1.3b", "jamba-1.5-large-398b"]
FAMILY_GRID = [MeshTopology(data=2, model=2), MeshTopology(data=2, model=2,
                                                           fsdp=True),
               MeshTopology(pod=2, data=1, model=2)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_sweep_equals_pointwise_for_every_family(arch):
    cfg = treg.get_smoke(arch)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = TM.abstract_params(cfg)
    # 8 positions: the recurrent families' traces grow with the sequence
    batch = treg.input_specs(cfg, smoke_shape(8, BATCH))
    est = XMemEstimator.for_torch_gpu(trace_cache=TraceCache())
    res = SweepService(est).estimate_mesh_sweep(
        fwd, params, batch, FAMILY_GRID, update_fn=upd, opt_init_fn=init,
        cfg=cfg)
    assert res.stats["trace_cache"]["misses"] == 3
    opt_state = init(params)
    for topo, rep in res:
        pol = topo.sharding_policy()
        want = est.estimate_training(
            fwd, params, batch, update_fn=upd, opt_init_fn=init,
            shard_factor_fn=shard_factor_fn(cfg, topo.axis_sizes, pol,
                                            params=params,
                                            opt_state=opt_state,
                                            batch=batch),
            collective_specs=mesh_collective_specs(topo.axis_sizes, pol))
        assert _full(rep) == _full(want), topo.label
        assert rep.persistent_bytes < est.estimate_training(
            fwd, params, batch, update_fn=upd,
            opt_init_fn=init).persistent_bytes


def test_mesh_sweep_after_a_store_restart_equals_the_one_before(tmp_path):
    cfg = treg.get_smoke("qwen3-32b")
    grid = topology_grid(2) + topology_grid(4)

    def sweep(svc):
        fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
        return svc.mesh_sweep(
            fwd, TM.abstract_params(cfg),
            treg.input_specs(cfg, smoke_shape(SEQ, BATCH)), grid,
            update_fn=upd, opt_init_fn=init, cfg=cfg, capacity=1 << 30)

    sd = str(tmp_path / "store")
    svc = AdmissionService(workers=1, store_dir=sd)
    before = sweep(svc)
    svc.close()
    svc2 = AdmissionService(workers=1, store_dir=sd)
    after = sweep(svc2)
    svc2.close()
    assert after.stats["trace_cache"]["misses"] == 0
    assert svc2.cache.stats()["store_hits"] == 3
    assert [_full(r) for r in after.reports] == \
        [_full(r) for r in before.reports]


def test_the_mesh_and_plan_hillclimbs_answer_with_the_references_keys(
        tmp_path, capsys):
    import json

    from repro_torch.launch import hillclimb as thc
    args = ["--smoke", "--device", "cpu", "--hbm-gib", "0.089", "--devices",
            "2,4", "--out", str(tmp_path)]
    assert thc.main(["--xmem-mesh", "qwen3-32b", *args]) == 0
    mesh = json.loads((tmp_path / "xmem_mesh__qwen3-32b.json").read_text())
    assert {"arch", "kind", "hbm_bytes", "seq", "batch", "topologies",
            "sweep", "best_topology", "best_devices",
            "best_peak_bytes"} <= set(mesh)
    assert mesh["kind"] == "xmem_mesh" and len(mesh["topologies"]) == 8
    assert mesh["sweep"]["trace_cache"]["misses"] == 3
    fits = [r for r in mesh["topologies"] if r["fits"]]
    assert fits and all(r["peak_bytes"] <= 0.089 * 2**30 for r in fits)
    best = min(fits, key=lambda r: (r["devices"], r["peak_bytes"]))
    assert mesh["best_topology"] == best["topology"]
    rc = thc.main(["--xmem-plan", "qwen3-32b", *args])
    plan = json.loads((tmp_path / "xmem_plan__qwen3-32b.json").read_text())
    assert rc == 0 and plan["kind"] == "xmem_plan" and not plan["admit"]
    assert any(o["knob"] == "topology" for o in plan["counter_offers"])
    assert plan["stats"]["axes"]["topology"] == 8
    out = capsys.readouterr().out
    assert "[xmem-mesh] best:" in out and "correlation_id=" in out

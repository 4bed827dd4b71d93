"""The port's sharding rule engine (``repro_torch.distributed``) against
the JAX package's (``repro.distributed``), on the CPU.

* Specs: ``spec_for_path``, ``opt_spec_for_shape``,
  ``batch_spec_for_shape`` and ``cache_spec_for`` equal the reference's
  as tuples for every leaf of all ten architectures' full-width abstract
  parameters, AdamW and Adafactor states, training batch and decode
  cache, on {data, model} meshes (1,2), (2,2), (4,4), (16,16) and the
  (2,16,16) mesh with a pod axis, fsdp off and on.
* Factors: ``spec_factor``, ``SpecShardFactors`` and
  ``_heuristic_factor_fn`` give every block of the same lifecycles the
  reference's factor (the JAX package's traced phases, converted), and
  ``mesh_collective_specs`` equals the reference's field by field.
* Placements: on a ``DeviceMesh`` under torch's ``fake`` process group,
  each leaf's local shard holds its global bytes over ``spec_factor``;
  ``constrain`` is the identity outside a bound scope and on a plain
  tensor, and redistributes a DTensor inside one.
"""
import dataclasses
import itertools

import jax
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import DECODE_32K as JAX_DECODE_32K
from repro.configs.base import TRAIN_4K as JAX_TRAIN_4K
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.distributed import sharding as jsh
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import DECODE_32K, TRAIN_4K, smoke_shape
from repro_torch.distributed import act_sharding as tact
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.train import optimizer as topt
from test_torch_estimator_training import _to_port_phase

MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "4x4": {"data": 4, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
POLICIES = {"tp": jsh.ShardingPolicy(), "fsdp": jsh.ShardingPolicy(fsdp=True),
            "fsdp_pod": jsh.ShardingPolicy(fsdp=True,
                                           fsdp_axes=("data", "pod"))}


def _port_policy(p):
    return tsh.ShardingPolicy(**dataclasses.asdict(p))


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(kp): tuple(int(d) for d in leaf.shape)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {pytree.keystr(kp): tuple(int(d) for d in leaf.shape)
            for kp, leaf in pytree.tree_flatten_with_path(tree)[0]
            if leaf is not None}


def _trees(arch: str, kind: str):
    """(JAX leaves, port leaves): keystr path -> shape, full width."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    if kind == "params":
        return (_jax_leaves(JM.abstract_params(jcfg)),
                _port_leaves(TM.abstract_params(tcfg)))
    if kind in ("adamw", "adafactor"):
        return (_jax_leaves(jax.eval_shape(
                    jopt.get_optimizer(kind).init, JM.abstract_params(jcfg))),
                _port_leaves(topt.get_optimizer(kind).init(
                    TM.abstract_params(tcfg))))
    if kind == "batch":
        return (_jax_leaves(jreg.input_specs(jcfg, JAX_TRAIN_4K)),
                _port_leaves(treg.input_specs(tcfg, TRAIN_4K)))
    return (_jax_leaves(jreg.abstract_cache(jcfg, JAX_DECODE_32K)),
            _port_leaves(treg.abstract_cache(tcfg, DECODE_32K)))


def _specs(kind, leaves, mesh, policy, pkg):
    if kind == "params":
        return {p: tuple(pkg.spec_for_path(p, s, mesh, policy))
                for p, s in leaves.items()}
    if kind == "cache":
        return {p: tuple(pkg.cache_spec_for(p, s, mesh, policy))
                for p, s in leaves.items()}
    fn = (pkg.batch_spec_for_shape if kind == "batch"
          else pkg.opt_spec_for_shape)
    return {p: tuple(fn(s, mesh, policy)) for p, s in leaves.items()}


@pytest.mark.parametrize("kind", ["params", "adamw", "adafactor", "batch",
                                  "cache"])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_specs_equal_the_reference_for_every_leaf(arch, kind):
    jleaves, tleaves = _trees(arch, kind)
    if kind in ("params", "batch", "cache"):
        assert tleaves == jleaves
    else:
        # the optimizers' states hold the same leaves under their own
        # containers: compared as multisets of shapes
        assert sorted(tleaves.values()) == sorted(jleaves.values())
    n_sharded = 0
    for (mname, mesh), (pname, pol) in itertools.product(MESHES.items(),
                                                         POLICIES.items()):
        want = _specs(kind, jleaves, mesh, pol, jsh)
        got = _specs(kind, tleaves, mesh, _port_policy(pol), tsh)
        if kind in ("params", "batch", "cache"):
            assert got == want, (mname, pname)
        else:
            assert sorted(zip(tleaves.values(), got.values())) == \
                sorted(zip(jleaves.values(), want.values())), (mname, pname)
        n_sharded += sum(any(e is not None for e in s)
                         for s in got.values())
    if kind != "batch" or arch != "internvl2-1b":
        assert n_sharded > 0


def test_the_spec_type_is_a_tuple_equal_to_the_references():
    spec = tsh.P("data", None, ("pod", "data"))
    assert isinstance(spec, tuple)
    assert tuple(spec) == tuple(jsh.P("data", None, ("pod", "data")))
    assert tuple(tsh.P()) == tuple(jsh.P()) == ()


# -- factors on the same lifecycles ---------------------------------------------
ARCH = "qwen3-32b"
B, S = 4, 32
FACTOR_MESHES = [({"data": 2, "model": 2}, jsh.ShardingPolicy(
                      batch_axes=("data",))),
                 ({"data": 4, "model": 2}, jsh.ShardingPolicy(
                      fsdp=True, batch_axes=("data",))),
                 ({"pod": 2, "data": 2, "model": 4}, jsh.ShardingPolicy(
                      fsdp=True, fsdp_axes=("data", "pod"))),
                 ({"data": 1, "model": 8}, jsh.ShardingPolicy())]


@pytest.fixture(scope="module")
def phases():
    """The reference's traced phases of a smoke job (MoE, so expert
    stacks and a router are among the leaves) and both packages' trees."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    fwd, upd, init = jax_hooks(jcfg, JaxTrainPolicy())
    jparams = JM.abstract_params(jcfg)
    jbatch = jreg.input_specs(jcfg, jax_smoke_shape(S, B))
    est = JaxEstimator.for_torch_gpu()
    jphases = est.trace_phases(fwd, jparams, jbatch, upd, init)
    blocks = [lc for ph in jphases for lc in ph.lifecycles]
    tblocks = [lc for ph in jphases for lc in _to_port_phase(ph).lifecycles]
    tparams = TM.abstract_params(tcfg)
    return dict(jblocks=blocks, tblocks=tblocks, jparams=jparams,
                tparams=tparams,
                jopt=jax.eval_shape(init, jparams),
                topt=topt.get_optimizer("adamw").init(tparams),
                jbatch=jbatch, tbatch=treg.input_specs(tcfg, smoke_shape(S, B)),
                jcfg=jcfg, tcfg=tcfg)


@pytest.mark.parametrize("k", range(len(FACTOR_MESHES)))
def test_spec_factors_equal_the_reference_per_block(phases, k):
    mesh, pol = FACTOR_MESHES[k]
    want_fn = jsh.shard_factor_fn(None, mesh, pol, params=phases["jparams"],
                                  opt_state=phases["jopt"],
                                  batch=phases["jbatch"])
    got_fn = tsh.shard_factor_fn(None, mesh, _port_policy(pol),
                                 params=phases["tparams"],
                                 opt_state=phases["topt"],
                                 batch=phases["tbatch"])
    want = [want_fn(b) for b in phases["jblocks"]]
    got = [got_fn(b) for b in phases["tblocks"]]
    assert got == want
    assert any(f > 1.0 for f in got)
    # the resolved tables, too
    assert got_fn.param_factor_by_shape == want_fn.param_factor_by_shape
    assert got_fn.model_widths == want_fn.model_widths
    assert got_fn.batch_extents == want_fn.batch_extents
    # the heuristic, on the same blocks
    hw = jsh.shard_factor_fn(phases["jcfg"], mesh, pol, mode="heuristic")
    hg = tsh.shard_factor_fn(phases["tcfg"], mesh, _port_policy(pol),
                             mode="heuristic")
    assert [hg(b) for b in phases["tblocks"]] == \
        [hw(b) for b in phases["jblocks"]]


def test_params_default_to_the_ports_model(phases):
    mesh, pol = FACTOR_MESHES[1]
    a = tsh.shard_factor_fn(phases["tcfg"], mesh, _port_policy(pol))
    b = tsh.shard_factor_fn(None, mesh, _port_policy(pol),
                            params=phases["tparams"])
    assert a.param_factor_by_shape == b.param_factor_by_shape
    with pytest.raises(ValueError):
        tsh.shard_factor_fn(None, mesh, mode="exact")


@pytest.mark.parametrize("shape", [(7,), (48, 64), (151655, 896),
                                   (3, 5, 7), (2, 24, 130), ()])
def test_spec_factor_equals_the_reference(shape):
    for mesh in MESHES.values():
        for spec in (jsh.P(), jsh.P("model"), jsh.P(None, "data"),
                     jsh.P(("pod", "data"), "model"), jsh.P("data", None,
                                                           "model")):
            assert tsh.spec_factor(tsh.P(*spec), shape, mesh) == \
                jsh.spec_factor(spec, shape, mesh)


def test_cache_factors_equal_the_reference():
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    jcache = jreg.abstract_cache(jcfg, jax_smoke_shape(S, B))
    tcache = treg.abstract_cache(tcfg, smoke_shape(S, B))
    from repro.core.events import BlockKind as JBK, BlockLifecycle as JBL
    from repro_torch.core.events import BlockKind as TBK
    from repro_torch.core.events import BlockLifecycle as TBL
    for mesh, pol in FACTOR_MESHES:
        w = jsh.shard_factor_fn(None, mesh, pol, params=JM.abstract_params(
            jcfg), cache=jcache)
        g = tsh.shard_factor_fn(None, mesh, _port_policy(pol),
                                params=TM.abstract_params(tcfg), cache=tcache)
        assert g.cache_factor_by_shape == w.cache_factor_by_shape
        for shape in _port_leaves(tcache).values():
            assert g(TBL(0, 1, 0, None, block_kind=TBK.CACHE, shape=shape)) \
                == w(JBL(0, 1, 0, None, block_kind=JBK.CACHE, shape=shape))


@pytest.mark.parametrize("mesh", [{"data": 4, "model": 1},
                                  {"data": 2, "model": 4},
                                  {"pod": 2, "data": 2, "model": 2},
                                  {"data": 1, "model": 1}])
@pytest.mark.parametrize("fsdp", [False, True])
def test_collective_specs_equal_the_reference(mesh, fsdp):
    pol = jsh.ShardingPolicy(fsdp=fsdp, fsdp_axes=(
        ("data", "pod") if "pod" in mesh else ("data",)))
    want = jsh.mesh_collective_specs(mesh, pol)
    got = tsh.mesh_collective_specs(mesh, _port_policy(pol))

    def fields(spec):
        d = dataclasses.asdict(spec)
        d["phase"] = spec.phase.value
        return d
    assert [fields(s) for s in got] == [fields(s) for s in want]


# -- placements on a DeviceMesh under the fake process group -------------------
WORLD = 8


@pytest.fixture(scope="module")
def fake_pg():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    yield
    dist.destroy_process_group()


def _local_bytes(t, placements, mesh):
    from torch.distributed.tensor import distribute_tensor
    d = distribute_tensor(t, mesh, list(placements))
    local = d.to_local()
    return local.numel() * local.element_size()


@pytest.mark.parametrize("shape,names", [((2, 4), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model")),
                                         ((8, 1), ("data", "model"))])
def test_each_local_shard_holds_global_bytes_over_the_factor(fake_pg, shape,
                                                             names):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    sizes = tmesh.mesh_axis_sizes(mesh)
    assert sizes == dict(zip(names, shape))
    cfg = treg.get_smoke(ARCH)
    params = TM.init_params(cfg, 0, device="cpu")
    for pol in (tsh.ShardingPolicy(), tsh.ShardingPolicy(fsdp=True)):
        placements = tsh.param_shardings(params, cfg, mesh, pol)
        specs = tsh.param_shardings(params, cfg, sizes, pol)
        n_sharded = 0
        for (path, t), (_, pl), (_, spec) in zip(
                tsh._leaves_with_path(params),
                tsh._leaves_with_path(placements),
                tsh._leaves_with_path(specs)):
            assert pl == tsh.to_placements(spec, mesh)
            f = tsh.spec_factor(spec, tuple(t.shape), sizes)
            got = _local_bytes(t, pl, mesh)
            assert got * f == t.numel() * t.element_size(), path
            n_sharded += f > 1
        if shape[-1] > 1:
            assert n_sharded > 0
    batch = {"tokens": torch.zeros(8, 16, dtype=torch.int32)}
    for (_, t), (_, pl) in zip(
            tsh._leaves_with_path(batch),
            tsh._leaves_with_path(tsh.batch_shardings(batch, mesh))):
        f = tsh.spec_factor(tsh.batch_spec_for_shape(tuple(t.shape), sizes),
                            tuple(t.shape), sizes)
        assert _local_bytes(t, pl, mesh) * f == t.numel() * t.element_size()
    opt = topt.get_optimizer("adamw").init(params)
    for (_, t), (_, pl) in zip(
            tsh._leaves_with_path(opt),
            tsh._leaves_with_path(tsh.opt_state_shardings(opt, mesh))):
        f = tsh.spec_factor(tsh.opt_spec_for_shape(tuple(t.shape), sizes),
                            tuple(t.shape), sizes)
        assert _local_bytes(t, pl, mesh) * f == t.numel() * t.element_size()
    cache = TM.init_cache(cfg, 8, 16, device="cpu")
    for (path, t), (_, pl) in zip(
            tsh._leaves_with_path(cache),
            tsh._leaves_with_path(tsh.cache_shardings(cache, mesh))):
        f = tsh.spec_factor(tsh.cache_spec_for(path, tuple(t.shape), sizes),
                            tuple(t.shape), sizes)
        assert _local_bytes(t, pl, mesh) * f == t.numel() * t.element_size()


def test_constrain_redistributes_only_a_dtensor_in_a_bound_scope(fake_pg):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    mesh = tmesh.make_smoke_mesh()
    assert tmesh.mesh_axis_sizes(mesh) == {"data": 2, "model": 4}
    x = torch.randn(4, 6, 8)
    dims = ("batch", None, "vocab")
    assert tact.constrain(x, dims) is x           # no scope
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    assert tact.constrain(d, dims) is d
    with tact.logical_axis_rules(mesh, tact.DEFAULT_RULES):
        assert tact.constrain(x, dims) is x       # plain tensor
        out = tact.constrain(d, dims)
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Shard(0), Shard(2))
        assert out.to_local().shape == (2, 6, 2)
        # divisibility guard: 6 does not divide over model 4
        odd = distribute_tensor(torch.randn(4, 8, 6), mesh,
                                [Replicate(), Replicate()])
        assert tuple(tact.constrain(odd, dims).placements) == \
            (Shard(0), Replicate())
    assert tact.constrain(d, dims) is d           # the scope has ended


def test_the_models_anchors_change_no_trace():
    """``constrain`` in the model is the identity outside a scope: a
    step traced inside a bound scope over plain tensors equals one
    traced outside it, block by block."""
    from repro_torch.core.estimator import XMemEstimator
    from repro_torch.train import TrainPolicy, make_estimator_hooks
    cfg = treg.get_smoke(ARCH)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    args = (fwd, TM.abstract_params(cfg),
            treg.input_specs(cfg, smoke_shape(S, B)), upd, init)

    class _Mesh:
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(i):
            return 2

    plain = XMemEstimator.for_torch_gpu().trace_phases(*args)
    with tact.logical_axis_rules(_Mesh(), tact.DEFAULT_RULES):
        bound = XMemEstimator.for_torch_gpu().trace_phases(*args)
    for a, b in zip(plain, bound):
        assert list(a.lifecycles) == list(b.lifecycles)

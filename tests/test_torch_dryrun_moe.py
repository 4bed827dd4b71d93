"""The port's sharded dry run for the MoE family, on the CPU at smoke
width, under torch's ``fake`` process group (rank 0 of a mesh of 8):
expert parallelism over ``model`` (``act_sharding.local_experts``).

* Every MoE smoke cell (phi3.5-moe and kimi-k2 x train, prefill,
  decode) runs ``ok`` on a (data, model) (2, 4) and a (pod, data,
  model) (2, 2, 2) mesh, with the record's keys; no serving cell
  moves an ``all-to-all`` (the dispatch moves no tokens).
* Rank 0's traced prefill gathers only its own experts' capacity rows:
  its largest expert-input block is ``[E/M * C, D]``, and no block has
  the shape of all E experts' rows.
* Counts: a MoE layer's expert products on rank 0, times the ranks, are
  the unsharded layer's; its combine is one f32 all-reduce of the
  rank's tokens over ``model``.
* A shard moved to another tensor dim (an expert stack's gradient into
  its optimizer state's layout) is traced and counted as the card's
  all-to-all: its output and its two staging buffers, not the
  all-gather DTensor runs on a CPU mesh.
* Depth composition holds for the MoE training phase under DTensor
  (probes of 2, 3 and 4 layers against the full trace, 10 layers).
* A fake world's step runs on its own mesh, not on an equal mesh of an
  earlier world that DTensor's sharding caches hold.
* A head dim the kernels pad (112 -> 128) runs ``ok`` in a sharded
  prefill (its logits: ``test_torch_moe_sharded.py``).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.tracer import trace_fn
from repro_torch.distributed import act_sharding as act
from repro_torch.distributed import program as prg
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.program_analysis import count_local
from repro_torch.models import moe as moe_mod

MOE = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")
RECORD_KEYS = {"devices", "memory", "cost", "collectives", "hlo_ops"}


def test_a_new_world_runs_on_its_own_mesh():
    # opens its own worlds, before the module's: a cached op of an
    # earlier world must not hand back that world's (equal) mesh
    from torch.distributed.tensor import Replicate
    meshes = []
    for _ in range(2):
        with fake_world(8):
            mesh = _mesh("2x4")
            t = prg.to_dtensor(torch.empty(256, 64),
                               prg.Layout((Replicate(), Replicate()),
                                          (256, 64), (64, 1)), mesh)
            out = t.detach()
            assert out.device_mesh is mesh
            meshes.append(mesh)
    assert meshes[0] == meshes[1] and meshes[0] is not meshes[1]


@pytest.fixture(scope="module")
def world():
    with fake_world(8):
        yield


def _mesh(name):
    from torch.distributed.device_mesh import init_device_mesh
    dims, names = MESHES[name]
    return init_device_mesh("cpu", dims, mesh_dim_names=names)


def _shape(kind):
    return smoke_shape(seq_len=16, global_batch=8, kind=kind)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", MOE)
def test_every_moe_smoke_cell_runs_ok(world, arch, mesh_name):
    mesh = _mesh(mesh_name)
    cfg = treg.get_smoke(arch)
    for kind in KINDS:
        out = dryrun.cell_record(cfg, _shape(kind), mesh, {})
        assert RECORD_KEYS <= set(out), kind
        assert out["devices"] == 8
        mem = out["memory"]
        assert 0 < mem["persistent_bytes"] <= mem["per_device_bytes"], kind
        assert not mem["oom"]
        assert out["cost"]["flops_by_op"]["aten::bmm"] > 0, kind
        coll = out["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0, kind
        assert coll["bytes"]["all-reduce"] > 0, kind
        if kind != "train":     # training moves the expert stacks'
            # gradients into their optimizer state's layout
            assert coll["count"]["all-to-all"] == 0, kind


@pytest.mark.parametrize("arch", MOE)
def test_rank0_gathers_only_its_experts_capacity_rows(world, arch):
    mesh = _mesh("2x4")
    cfg = dryrun._with_moe_groups(treg.get_smoke(arch), mesh)
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, impl="flash"))
    job = dryrun.build_job(cfg, _shape("prefill"), mesh)
    _, tr, _ = trace_fn(job.programs["step"].local,
                        *dryrun._serving_args(job))
    m = cfg.moe
    E, D, groups = m.num_experts, cfg.d_model, m.num_groups
    C = moe_mod.expert_capacity(8 * 16 // groups, m)
    n = E // mesh.size(1)
    rows = [b.shape for b in tr.blocks.values()
            if b.op == "aten::index_select" and b.shape[-1:] == (D,)]
    assert max(rows, key=lambda s: s[0]) == (n * C, D)
    shapes = {b.shape for b in tr.blocks.values()}
    assert (E * C, D) not in shapes and (E, C, D) not in shapes


def test_expert_flops_and_the_combine_all_reduce(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh("2x4")
    data, model = mesh.size(0), mesh.size(1)
    cfg = dataclasses.replace(treg.get_smoke("phi3.5-moe-42b-a6.6b").moe,
                              num_experts=8, num_groups=2)
    B, S, D, F = 8, 16, 64, 32
    p = moe_mod.moe_params(None, D, F, cfg.num_experts, torch.bfloat16,
                           device="meta")
    x = torch.empty(B, S, D, dtype=torch.bfloat16, device="meta")
    rep, ep = (Replicate(), Replicate()), (Replicate(), Shard(0))
    lays = [prg.Layout((Shard(0), Replicate()), tuple(x.shape),
                       act._contiguous_stride(x.shape))]
    lays += [prg.Layout(rep if k == "router" else ep, tuple(t.shape),
                        act._contiguous_stride(t.shape))
             for k, t in p.items()]

    def layer(xl, *ws):
        xd, *wd = (prg.to_dtensor(t, lay, mesh) for t, lay in zip(
            (xl, *ws), lays))
        with act.logical_axis_rules(mesh, act.DEFAULT_RULES):
            return moe_mod.moe_ffn(xd, dict(zip(p, wd)), cfg).to_local()
    local = [torch.empty(prg.local_shape(lay.shape, lay.placements, mesh),
                         dtype=t.dtype)
             for lay, t in zip(lays, (x, *p.values()))]
    c = count_local(layer, *local)
    whole = count_local(lambda x, p: moe_mod.moe_experts(x, p, cfg, 2, 0),
                        torch.empty(B, S, D, dtype=torch.bfloat16),
                        {k: torch.empty(t.shape, dtype=t.dtype)
                         for k, t in p.items()})
    bmm = c.flops_by_op["aten::bmm"]
    assert bmm > 0 and bmm * model * data == whole.flops_by_op["aten::bmm"]
    coll = c.collectives()
    # one f32 all-reduce of the rank's [B / data, S, D] combine
    assert coll["count"]["all-reduce"] == 1
    assert coll["bytes"]["all-reduce"] == B // data * S * D * 4
    assert coll["total_bytes"] == coll["bytes"]["all-reduce"]


def test_a_shard_dim_move_is_traced_as_the_cards_all_to_all(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh("2x4")
    lay = prg.Layout((Replicate(), Shard(0)), (16, 64, 32), (2048, 32, 1))

    def move(local):
        g = prg.to_dtensor(local, lay, mesh)
        return g.redistribute(mesh, [Replicate(), Shard(2)]).to_local()
    local = torch.empty(4, 64, 32)
    _, tr, out = trace_fn(move, local)
    assert tuple(out.shape) == (16, 64, 8)
    blocks = [b for b in tr.blocks.values() if b.op != "input"]
    assert {b.op for b in blocks} == {"_dtensor::shard_dim_alltoall"}
    nbytes = local.numel() * 4
    # the card's requests: two staging buffers of the input's size, then
    # the output; the staging freed after it, the second first
    assert [(b.size, b.kind.value) for b in blocks] == [
        (nbytes, "temp"), (nbytes, "temp"), (nbytes, "output")]
    first, second, out = blocks
    assert out.alloc_t < second.free_t < first.free_t
    coll = count_local(move, local).collectives()
    assert coll["bytes"]["all-to-all"] == nbytes
    assert coll["total_bytes"] == nbytes


def test_the_sharded_moe_train_phase_composes_to_its_full_trace(world):
    from repro_torch.core import depth as Dp
    from repro_torch.core.estimator import _fwd_out_kinds, trace_entry
    from repro_torch.core.events import BlockKind, Phase
    mesh = _mesh("2x4")
    cfg = dataclasses.replace(treg.get_smoke("phi3.5-moe-42b-a6.6b"),
                              n_layers=10)
    cfg = dryrun._with_moe_groups(cfg, mesh)
    policy = dataclasses.replace(dryrun.arch_sharding_policy(cfg, mesh),
                                 fsdp=True)
    job = dryrun.build_job(cfg, _shape("train"), mesh, policy,
                           dryrun.TrainPolicy())
    fn = job.programs["fwd_bwd"].local
    awk = [(job.local["params"], BlockKind.PARAM, "params"),
           (job.local["batch"], BlockKind.INPUT, "batch")]

    def trace(f, a, labeller=None):
        return trace_entry(f, a, labeller=labeller,
                           phase=Phase.FORWARD_BACKWARD,
                           out_kind_fn=_fwd_out_kinds, grad=True)
    composed, info = Dp.compose(fn.depth_plan, awk, trace)
    assert info["source"] == "composed", info
    assert Dp.phases_equal(composed, trace(fn, awk)[0])


def test_a_padded_head_dim_runs_in_a_sharded_prefill(world):
    cfg = dataclasses.replace(treg.get_smoke("qwen3-32b"), head_dim=112,
                              n_heads=8)
    out = dryrun.cell_record(cfg, _shape("prefill"), _mesh("2x4"), {})
    assert out["cost"]["flops_by_op"]["repro_torch::flash_attention"] > 0

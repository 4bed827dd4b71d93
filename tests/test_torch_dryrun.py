"""The port's sharded dry run (``repro_torch.launch.dryrun``) on the CPU,
at smoke width, under torch's ``fake`` process group (rank 0 of a mesh
of 8): nothing is allocated and the collectives move no data.

* Every dense smoke cell (train, prefill, decode) runs ``ok`` on a
  (data, model) (2, 4) and a (pod, data, model) (2, 2, 2) mesh, and its
  record has the reference's keys.
* Local shards: every leaf of the params, optimizer state, batch and
  cache holds its global bytes over ``spec_factor``.
* The tracer records rank 0's local program: a sharded step's
  persistent bytes are the local shards' bytes, and DTensor's
  sharding-propagation ops (global shapes) add no block.
* Counts: a pure tensor-parallel product's local FLOPs times ``model``
  are the global FLOPs; an fsdp product's all-gather bytes are the
  local weight shard times ``data``.
* Depth composition holds under DTensor: a sharded step's phase
  composed from probes of 2, 3 and 4 layers equals its full trace
  column by column (train with fsdp, prefill, decode at 10 layers).
* A depth cut keeps its full config's policies.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.estimator import XMemEstimator
from repro_torch.distributed import act_sharding as act
from repro_torch.distributed import program as prg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.program_analysis import count_local

DENSE = ("qwen3-32b", "phi4-mini-3.8b", "starcoder2-3b", "gemma3-4b")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")
RECORD_KEYS = {"devices", "memory", "cost", "collectives", "hlo_ops"}


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


def _job(arch, mesh, kind, fsdp=True, microbatches=2):
    cfg = treg.get_smoke(arch)
    policy = dryrun.arch_sharding_policy(cfg, mesh)
    policy = dataclasses.replace(policy, fsdp=fsdp)
    tp = dryrun.TrainPolicy(microbatches=microbatches)
    return cfg, dryrun.build_job(cfg, _shape(kind), mesh, policy, tp)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DENSE)
def test_every_dense_smoke_cell_runs_ok(world, arch, mesh_name):
    mesh = _mesh(mesh_name)
    cfg = treg.get_smoke(arch)
    for kind in KINDS:
        record = {}
        out = dryrun.cell_record(cfg, _shape(kind), mesh, record)
        assert RECORD_KEYS <= set(out), kind
        assert out["devices"] == 8
        mem = out["memory"]
        assert 0 < mem["persistent_bytes"] <= mem["per_device_bytes"], kind
        assert not mem["oom"]
        assert out["cost"]["flops"] > 0 and out["hlo_ops"] > 0, kind
        coll = out["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0, kind
        assert set(coll["bytes"]) == set(dryrun.COLLECTIVES)
        if kind == "train":
            assert record["train_policy"]["optimizer"] == "adamw"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shards_hold_global_bytes_over_the_factor(world, mesh_name,
                                                        kind):
    mesh = _mesh(mesh_name)
    cfg, job = _job("qwen3-32b", mesh, kind)
    sizes = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    rules = {"params": lambda path, s: tsh.spec_for_path(path, s, sizes,
                                                         job.policy),
             "opt_state": lambda path, s: tsh.opt_spec_for_shape(
                 s, sizes, job.policy),
             "batch": lambda path, s: tsh.batch_spec_for_shape(
                 s, sizes, job.policy),
             "cache": lambda path, s: tsh.cache_spec_for(path, s, sizes,
                                                         job.policy)}
    n_sharded = 0
    for name, tree in job.trees.items():
        local = dict(tsh._leaves_with_path(job.local[name]))
        for path, t in tsh._leaves_with_path(tree):
            shape = tuple(t.shape)
            f = tsh.spec_factor(rules[name](path, shape), shape, sizes)
            loc = local[path]
            assert loc.numel() * loc.element_size() * f \
                == t.numel() * t.element_size(), (name, path)
            n_sharded += f > 1
    assert n_sharded > 0


def test_the_traced_persistent_bytes_are_the_local_shards(world):
    mesh = _mesh("2x4")
    _, job = _job("qwen3-32b", mesh, "train")
    p = job.programs
    est = XMemEstimator.for_torch_gpu()
    fwd, upd, init = est.trace_phases(
        p["fwd_bwd"].local, job.local["params"], job.local["batch"],
        p["update"].local, p["opt_init"].local)
    want = dryrun.local_bytes(job.local["params"]) \
        + dryrun.local_bytes(job.local["batch"])
    assert sum(b.size for b in fwd.input_blocks) == want
    # the gradients come back in the parameters' layout
    assert sum(b.size for b in fwd.output_blocks
               if b.kind.value == "grad") \
        == dryrun.local_bytes(job.local["params"]) * 2   # f32 accumulators
    state = sum(b.size for b in init.output_blocks)
    assert state == dryrun.local_bytes(job.local["opt_state"])
    rep = est.estimate_training(
        p["fwd_bwd"].local, job.local["params"], job.local["batch"],
        update_fn=p["update"].local, opt_init_fn=p["opt_init"].local)
    assert rep.persistent_bytes == dryrun.local_bytes(job.local["params"]) \
        + dryrun.local_bytes(job.local["opt_state"])


def test_sharding_propagation_adds_no_block(world):
    from torch.distributed.tensor import Shard
    from repro_torch.core.tracer import trace_fn
    mesh = _mesh("2x4")
    lay_x = prg.Layout((Shard(0), Shard(1)), (32, 64), (64, 1))
    lay_w = prg.Layout((Shard(0), Shard(1)), (64, 256), (256, 1))

    def local_mm(x, w):
        xd, wd = prg.to_dtensor(x, lay_x, mesh), prg.to_dtensor(w, lay_w,
                                                                mesh)
        with act.logical_axis_rules(mesh, act.DEFAULT_RULES):
            return act.linear(xd, act.gathered(wd)).to_local()
    x = torch.empty(16, 16, device="meta")
    w = torch.empty(32, 64, device="meta")
    _, tr, out = trace_fn(local_mm, x, w)
    assert tuple(out.shape) == (16, 64)
    blocks = [b for b in tr.blocks.values() if b.op != "input"]
    # x gathered over model (16 x 64), w gathered over data (64 x 64),
    # the local product (16 x 64); never the global [32, 256] product
    assert max(b.size for b in blocks) == 64 * 64 * 4
    assert (32, 256) not in {b.shape for b in blocks}
    ops = {b.op for b in blocks}
    assert "aten::mm" in ops
    assert "_c10d_functional::all_gather_into_tensor" in ops


def test_local_flops_and_collective_bytes(world):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    # pure tensor parallelism: w's columns over model 8
    tp = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
    lay_x = prg.Layout((Replicate(), Replicate()), (16, 64), (64, 1))
    lay_w = prg.Layout((Replicate(), Shard(1)), (64, 256), (256, 1))

    def product(mesh, lx, lw):
        def fn(x, w):
            with act.logical_axis_rules(mesh, act.DEFAULT_RULES):
                return act.linear(prg.to_dtensor(x, lx, mesh),
                                  act.gathered(prg.to_dtensor(w, lw, mesh))
                                  ).to_local()
        return fn
    c = count_local(product(tp, lay_x, lay_w),
                    torch.empty(16, 64), torch.empty(64, 32))
    assert c.flops * 8 == 2 * 16 * 64 * 256
    assert c.collectives()["total_bytes"] == 0
    # fsdp: w's rows over data 8, gathered before the product
    fs = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    lay_x = prg.Layout((Shard(0), Replicate()), (16, 64), (64, 1))
    lay_w = prg.Layout((Shard(0), Replicate()), (64, 256), (256, 1))
    c = count_local(product(fs, lay_x, lay_w),
                    torch.empty(2, 64), torch.empty(8, 256))
    assert c.collectives()["bytes"]["all-gather"] == 8 * 256 * 4 * 8
    assert c.collectives()["count"]["all-gather"] == 1
    assert c.flops == 2 * 2 * 64 * 256


@pytest.mark.parametrize("kind", KINDS)
def test_a_sharded_phase_composes_to_its_full_trace(world, kind):
    from repro_torch.core import depth as D
    from repro_torch.core.estimator import _fwd_out_kinds, trace_entry
    from repro_torch.core.events import BlockKind, Phase
    mesh = _mesh("2x4")
    cfg = dataclasses.replace(treg.get_smoke("qwen3-32b"), n_layers=10)
    policy = dataclasses.replace(dryrun.arch_sharding_policy(cfg, mesh),
                                 fsdp=True)
    job = dryrun.build_job(cfg, _shape(kind), mesh, policy,
                           dryrun.TrainPolicy())
    params = (job.local["params"], BlockKind.PARAM, "params")
    if kind == "train":
        fn = job.programs["fwd_bwd"].local
        awk = [params, (job.local["batch"], BlockKind.INPUT, "batch")]
        opts = dict(phase=Phase.FORWARD_BACKWARD, out_kind_fn=_fwd_out_kinds,
                    grad=True)
    else:
        fn = job.programs["step"].local
        awk = [params, (job.local["cache"], BlockKind.CACHE, "cache"),
               (job.local["batch"], BlockKind.INPUT, "batch")]
        opts = dict(phase=Phase.DECODE)

    def trace(f, a, labeller=None):
        return trace_entry(f, a, labeller=labeller, **opts)
    composed, info = D.compose(fn.depth_plan, awk, trace)
    assert info["source"] == "composed", info
    assert D.phases_equal(composed, trace(fn, awk)[0])


def test_a_cut_cell_keeps_the_full_configs_policies():
    sizes = {"data": 16, "model": 16}
    full = treg.get_config("qwen3-32b")
    cut = dataclasses.replace(full, n_layers=2)
    train = dryrun.SHAPES_BY_NAME["train_4k"]
    spol, tpol = dryrun.policies(full, train, sizes)
    assert spol.fsdp and (tpol.optimizer, tpol.microbatches) == ("adamw", 4)
    # the cut alone would pick another job: no fsdp, 1 microbatch
    spol, tpol = dryrun.policies(cut, train, sizes)
    assert not spol.fsdp and tpol.microbatches == 1
    assert dryrun.policies(full, dryrun.SHAPES_BY_NAME["decode_32k"],
                           sizes)[1] is None


def test_cli_records_a_skipped_long_cell(tmp_path):
    rec = dryrun.run_cell("qwen3-32b", "long_500k", False, str(tmp_path),
                          device="cpu")
    assert rec["skipped"] and not rec["ok"]
    assert (tmp_path / "qwen3-32b__long_500k__pod16x16.json").exists()


def test_a_failing_cell_is_recorded_with_its_error(tmp_path, monkeypatch):
    import contextlib

    import torch.distributed.device_mesh as dm

    def boom(*a, **k):
        raise RuntimeError("no rule for this op")
    monkeypatch.setattr(dryrun, "cell_record", boom)
    monkeypatch.setattr(dryrun, "fake_world",
                        lambda n: contextlib.nullcontext())
    monkeypatch.setattr(dm, "init_device_mesh", lambda *a, **k: None)
    rec = dryrun.run_cell("qwen3-32b", "decode_32k", False, str(tmp_path),
                          device="cpu")
    assert rec["ok"] is False
    assert rec["error"] == "RuntimeError: no rule for this op"
    assert "traceback" in rec and rec["compile_s"] >= 0


def test_the_cli_needs_a_card_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert dryrun.main(["--arch", "qwen3-32b", "--shape", "decode_32k"]) == 1
    assert "--device cpu" in capsys.readouterr().out

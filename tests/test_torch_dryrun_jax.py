"""The port's rank-0 argument bytes against the JAX package's compiled
sharded program, byte for byte.

In a subprocess with 8 host devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=8``), the JAX package builds a
smoke training cell on a (data 2, model 4) mesh as its dry run's
``run_cell`` does (its own ``param_shardings``, ``opt_state_shardings``,
``batch_shardings`` and ``make_train_step``), compiles it, and reports
``memory_analysis().argument_size_in_bytes``: one device's params,
optimizer state and batch. The port lays out the same trees on the same
mesh (rank 0 of a ``fake`` process group) and sums its local shards'
bytes. They are equal, with fsdp off and on, for the dense qwen3-32b
and for phi3.5-moe (its expert stacks sharded on the expert dim over
``model``, and under fsdp also over ``data``). The reference's MoE
program dispatches through all-to-alls (GSPMD's, counted in its HLO);
the port's dispatch has none (``test_torch_dryrun_moe.py``).
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.distributed import program as prg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

ARCH = "qwen3-32b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
SEQ, BATCH, MICRO = 16, 8, 2

_JAX = f"""
import json, jax
from repro.configs import get_smoke
from repro.configs.base import smoke_shape
from repro.configs.registry import input_specs
from repro.distributed.act_sharding import DEFAULT_RULES, logical_axis_rules
from repro.distributed.sharding import (ShardingPolicy, batch_shardings,
                                        opt_state_shardings, param_shardings)
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.mesh import make_smoke_mesh
from repro.models import model as M
from repro.train.train_step import TrainPolicy, make_train_step

def sds(tree, shardings):
    return jax.tree_util.tree_map(
        lambda l, s: jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=s),
        tree, shardings)

mesh = make_smoke_mesh(8)
assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {{"data": 2,
                                                           "model": 4}}
out = {{}}
for arch, fsdp in [(a, f) for a in ({ARCH!r}, {MOE_ARCH!r})
                   for f in (False, True)]:
    cfg = get_smoke(arch)
    sp = ShardingPolicy(fsdp=fsdp, fsdp_axes=("data",), batch_axes=("data",))
    ap = M.abstract_params(cfg)
    step, opt = make_train_step(cfg, TrainPolicy(optimizer="adamw",
                                                 microbatches={MICRO},
                                                 clip_norm=1.0))
    ao = jax.eval_shape(opt.init, ap)
    bs = input_specs(cfg, smoke_shape(seq_len={SEQ}, global_batch={BATCH}))
    args = (sds(ap, param_shardings(ap, cfg, mesh, sp)),
            sds(ao, opt_state_shardings(ao, mesh, sp)),
            sds(bs, batch_shardings(bs, mesh, sp)))
    with mesh, logical_axis_rules(mesh, DEFAULT_RULES):
        compiled = jax.jit(step, donate_argnums=(0, 1)).lower(*args).compile()
    key = str(fsdp) if arch == {ARCH!r} else f"{{arch}}/{{fsdp}}"
    out[key] = int(compiled.memory_analysis().argument_size_in_bytes)
    out[key + "/all-to-all"] = collective_bytes(
        compiled.as_text())["count"]["all-to-all"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_argument_bytes():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    got = subprocess.run([sys.executable, "-c", _JAX], env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def _port_argument_bytes(arch: str, fsdp: bool) -> int:
    from torch.distributed.device_mesh import init_device_mesh
    cfg = treg.get_smoke(arch)
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        policy = tsh.ShardingPolicy(fsdp=fsdp, fsdp_axes=("data",),
                                    batch_axes=("data",))
        job = prg.sharded_job(
            cfg, smoke_shape(seq_len=SEQ, global_batch=BATCH), mesh, policy,
            "train", train_policy=dryrun.TrainPolicy(microbatches=MICRO))
        return sum(dryrun.local_bytes(job.local[name])
                   for name in ("params", "opt_state", "batch"))


@pytest.mark.parametrize("fsdp", [False, True])
def test_rank0_argument_bytes_equal_the_jax_compiled_programs(
        jax_argument_bytes, fsdp):
    port = _port_argument_bytes(ARCH, fsdp)
    # no delta: the optimizer's step count is a 0-d int32 in both
    assert port == jax_argument_bytes[str(fsdp)], (port, jax_argument_bytes)


@pytest.mark.parametrize("fsdp", [False, True])
def test_moe_rank0_argument_bytes_equal_the_jax_compiled_programs(
        jax_argument_bytes, fsdp):
    port = _port_argument_bytes(MOE_ARCH, fsdp)
    assert port == jax_argument_bytes[f"{MOE_ARCH}/{fsdp}"], (
        port, jax_argument_bytes)
    # expert parallelism and fsdp shrink rank 0's share
    assert port == (197_316 if fsdp else 237_572)
    assert jax_argument_bytes[f"{MOE_ARCH}/{fsdp}/all-to-all"] > 0

"""The port's sharded steps under a process group whose collectives move
data (torch's threaded test group: one thread a rank, 4 ranks), against
the JAX package's unsharded steps on the same weights, in f32.

* Training on a (data 2, model 2) mesh with fsdp and 2 microbatches:
  the loss and every gathered gradient ``allclose`` the JAX package's
  ``make_fwd_bwd`` (rtol 1e-4, atol 1e-5); on the JAX package's
  gradients, the sharded AdamW update with global-norm clipping (the
  norm reduced over the shards, the state in its own layout) gives its
  parameters.
* Serving on a (data 1, model 4) mesh, where qwen3-smoke's 2 kv heads do
  not divide the model axis (k and v replicated, each rank's kv heads
  sliced by the attention's sharding rule): the prefill's logits, with
  the flash op's plain version, ``allclose`` the JAX package's prefill;
  a decode step against a cache sharded over positions (the
  flash-decoding combine) equals the port's unsharded decode, logits
  and the written cache.
"""
import dataclasses
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train.train_step import make_fwd_bwd as jax_fwd_bwd
from repro.train.train_step import make_prefill_step as jax_prefill
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.distributed import program as prg
from repro_torch.distributed import sharding as tsh
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train.train_step import TrainPolicy, make_serve_step

RTOL, ATOL = 1e-4, 1e-5
ARCH = "qwen3-32b"
TIMEOUT_S = 240


def _cfgs(**kw):
    out = []
    for reg in (jreg, treg):
        c = reg.get_smoke(ARCH)
        out.append(dataclasses.replace(c, param_dtype="float32", **kw))
    return out


def _weights(jcfg, tcfg):
    jp = JM.init_params(jcfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, tcfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1), dtype=np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


def _threads(world_size: int, fn):
    """``fn(rank)`` on ``world_size`` threads, each rank of a threaded
    process group; the results by rank. Fails on an exception in any
    thread or past ``TIMEOUT_S``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    world = _install_threaded_pg()
    store = dist.HashStore()
    out, errors = {}, queue.Queue()
    lock_before = getattr(ShardingPropagator, "_fake_mode_lock", None)
    ShardingPropagator._fake_mode_lock = threading.Lock()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)

    def worker(rank):
        dist.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.put((rank, e))
        finally:
            if world == dist.distributed_c10d._world:
                dist.destroy_process_group()
    try:
        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in threads), "a rank hung"
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        ShardingPropagator._fake_mode_lock = lock_before
        _uninstall_threaded_pg()
    if not errors.empty():
        rank, e = errors.get()
        raise AssertionError(f"rank {rank}: {e!r}") from e
    return out


def _mesh(dims):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def test_a_sharded_train_step_matches_the_jax_unsharded_step():
    jc, tc = _cfgs()
    jp, tp = _weights(jc, tc)
    batch = _tokens(tc, 8, 16)
    jloss, jgrads = jax.jit(jax_fwd_bwd(jc, 2))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    policy = tsh.ShardingPolicy(fsdp=True)

    def rank(r):
        from torch.distributed.tensor import distribute_tensor
        mesh = _mesh((2, 2))
        job = prg.sharded_job(tc, smoke_shape(16, 8, "train"), mesh, policy,
                              "train", train_policy=TrainPolicy(
                                  microbatches=2))
        params = pytree.tree_map(
            lambda lay, t: distribute_tensor(t, mesh, list(lay.placements)),
            job.layouts["params"], tp, is_leaf=prg._is_layout)
        b = pytree.tree_map(
            lambda lay, t: distribute_tensor(torch.from_numpy(t), mesh,
                                             list(lay.placements)),
            job.layouts["batch"], batch, is_leaf=prg._is_layout)
        loss, grads = job.programs["fwd_bwd"].run(params, b)
        return (loss.full_tensor().item(),
                pytree.tree_map(lambda g: g.full_tensor(), grads))
    got = _threads(4, rank)
    for r in range(4):
        loss, grads = got[r]
        np.testing.assert_allclose(loss, float(jloss), rtol=RTOL, atol=ATOL)
        for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
            np.testing.assert_allclose(
                _at(grads, path).float().numpy(),
                np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                err_msg=f"rank {r} {jax.tree_util.keystr(path)}")


def test_a_sharded_clipped_update_matches_the_jax_update():
    jc, tc = _cfgs()
    jp, tp = _weights(jc, tc)
    batch = _tokens(tc, 8, 16)
    _, jgrads = jax.jit(jax_fwd_bwd(jc, 2))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    policy = TrainPolicy(microbatches=2)
    jo = jopt.get_optimizer("adamw", lr=policy.learning_rate)
    want, _ = jopt.clip_by_global_norm(jo.update, policy.clip_norm)(
        jp, jgrads, jo.init(jp))
    grads = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), tc, device="cpu")

    def rank(r):
        from torch.distributed.tensor import distribute_tensor
        mesh = _mesh((2, 2))
        job = prg.sharded_job(tc, smoke_shape(16, 8, "train"), mesh,
                              tsh.ShardingPolicy(fsdp=True), "train",
                              train_policy=policy)

        def put(lays, tree):
            return pytree.tree_map(
                lambda lay, t: distribute_tensor(t.clone(), mesh,
                                                 list(lay.placements)),
                lays, tree, is_leaf=prg._is_layout)
        params = put(job.layouts["params"], tp)
        state = job.programs["opt_init"].run(params)
        state = pytree.tree_map(
            lambda lay, t: t.redistribute(mesh, list(lay.placements)),
            job.layouts["opt_state"], state, is_leaf=prg._is_layout)
        job.programs["update"].run(params, put(job.layouts["params"], grads),
                                   state)
        return pytree.tree_map(lambda t: t.full_tensor(), params)
    got = _threads(4, rank)
    for r in range(4):
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            np.testing.assert_allclose(
                _at(got[r], path).float().numpy(), np.asarray(w, np.float32),
                rtol=RTOL, atol=ATOL,
                err_msg=f"rank {r} {jax.tree_util.keystr(path)}")


def test_sharded_prefill_and_decode_match_unsharded_steps():
    jc, tc = _cfgs()
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, impl="flash"))
    jp, tp = _weights(jc, tc)
    prompt = _tokens(tc, 4, 12)
    toks = prompt["tokens"]
    jlogits = jax.jit(jax_prefill(jc))(jp, {"tokens": jnp.asarray(toks)})
    # the port's unsharded decode: a cache of 15 positions, 12 written
    cache = TM.init_cache(tc, 4, 16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("k", "v"):
        cache[name][:, :, :12] = torch.randn(cache[name][:, :, :12].shape,
                                             generator=gen)
    new = {"tokens": torch.from_numpy(toks[:, :1].copy())}
    ref_cache = {k: v.clone() for k, v in cache.items()}
    ref_logits, _ = make_serve_step(tc, 12)(tp, ref_cache, new)
    policy = tsh.ShardingPolicy()

    def rank(r):
        from torch.distributed.tensor import distribute_tensor
        mesh = _mesh((1, 4))

        def put(lays, tree):
            return pytree.tree_map(
                lambda lay, t: distribute_tensor(t, mesh,
                                                 list(lay.placements)),
                lays, tree, is_leaf=prg._is_layout)
        pre = prg.sharded_job(tc, smoke_shape(12, 4, "prefill"), mesh,
                              policy, "prefill")
        params = put(pre.layouts["params"], tp)
        logits = pre.programs["step"].run(
            params, {}, put(pre.layouts["batch"],
                            {k: torch.from_numpy(v)
                             for k, v in prompt.items()}))
        dec = prg.sharded_job(tc, smoke_shape(16, 4, "decode"), mesh,
                              policy, "decode", cache_len=12)
        c = put(dec.layouts["cache"], {k: v.clone() for k, v in
                                       cache.items()})
        assert any(p.dim == 2 for p in c["k"].placements
                   if hasattr(p, "dim")), "cache not sharded over positions"
        dlogits, c = dec.programs["step"].run(params, c, put(
            dec.layouts["batch"], new))
        return (logits.full_tensor(), dlogits.full_tensor(),
                {k: v.full_tensor() for k, v in c.items()})
    got = _threads(4, rank)
    for r in range(4):
        logits, dlogits, c = got[r]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dlogits.numpy(), ref_logits.numpy(),
                                   rtol=RTOL, atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(c[k].numpy(), ref_cache[k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)

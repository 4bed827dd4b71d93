"""The port's MoE steps under DTensor (expert parallelism over ``model``,
``act_sharding.local_experts``) in a process group whose collectives
move data (torch's threaded test group: one thread a rank, 4 ranks),
against the JAX package's unsharded steps on the same weights, in f32.

* Training phi3.5-moe-smoke on a (data 2, model 2) mesh with fsdp, 2
  microbatches and 2 dispatch groups, at a capacity factor low enough
  that experts overflow (the JAX package's own maps drop assignments):
  the loss and every gathered gradient, the router's included,
  ``allclose`` the JAX package's ``make_fwd_bwd`` at the same groups
  (rtol 1e-4, atol 1e-5). With tokens dropped, which tokens share a
  dispatch group decides the result. A sharded microbatch is the k-th
  slice of each rank's rows (``train_step._split_microbatches``), the
  JAX package's the k-th slice of the batch; with as many groups as
  data ranks, both cut the batch into the same groups (runs of
  B / (microbatches x data) sequences), only in another order of
  microbatches, which the mean loss does not see.
* Serving kimi-k2-smoke on a (data 1, model 4) mesh, 2 of its 8 experts
  a rank: the prefill's logits ``allclose`` the JAX package's prefill;
  one decode step equals the port's unsharded decode, in logits and in
  the written cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.train.train_step import make_fwd_bwd as jax_fwd_bwd
from repro.train.train_step import make_prefill_step as jax_prefill
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.distributed import program as prg
from repro_torch.distributed import sharding as tsh
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train.train_step import TrainPolicy, make_serve_step
from test_torch_sharded_step import _at, _mesh, _threads, _tokens

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch, impl=None, **moe):
    out = []
    for reg in (jreg, treg):
        c = reg.get_smoke(arch)
        c = dataclasses.replace(c, param_dtype="float32",
                                moe=dataclasses.replace(c.moe, **moe))
        if impl is not None and reg is treg:
            c = dataclasses.replace(c, attention=dataclasses.replace(
                c.attention, impl=impl))
        out.append(c)
    return out


def _weights(jcfg, tcfg):
    jp = JM.init_params(jcfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, tcfg, device="cpu")


def _put(mesh, lays, tree):
    from torch.distributed.tensor import distribute_tensor
    return pytree.tree_map(
        lambda lay, t: distribute_tensor(t, mesh, list(lay.placements)),
        lays, tree, is_leaf=prg._is_layout)


def _jax_dropped(fn, *args) -> int:
    """Assignments the JAX package's dispatch maps dropped over capacity
    while ``fn(*args)`` ran (its token map's filled slots against the
    group's ``Tg * k`` assignments)."""
    counts = []
    dispatch = jmoe._dispatch_one_group

    def counting(xg, topi, topv, n_experts, capacity):
        out = dispatch(xg, topi, topv, n_experts, capacity)
        n = topi.size - (out[1] < xg.shape[0]).sum()
        jax.debug.callback(lambda d: counts.append(int(d)), n)
        return out
    jmoe._dispatch_one_group = counting
    try:
        jax.block_until_ready(fn(*args))
    finally:
        jmoe._dispatch_one_group = dispatch
    assert counts, "no dispatch ran"
    return sum(counts)


def test_a_sharded_moe_train_step_with_drops_matches_jax():
    jc, tc = _cfgs("phi3.5-moe-42b-a6.6b", num_groups=2,
                   capacity_factor=0.5)
    jp, tp = _weights(jc, tc)
    batch = _tokens(tc, 8, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_fwd_bwd(jc, 2))
    assert _jax_dropped(step, jp, jb) > 0, "no expert overflowed"
    jloss, jgrads = step(jp, jb)

    def rank(r):
        mesh = _mesh((2, 2))
        job = prg.sharded_job(tc, smoke_shape(16, 8, "train"), mesh,
                              tsh.ShardingPolicy(fsdp=True), "train",
                              train_policy=TrainPolicy(microbatches=2))
        params = _put(mesh, job.layouts["params"], tp)
        b = _put(mesh, job.layouts["batch"],
                 {k: torch.from_numpy(v) for k, v in batch.items()})
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


def test_sharded_moe_prefill_and_decode_match_unsharded_steps():
    jc, tc = _cfgs("kimi-k2-1t-a32b", impl="flash")
    jp, tp = _weights(jc, tc)
    prompt = _tokens(tc, 4, 12)
    toks = prompt["tokens"]
    jlogits = jax.jit(jax_prefill(jc))(jp, {"tokens": jnp.asarray(toks)})
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
        mesh = _mesh((1, 4))
        pre = prg.sharded_job(tc, smoke_shape(12, 4, "prefill"), mesh,
                              policy, "prefill")
        params = _put(mesh, pre.layouts["params"], tp)
        assert params["layers"]["moe"]["we_up"].to_local().shape[1] == 2
        logits = pre.programs["step"].run(
            params, {}, _put(mesh, pre.layouts["batch"],
                             {k: torch.from_numpy(v)
                              for k, v in prompt.items()}))
        dec = prg.sharded_job(tc, smoke_shape(16, 4, "decode"), mesh,
                              policy, "decode", cache_len=12)
        c = _put(mesh, dec.layouts["cache"],
                 {k: v.clone() for k, v in cache.items()})
        dlogits, c = dec.programs["step"].run(
            params, c, _put(mesh, dec.layouts["batch"], new))
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


def test_a_padded_head_dim_prefill_matches_the_unsharded_one():
    # head dim 112: the attention op pads it to 128 and hands back the
    # sliced output contiguous, which a rank's local shard can view
    from repro_torch.train.train_step import make_prefill_step
    cfg = dataclasses.replace(
        treg.get_smoke("qwen3-32b"), head_dim=112, n_heads=8,
        param_dtype="float32")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, impl="flash"))
    params = TM.init_params(cfg, seed=0, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 4, 12).items()}
    want = make_prefill_step(cfg)(params, prompt)

    def rank(r):
        mesh = _mesh((1, 4))
        job = prg.sharded_job(cfg, smoke_shape(12, 4, "prefill"), mesh,
                              tsh.ShardingPolicy(), "prefill")
        return job.programs["step"].run(
            _put(mesh, job.layouts["params"], params), {},
            _put(mesh, job.layouts["batch"], prompt)).full_tensor()
    got = _threads(4, rank)
    for r in range(4):
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")


def test_a_sharded_adafactor_update_matches_the_jax_update():
    # kimi-k2's training policy (over 80B parameters): Adafactor, whose
    # factored row and column moments are laid out from their weight's
    from repro.train import optimizer as jopt
    jc, tc = _cfgs("kimi-k2-1t-a32b")
    jp, tp = _weights(jc, tc)
    rng = np.random.default_rng(0)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape, np.float32)), jp)
    policy = TrainPolicy(optimizer="adafactor", microbatches=2)
    jo = jopt.get_optimizer("adafactor", lr=policy.learning_rate)
    want, _ = jopt.clip_by_global_norm(jo.update, policy.clip_norm)(
        jp, jgrads, jo.init(jp))
    grads = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), tc, device="cpu")

    def rank(r):
        mesh = _mesh((2, 2))
        job = prg.sharded_job(tc, smoke_shape(16, 8, "train"), mesh,
                              tsh.ShardingPolicy(fsdp=True), "train",
                              train_policy=policy)
        params = _put(mesh, job.layouts["params"],
                      pytree.tree_map(torch.clone, tp))
        state = job.programs["opt_init"].run(params)
        state = pytree.tree_map(
            lambda lay, t: t.redistribute(mesh, list(lay.placements)),
            job.layouts["opt_state"], state, is_leaf=prg._is_layout)
        job.programs["update"].run(
            params, _put(mesh, job.layouts["params"],
                         pytree.tree_map(torch.clone, grads)), state)
        return pytree.tree_map(lambda t: t.full_tensor(), params)
    got = _threads(4, rank)
    for r in range(4):
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            np.testing.assert_allclose(
                _at(got[r], path).float().numpy(), np.asarray(w, np.float32),
                rtol=RTOL, atol=ATOL,
                err_msg=f"rank {r} {jax.tree_util.keystr(path)}")

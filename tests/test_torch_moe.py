"""The port's MoE family against the JAX package, on the CPU in f32.

Weights come from the JAX package's ``init_params`` / ``moe_params`` and
cross through ``convert``; inputs are numpy arrays from a seed. Layer
outputs, losses, gradients, logits, caches and optimizer steps must
agree within rtol 1e-4, atol 1e-5; parameter, optimizer-state and
persistent bytes are byte-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro.train.train_step import make_fwd_bwd as jax_fwd_bwd
from repro.train.train_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig, smoke_shape
from repro_torch.core.estimator import CUBLAS_WORKSPACE_BYTES, XMemEstimator
from repro_torch.core.events import BlockKind
from repro_torch.core.tracer import trace_fn
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (TrainPolicy, make_estimator_hooks,
                                          make_fwd_bwd, make_prefill_step)

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def _close_tree(port, ref):
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(leaves) == len(pytree.tree_leaves(port))
    for path, want in leaves:
        _close(_at(port, path), want, jax.tree_util.keystr(path))


def _bytes(tree):
    return sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize
               for t in jax.tree_util.tree_leaves(tree))


def _tbytes(tree):
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _cfgs(arch, every_n_layers=1, **kw):
    """The same smoke config in both packages, f32 parameters."""
    out = []
    for reg in (jreg, treg):
        c = reg.get_smoke(arch)
        out.append(dataclasses.replace(
            c, param_dtype="float32",
            moe=dataclasses.replace(c.moe, every_n_layers=every_n_layers),
            **kw))
    return out


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, tcfg, device="cpu")


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                         # masked positions
    return {"tokens": np.ascontiguousarray(toks[:, :-1]), "labels": labels}


# ---------------------------------------------------------------------------
# the MoE layer
def _moe_pair(D, F, E, k, cf, groups=1, seed=0):
    jc = JaxMoEConfig(num_experts=E, top_k=k, capacity_factor=cf,
                      num_groups=groups)
    tc = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf,
                   num_groups=groups)
    jp = jmoe.moe_params(jax.random.key(seed), D, F, E, jnp.float32)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    return jc, tc, jp, tp


def _dropped(topi, E, C):
    """Assignments over capacity, from the expert ids of the top-k."""
    counts = np.bincount(np.asarray(topi).reshape(-1), minlength=E)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("B,S,E,k,cf,groups", [
    (2, 16, 4, 2, 1.25, 1),
    (2, 32, 4, 2, 0.5, 1),       # 64 tokens, C 16 for 128 assignments
    (2, 16, 8, 2, 1.5, 2),       # two dispatch groups
    (4, 16, 8, 3, 0.25, 2),      # C 8 for 96 assignments a group
], ids=["plain", "drops", "groups2", "groups2_drops"])
def test_moe_ffn_matches_jax(B, S, E, k, cf, groups):
    D, F = 16, 24
    jc, tc, jp, tp = _moe_pair(D, F, E, k, cf, groups)
    x = np.random.default_rng(1).standard_normal((B, S, D), dtype=np.float32)
    want = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jc))(jnp.asarray(x), jp)
    got = tmoe.moe_ffn(torch.from_numpy(x), tp, tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, D)
    _close(got, want)
    if cf < 1.0:     # the case drops tokens, and the same ones
        xf = torch.from_numpy(x).reshape(groups, -1, D)
        _, topi, _ = tmoe._route(torch.from_numpy(x), tp["router"], tc)
        C = tmoe.expert_capacity(xf.shape[1], tc)
        assert sum(_dropped(t, E, C) for t in topi.numpy()) > 0


def test_moe_ffn_gradients_match_jax():
    D, F, E, k = 16, 24, 4, 2
    jc, tc, jp, tp = _moe_pair(D, F, E, k, 0.5)
    x = np.random.default_rng(2).standard_normal((2, 32, D), dtype=np.float32)

    def jloss(p, x):
        return jnp.sum(jmoe.moe_ffn(x, p, jc) ** 2)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: t.requires_grad_() for n, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (tmoe.moe_ffn(tx, tp, tc) ** 2).sum().backward()
    _close(tx.grad, jgx)
    for n in jp:
        _close(tp[n].grad, jg[n], n)


@pytest.mark.parametrize("tokens", [1, 7, 64, 1000, 16384])
@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.5), (16, 2, 1.25),
                                    (384, 8, 1.25), (8, 1, 0.5)])
def test_expert_capacity_matches_jax(tokens, E, k, cf):
    jc = JaxMoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    tc = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    c = tmoe.expert_capacity(tokens, tc)
    assert c == jmoe.expert_capacity(tokens, jc)
    assert c >= 8 and c % 8 == 0


def test_aux_load_balance_loss_matches_jax():
    jc, tc, jp, tp = _moe_pair(16, 24, 8, 2, 1.25)
    x = np.random.default_rng(3).standard_normal((2, 20, 16),
                                                 dtype=np.float32)
    _close(tmoe.aux_load_balance_loss(torch.from_numpy(x), tp, tc),
           jmoe.aux_load_balance_loss(jnp.asarray(x), jp, jc))


def test_moe_params_layout():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_params(gen, 16, 24, 4, torch.bfloat16, device="cpu",
                        lead=(3,))
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (3, 16, 4)
    assert p["we_gate"].shape == p["we_up"].shape == (3, 4, 16, 24)
    assert p["we_down"].shape == (3, 4, 24, 16)
    assert p["we_down"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the model
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jc, tc = _cfgs(arch, remat=remat)
    jp, tp = _params(jc, tc)
    batch = _batch(tc, 2, 16)
    jl_, jg = jax.jit(jax_fwd_bwd(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl_, tg = make_fwd_bwd(tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl_, jl_)
    _close_tree(tg, jg)
    # stacked expert leaves keep their stacked gradient shapes; the
    # router's gradient stays f32
    moe = tg["layers"]["moe"]
    assert moe["we_gate"].shape == (tc.n_layers, tc.moe.num_experts,
                                    tc.d_model, tc.d_ff)
    assert moe["router"].dtype == torch.float32


@pytest.mark.parametrize("remat", ["none", "full"])
def test_alternating_layers_match_jax(remat):
    # every_n_layers=2: dense/MoE pairs, stacked as "dense" and "moe"
    # halves, the cache read in pairs
    jc, tc = _cfgs("phi3.5-moe-42b-a6.6b", every_n_layers=2, n_layers=4,
                   remat=remat)
    jp, tp = _params(jc, tc)
    assert set(tp["layers"]) == {"dense", "moe"}
    assert "mlp" in tp["layers"]["dense"] and "moe" in tp["layers"]["moe"]
    batch = _batch(tc, 2, 16, seed=4)
    jl_, jg = jax.jit(jax_fwd_bwd(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl_, tg = make_fwd_bwd(tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl_, jl_)
    _close_tree(tg, jg)
    _decode_matches(jc, tc, jp, tp)


def _decode_matches(jc, tc, jp, tp, B=2, max_len=16, cache_len=5):
    rng = np.random.default_rng(9)
    shape = (jc.n_layers, B, max_len, jc.n_kv_heads, jc.hd)
    kv = {n: rng.standard_normal(shape, dtype=np.float32)
          for n in ("k", "v")}
    toks = rng.integers(0, jc.vocab, (B, 1), dtype=np.int32)
    ref_logits, ref_cache = jax.jit(
        lambda p, c, b: JM.decode_step(p, c, b, cache_len, jc))(
        jp, {n: jnp.asarray(a) for n, a in kv.items()},
        {"tokens": jnp.asarray(toks)})
    cache = convert.tree_from_numpy(kv, device="cpu")
    before = cache["k"].data_ptr()
    logits, new_cache = TM.decode_step(
        tp, cache, {"tokens": torch.from_numpy(toks)}, cache_len, tc)
    assert new_cache["k"].data_ptr() == before     # updated in place
    _close(logits, ref_logits)
    for n in ("k", "v"):
        _close(new_cache[n], ref_cache[n], n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    # prefill logits (the flash op's plain version against the JAX
    # package's Pallas kernel in interpret mode), then a decode step
    # against a cache of 5 positions
    jc, tc = _cfgs(arch)
    jc = dataclasses.replace(
        jc, attention=dataclasses.replace(jc.attention, impl="pallas"))
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, impl="flash"))
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, 12),
                                             dtype=np.int32)
    ref = jax.jit(jax_prefill_step(jc))(jp, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)
    _decode_matches(jc, tc, jp, tp)


def test_adamw_step_matches_jax_with_byte_exact_state():
    jc, tc = _cfgs("phi3.5-moe-42b-a6.6b")
    jp, _ = _params(jc, tc)
    rng = np.random.default_rng(5)

    def grads():
        return jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
            jp)
    g1, g2 = grads(), grads()
    jo, to = jopt.get_optimizer("adamw"), topt.get_optimizer("adamw")
    ju = jopt.clip_by_global_norm(jo.update, 1.0)
    tu = topt.clip_by_global_norm(to.update, 1.0)
    p1, s1 = ju(jp, jax.tree_util.tree_map(jnp.asarray, g1), jo.init(jp))
    p2, s2 = ju(p1, jax.tree_util.tree_map(jnp.asarray, g2), s1)

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)
    tp = convert.params_from_numpy(host(p1), tc, device="cpu")
    ts = convert.opt_state_from_numpy(host(s1), to, tc, device="cpu")
    tg = convert.params_from_numpy(g2, tc, device="cpu")
    assert _tbytes(ts) == _bytes(s1)
    assert ts["m"]["layers"]["moe"]["router"].dtype == torch.float32
    tu(tp, tg, ts)
    _close_tree(tp, p2)
    _close_tree(ts, s2)


# ---------------------------------------------------------------------------
# bytes and the estimator
@pytest.mark.parametrize("arch,n_params", [
    ("phi3.5-moe-42b-a6.6b", 41_872_527_360), ("kimi-k2-1t-a32b", None)])
def test_full_width_parameter_bytes_match_jax(arch, n_params):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    tparams = TM.abstract_params(tc)
    assert _tbytes(tparams) == _bytes(JM.abstract_params(jc))
    numel = sum(t.numel() for t in pytree.tree_leaves(tparams))
    assert numel == jc.param_count()
    if n_params is not None:
        assert numel == n_params
    router = tparams["layers"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert router.shape == (tc.n_layers, tc.d_model, tc.moe.num_experts)


def test_persistent_bytes_match_the_jax_estimator():
    # byte-exact persistent bytes (params + AdamW m and v); the port
    # counts the optimizer's 4-byte count, which the JAX trace folds into
    # a literal. The tensor peaks differ by design (in-place update, the
    # CUDA preset's workspaces): the delta is recorded, not held.
    arch, B, S = "phi3.5-moe-42b-a6.6b", 2, 32
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    jf, ju, ji = jax_hooks(jcfg, JaxTrainPolicy())
    jrep = JaxEstimator.for_torch_gpu().estimate_training(
        jf, JM.abstract_params(jcfg), jreg.input_specs(
            jcfg, jax_smoke_shape(S, B)), update_fn=ju, opt_init_fn=ji)
    tf, tu, ti = make_estimator_hooks(tcfg, TrainPolicy())
    trep = XMemEstimator.for_torch_gpu().estimate_training(
        tf, TM.abstract_params(tcfg), treg.input_specs(
            tcfg, smoke_shape(S, B)), update_fn=tu, opt_init_fn=ti)
    assert trep.persistent_bytes == jrep.persistent_bytes + 4
    tparams = TM.abstract_params(tcfg)
    numel = sum(t.numel() for t in pytree.tree_leaves(tparams))
    assert trep.persistent_bytes == _tbytes(tparams) + 8 * numel + 4
    print(f"peak_tensor_bytes port {trep.peak_tensor_bytes} jax "
          f"{jrep.peak_tensor_bytes} delta "
          f"{trep.peak_tensor_bytes - jrep.peak_tensor_bytes}")


@pytest.mark.parametrize("where,jax_admits,port_admits", [
    pytest.param(1024 << 20, True, True, id="1024-True"),
    pytest.param(1 << 20, False, False, id="1-False"),
    pytest.param("at_port_estimate", True, True, id="at_port_estimate"),
    pytest.param("below_port_estimate", True, False,
                 id="below_port_estimate"),
    pytest.param("between_the_peaks", True, False, id="between_the_peaks"),
    pytest.param("below_jax_estimate", False, False,
                 id="below_jax_estimate"),
])
def test_training_gate_verdict_matches_jax(where, jax_admits, port_admits):
    # fixed capacities, and capacities placed by each gate's own
    # unconstrained estimate. Between the two estimates the gates disagree
    # by design: the port's GPU preset holds cuBLAS's two 32 MiB
    # workspaces, which the JAX estimate lacks; without them the port's
    # tensor peak lies under the JAX gate's estimate
    arch, B, S = "phi3.5-moe-42b-a6.6b", 2, 32
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)

    def gates(cap):
        jok, jrep = jtrain.admission_check(
            jcfg, JaxTrainPolicy(), jax_smoke_shape(S, B), hbm_bytes=cap,
            verbose=False)
        tok, trep = ttrain.admission_check(tcfg, TrainPolicy(),
                                           smoke_shape(S, B), cap)
        return jok, jrep, tok, trep

    _, jrep, _, trep = gates(1 << 40)
    workspaces = 2 * CUBLAS_WORKSPACE_BYTES
    assert 0 < trep.peak_tensor_bytes - workspaces < jrep.peak_bytes
    cap = where if isinstance(where, int) else {
        "at_port_estimate": trep.peak_bytes,
        "below_port_estimate": trep.peak_bytes - 1,
        "between_the_peaks": (jrep.peak_bytes + trep.peak_tensor_bytes) // 2,
        "below_jax_estimate": jrep.peak_tensor_bytes - 1}[where]
    jok, _, tok, rep = gates(cap)
    assert (jok, tok) == (jax_admits, port_admits)
    assert rep.persistent_bytes < cap or not port_admits


@pytest.mark.parametrize("n,dtype,temps", [
    # as the card's allocator showed them (torch 2.11, H100)
    (32768, torch.int64, [262144, 549375]),
    (16384, torch.int64, [131072, 283135]),
    (100003, torch.int64, [800024, 1639935]),
    (65536, torch.int64, [524288, 1080831]),
    (4097, torch.int64, [32776, 83967]),
    (4096, torch.int64, [32768]),               # sorted in place
    (32768, torch.float32, []),                 # not measured: not modeled
])
def test_tracer_adds_the_sorts_buffers(n, dtype, temps):
    # CUDA's sort of a long segment sorts an int64 identity permutation
    # with cub, whose temp storage the fake kernel does not allocate
    for stable in (True, False):
        _, tr, _ = trace_fn(lambda k: torch.sort(k, stable=stable),
                            torch.zeros(n, dtype=dtype))
        got = [b.size for b in tr.blocks.values() if b.kind is BlockKind.TEMP]
        assert got == temps

"""The port's hybrid (jamba) and SSM (xLSTM) families against the JAX
package, on the CPU.

jamba-smoke (periods of 1 attention + 3 Mamba layers, MoE on odd
positions) and xlstm-smoke (periods of 3 mLSTM + 1 sLSTM) with f32
weights converted from the JAX package's ``init_params`` and inputs
from a numpy seed. Losses, logits, decode states and jamba's gradients
agree within rtol 1e-4, atol 1e-5; parameter, cache and persistent
bytes are byte-exact at full width; the gates and the cache profile
give the JAX package's answers.

xlstm-smoke's gradients and decode states are held to a bound measured
from the reference itself: at these random weights the mLSTM's
normalizer (``h = num / max(|den|, e^-m)``) amplifies rounding from
block to block, so that one ulp of noise on the JAX package's own f32
weights moves its gradients by about 2e-4 (normwise, 30 times the
elementwise tolerance above) and its third decode step's mLSTM state by
up to 10 times that tolerance. The port's gradients must lie within
twice that normwise distance of the JAX package's, and each decode leaf
within the tolerance plus twice the leaf's largest such move.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.core.events import BlockKind as JaxKind
from repro.core.events import Phase as JaxPhase
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.train import data as jdata
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro.train.train_step import make_fwd_bwd as jax_fwd_bwd
from repro.train.train_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.estimator import XMemEstimator
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train import data as tdata
from repro_torch.train.train_step import (TrainPolicy, make_estimator_hooks,
                                          make_fwd_bwd, make_prefill_step)

RTOL, ATOL = 1e-4, 1e-5
HYBRID, SSM = "jamba-1.5-large-398b", "xlstm-1.3b"
ARCHS = [HYBRID, SSM]


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def _pairs(port, ref):
    """(path, port leaf, reference leaf) in the reference's order."""
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(leaves) == len(pytree.tree_leaves(port))
    for path, want in leaves:
        got = _at(port, path)
        assert tuple(got.shape) == tuple(want.shape), path
        yield jax.tree_util.keystr(path), got, want


def _normwise(port, ref) -> float:
    """The largest ||port - ref|| / ||ref|| over the leaves."""
    worst = 0.0
    for _, got, want in _pairs(port, ref):
        got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                         else got, np.float64)
        want = np.asarray(want, np.float64)
        worst = max(worst, np.linalg.norm(got - want) / np.linalg.norm(want))
    return worst


def _noisy(params, seed=99):
    """``params`` with one ulp of relative noise on every weight."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a * (1 + jnp.asarray(rng.standard_normal(a.shape),
                                       jnp.float32) * 2.0 ** -24), params)


def _close_within_noise(port, ref, noisy, msg=""):
    """rtol/atol, plus twice the largest distance of ``noisy`` (the
    reference at ``_noisy`` weights) from ``ref`` as an absolute term."""
    ref = np.asarray(ref, np.float32)
    spread = float(np.abs(np.asarray(noisy, np.float32) - ref).max())
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=RTOL,
                               atol=ATOL + 2 * spread, err_msg=msg)


def _bytes(tree):
    return sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize
               for t in jax.tree_util.tree_leaves(tree))


def _tbytes(tree):
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _cfgs(arch, impl=None, **kw):
    """The same smoke config in both packages, f32 parameters; ``impl``
    is (JAX's, the port's) attention implementation."""
    out = []
    for reg, i in zip((jreg, treg), impl or (None, None)):
        c = reg.get_smoke(arch)
        att = c.attention if i is None else dataclasses.replace(c.attention,
                                                                impl=i)
        out.append(dataclasses.replace(c, param_dtype="float32",
                                       attention=att, **kw))
    return out


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, tcfg, device="cpu")


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def _train_batch(cfg, b, s, seed=0):
    """The data pipeline's batch, with a few labels masked."""
    batch = jdata.SyntheticDataset(cfg, jax_smoke_shape(s, b),
                                   jdata.DataConfig(seed=seed)).batch(0)
    batch["labels"] = np.array(batch["labels"])
    batch["labels"][0, :3] = -1
    return batch


# ---------------------------------------------------------------------------
# the models
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    # 24 positions: two chunks of 16, the second padded
    jc, tc = _cfgs(arch, remat=remat)
    jp, tp = _params(jc, tc)
    jb, tb = _both(_train_batch(jc, 2, 24))
    jfb = jax.jit(jax_fwd_bwd(jc))
    jl_, jg = jfb(jp, jb)
    tl_, tg = make_fwd_bwd(tc)(tp, tb)
    _close(tl_, jl_)
    if arch == HYBRID:
        for name, got, want in _pairs(tg, jg):
            _close(got, want, name)
        return
    noise = _normwise(jfb(_noisy(jp), jb)[1], jg)
    assert 1e-6 < noise < 1e-3          # the reference's own sensitivity
    assert _normwise(tg, jg) <= 2 * noise


def test_stacked_gradients_keep_the_jax_shapes():
    # the mLSTM leaves are stacked two deep; each block's gradient goes
    # into its [p, j] slice of one stacked gradient
    jc, tc = _cfgs(SSM)
    _, tp = _params(jc, tc)
    _, tb = _both(_train_batch(jc, 1, 8))
    _, tg = make_fwd_bwd(tc)(tp, tb)
    n_periods = tc.n_layers // tc.xlstm.slstm_every
    wq = tg["layers"]["mlstm"]["wq"]
    assert wq.shape[:2] == (n_periods, tc.xlstm.slstm_every - 1)
    assert all(wq[p, j].abs().sum() > 0 for p in range(wq.shape[0])
               for j in range(wq.shape[1]))
    assert all(t.grad is None for t in pytree.tree_leaves(tp))


@pytest.mark.parametrize("impls", [("pallas", "flash"), ("auto", "auto")],
                         ids=["flash_vs_pallas", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch, impls):
    # last-position logits; jamba's attention through the flash op's
    # plain version against the JAX package's Pallas kernel in interpret
    # mode (xLSTM has no attention: the two impls are one path)
    jc, tc = _cfgs(arch, impls)
    jp, tp = _params(jc, tc)
    prompt = tserve.make_prompts(tc, 2, 20, seed=7)
    jb, tb = _both(prompt)
    ref = jax.jit(jax_prefill_step(jc))(jp, jb)
    out = make_prefill_step(tc)(tp, tb)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_match_jax(arch):
    # every cache leaf after every step; jamba's KV cache starts random
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(9)
    B, max_len = 2, 16
    state = jax.tree_util.tree_map(np.asarray, JM.init_cache(jc, B, max_len))
    for n in ("k", "v"):
        if n in state:
            state[n] = rng.standard_normal(state[n].shape, dtype=np.float32)
    jcache = ncache = {n: jnp.asarray(a) for n, a in state.items()}
    tcache = convert.tree_from_numpy(state, device="cpu")
    jstep = jax.jit(lambda p, c, b, i: JM.decode_step(p, c, b, i, jc))
    noisy = _noisy(jp)
    for cache_len in (5, 6, 7):
        tok = rng.integers(0, jc.vocab, (B, 1), dtype=np.int32)
        jb, tb = _both({"tokens": tok})
        ref_logits, jcache = jstep(jp, jcache, jb, cache_len)
        logits, out = TM.decode_step(tp, tcache, tb, cache_len, tc)
        assert out is tcache                      # written in place
        _close(logits, ref_logits, f"step at {cache_len}")
        assert set(tcache) == set(jcache)
        if arch == HYBRID:
            for n in jcache:
                _close(tcache[n], jcache[n], f"{n} at {cache_len}")
            continue
        _, ncache = jstep(noisy, ncache, jb, cache_len)
        for n in jcache:
            _close_within_noise(tcache[n], jcache[n], ncache[n],
                                f"{n} at {cache_len}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_jax(arch):
    # prefill argmax, then decode from init_cache's state at position 0,
    # as the JAX package's serve loop does; the second request starts
    # from a reset state
    jc, tc = _cfgs(arch, ("pallas", "flash"))
    jp, tp = _params(jc, tc)
    B, max_len, prompt_len, tokens = 2, 32, 20, 4
    res = tserve.serve(tc, B, max_len, prompt_len, tokens, device="cpu",
                       seed=5, params=tp, requests=2)
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, {"tokens": t}, i,
                                                     jc))
    for r in range(2):
        jb, _ = _both(tserve.make_prompts(tc, B, prompt_len, seed=5 + r))
        logits = jax.jit(jax_prefill_step(jc))(jp, jb)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        cache = JM.init_cache(jc, B, max_len)
        want = []
        for i in range(tokens):
            logits, cache = step(jp, cache, tok, jnp.int32(i))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            want.append(np.asarray(tok))
        np.testing.assert_array_equal(res.tokens[r],
                                      np.concatenate(want, axis=1))
    assert res.tokens.shape == (2, B, tokens)
    assert fa.launches == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_cache_restores_init_cache(arch):
    tc = treg.get_smoke(arch)
    cache = TM.init_cache(tc, 2, 8, device="cpu")
    fresh = {k: v.clone() for k, v in cache.items()}
    for v in cache.values():
        v.normal_()
    assert TM.reset_cache(cache) is cache
    for k in fresh:
        assert torch.equal(cache[k], fresh[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    # keys, shapes, dtypes and values; the sLSTM state starts all zeros
    # and the mLSTM stabilizer at -1e30, as the reference's init_cache
    jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
    want = JM.init_cache(jc, 3, 12)
    got = TM.init_cache(tc, 3, 12, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prompts_and_batches_have_the_jax_keys_and_values(arch):
    tc, jc = treg.get_smoke(arch), jreg.get_smoke(arch)
    specs = tserve.prompt_specs(tc, 3, 40)
    want = jserve.prompt_specs(jc, 3, 40)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert set(tserve.decode_input(tc, 3)) == set(jserve.decode_input(jc, 3))
    jds = jdata.SyntheticDataset(jc, jax_smoke_shape(32, 4))
    tds = tdata.SyntheticDataset(tc, smoke_shape(32, 4))
    for step in (0, 5):
        got, ref = tds.batch(step), jds.batch(step)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_checks_the_family_tree(arch):
    jc, tc = _cfgs(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jc, jax.random.key(1)))
    tp = convert.params_from_numpy(jp, tc, device="cpu")
    assert _tbytes(tp) == _bytes(jp)
    # the other family's tree is refused
    other = _cfgs(SSM if arch == HYBRID else HYBRID)[0]
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_numpy(jax.tree_util.tree_map(
            np.asarray, JM.init_params(other, jax.random.key(1))), tc,
            device="cpu")
    # the decode state converts leaf for leaf into init_cache's structure
    state = convert.tree_from_numpy(jax.tree_util.tree_map(
        np.asarray, JM.init_cache(jc, 2, 8)), device="cpu")
    like = TM.init_cache(tc, 2, 8, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in like.items()}


# ---------------------------------------------------------------------------
# bytes, the estimator and the gates
@pytest.mark.parametrize("arch,param_bytes", [(HYBRID, 797_154_754_560),
                                              (SSM, 2_124_968_608)])
def test_full_width_parameter_and_cache_bytes_match_jax(arch, param_bytes):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    tparams = TM.abstract_params(tc)
    assert _tbytes(tparams) == _bytes(JM.abstract_params(jc)) == param_bytes
    jcache = jax.eval_shape(lambda: JM.init_cache(jc, 3, 2064))
    assert _tbytes(TM.init_cache(tc, 3, 2064, device="meta")) == \
        _bytes(jcache)


def test_jambas_cut_is_one_attention_and_one_mamba_moe_layer():
    # the configuration the card serves: attn_every=2, n_layers=2, full
    # width (23.83 GB of bf16)
    cut = dataclasses.replace(
        treg.get_config(HYBRID), n_layers=2,
        attention=dataclasses.replace(treg.get_config(HYBRID).attention,
                                      attn_every=2))
    params = TM.abstract_params(cut)
    assert set(params["layers"]) == {"pos0", "pos1"}
    assert "mlp" in params["layers"]["pos0"]
    assert "moe" in params["layers"]["pos1"]
    assert "mamba" in params["layers"]["pos1"]
    jcut = dataclasses.replace(
        jreg.get_config(HYBRID), n_layers=2,
        attention=dataclasses.replace(jreg.get_config(HYBRID).attention,
                                      attn_every=2))
    assert _tbytes(params) == _bytes(JM.abstract_params(jcut))
    assert 23.8e9 < _tbytes(params) < 23.9e9


def _jax_serving(cfg, phase, B, max_len):
    params = JM.abstract_params(cfg)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, max_len))
    if phase == "decode":
        fn, batch = jserve.make_decode_fn(cfg), jserve.decode_input(cfg, B)
    else:
        fn = jserve.make_prefill_fn(cfg)
        batch = jserve.prompt_specs(cfg, B, max_len)
    entry = JaxEstimator.for_torch_gpu()._trace_phase(
        fn, [(params, JaxKind.PARAM, "params"),
             (cache, JaxKind.CACHE, "cache"),
             (batch, JaxKind.INPUT, "batch")], JaxPhase.DECODE, tag="decode")
    by_kind: dict = {}
    for b in entry.input_blocks:
        by_kind[b.kind.value] = by_kind.get(b.kind.value, 0) + b.size
    return by_kind


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_persistent_bytes_match_jax(arch, phase):
    B, max_len = 4, 32
    jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
    want = _jax_serving(jc, phase, B, max_len)
    if phase == "decode":
        fn, batch = tserve.make_decode_fn(tc), tserve.decode_input(tc, B)
    else:
        fn = tserve.make_prefill_fn(tc)
        batch = tserve.prompt_specs(tc, B, max_len)
    got = XMemEstimator.for_torch_gpu().estimate_serving(
        fn, TM.abstract_params(tc), TM.init_cache(tc, B, max_len,
                                                  device="meta"), batch)
    kinds = got.breakdown["persistent_by_kind"]
    for kind in ("param", "cache", "input"):
        assert kinds[kind] == want[kind], kind


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_estimate_counts_the_cublas_workspace(arch):
    # from the step's first matmul on, outside the persistent bytes
    tc = treg.get_smoke(arch)
    B, max_len = 4, 32
    args = (tserve.make_decode_fn(tc), TM.abstract_params(tc),
            TM.init_cache(tc, B, max_len, device="meta"),
            tserve.decode_input(tc, B))
    with_ws = XMemEstimator.for_torch_gpu().estimate_serving(*args)
    without = XMemEstimator.for_torch_gpu(
        cublas_workspace=0).estimate_serving(*args)
    assert with_ws.peak_tensor_bytes - without.peak_tensor_bytes == 32 << 20
    assert with_ws.persistent_bytes == without.persistent_bytes
    assert with_ws.breakdown == without.breakdown


@pytest.mark.parametrize("arch", ARCHS)
def test_training_persistent_bytes_match_the_jax_estimator(arch):
    # params + AdamW m and v, byte for byte (the port also counts the
    # optimizer's 4-byte count, which the JAX trace folds into a literal)
    B, S = 2, 32
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


@pytest.mark.parametrize("capacity,admits", [(1 << 30, True),
                                             (1 << 20, False)],
                         ids=["1GiB", "1MiB"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_gate_verdict_matches_jax(arch, capacity, admits):
    B, S = 2, 32
    jok, _ = jtrain.admission_check(
        jreg.get_smoke(arch), JaxTrainPolicy(), jax_smoke_shape(S, B),
        hbm_bytes=capacity, verbose=False)
    tok, _ = ttrain.admission_check(treg.get_smoke(arch), TrainPolicy(),
                                    smoke_shape(S, B), capacity)
    assert (jok, tok) == (admits, admits)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_serving_cache_profile_matches_jax(arch):
    want = jserve.serving_cache_profile(jreg.get_smoke(arch), 64)
    assert tserve.serving_cache_profile(treg.get_smoke(arch), 64) == want
    kv_tok, resident = want
    if arch == SSM:
        assert kv_tok == 0 and resident > 0   # recurrent state, no KV
    elif arch == HYBRID:
        assert kv_tok > 0 and resident > 0    # KV and Mamba state
    else:
        assert kv_tok > 0 and resident == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_gate_takes_the_family(arch):
    cfg = treg.get_smoke(arch)
    batch, gate = tserve.pick_batch(cfg, 48, 1 << 62, candidates=(4,))
    assert batch == 4
    assert gate["decode"].breakdown["persistent_by_kind"]["cache"] == \
        _tbytes(TM.init_cache(cfg, 4, 48, device="meta"))
    batch, _ = tserve.pick_batch(cfg, 48, 1 << 20, candidates=(4, 1))
    assert batch is None


# ---------------------------------------------------------------------------
# the launchers
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--max-len", "32", "--tokens", "2"]) == 0
    assert "serving batch=64" in capsys.readouterr().out
    assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--seq", "32", "--batch", "2", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


def test_jambas_cut_training_gate_rejects():
    # one MoE layer's experts are 19.3 GB of bf16; with their gradients
    # and f32 AdamW state no batch of the cut fits an 80 GB card. Traced
    # at a short sequence: the parameter state alone is over capacity,
    # and the replay runs out of memory
    cut = dataclasses.replace(
        treg.get_config(HYBRID), n_layers=2,
        attention=dataclasses.replace(treg.get_config(HYBRID).attention,
                                      attn_every=2))
    est = XMemEstimator.for_torch_gpu()
    batch, gate = ttrain.pick_train_batch(cut, TrainPolicy(), 64,
                                          80 * 2**30, candidates=(1,),
                                          est=est)
    assert batch is None
    (cand,) = gate["candidates"]
    assert not cand["fits"] and cand["oom"]
    # unbounded, the same traces give the whole peak
    _, rep = ttrain.admission_check(cut, TrainPolicy(), smoke_shape(64, 1),
                                    1 << 62, est)
    assert rep.persistent_bytes > 4 * _tbytes(TM.abstract_params(cut))
    assert rep.peak_bytes > 100e9

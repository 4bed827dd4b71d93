"""The port's VLM and audio families against the JAX package, on the CPU.

internvl2 (patch embeddings before the text, loss on the text) and
musicgen (4 codebooks summed at the input, 4 output heads) at their
smoke sizes. Weights come from the JAX package's ``init_params`` through
``convert``; inputs are numpy arrays from a seed. Losses, gradients,
prefill and decode logits agree within rtol 1e-4, atol 1e-5 in f32;
parameter, cache and persistent bytes are byte-exact at full width; the
gates give the JAX package's verdicts.
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
from repro.models import layers as jl
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
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.train import data as tdata
from repro_torch.train.train_step import (TrainPolicy, make_estimator_hooks,
                                          make_fwd_bwd, make_prefill_step)

RTOL, ATOL = 1e-4, 1e-5
VLM, AUDIO = "internvl2-1b", "musicgen-medium"
ARCHS = [VLM, AUDIO]


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
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jc, tc = _cfgs(arch, remat=remat)
    jp, tp = _params(jc, tc)
    jb, tb = _both(_train_batch(jc, 2, 24))
    jl_, jg = jax.jit(jax_fwd_bwd(jc))(jp, jb)
    tl_, tg = make_fwd_bwd(tc)(tp, tb)
    _close(tl_, jl_)
    _close_tree(tg, jg)
    if arch == AUDIO:
        assert tg["embed"].shape == (tc.num_codebooks, tc.vocab, tc.d_model)
        assert tg["head"].shape == (tc.d_model, tc.num_codebooks * tc.vocab)


def test_vlm_loss_covers_the_text_alone():
    # the patches change the text's hidden states, but only text
    # positions are scored: labels are [B, S_text]
    jc, tc = _cfgs(VLM)
    _, tp = _params(jc, tc)
    batch = _train_batch(jc, 2, 24)
    assert batch["labels"].shape == batch["tokens"].shape
    _, tb = _both(batch)
    loss = TM.loss_fn(tp, tb, tc)
    tb["patch_embeds"] = tb["patch_embeds"] * 2
    assert not torch.isclose(loss, TM.loss_fn(tp, tb, tc))


def test_codebook_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    labels = rng.integers(0, 16, (2, 5, 4), dtype=np.int32)
    labels[0, 0, :2] = -1
    _close(tl.cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
           jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("tie", [False, True])
def test_audio_logits_per_codebook_match_jax(tie):
    jc, tc = _cfgs(AUDIO, tie_embeddings=tie)
    jp, tp = _params(jc, tc)
    h = np.random.default_rng(4).standard_normal((2, 3, jc.d_model),
                                                 dtype=np.float32)
    want = JM.logits_fn(jp, jnp.asarray(h), jc)
    got = TM.logits_fn(tp, torch.from_numpy(h), tc)
    assert tuple(got.shape) == (2, 3, tc.num_codebooks, tc.vocab)
    _close(got, want)


@pytest.mark.parametrize("impls", [("pallas", "flash"), ("auto", "auto")],
                         ids=["flash_vs_pallas", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch, impls):
    # last-position logits; the flash op's plain version against the
    # JAX package's Pallas kernel in interpret mode
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
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(9)
    B, max_len = 2, 16
    shape = (jc.n_layers, B, max_len, jc.n_kv_heads, jc.hd)
    kv = {n: rng.standard_normal(shape, dtype=np.float32) for n in "kv"}
    jcache = {n: jnp.asarray(a) for n, a in kv.items()}
    tcache = convert.tree_from_numpy(kv, device="cpu")
    jstep = jax.jit(lambda p, c, b, i: JM.decode_step(p, c, b, i, jc))
    for cache_len in (5, 6, 7):
        spec = tserve.decode_input(tc, B)
        batch = {k: rng.integers(0, jc.vocab, tuple(v.shape), dtype=np.int32)
                 for k, v in spec.items()}
        assert set(batch) == set(jserve.decode_input(jc, B))
        jb, tb = _both(batch)
        ref_logits, jcache = jstep(jp, jcache, jb, cache_len)
        logits, tcache = TM.decode_step(tp, tcache, tb, cache_len, tc)
        _close(logits, ref_logits, f"step at {cache_len}")
        for n in "kv":
            _close(tcache[n], jcache[n], n)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_jax(arch):
    # prefill argmax, then decode from cache position 0 (per codebook for
    # audio), as the JAX package's serve loop does
    jc, tc = _cfgs(arch, ("pallas", "flash"))
    jp, tp = _params(jc, tc)
    B, max_len, prompt_len, tokens = 2, 32, 20, 4
    res = tserve.serve(tc, B, max_len, prompt_len, tokens, device="cpu",
                       seed=5, params=tp)
    jb, _ = _both(tserve.make_prompts(tc, B, prompt_len, seed=5))
    logits = jax.jit(jax_prefill_step(jc))(jp, jb)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    cache = JM.init_cache(jc, B, max_len)
    key = "codes" if arch == AUDIO else "tokens"
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, {key: t}, i, jc))
    want = []
    for i in range(tokens):
        logits, cache = step(jp, cache, tok, jnp.int32(i))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(res.tokens[0],
                                  np.concatenate(want, axis=1))
    per_step = (tc.num_codebooks,) if arch == AUDIO else ()
    assert res.tokens.shape == (1, B, tokens, *per_step)
    assert fa.launches == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prompts_have_the_jax_keys_and_shapes(arch):
    tc, jc = treg.get_smoke(arch), jreg.get_smoke(arch)
    specs = tserve.prompt_specs(tc, 3, 40)
    want = jserve.prompt_specs(jc, 3, 40)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    prompts = tserve.make_prompts(tc, 3, 40, seed=1)
    for k, v in prompts.items():
        assert v.shape == tuple(specs[k].shape)
        if k == "patch_embeds":
            assert v.dtype == np.float32 and 0.01 < v.std() < 0.03
        else:
            assert v.dtype == np.int32 and 0 <= v.min() and v.max() < tc.vocab
    dev = tserve.device_prompts(tc, 3, 40, seed=1, device="cpu")
    assert all(t.dtype == (tc.dtype if t.is_floating_point() else torch.int32)
               for t in dev.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_match_jax(arch):
    jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
    jds = jdata.SyntheticDataset(jc, jax_smoke_shape(32, 4))
    tds = tdata.SyntheticDataset(tc, smoke_shape(32, 4))
    for step in (0, 5):
        want, got = jds.batch(step), tds.batch(step)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    dev = tds.device_batch(5, "cpu")
    assert all(t.is_contiguous() for t in dev.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_checks_the_family_tree(arch):
    jc, tc = _cfgs(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jc, jax.random.key(1)))
    tp = convert.params_from_numpy(jp, tc, device="cpu")
    assert _tbytes(tp) == _bytes(jp)
    bad = dict(jp, embed=jp["embed"][..., :-1])
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_numpy(bad, tc, device="cpu")


# ---------------------------------------------------------------------------
# bytes, the estimator and the gates
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_and_cache_bytes_match_jax(arch):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    tparams = TM.abstract_params(tc)
    assert _tbytes(tparams) == _bytes(JM.abstract_params(jc))
    assert sum(t.numel() for t in pytree.tree_leaves(tparams)) == \
        jc.param_count()
    jcache = jax.eval_shape(lambda: JM.init_cache(jc, 3, 2320))
    assert _tbytes(TM.init_cache(tc, 3, 2320, device="meta")) == \
        _bytes(jcache)


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
    # parameters, cache and the prompt's blocks (patch embeddings and
    # tokens, or codes) byte for byte
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
    numel = sum(t.numel() for t in pytree.tree_leaves(TM.abstract_params(
        tcfg)))
    assert trep.persistent_bytes == _tbytes(TM.abstract_params(tcfg)) \
        + 8 * numel + 4


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


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_gate_reads_the_families_inputs(arch):
    cfg = treg.get_smoke(arch)
    batch, gate = tserve.pick_batch(cfg, 48, 1 << 62, candidates=(4,))
    assert batch == 4
    assert gate["prefill"].breakdown["persistent_by_kind"]["input"] > 0
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


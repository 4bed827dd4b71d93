"""The port's configs, layers and dense model against the JAX package.

Weights come from the JAX package's ``init_params`` (f32) and cross
through ``convert.params_from_numpy``; inputs are numpy arrays from a
seed. Logits and caches must agree within 1e-4 in f32 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES_BY_NAME
from repro.models import layers as jl
from repro.models import model as JM
from repro.train.train_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import registry as treg
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.train.train_step import make_prefill_step

ATOL = 1e-4
ARCHS = ["qwen3-32b", "phi4-mini-3.8b", "starcoder2-3b"]


def _cfgs(arch, impl_port="auto", impl_jax="auto", **kw):
    """The same smoke config in both packages, f32 parameters."""
    out = []
    for reg, impl in ((jreg, impl_jax), (treg, impl_port)):
        c = reg.get_smoke(arch)
        out.append(dataclasses.replace(
            c, param_dtype="float32",
            attention=dataclasses.replace(c.attention, impl=impl, **kw)))
    return out


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, tcfg, device="cpu")


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# configs
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_match(arch):
    for getter in ("get_config", "get_smoke"):
        jc = getattr(jreg, getter)(arch)
        tc = getattr(treg, getter)(arch)
        assert jc.param_count() == tc.param_count()
        assert jc.active_param_count() == tc.active_param_count()
        assert jc.hd == tc.hd and jc.padded_vocab == tc.padded_vocab
        assert str(tc.dtype) == f"torch.{jc.param_dtype}"
        shape = SHAPES_BY_NAME["train_4k"]
        for fn in ("input_specs", "decode_input_specs"):
            js = getattr(jreg, fn)(jc, shape, batch_override=2)
            ts = getattr(treg, fn)(tc, shape, batch_override=2)
            assert set(js) == set(ts)
            for key in js:
                assert tuple(js[key].shape) == tuple(ts[key].shape)
                assert ts[key].device.type == "meta"
                assert str(ts[key].dtype) == f"torch.{js[key].dtype}"


@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma3-4b"])
def test_abstract_cache_matches(arch):
    shape = SHAPES_BY_NAME["train_4k"]
    jc = jreg.abstract_cache(jreg.get_smoke(arch), shape, batch_override=2)
    tc = treg.abstract_cache(treg.get_smoke(arch), shape, batch_override=2)
    assert set(jc) == set(tc)
    for key in jc:
        assert tuple(jc[key].shape) == tuple(tc[key].shape)
        assert tc[key].device.type == "meta"
        assert str(tc[key].dtype) == f"torch.{jc[key].dtype}"


# ---------------------------------------------------------------------------
# layers
def _rand(*shape, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_norm_rope_swiglu_match():
    jx, tx = _rand(2, 6, 4, 16)
    js, ts = _rand(16, seed=1)
    _close(tl.rms_norm(tx, ts), jl.rms_norm(jx, js))
    pos = np.arange(3, 9)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jl.apply_rope(jx, jnp.asarray(pos), 1e6))
    jx2, tx2 = _rand(2, 6, 8, seed=2)
    ws = [_rand(*s, seed=3 + i) for i, s in
          enumerate([(8, 12), (8, 12), (12, 8)])]
    _close(tl.swiglu(tx2, *[w[1] for w in ws]),
           jl.swiglu(jx2, *[w[0] for w in ws]))


@pytest.mark.parametrize("S,cq,ckv,window", [(96, 32, 32, None),
                                             (130, 64, 64, None),
                                             (128, 32, 32, 32)])
def test_attention_paths_match(S, cq, ckv, window):
    (jq, tq), (jk, tk), (jv, tv) = (_rand(2, S, 4, 16, seed=i)
                                    for i in range(3))
    _close(tl.dense_attention(tq, tk, tv, window=window),
           jl.dense_attention(jq, jk, jv, window=window))
    _close(tl.chunked_attention(tq, tk, tv, window=window, chunk_q=cq,
                                chunk_kv=ckv),
           jl.chunked_attention(jq, jk, jv, window=window, chunk_q=cq,
                                chunk_kv=ckv))


def test_decode_attention_matches():
    (jq, tq) = _rand(2, 1, 4, 16)
    (jk, tk), (jv, tv) = _rand(2, 20, 2, 16, seed=1), _rand(2, 20, 2, 16,
                                                           seed=2)
    for window in (None, 4):
        _close(tl.decode_attention(tq, tk, tv, 11, window=window),
               jl.decode_attention(jq, jk, jv, 11, window=window))


# ---------------------------------------------------------------------------
# model
@pytest.mark.parametrize("impls", [("flash", "pallas"), ("auto", "auto")],
                         ids=["flash_vs_pallas", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch, impls):
    jcfg, tcfg = _cfgs(arch, *impls)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 12),
                                             dtype=np.int32)
    ref = jax.jit(jax_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


def test_prefill_gemma3_global_flags_match():
    jcfg, tcfg = _cfgs("gemma3-4b")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (1, 20),
                                             dtype=np.int32)
    ref = jax.jit(jax_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    _close(make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)}),
           ref)


@pytest.mark.parametrize("arch", ARCHS + ["gemma3-4b"])
def test_decode_step_logits_and_cache_match(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(9)
    B, max_len, cache_len = 2, 16, 5
    shape = (jcfg.n_layers, B, max_len, jcfg.n_kv_heads, jcfg.hd)
    kv = {n: rng.standard_normal(shape, dtype=np.float32)
          for n in ("k", "v")}
    toks = rng.integers(0, jcfg.vocab, (B, 1), dtype=np.int32)
    ref_logits, ref_cache = jax.jit(
        lambda p, c, b: JM.decode_step(p, c, b, cache_len, jcfg))(
        jp, {n: jnp.asarray(a) for n, a in kv.items()},
        {"tokens": jnp.asarray(toks)})
    cache = convert.tree_from_numpy(kv, device="cpu")
    before = cache["k"].data_ptr()
    logits, new_cache = TM.decode_step(tp, cache, {"tokens": torch.from_numpy(
        toks)}, cache_len, tcfg)
    assert new_cache["k"].data_ptr() == before     # updated in place
    _close(logits, ref_logits)
    for n in ("k", "v"):
        _close(new_cache[n], ref_cache[n])


def test_bf16_weights_convert_byte_exact():
    jcfg = jreg.get_smoke("qwen3-32b")
    tcfg = treg.get_smoke("qwen3-32b")
    jp = JM.init_params(jcfg, jax.random.key(1))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.params_from_numpy(tree, tcfg, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16))
    assert sum(leaf.nbytes for _, leaf in jleaves) == sum(
        t.numel() * t.element_size()
        for t in torch.utils._pytree.tree_leaves(TM.abstract_params(tcfg)))


def test_convert_rejects_a_mismatched_tree():
    tcfg = treg.get_smoke("qwen3-32b")
    tree = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jreg.get_smoke("phi4-mini-3.8b"),
                                   jax.random.key(0)))
    with pytest.raises(ValueError):
        convert.params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "internvl2-1b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        TM.abstract_params(treg.get_smoke(arch))


def test_init_params_seeded_and_in_dtype():
    cfg = treg.get_smoke("qwen3-32b")
    a = TM.init_params(cfg, 3, device="cpu")
    b = TM.init_params(cfg, 3, device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert a["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads * cfg.hd)

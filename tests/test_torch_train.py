"""The port's training path against the JAX package, on the CPU in f32.

Weights come from the JAX package's ``init_params`` and cross through
``convert.params_from_numpy``; batches, gradients and optimizer states
are numpy arrays from a seed. Losses, gradients and optimizer steps
must agree within rtol 1e-4, atol 1e-5.
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
from repro.models import layers as jl
from repro.models import model as JM
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import make_fwd_bwd as jax_fwd_bwd
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core.events import BlockKind
from repro_torch.core.tracer import trace_fn
from repro_torch.examples import quickstart
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_fwd_bwd

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch, **kw):
    """The same smoke config in both packages, f32 parameters."""
    out = []
    for reg in (jreg, treg):
        c = reg.get_smoke(arch)
        att = {k: v for k, v in kw.items() if k in ("dense_threshold",
                                                    "chunk_q", "chunk_kv")}
        top = {k: v for k, v in kw.items() if k not in att}
        out.append(dataclasses.replace(
            c, param_dtype="float32",
            attention=dataclasses.replace(c.attention, **att), **top))
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


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def _close_tree(port, ref):
    """Every leaf of the JAX tree ``ref`` against the port's leaf at the
    same key path."""
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(leaves) == len(pytree.tree_leaves(port))
    for path, want in leaves:
        got = _at(port, path)
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            rtol=RTOL, atol=ATOL, err_msg=jax.tree_util.keystr(path))


def _loss_and_grads(jc, tc, b, s, microbatches=1):
    jp, tp = _params(jc, tc)
    batch = _batch(tc, b, s)
    jl_, jg = jax.jit(jax_fwd_bwd(jc, microbatches))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl_, tg = make_fwd_bwd(tc, microbatches)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=RTOL, atol=ATOL)
    _close_tree(tg, jg)
    return tl_, tg


# ---------------------------------------------------------------------------
# loss and gradients
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "phi4-mini-3.8b",
                                  "starcoder2-3b", "gemma3-4b"])
def test_loss_and_grads_match_jax(arch, remat):
    jc, tc = _cfgs(arch, remat=remat)
    _, grads = _loss_and_grads(jc, tc, 2, 16)
    # stacked [L, ...] leaves keep their stacked gradient shapes
    for k, g in grads["layers"]["attn"].items():
        assert g.shape[0] == tc.n_layers, k


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_chunked_attention_grads_match_jax(remat):
    # seq 40 above a lowered dense_threshold: the trainable chunked path
    # (q chunks of 16 checkpointed, kv chunks of 8, a ragged last chunk)
    jc, tc = _cfgs("qwen3-32b", remat=remat, dense_threshold=16,
                   chunk_q=16, chunk_kv=8)
    _loss_and_grads(jc, tc, 2, 40)


def test_microbatches_match_jax_accumulation():
    jc, tc = _cfgs("qwen3-32b")
    _, grads = _loss_and_grads(jc, tc, 4, 16, microbatches=2)
    # accumulated gradients are f32 in both packages
    assert all(g.dtype == torch.float32 for g in pytree.tree_leaves(grads))


def test_cross_entropy_matches_jax_and_masks():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5), dtype=np.int32)
    labels[1, 2:] = -1
    got = tl.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    none = np.full((2, 5), -1, dtype=np.int32)     # nothing to predict
    assert float(tl.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(none))) == 0.0


def test_stacked_gradients_are_written_in_place_not_summed():
    # a plain leaf[i] gives every layer a select_backward the size of the
    # whole stack; the port writes each layer's slice into one buffer
    cfg = treg.get_smoke("qwen3-32b")
    params = TM.abstract_params(cfg)
    batch = treg.input_specs(cfg, smoke_shape(16, 2))

    def step(p, b):
        return make_fwd_bwd(cfg)(p, b)
    _, tr, out = trace_fn(step, params, batch, grad=True)
    stacked = {tuple(v.shape) for v in pytree.tree_leaves(params["layers"])}
    assert not [b for b in tr.blocks.values()
                if b.op == "aten::select_backward" and b.shape in stacked]
    grads = out[1]
    assert grads["layers"]["mlp"]["w_up"].shape == \
        params["layers"]["mlp"]["w_up"].shape


# ---------------------------------------------------------------------------
# optimizers
def _rand_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
        tree)


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("name", sorted(jopt.OPTIMIZERS))
def test_update_step_matches_jax(name, clip):
    # one JAX step from the zero state gives a state with nonzero
    # moments and count 1; it crosses to the port by key path, and one
    # more step runs in both packages
    jc, tc = _cfgs("qwen3-32b")
    jp, _ = _params(jc, tc)
    g1, g2 = _rand_like(jp, 1), _rand_like(jp, 2)
    jo, to = jopt.get_optimizer(name), topt.get_optimizer(name)
    ju, tu = jo.update, to.update
    if clip is not None:
        ju = jopt.clip_by_global_norm(ju, clip)
        tu = topt.clip_by_global_norm(tu, clip)
    p1, s1 = ju(jp, jax.tree_util.tree_map(jnp.asarray, g1), jo.init(jp))
    p2, s2 = ju(p1, jax.tree_util.tree_map(jnp.asarray, g2), s1)

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)
    tp = convert.params_from_numpy(host(p1), tc, device="cpu")
    ts = convert.opt_state_from_numpy(host(s1), to, tc, device="cpu")
    tg = convert.params_from_numpy(g2, tc, device="cpu")
    out_p, out_s = tu(tp, tg, ts)
    assert out_p is tp and out_s is ts          # updated in place
    _close_tree(tp, p2)
    _close_tree(ts, s2)


def test_opt_state_converter_matches_by_key_path():
    # JAX flattens dicts by sorted key, the port by insertion order: the
    # converter must rebuild the port's order, or the update pairs the
    # wrong leaves
    jc, tc = _cfgs("qwen3-32b")
    jp, tp = _params(jc, tc)
    opt = topt.get_optimizer("adam")
    state = jopt.get_optimizer("adam").init(jp)
    ts = convert.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), opt, tc, device="cpu")
    assert list(ts) == list(opt.init(tp))
    assert [t.shape for t in pytree.tree_leaves(ts["m"])] == \
        [t.shape for t in pytree.tree_leaves(tp)]
    assert ts["count"].dtype == torch.int32 and ts["count"].ndim == 0
    with pytest.raises(ValueError):
        convert.opt_state_from_numpy({"m": {}}, opt, tc, device="cpu")


# ---------------------------------------------------------------------------
# data, launcher, quickstart
def test_synthetic_batches_match_jax():
    jc, tc = jreg.get_smoke("qwen3-32b"), treg.get_smoke("qwen3-32b")
    jds = jdata.SyntheticDataset(jc, jax_smoke_shape(32, 4))
    tds = tdata.SyntheticDataset(tc, smoke_shape(32, 4))
    for step in (0, 5):
        want, got = jds.batch(step), tds.batch(step)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    dev = tds.device_batch(5, "cpu")
    assert dev["tokens"].dtype == torch.int32
    assert dev["tokens"].is_contiguous()


def test_train_launcher_on_the_cpu(capsys):
    assert ttrain.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                        "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "ADMIT" in out and "step   2 loss" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


def test_train_launcher_needs_a_card_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card exit; this machine has a card")
    assert ttrain.main(["--arch", "qwen3-32b", "--smoke", "--steps",
                        "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_gate_rejects_and_admits_by_capacity(capsys):
    cfg = treg.get_smoke("qwen3-32b")
    policy = ttrain.TrainPolicy()
    b, gate = ttrain.pick_train_batch(cfg, policy, 32, 1 << 62, (8, 1))
    assert b == 8 and gate["trace_cache"] == {"hits": 0, "misses": 3}
    need = gate["candidates"][0]["estimate"]
    assert ttrain.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                        "--seq", "32", "--batch", "1", "--steps", "0",
                        "--capacity-gib", str(1 / 2**20)]) == 2
    assert "rejected" in capsys.readouterr().out
    # the largest batch whose replay at capacity fits; the optimizer
    # phases are traced once for both candidates
    b, gate = ttrain.pick_train_batch(cfg, policy, 32, need - 1, (8, 1))
    assert b == 1 and gate["report"].peak_bytes <= need - 1
    assert not gate["candidates"][0]["fits"]
    assert gate["trace_cache"] == {"hits": 2, "misses": 4}


def test_quickstart_on_the_cpu_measures_nothing(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "xMem estimate" in out and "no ground truth" in out


def test_backward_ops_reach_the_tracer():
    # checkpointed layers under torch.autograd.grad: the engine runs the
    # backward (recomputed forward included) under the tracer's modes
    from torch.utils.checkpoint import checkpoint

    def step(w, h):
        w = w.detach().requires_grad_()
        for i in range(4):
            h = checkpoint(lambda x, i=i: torch.tanh(x @ w[i]), h,
                           use_reentrant=False)
        return torch.autograd.grad(h.sum(), w)[0]
    _, tr, out = trace_fn(step, torch.zeros(4, 16, 16), torch.zeros(8, 16),
                          grad=True)
    bwd = [b for b in tr.blocks.values() if b.scope == "backward"]
    assert {"aten::tanh", "aten::mm"} <= {b.op for b in bwd}
    assert tr.output_blocks[0].kind is BlockKind.OUTPUT
    assert out.shape == (4, 16, 16)


@pytest.mark.parametrize("grad_layout", ["contiguous", "transposed"])
def test_tracer_adds_the_buffers_cuda_kernels_make_inside_an_op(grad_layout):
    # softmax's backward computes grad * output (and makes it contiguous
    # when grad is not); a sum of a bool tensor casts it to int64 first
    def step(s, g):
        s = s.detach().requires_grad_()
        p = torch.softmax(s, -1)
        loss = (p * g).sum() + s.amax(-1).sum()
        return torch.autograd.grad(loss, s)[0]
    g = torch.zeros(2, 3, 8, 16)
    if grad_layout == "transposed":
        g = torch.zeros(2, 3, 16, 8).transpose(-1, -2)
    _, tr, _ = trace_fn(step, torch.zeros(2, 3, 8, 16), g, grad=True)
    temps = [(b.op, b.size, b.free_t - b.alloc_t) for b in tr.blocks.values()
             if b.kind is BlockKind.TEMP]
    n = 2 * 3 * 8 * 16
    softmax = [t for t in temps if t[0] == "aten::_softmax_backward_data"]
    # the product (mul) takes the layout of the incoming gradient, here
    # p's gradient g * 1, laid out like g
    assert [size for _, size, _ in softmax] == \
        [4 * n] * (1 if grad_layout == "contiguous" else 2)
    assert [t for t in temps if t[0] == "aten::sum"] == \
        [("aten::sum", 8 * n, 1)]         # the amax backward's mask count
    assert all(life >= 1 for _, _, life in temps)


def test_a_dispatch_mode_keeps_the_engine_from_summing_in_place():
    # an expected delta of the tracer (PERF.md section 7): without a
    # Python dispatch mode the autograd engine sums a tensor's gradients
    # in place (aten::add_) when it holds the only reference; under the
    # tracer's mode it sums them out of place, so the trace has
    # allocations the card does not make (chip_smoke's attn_layer)
    from torch.profiler import ProfilerActivity, profile

    def step(q):
        q = q.detach().requires_grad_()
        o = tl.chunked_attention(q, q, q, chunk_q=16, chunk_kv=32)
        return torch.autograd.grad(o.float().square().mean(), q)[0]
    q = torch.randn(1, 64, 2, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(q)
    names = [e.name for e in prof.events()]
    in_place = names.count("aten::add_")
    _, tr, _ = trace_fn(step, q, grad=True)
    traced = sum(b.op == "aten::add" for b in tr.blocks.values())
    assert in_place > 0
    assert traced == names.count("aten::add") + in_place

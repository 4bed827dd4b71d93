"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the CPU.

xlstm-smoke's width (d_model 64, 4 heads, chunk 16), f32 weights from
the JAX package's ``mlstm_params``/``slstm_params`` and inputs from a
numpy seed. Outputs, gradients and states agree within rtol 1e-4, atol
1e-5; the chunkwise mLSTM also agrees with the port's own sequential
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import xlstm as jxl
from repro_torch.configs import registry as treg
from repro_torch.core.tracer import trace_fn
from repro_torch.models import xlstm as txl

RTOL, ATOL = 1e-4, 1e-5
ARCH = "xlstm-1.3b"
JCFG, TCFG = jreg.get_smoke(ARCH), treg.get_smoke(ARCH)
D, H = JCFG.d_model, JCFG.n_heads


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _rand(*shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale


def _torch(tree, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in tree.items()}


def _cell_inputs(S, seed=0):
    """q, k [B, S, H, 4], v [B, S, H, 8], input and forget gates."""
    B = 2
    return [_rand(B, S, H, 4, seed=seed, scale=0.5),
            _rand(B, S, H, 4, seed=seed + 1, scale=0.5),
            _rand(B, S, H, 8, seed=seed + 2),
            _rand(B, S, H, seed=seed + 3),
            _rand(B, S, H, seed=seed + 4) + 3.0]


# ---------------------------------------------------------------------------
# mLSTM
@pytest.mark.parametrize("S,chunk", [(16, 16), (20, 8), (7, 4), (5, 16)])
def test_mlstm_chunkwise_matches_jax_and_the_recurrence(S, chunk):
    # S not a multiple of chunk pads the last chunk with identity steps
    ins = _cell_inputs(S)
    jh, jst = jxl.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=chunk)
    th, tst = txl.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=chunk)
    assert tuple(th.shape) == tuple(jh.shape)
    _close(th, jh, "h")
    for name, a, b in zip("Cnm", tst, jst):
        _close(a, b, name)
    rh, rst = txl.mlstm_recurrent_reference(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(th.numpy(), rh.numpy(), rtol=1e-3, atol=1e-4)
    for name, a, b in zip("Cnm", tst, rst):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_mlstm_recurrent_reference_matches_jax():
    ins = _cell_inputs(9, seed=3)
    jh, jst = jxl.mlstm_recurrent_reference(*map(jnp.asarray, ins))
    th, tst = txl.mlstm_recurrent_reference(*map(torch.from_numpy, ins))
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


def test_mlstm_chunkwise_carries_a_state():
    # two halves, the second from the first's state, are the whole
    ins = _cell_inputs(24, seed=5)
    t = [torch.from_numpy(a) for a in ins]
    whole, st = txl.mlstm_chunkwise(*t, chunk=8)
    first, mid = txl.mlstm_chunkwise(*(a[:, :13] for a in t), chunk=8)
    second, end = txl.mlstm_chunkwise(*(a[:, 13:] for a in t), state=mid,
                                      chunk=8)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), rtol=1e-3, atol=1e-4)
    jh, _ = jxl.mlstm_chunkwise(*(jnp.asarray(a[:, 13:]) for a in ins),
                                state=tuple(jnp.asarray(x.numpy())
                                            for x in mid), chunk=8)
    _close(second, jh)
    for a, b in zip(end, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


def _mlstm_params(seed=0):
    return jxl.mlstm_params(jax.random.key(seed), D, H, JCFG.xlstm,
                            jnp.float32)


@pytest.mark.parametrize("S", [8, 21])
def test_mlstm_block_and_gradients_match_jax(S):
    jp = _mlstm_params()
    x = _rand(2, S, D, seed=6)
    cot = _rand(2, S, D, seed=7, scale=0.1)

    def jloss(x, p):
        return (jxl.mlstm_block(x, p, H, JCFG.xlstm) * cot).sum()
    jout = jxl.mlstm_block(jnp.asarray(x), jp, H, JCFG.xlstm)
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tp = _torch(jp, grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = txl.mlstm_block(tx, tp, H, TCFG.xlstm)
    _close(out, jout, "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jgx, "x")
    for k, t in tp.items():
        _close(t.grad, jgp[k], k)


def test_mlstm_decode_steps_match_jax():
    jp = _mlstm_params(1)
    tp = _torch(jp)
    B = 3
    jst = jxl.mlstm_init_state(B, D, H, JCFG.xlstm)
    tst = txl.mlstm_init_state(B, D, H, TCFG.xlstm, device="cpu")
    for a, b in zip(tst, jst):
        _close(a, b)
    for step in range(3):
        x = _rand(B, 1, D, seed=20 + step)
        jout, jst = jxl.mlstm_decode_step(jnp.asarray(x), jst, jp, H)
        tout, tst = txl.mlstm_decode_step(torch.from_numpy(x), tst, tp, H)
        _close(tout, jout, f"out {step}")
        for name, a, b in zip("Cnm", tst, jst):
            _close(a, b, f"{name} {step}")


def test_mlstm_decode_continues_the_block():
    tp = _torch(_mlstm_params(2))
    S, B = 12, 2
    x = torch.from_numpy(_rand(B, S, D, seed=8))
    with torch.no_grad():
        full = txl.mlstm_block(x, tp, H, TCFG.xlstm)
        st = txl.mlstm_init_state(B, D, H, TCFG.xlstm, device="cpu")
        outs = []
        for t in range(S):
            out, st = txl.mlstm_decode_step(x[:, t:t + 1], st, tp, H)
            outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# sLSTM
def _slstm_params(seed=0):
    return jxl.slstm_params(jax.random.key(seed), D, H, jnp.float32)


def _slstm_state(B, seed):
    """A state as decoding leaves it: c and h of either sign, n > 0."""
    h, c, n, m = (_rand(B, D, seed=seed + i) for i in range(4))
    return (np.tanh(h), c, np.abs(n) + 0.5, m)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("S,chunk", [(1, 1), (16, 16), (13, 5)])
def test_slstm_block_matches_jax(S, chunk, with_state):
    # 13 steps in chunks of 5 pad two zero steps, which the returned
    # state includes, as in the reference
    jp = _slstm_params()
    x = _rand(2, S, D, seed=9)
    st = _slstm_state(2, 30) if with_state else None
    jout, jst = jxl.slstm_block(
        jnp.asarray(x), jp, H, chunk=chunk,
        state=None if st is None else tuple(map(jnp.asarray, st)))
    tout, tst = txl.slstm_block(
        torch.from_numpy(x), _torch(jp), H, chunk=chunk,
        state=None if st is None else tuple(map(torch.from_numpy, st)))
    _close(tout, jout, "out")
    for name, a, b in zip("hcnm", tst, jst):
        assert tuple(a.shape) == (2, D)
        _close(a, b, name)


@pytest.mark.parametrize("S", [8, 19])
def test_slstm_block_gradients_match_jax(S):
    jp = _slstm_params(1)
    x = _rand(2, S, D, seed=10)
    cot = _rand(2, S, D, seed=11, scale=0.1)

    def jloss(x, p):
        return (jxl.slstm_block(x, p, H, chunk=8)[0] * cot).sum()
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tp = _torch(jp, grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = txl.slstm_block(tx, tp, H, chunk=8)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jgx, "x")
    for k, t in tp.items():
        _close(t.grad, jgp[k], k)


def test_slstm_init_state_matches_jax():
    for a, b in zip(txl.slstm_init_state(3, D, device="cpu"),
                    jxl.slstm_init_state(3, D)):
        _close(a, b)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_params_have_the_jax_shapes_and_dtypes(block):
    if block == "mlstm":
        want = jax.eval_shape(lambda: jxl.mlstm_params(
            jax.random.key(0), D, H, JCFG.xlstm, jnp.bfloat16))
        got = txl.mlstm_params(None, D, H, TCFG.xlstm, torch.bfloat16,
                               device="meta", lead=(2, 3))
        lead = (2, 3)
        host = txl.mlstm_params(torch.Generator().manual_seed(0), D, H,
                                TCFG.xlstm, torch.float32, device="cpu")
        ref = _mlstm_params()
        fixed = ("b_if", "norm")
    else:
        want = jax.eval_shape(lambda: jxl.slstm_params(
            jax.random.key(0), D, H, jnp.bfloat16))
        got = txl.slstm_params(None, D, H, torch.bfloat16, device="meta",
                               lead=(2,))
        lead = (2,)
        host = txl.slstm_params(torch.Generator().manual_seed(0), D, H,
                                torch.float32, device="cpu")
        ref = _slstm_params()
        fixed = ("b_f", "norm")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == lead + tuple(v.shape), k
        assert got[k].dtype == torch.bfloat16, k
    for k in fixed:
        np.testing.assert_array_equal(host[k].numpy(), np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# what the trace sees
def test_log_sigmoid_allocates_only_its_output_under_the_trace():
    # F.logsigmoid's fake kernel allocates a buffer the input's size
    # that the CUDA kernel does not; -softplus(-x) allocates no such
    # buffer that outlives the op
    x = torch.empty((64, 256), device="meta")
    _, tr, _ = trace_fn(txl._log_sigmoid, x)
    live = [b for b in tr.blocks.values()
            if b.op != "input" and b.free_t is None]
    assert [b.size for b in live] == [64 * 256 * 4]
    _, tr, _ = trace_fn(torch.nn.functional.logsigmoid, x)
    assert sum(b.op == "aten::log_sigmoid_forward"
               for b in tr.blocks.values()) == 2     # the buffer is there


def test_slstm_step_ops_stay_few():
    # the CPU trace pays for every op of the step loop once a step:
    # one baddbmm gives the four gates, and the step takes 21 ops
    tp = txl.slstm_params(None, D, H, torch.bfloat16, device="meta")
    calls = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(func)
            return func(*args, **(kwargs or {}))

    def ops(S):
        calls.clear()
        x = torch.empty((2, S, D), dtype=torch.bfloat16, device="meta")
        with torch.no_grad(), Count():
            txl.slstm_block(x, tp, H, chunk=64)
        return list(calls)
    per_step = len(ops(33)) - len(ops(32))
    assert per_step == 21, per_step
    assert ops(32).count(torch.ops.aten.baddbmm.default) == 32

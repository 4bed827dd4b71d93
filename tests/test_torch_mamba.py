"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's, on the CPU.

jamba-smoke's Mamba width (d_model 64, d_inner 128, d_state 8, chunk
16), f32 weights from the JAX package's ``mamba_params`` and inputs from
a numpy seed. Outputs, gradients and decode states agree within rtol
1e-4, atol 1e-5; parameter shapes and dtypes are the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba as jmam
from repro_torch.configs import registry as treg
from repro_torch.core.tracer import trace_fn
from repro_torch.models import mamba as tmam

RTOL, ATOL = 1e-4, 1e-5
ARCH = "jamba-1.5-large-398b"


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _cfgs(**kw):
    jc, tc = jreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    return (dataclasses.replace(jc.mamba, **kw),
            dataclasses.replace(tc.mamba, **kw), jc.d_model)


def _params(jm, seed=0):
    jp = jmam.mamba_params(jax.random.key(seed), D, jm, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


D = jreg.get_smoke(ARCH).d_model


def test_params_have_the_jax_shapes_and_dtypes():
    jm, tm, _ = _cfgs()
    want = jax.eval_shape(lambda: jmam.mamba_params(
        jax.random.key(0), D, jm, jnp.bfloat16))
    got = tmam.mamba_params(None, D, tm, torch.bfloat16, device="meta",
                            lead=(3,))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == (3,) + tuple(v.shape), k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
    # the deterministic leaves hold the reference's values (A_log's
    # logarithms to the last bit or one off)
    jp, _ = _params(jm)
    host = tmam.mamba_params(torch.Generator().manual_seed(0), D, tm,
                             torch.float32, device="cpu")
    for k in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(host[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_allclose(host["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("S", [1, 5, 16])
def test_causal_conv1d_matches_jax(S):
    x, w, b = _rand(2, S, 12), _rand(4, 12, seed=1), _rand(12, seed=2)
    _close(tmam._causal_conv1d(*map(torch.from_numpy, (x, w, b))),
           jmam._causal_conv1d(*map(jnp.asarray, (x, w, b))))


def test_causal_conv1d_casts_back_to_the_input_dtype():
    x = torch.from_numpy(_rand(2, 7, 12)).to(torch.bfloat16)
    w = torch.from_numpy(_rand(4, 12, seed=1)).to(torch.bfloat16)
    out = tmam._causal_conv1d(x, w, torch.zeros(12, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape


@pytest.mark.parametrize("S", [7, 16, 37])     # 37: 2 chunks and a part
def test_block_output_and_gradients_match_jax(S):
    jm, tm, _ = _cfgs()
    jp, tp = _params(jm)
    x = _rand(2, S, D, seed=3)
    cot = _rand(2, S, D, seed=4)

    def jloss(x, p):
        return (jmam.mamba_block(x, p, jm)[0] * cot).sum()
    jout = jmam.mamba_block(jnp.asarray(x), jp, jm)[0]
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    for t in tp.values():
        t.requires_grad_()
    out, state = tmam.mamba_block(tx, tp, tm)
    assert state is None
    _close(out, jout, "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jgx, "x")
    for k, t in tp.items():
        _close(t.grad, jgp[k], k)


def test_block_checkpoints_each_chunk_when_it_trains():
    # the chunks' step loop is recomputed in the backward: its ops run
    # twice under grad mode and once without
    _, tm, _ = _cfgs()
    _, tp = _params(_cfgs()[0])
    x = torch.from_numpy(_rand(1, 20, D))

    def count(grad):
        calls = []
        orig = tmam._scan_chunk

        def spy(*a):
            calls.append(a[2].shape[1])
            return orig(*a)
        tmam._scan_chunk = spy
        try:
            with torch.set_grad_enabled(grad):
                p = {k: v.clone().requires_grad_(grad) for k, v in tp.items()}
                out, _ = tmam.mamba_block(x, p, tm)
                if grad:
                    out.sum().backward()
        finally:
            tmam._scan_chunk = orig
        return calls
    assert count(False) == [16, 4]
    assert count(True) == [16, 4, 4, 16]     # forward, then the backward


def test_three_decode_steps_match_jax():
    jm, tm, _ = _cfgs()
    jp, tp = _params(jm)
    B = 3
    jstate = jmam.mamba_init_state(B, D, jm)
    tstate = tmam.mamba_init_state(B, D, tm, device="cpu")
    for k in jstate:
        _close(tstate[k], jstate[k], k)
        assert tstate[k].dtype == torch.float32
    for step in range(3):
        x = _rand(B, 1, D, seed=10 + step)
        jout, jstate = jmam.mamba_decode_step(jnp.asarray(x), jstate, jp, jm)
        before = {k: v.clone() for k, v in tstate.items()}
        tout, new = tmam.mamba_decode_step(torch.from_numpy(x), tstate, tp, tm)
        for k in tstate:                         # the input is not written
            assert torch.equal(tstate[k], before[k])
        tstate = new
        _close(tout, jout, f"out {step}")
        for k in jstate:
            _close(tstate[k], jstate[k], f"{k} {step}")


def test_decode_steps_continue_the_block():
    # S decode steps from the zero state give the block's outputs: the
    # recurrence and the chunked scan are one function
    _, tm, _ = _cfgs()
    _, tp = _params(_cfgs()[0])
    S = 20
    x = torch.from_numpy(_rand(2, S, D, seed=5))
    with torch.no_grad():
        full, _ = tmam.mamba_block(x, tp, tm)
        state = tmam.mamba_init_state(2, D, tm, device="cpu")
        steps = []
        for t in range(S):
            out, state = tmam.mamba_decode_step(x[:, t:t + 1], state, tp, tm)
            steps.append(out)
    _close(torch.cat(steps, 1), full.numpy())


def test_the_trace_sees_no_grouped_convolution():
    # the conv is shifted multiply-adds, not a cuDNN convolution whose
    # workspace the trace would not see
    _, tm, _ = _cfgs()
    tp = tmam.mamba_params(None, D, tm, torch.bfloat16, device="meta")
    x = torch.empty((2, 40, D), dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        _, tr, out = trace_fn(lambda x, p: tmam.mamba_block(x, p, tm)[0],
                              x, tp)
    ops = {b.op for b in tr.blocks.values()}
    assert not any("conv" in op for op in ops), ops
    assert tuple(out.shape) == (2, 40, D) and out.dtype == torch.bfloat16

"""The port's attention kernel module against the JAX package.

On the CPU the operator runs its plain version, so these tests hold the
port's plain attention (``ref.attention_ref`` and the operator's CPU
path, through both wrappers) against JAX's ``attention_ref`` and the
Pallas kernel in interpret mode, with the cases and tolerances of
``tests/test_kernels.py``. The CUDA kernel itself is checked on the card
by ``chip_smoke.py`` and ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.kernels.ops import flash_attention as jax_flash_model
from repro.kernels.ref import attention_ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _make(shapes, dtype="float32", seed=0):
    """The same inputs for both packages: numpy f32 from a seed, cast to
    ``dtype`` on each side (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def _err(port, ref) -> float:
    return float(np.abs(port.float().numpy()
                        - np.asarray(ref.astype(jnp.float32))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,d", [
    (1, 2, 2, 128, 64),     # MHA
    (2, 4, 2, 256, 64),     # GQA g=2
    (1, 8, 2, 128, 128),    # GQA g=4, wide head
    (2, 2, 1, 192, 32),     # MQA, non-pow2 seq
])
def test_plain_vs_jax_shapes(B, H, Hkv, S, d, dtype):
    (q, k, v), (tq, tk, tv) = _make(
        [(B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)], dtype)
    ref = jax_ref(q, k, v, causal=True)
    kern = jax_flash(q, k, v, causal=True, block_q=64, block_k=64)
    assert _err(attention_ref(tq, tk, tv, causal=True), ref) < TOL[dtype]
    out = fa.flash_attention_bhsd(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert _err(out, kern) < TOL[dtype]


@pytest.mark.parametrize("window", [32, 64, 100])
def test_sliding_window_vs_jax(window):
    (q, k, v), (tq, tk, tv) = _make([(1, 4, 256, 64), (1, 2, 256, 64),
                                     (1, 2, 256, 64)], seed=window)
    kern = jax_flash(q, k, v, causal=True, window=window, block_q=64,
                     block_k=64)
    out = fa.flash_attention_bhsd(tq, tk, tv, causal=True, window=window)
    assert _err(out, kern) < 2e-5


def test_non_causal_vs_jax():
    (q, k, v), (tq, tk, tv) = _make([(1, 2, 128, 64), (1, 2, 128, 64),
                                     (1, 2, 128, 64)], seed=3)
    kern = jax_flash(q, k, v, causal=False, block_q=64, block_k=64)
    out = fa.flash_attention_bhsd(tq, tk, tv, causal=False)
    assert _err(out, kern) < 2e-5


def test_model_layout_wrapper_ragged_seq():
    # S=100 is no tile multiple: the JAX wrapper pads, the port's
    # kernel masks the edge itself and its wrapper only transposes views
    (q, k, v), (tq, tk, tv) = _make([(2, 100, 4, 64), (2, 100, 2, 64),
                                     (2, 100, 2, 64)], seed=1)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == tq.shape
    assert out.is_contiguous()
    assert _err(out, jax_flash_model(q, k, v, causal=True)) < 2e-5


def test_fake_impl_allocates_only_the_output():
    with FakeTensorMode():
        q = torch.empty(2, 64, 8, 16, dtype=torch.bfloat16)
        k = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16)
        out = ops.flash_attention(q, k, k, causal=True)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert out.is_contiguous()   # [B, S, H, d]: reshape is a view
    assert fa.launches == 0


def test_cpu_path_never_counts_a_launch():
    _, (tq, tk, tv) = _make([(1, 2, 64, 16), (1, 1, 64, 16),
                             (1, 1, 64, 16)])
    before = fa.launches
    fa.flash_attention_bhsd(tq, tk, tv)
    ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2))
    assert fa.launches == before == 0


@pytest.mark.parametrize("bad", ["kv_shape", "groups", "window"])
def test_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 32, 16)
    k = torch.zeros(1, 2, 32, 16)
    kw = {}
    if bad == "kv_shape":
        k = torch.zeros(1, 2, 32, 8)
    elif bad == "groups":
        k = torch.zeros(1, 3, 32, 16)
    else:
        kw["window"] = 0
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, k, **kw)


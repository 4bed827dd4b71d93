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
from repro_torch.configs import registry as treg
from repro_torch.kernels import build
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [64, None])
def test_head_dim_256_vs_jax(dtype, window):
    # gemma3's head dim: bf16 goes to the sm90 kernel on the card, f32 to
    # the simt kernel; the plain path here is what both are held to there
    (q, k, v), (tq, tk, tv) = _make([(1, 4, 256, 256), (1, 2, 256, 256),
                                     (1, 2, 256, 256)], dtype, seed=7)
    kern = jax_flash(q, k, v, causal=True, window=window, block_q=64,
                     block_k=64)
    out = fa.flash_attention_bhsd(tq, tk, tv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert _err(out, kern) < TOL[dtype]


@pytest.mark.parametrize("dtype,d,kernel", [
    *[(torch.bfloat16, d, "sm90") for d in (64, 128, 256)],
    *[(torch.bfloat16, d, "simt") for d in (16, 32)],
    *[(torch.float32, d, "simt") for d in (16, 32, 64, 128, 256)],
    (torch.float16, 128, None), (torch.bfloat16, 48, None),
    (torch.float32, 48, None), (torch.bfloat16, 512, None),
    (torch.float32, 512, None),
])
def test_route(dtype, d, kernel):
    if kernel is None:
        with pytest.raises(ValueError):
            fa.route(dtype, d)
    else:
        assert fa.route(dtype, d) == kernel


@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma3-4b",
                                  "phi4-mini-3.8b", "starcoder2-3b"])
def test_dense_configs_route_to_the_tensor_core_kernel(arch):
    cfg = treg.get_config(arch)
    assert cfg.dtype == torch.bfloat16
    assert fa.route(cfg.dtype, cfg.hd) == "sm90"


@pytest.mark.parametrize("layout", ["ok", "unit_d", "stride", "base"])
def test_tma_layout_check(layout):
    bf16 = torch.bfloat16
    t = torch.zeros(2, 64, 4, 128, dtype=bf16).transpose(1, 2)  # [B,S,H,d]
    if layout == "unit_d":
        t = torch.zeros(1, 2, 128, 64, dtype=bf16).transpose(2, 3)
    elif layout == "stride":
        t = torch.zeros(1, 2, 64, 65, dtype=bf16)[..., :64]    # 130-byte rows
    elif layout == "base":
        t = torch.zeros(2 * 64 * 64 + 1, dtype=bf16)[1:].view(1, 2, 64, 64)
    if layout == "ok":
        fa.check_tma(t, t[:, :1])
    else:
        with pytest.raises(ValueError):
            fa.check_tma(t)


@pytest.mark.parametrize("kernel,dtype,d", [
    ("sm90", torch.float32, 64),      # f32 is the simt kernel's
    ("sm90", torch.bfloat16, 32),     # no wgmma path at d 32
    ("simt", torch.bfloat16, 48),
    ("simt", torch.bfloat16, 32),     # takes it, but not on the CPU
])
def test_named_kernel_launch_rejects(kernel, dtype, d):
    q = torch.zeros(1, 2, 64, d, dtype=dtype)
    with pytest.raises(ValueError):
        fa.launch(kernel, q, q, q)
    assert fa.launches_by_kernel == {"sm90": 0, "simt": 0}


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build._target(name) for name in build.sources()}
    assert set(before) == {"flash_attention", "flash_attention_sm90"}
    header = tmp_path / "wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._target(name) for name in build.sources()}
    assert all(after[n] != before[n] for n in before)
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("-I", str(tmp_path / "inc")))
    assert build._target("flash_attention") != after["flash_attention"]
    assert build._include_dirs(("-Ia", "-I", "b", "-O3")) == ["a", "b"]


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
    assert fa.launches_by_kernel == {"sm90": 0, "simt": 0}


def test_cpu_path_never_counts_a_launch():
    _, (tq, tk, tv) = _make([(1, 2, 64, 16), (1, 1, 64, 16),
                             (1, 1, 64, 16)])
    before = fa.launches
    fa.flash_attention_bhsd(tq, tk, tv)
    ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2))
    assert fa.launches == before == 0
    assert fa.launches_by_kernel == {"sm90": 0, "simt": 0}


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



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [112, 48])
def test_padded_head_dims_vs_jax(d, dtype):
    # kimi-k2's head dim 112 (and 48) reach a kernel zero-padded to the
    # next head dim it takes, with the scale of the true one: the plain
    # version of the padded call equals the plain version at the true d,
    # and the JAX wrapper's Pallas kernel in interpret mode
    (q, k, v), (tq, tk, tv) = _make([(2, 40, 8, d), (2, 40, 2, d),
                                     (2, 40, 2, d)], dtype, seed=d)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    ref = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2), causal=True).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() \
        < (0 if dtype == "float32" else 1e-2) + 1e-6
    assert _err(out, jax_flash_model(q, k, v, causal=True)) < TOL[dtype]
    assert fa.launches == 0


@pytest.mark.parametrize("dtype,d,padded", [
    (torch.bfloat16, 112, 128), (torch.bfloat16, 48, 64),
    (torch.bfloat16, 8, 16), (torch.bfloat16, 200, 256),
    (torch.float32, 112, 128), (torch.float32, 100, 128),
    *[(torch.bfloat16, d, d) for d in (16, 32, 64, 128, 256)],
    *[(torch.float32, d, d) for d in (16, 32, 64, 128, 256)],
    (torch.bfloat16, 257, None), (torch.float16, 64, None),
])
def test_padded_head_dim(dtype, d, padded):
    # the least head dim a kernel takes; route itself is unchanged, so a
    # head dim that is its own padding routes as before
    if padded is None:
        with pytest.raises(ValueError):
            fa.padded_head_dim(dtype, d)
        return
    assert fa.padded_head_dim(dtype, d) == padded
    assert fa.route(dtype, padded) in ("sm90", "simt")
    if padded != d:
        with pytest.raises(ValueError):
            fa.route(dtype, d)


def test_kimi_head_dim_reaches_the_tensor_core_kernel_padded():
    cfg = treg.get_config("kimi-k2-1t-a32b")
    assert cfg.hd == 112
    assert fa.route(cfg.dtype, fa.padded_head_dim(cfg.dtype, cfg.hd)) \
        == "sm90"


def test_padding_is_traced_outside_the_operator():
    # three padded copies, the operator's padded output and that output
    # sliced back to the head dim (contiguous, so that a head merge is a
    # view, on a rank's local shard too) are ordinary op outputs; the
    # operator allocates only its output
    from repro_torch.core.tracer import trace_fn

    def attend(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)
    q = torch.empty(2, 64, 8, 112, dtype=torch.bfloat16)
    k = torch.empty(2, 64, 2, 112, dtype=torch.bfloat16)
    _, tr, _ = trace_fn(attend, q, k, k)
    sizes = sorted(b.size for b in tr.blocks.values() if b.op != "input")
    assert sizes == sorted([2 * 64 * 8 * 128 * 2, 2 * 64 * 2 * 128 * 2,
                            2 * 64 * 2 * 128 * 2, 2 * 64 * 8 * 128 * 2,
                            2 * 64 * 8 * 112 * 2])

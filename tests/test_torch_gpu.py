"""The port on the card: tests that need a CUDA device.

They import no JAX, so they run on a GPU machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each one skips.
"""
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.core.estimator import XMemEstimator
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
def test_kernel_vs_plain_on_the_card():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn(2, 8, 192, 64, generator=g, device="cuda").to(dtype)
        k = torch.randn(2, 2, 192, 64, generator=g, device="cuda").to(dtype)
        before = fa.launches
        out = fa.flash_attention_bhsd(q, k, k, causal=True)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        err = (out.float() - attention_ref(q, k, k).float()).abs().max()
        assert err.item() < tol
    with pytest.raises(ValueError):   # head dim the kernel does not take
        fa.flash_attention_bhsd(q[..., :48], k[..., :48], k[..., :48])


@pytest.mark.gpu
def test_estimate_vs_measured_on_the_card():
    _need_card()
    from repro_torch.core.baselines.directprobe import measured_peak
    B, max_len = 4, 32
    cfg = treg.get_smoke("qwen3-32b")
    fn = tserve.make_prefill_fn(cfg)
    est = XMemEstimator.for_torch_gpu().estimate_serving(
        fn, TM.abstract_params(cfg), TM.init_cache(cfg, B, max_len,
                                                   device="meta"),
        tserve.prompt_specs(cfg, B, max_len))
    params = TM.init_params(cfg, 0, device="cuda")
    cache = TM.init_cache(cfg, B, max_len, device="cuda")
    prompt = {"tokens": torch.zeros(B, max_len, dtype=torch.int32,
                                    device="cuda")}
    got = measured_peak(fn, params, cache, prompt, history=True)
    assert got.allocated > 0 and got.reserved >= got.allocated
    assert len(got.allocs) == got.n_allocs > 0
    assert est.peak_tensor_bytes > 0

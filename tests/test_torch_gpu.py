"""The port on the card: tests that need a CUDA device.

They import no JAX, so they run on a GPU machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each one skips.
"""
import dataclasses

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

    def rand(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cases = [(torch.float32, 64, None, "simt", 2e-5),
             (torch.bfloat16, 64, None, "sm90", 2e-2),
             (torch.bfloat16, 128, None, "sm90", 2e-2),    # qwen3's head dim
             (torch.bfloat16, 256, 100, "sm90", 2e-2),     # gemma3's, local
             (torch.float32, 256, 100, "simt", 2e-5)]
    for dtype, d, window, kernel, tol in cases:
        q = rand(2, 8, 192, d, dtype=dtype)
        k = rand(2, 2, 192, d, dtype=dtype)
        v = rand(2, 2, 192, d, dtype=dtype)
        before, on = fa.launches, fa.launches_by_kernel[kernel]
        out = fa.flash_attention_bhsd(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert fa.launches_by_kernel[kernel] == on + 1
        ref = attention_ref(q, k, v, causal=True, window=window)
        assert (out.float() - ref.float()).abs().max().item() < tol
    with pytest.raises(ValueError):   # head dim no kernel takes
        fa.flash_attention_bhsd(q[..., :48], k[..., :48], k[..., :48])


@pytest.mark.gpu
def test_gemma3_head_dim_256_prefill_on_the_card():
    # gemma3-4b at full width (head dim 256), 6 layers (5 local with a
    # 1024 window, 1 global), a small vocab: the flash path's prefill
    # logits against the dense path's, same weights
    _need_card()
    from repro_torch.train.train_step import make_prefill_step
    full = treg.get_config("gemma3-4b")
    cfg = dataclasses.replace(full, n_layers=6, vocab=1024)
    flash = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="flash"))
    dense = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="dense"))
    params = TM.init_params(cfg, 0, device="cuda")
    prompt = tserve.device_prompts(cfg, 2, 1536, seed=1)
    before = fa.launches_by_kernel["sm90"]
    lf = make_prefill_step(flash)(params, prompt).float()
    assert fa.launches_by_kernel["sm90"] == before + cfg.n_layers
    ld = make_prefill_step(dense)(params, prompt).float()
    assert torch.isfinite(lf).all()
    assert ((lf - ld).abs().max() / ld.abs().max()).item() < 5e-2


@pytest.mark.gpu
def test_kimi_head_dim_112_prefill_on_the_card():
    # kimi-k2's attention widths (d_model 7168, 64/8 heads, head dim 112),
    # one layer, its experts cut to 8 for this test, a small vocab: head
    # dim 112 reaches the sm90 kernel zero-padded to 128, and the flash
    # path's prefill logits match the dense path's
    _need_card()
    from repro_torch.train.train_step import make_prefill_step
    full = treg.get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(
        full, n_layers=1, vocab=1024,
        moe=dataclasses.replace(full.moe, num_experts=8))
    assert cfg.hd == 112
    flash = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="flash"))
    dense = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="dense"))
    params = TM.init_params(cfg, 0, device="cuda")
    prompt = tserve.device_prompts(cfg, 2, 1024, seed=2)
    before = dict(fa.launches_by_kernel)
    lf = make_prefill_step(flash)(params, prompt).float()
    assert fa.launches_by_kernel == {"sm90": before["sm90"] + cfg.n_layers,
                                     "simt": before["simt"]}
    ld = make_prefill_step(dense)(params, prompt).float()
    assert torch.isfinite(lf).all()
    assert ((lf - ld).abs().max() / ld.abs().max()).item() < 5e-2


def _warm_cublas():
    # the process's first matmul allocates cuBLAS's workspace, which the
    # serving estimate places at the step's first matmul: make it before
    # measuring, as a serving process has it from its first step on
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones(64, 64, device="cuda", dtype=dtype)
        (a @ a).sum().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,positions,n_layers,batch,attn_every", [
    ("internvl2-1b", 2304, 2, 32, None),
    ("musicgen-medium", 2048, 2, 32, None),
    ("jamba-1.5-large-398b", 2048, 2, 8, 2),
    ("xlstm-1.3b", 2048, 8, 32, None)])
def test_family_serving_estimate_vs_measured_on_the_card(
        arch, positions, n_layers, batch, attn_every):
    # the VLM (256 patches + 2048 tokens), audio (2048 codes x 4
    # codebooks), hybrid (jamba cut to one attention and one Mamba+MoE
    # layer, 23.8 GB) and SSM (one period: 7 mLSTM + 1 sLSTM) families
    # at full width through the flash kernel where they attend: the
    # serving estimate against the card's peaks
    _need_card()
    full = treg.get_config(arch)
    cfg = dataclasses.replace(
        full, n_layers=n_layers,
        attention=dataclasses.replace(
            full.attention, impl="flash",
            attn_every=attn_every or full.attention.attn_every))
    B, max_len = batch, positions + 16
    attention_layers = (0 if cfg.family == "ssm" else
                        n_layers // attn_every if attn_every else n_layers)
    _warm_cublas()
    est = XMemEstimator.for_torch_gpu()
    params_abs = TM.abstract_params(cfg)
    cache_abs = TM.init_cache(cfg, B, max_len, device="meta")
    want = {"prefill": est.estimate_serving(
                tserve.make_prefill_fn(cfg), params_abs, cache_abs,
                tserve.prompt_specs(cfg, B, positions)),
            "decode": est.estimate_serving(
                tserve.make_decode_fn(cfg), params_abs, cache_abs,
                tserve.decode_input(cfg, B))}
    before = fa.launches_by_kernel["sm90"]
    # the parameters go into an allocator with no cached blocks, as in a
    # serving process that starts with its model; blocks that earlier
    # tests left cached would take them, a placement no estimate sees
    torch.cuda.empty_cache()
    res = tserve.serve(cfg, B, max_len, positions, 4, "cuda")
    assert fa.launches_by_kernel["sm90"] == before + attention_layers
    assert torch.isfinite(res.prefill_logits[0].float()).all()
    # each phase held to its own 5 % limit, as chip_smoke holds the
    # full-depth paths
    for phase, rep in want.items():
        card = res.peaks[phase]
        for measured, estimate in (("reserved", rep.peak_bytes),
                                   ("allocated", rep.peak_tensor_bytes)):
            got = getattr(card, measured)
            print(f"{arch} {phase} {measured}: estimate {estimate} card "
                  f"{got} ({(estimate - got) / got:+.4%})")
            assert abs(estimate - got) / got < 0.05, (
                phase, measured, estimate, got, card.segment_sizes)


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


@pytest.mark.gpu
def test_training_estimate_vs_measured_on_the_card():
    # qwen3-32b's full width, one layer, a 8192-token vocabulary, AdamW
    # with clipping: 3 steps from resident parameters against the
    # estimate of the same 3 iterations (about 10 GB on the card). The
    # live-tensor peak is held to 1 %; the reserved peak to 10 %, since
    # the allocator's segment choices depend on what the process did
    # before (PERF.md)
    _need_card()
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config("qwen3-32b"), n_layers=1,
                              vocab=8192)
    shape = smoke_shape(1024, 2)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, TrainPolicy())
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fwd_bwd, TM.abstract_params(cfg),
                                treg.input_specs(cfg, shape),
                                update_fn=update, opt_init_fn=opt_init)
    ds = SyntheticDataset(cfg, shape)
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"),
                            est.iterations)
    assert all(math.isfinite(x) for x in got.out.losses)
    assert len(got.out.losses) == est.iterations
    assert abs(rep.peak_tensor_bytes - got.allocated) / got.allocated < 0.01
    assert abs(rep.peak_bytes - got.reserved) / got.reserved < 0.10


@pytest.mark.gpu
def test_moe_training_estimate_vs_measured_on_the_card():
    # phi3.5-moe's full width (16 experts, top-2, f32 router), one layer,
    # a 8192-token vocabulary, AdamW with clipping, batch 2 x 1024 (dense
    # attention): 3 steps against the estimate of the same 3 iterations,
    # held as the dense training test is. Run it in a pytest process of
    # its own (-k moe_training), as a training job has one
    _need_card()
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config("phi3.5-moe-42b-a6.6b"),
                              n_layers=1, vocab=8192)
    shape = smoke_shape(1024, 2)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, TrainPolicy())
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fwd_bwd, TM.abstract_params(cfg),
                                treg.input_specs(cfg, shape),
                                update_fn=update, opt_init_fn=opt_init)
    ds = SyntheticDataset(cfg, shape)
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"),
                            est.iterations)
    assert all(math.isfinite(x) for x in got.out.losses)
    assert len(got.out.losses) == est.iterations
    assert abs(rep.peak_tensor_bytes - got.allocated) / got.allocated < 0.01
    assert abs(rep.peak_bytes - got.reserved) / got.reserved < 0.10


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_family_training_estimate_vs_measured_on_the_card(arch):
    # internvl2 (its 151,655-word vocabulary: f32 log-probabilities of
    # the text positions) and musicgen (4 codebook heads) at full width,
    # one layer, AdamW with clipping, batch 2 x 1024 positions (dense
    # attention): 3 steps against the estimate of the same 3 iterations,
    # held as the dense training test is. Run each in a pytest process
    # of its own (-k "family_training and internvl2", and musicgen)
    _need_card()
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config(arch), n_layers=1)
    shape = smoke_shape(1024, 2)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, TrainPolicy())
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fwd_bwd, TM.abstract_params(cfg),
                                treg.input_specs(cfg, shape),
                                update_fn=update, opt_init_fn=opt_init)
    ds = SyntheticDataset(cfg, shape)
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"),
                            est.iterations)
    assert all(math.isfinite(x) for x in got.out.losses)
    assert len(got.out.losses) == est.iterations
    assert abs(rep.peak_tensor_bytes - got.allocated) / got.allocated < 0.01
    assert abs(rep.peak_bytes - got.reserved) / got.reserved < 0.10


@pytest.mark.gpu
def test_directprobe_vs_measured_training_on_the_card():
    # qwen3-32b's full width, two layers, a 8192-token vocabulary, AdamW
    # with clipping, batch 4 x 1024: DirectProbe's runs at batches 1 and
    # 2 (2 steps each), extrapolated to 4, against 3 steps measured at 4,
    # both printed. Held to the reference's own 25 %
    # (tests/test_core_pipeline.py::TestBaselines). Run it in a pytest
    # process of its own (-k directprobe), as a training job has one
    _need_card()
    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines import DirectProbeEstimator, JobSpec
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config("qwen3-32b"), n_layers=2,
                              vocab=8192)
    shape = smoke_shape(1024, 4)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, TrainPolicy())
    probe = DirectProbeEstimator()
    estimate = probe.estimate(JobSpec(
        "qwen3-2l", fwd_bwd, TM.abstract_params(cfg),
        treg.input_specs(cfg, shape), update, opt_init))
    ds = SyntheticDataset(cfg, shape)
    # the parameters made from a released cache, as a fresh job's are
    torch.cuda.empty_cache()
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"), 3)
    print(f"directprobe {estimate} (probes {probe.last_probes}, "
          f"{probe.last_runtime_s:.2f} s), measured reserved {got.reserved}, "
          f"{(estimate - got.reserved) / got.reserved:+.4%}")
    assert [b for b, _ in probe.last_probes] == [1, 2]
    assert abs(estimate - got.reserved) / got.reserved < 0.25


@pytest.mark.gpu
def test_sweep_admitted_batch_trains_within_tolerance_on_the_card():
    # qwen3-32b's full width, two layers, a 8192-token vocabulary, AdamW
    # with clipping, sequences of 1024: one sweep over batches 1-6 at the
    # card's capacity (probes 1, 4, 6 and the repair at 2 traced, 3 and 5
    # synthesized), then the largest admitted batch trains 3 steps. Its
    # estimate is held to chip_smoke's RESERVED_TOL (5 %). Run it in a
    # pytest process of its own (-k sweep_admitted), as a training job
    # has one
    _need_card()
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.core.sweep import SweepPoint, SweepService
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config("qwen3-32b"), n_layers=2,
                              vocab=8192)
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, TrainPolicy())
    params = TM.abstract_params(cfg)
    capacity = tserve.device_capacity()
    batches = range(1, 7)
    res = SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        [SweepPoint(fwd_bwd, params,
                    treg.input_specs(cfg, smoke_shape(1024, b)),
                    update_fn=update, opt_init_fn=opt_init,
                    capacity=capacity) for b in batches])
    admitted = [b for b, rep in zip(batches, res.reports)
                if not rep.oom and rep.peak_bytes <= capacity]
    assert admitted and res.stats["interpolated"] > 0
    batch = max(admitted)
    rep = res.reports[batch - 1]
    shape = smoke_shape(1024, batch)
    ds = SyntheticDataset(cfg, shape)
    torch.cuda.empty_cache()
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"), 3)
    rel = (rep.peak_bytes - got.reserved) / got.reserved
    print(f"sweep {res.sources} {res.stats['wall_s']:.2f} s; batch {batch}: "
          f"estimate {rep.peak_bytes}, measured reserved {got.reserved} "
          f"({rel:+.4%}); tensors {rep.peak_tensor_bytes} vs "
          f"{got.allocated}")
    assert all(math.isfinite(x) for x in got.out.losses)
    assert abs(rel) <= 0.05


@pytest.mark.gpu
def test_admission_service_store_and_training_on_the_card(tmp_path):
    # qwen3-32b's full width, two layers, a 8192-token vocabulary, AdamW
    # with clipping, sequences of 1024: the training gate through an
    # admission service over a persistent trace store admits a batch at
    # the card's capacity; a second service over the same directory
    # answers it from disk with the same bytes; the batch trains 3 steps
    # and its reserved peak is held to chip_smoke's RESERVED_TOL (5 %)
    # against the decision. Run it in a pytest process of its own
    # (-k admission_service), as a training job has one
    _need_card()
    import math

    from repro_torch.configs.base import smoke_shape
    from repro_torch.core.baselines.directprobe import measured_training
    from repro_torch.launch import train as ttrain
    from repro_torch.service import AdmissionService
    from repro_torch.train import (SyntheticDataset, TrainPolicy,
                                   make_estimator_hooks)
    cfg = dataclasses.replace(treg.get_config("qwen3-32b"), n_layers=2,
                              vocab=8192)
    policy = TrainPolicy()
    capacity = tserve.device_capacity()
    store = str(tmp_path / "store")
    batch, gate = ttrain.pick_train_batch(
        cfg, policy, 1024, capacity, (8, 4, 2, 1),
        service=AdmissionService(workers=1, store_dir=store))
    assert batch is not None
    decision = gate["decision"]
    assert decision.admit and decision.rung == "exact"
    shape = smoke_shape(1024, batch)
    ok, _, again = ttrain.admission_check(
        cfg, policy, shape, capacity,
        service=AdmissionService(workers=1, store_dir=store),
        return_decision=True)
    assert ok and again.provenance["source"] == "disk"
    assert again.provenance["trace_cache"]["misses"] == 0
    for f in ("peak_bytes", "peak_tensor_bytes", "persistent_bytes"):
        assert getattr(again, f) == getattr(decision, f), f
    fwd_bwd, update, opt_init = make_estimator_hooks(cfg, policy)
    ds = SyntheticDataset(cfg, shape)
    torch.cuda.empty_cache()
    got = measured_training(fwd_bwd, update, opt_init,
                            TM.init_params(cfg, 0, device="cuda"),
                            lambda step: ds.device_batch(step, "cuda"), 3)
    rel = (decision.peak_bytes - got.reserved) / got.reserved
    print(f"admission service batch {batch}: decision {decision.peak_bytes}"
          f" ({again.provenance['source']} after the restart), measured "
          f"reserved {got.reserved} ({rel:+.4%})")
    assert all(math.isfinite(x) for x in got.out.losses)
    assert abs(rel) <= 0.05

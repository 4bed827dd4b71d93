"""The port's baselines (``repro_torch.core.baselines``) against the JAX
package's (``repro.core.baselines``).

* ``JobSpec``: parameter, batch and optimizer-state bytes and the
  feature vector are byte-exact for each family's smoke config and each
  optimizer. The optimizers' ``count`` scalar makes no difference here:
  ``jax.eval_shape`` of the JAX ``init`` keeps it (4 bytes), as the
  port's ``init`` on meta tensors does.
* SchedTune is a copy: the same feature rows and truths give the same
  fitted ``w``, ``mu``, ``sd`` and estimates, bit for bit, and the same
  cold-start guess.
* TensorSum: the persistent terms are byte-exact, and
  ``activation_bytes`` of the JAX package's own trace (converted to the
  port's schema-v5 types) is the reference's activation sum to the
  byte. On the port's own trace the sum is not held: the op graphs
  differ (an eager backward, every checkpointed forward recomputed, the
  CUDA kernels' own buffers). For qwen3-32b smoke, AdamW, clip 1.0,
  batch 2 x 64 tokens, the reference estimates 12,318,040 B and the port
  15,586,848 B.
* DNNMem: ``peak_from_lifecycles`` of the JAX package's lifecycles,
  converted, is the reference's peak, bit for bit. On the port's own
  trace the qwen3-32b and internvl2 smoke jobs give the reference's
  2,097,152 B; phi3.5-moe smoke 2,097,152 B where the reference has
  4,194,304 B (the op graphs differ). Its estimate is blind to
  the optimizer, as the reference's is.
* Either baseline gives the same estimate, to the byte, from the
  forward+backward trace an ``XMemEstimator`` cached as from its own.
* DirectProbe: ``_scale_batch`` gives the reference's shapes, and its
  extrapolation of injected probe peaks is the reference's, bit for bit;
  a probe that runs out of memory raises ``ProbeOOMError``; with no CUDA
  device it raises and runs nothing on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core.baselines import DirectProbeEstimator as JaxDirectProbe
from repro.core.baselines import DNNMemEstimator as JaxDNNMem
from repro.core.baselines import JobSpec as JaxJobSpec
from repro.core.baselines import SchedTuneEstimator as JaxSchedTune
from repro.core.baselines import TensorSumEstimator as JaxTensorSum
from repro.core.baselines import directprobe as jdp
from repro.core.baselines import dnnmem as jdnn
from repro.core.baselines import tensorsum as jts
from repro.models import model as JM
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import events as tev
from repro_torch.core.baselines import (DirectProbeEstimator,
                                        DNNMemEstimator, JobSpec,
                                        ProbeOOMError, SchedTuneEstimator,
                                        TensorSumEstimator)
from repro_torch.core.baselines import directprobe as tdp
from repro_torch.core.baselines.common import trace_fwd_bwd
from repro_torch.core.baselines.dnnmem import peak_from_lifecycles
from repro_torch.core.baselines.tensorsum import activation_bytes
from repro_torch.core.estimator import XMemEstimator
from repro_torch.models import model as TM
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks

# one smoke config of each family
ARCHS = ("qwen3-32b", "phi3.5-moe-42b-a6.6b", "internvl2-1b",
         "musicgen-medium", "jamba-1.5-large-398b", "xlstm-1.3b")
OPTIMIZERS = ("sgd", "adam", "adamw", "adafactor", "rmsprop", "adagrad")
# optimizer states per parameter (the reference benchmark's table)
STATES = {"sgd": 0, "adafactor": 0.05, "rmsprop": 1, "adagrad": 1,
          "adam": 2, "adamw": 2}
S = 64


def _meta(cfg, opt, batch):
    return {"family": cfg.family, "optimizer": opt, "batch_size": batch,
            "seq_len": S, "d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "optimizer_states": STATES[opt], "grad_release": "pos0"}


def _jax_job(arch, opt="adamw", batch=2):
    cfg = jreg.get_smoke(arch)
    fwd, upd, init = jax_hooks(cfg, JaxTrainPolicy(optimizer=opt,
                                                   clip_norm=1.0))
    return JaxJobSpec(f"{arch}|{opt}|b{batch}", fwd, JM.abstract_params(cfg),
                      jreg.input_specs(cfg, jax_smoke_shape(S, batch)), upd,
                      init, _meta(cfg, opt, batch))


def _port_job(arch, opt="adamw", batch=2):
    cfg = treg.get_smoke(arch)
    fwd, upd, init = make_estimator_hooks(
        cfg, TrainPolicy(optimizer=opt, clip_norm=1.0))
    return JobSpec(f"{arch}|{opt}|b{batch}", fwd, TM.abstract_params(cfg),
                   treg.input_specs(cfg, smoke_shape(S, batch)), upd, init,
                   _meta(cfg, opt, batch))


# -- the reference's small job (tests/test_core_pipeline.py), both ways ------
D, H, B = 128, 256, 32


def _jax_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"])
    y = h @ params["w2"]
    return jnp.mean((y - batch["y"]) ** 2)


def _jax_adam(p, g, s):
    def upd(pp, gg, ss):
        m, v = ss
        m = 0.9 * m + 0.1 * gg
        v = 0.999 * v + 0.001 * gg * gg
        return pp - 1e-3 * m / (jnp.sqrt(v) + 1e-8), (m, v)
    out = jax.tree.map(upd, p, g, s, is_leaf=lambda x: isinstance(x, tuple))
    return {k: out[k][0] for k in out}, {k: out[k][1] for k in out}


def _jax_small_job():
    f32 = jnp.float32
    return JaxJobSpec(
        "small", lambda p, b: jax.value_and_grad(_jax_loss)(p, b),
        {"w1": jax.ShapeDtypeStruct((D, H), f32),
         "w2": jax.ShapeDtypeStruct((H, D), f32)},
        {"x": jax.ShapeDtypeStruct((B, D), f32),
         "y": jax.ShapeDtypeStruct((B, D), f32)}, _jax_adam,
        lambda p: jax.tree.map(lambda x: (jnp.zeros_like(x),
                                          jnp.zeros_like(x)), p))


def _small_fwd_bwd(params, batch):
    p = {k: t.detach().requires_grad_() for k, t in params.items()}
    y = torch.tanh(batch["x"] @ p["w1"]) @ p["w2"]
    loss = ((y - batch["y"]) ** 2).mean()
    return loss.detach(), dict(zip(p, torch.autograd.grad(loss,
                                                          list(p.values()))))


def _small_adam_init(params):
    return {k: (torch.zeros_like(t), torch.zeros_like(t))
            for k, t in params.items()}


def _small_adam(params, grads, state):
    # in place with one temporary, as the port's optimizers update
    with torch.no_grad():
        for k, p in params.items():
            m, v = state[k]
            g = grads[k]
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.addcdiv_(m, v.sqrt().add_(1e-8), value=-1e-3)
    return params, state


def _small_sgd(params, grads, state):
    with torch.no_grad():
        for k, p in params.items():
            p.sub_(0.01 * grads[k])
    return params, state


def _port_small_job(opt="adam"):
    def meta(*shape):
        return torch.empty(shape, device="meta")
    update, init = ((_small_adam, _small_adam_init) if opt == "adam"
                    else (_small_sgd, lambda p: ()))
    return JobSpec("small", _small_fwd_bwd,
                   {"w1": meta(D, H), "w2": meta(H, D)},
                   {"x": meta(B, D), "y": meta(B, D)}, update, init)


JOBS = {"small": (_jax_small_job, _port_small_job),
        "qwen3": (lambda: _jax_job("qwen3-32b"),
                  lambda: _port_job("qwen3-32b")),
        "moe_sgd": (lambda: _jax_job("phi3.5-moe-42b-a6.6b", "sgd"),
                    lambda: _port_job("phi3.5-moe-42b-a6.6b", "sgd"))}


def _persistent(job) -> int:
    return 2 * job.param_bytes() + job.opt_state_bytes() + job.batch_bytes()


def _port_trace(trace) -> tev.Trace:
    """A JAX trace in the port's types (schema-v5 columns)."""
    return tev.Trace.from_columnar(
        tev.ColumnarTrace.from_json(trace.columnar().to_json()))


def _port_blocks(blocks) -> list:
    return [tev.BlockLifecycle(
        b.block_id, b.size, b.alloc_t, b.free_t, b.iteration,
        tev.Phase(b.phase.value), b.op, b.scope, tev.BlockKind(
            b.block_kind.value), b.shard_factor, b.shape,
        tev.MemorySpace(b.space.value)) for b in blocks]


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_jobspec_is_byte_exact_against_jax(arch, opt):
    want, got = _jax_job(arch, opt), _port_job(arch, opt)
    assert got.param_bytes() == want.param_bytes() > 0
    assert got.batch_bytes() == want.batch_bytes() > 0
    assert got.opt_state_bytes() == want.opt_state_bytes()
    assert got.features() == want.features()


def test_jobspec_without_an_optimizer_has_no_state():
    job = _port_small_job()
    job.opt_init_fn = None
    assert job.opt_state_bytes() == 0
    assert _port_small_job().opt_state_bytes() == 2 * job.param_bytes()


# ---------------------------------------------------------------------------
def _schedtune_history():
    rng = np.random.default_rng(17)
    pairs = [(arch, opt, b) for arch in ARCHS[:2] for opt in ("sgd", "adamw")
             for b in (1, 2, 4)]
    truths = [int(x) for x in rng.integers(10**7, 10**10, len(pairs))]
    return pairs, truths


def test_schedtune_fit_and_estimates_are_bit_identical():
    pairs, truths = _schedtune_history()
    want, got = JaxSchedTune(), SchedTuneEstimator()
    want.fit([_jax_job(*p) for p in pairs], truths)
    got.fit([_port_job(*p) for p in pairs], truths)
    for name in ("w", "mu", "sd"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    # the history's jobs and unseen families (the cold start's victims)
    for arch in ARCHS:
        for b in (2, 8):
            assert got.estimate(_port_job(arch, "adamw", b)) == \
                want.estimate(_jax_job(arch, "adamw", b))


@pytest.mark.parametrize("arch", ARCHS)
def test_schedtune_cold_start_is_the_reference_guess(arch):
    got = SchedTuneEstimator().estimate(_port_job(arch))
    assert got == JaxSchedTune().estimate(_jax_job(arch))
    job = _port_job(arch)
    assert got == 3 * job.param_bytes() + 8 * job.batch_bytes()


# ---------------------------------------------------------------------------
def _reference_trace(monkeypatch, module, name, jax_estimate):
    """Run a reference estimate, capturing what its module's ``name``
    (``trace_fn`` or ``reconstruct_lifecycles``) returned."""
    seen = []
    real = getattr(module, name)

    def capture(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(module, name, capture)
    value = jax_estimate()
    assert len(seen) == 1
    return value, seen[0]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_tensorsum_activation_bytes_of_the_jax_trace(monkeypatch, job):
    jax_job = JOBS[job][0]()
    want, (trace, _) = _reference_trace(
        monkeypatch, jts, "trace_fn", lambda: JaxTensorSum().estimate(jax_job))
    assert activation_bytes(_port_trace(trace)) == \
        want - _persistent(jax_job) > 0


@pytest.mark.parametrize("job", sorted(JOBS))
def test_tensorsum_persistent_terms_are_byte_exact(monkeypatch, job):
    make_jax, make_port = JOBS[job]
    port_job = make_port()
    got = TensorSumEstimator().estimate(port_job)
    assert got - activation_bytes(trace_fwd_bwd(port_job)) == \
        _persistent(port_job) == _persistent(make_jax())


def test_tensorsum_overestimates():
    """Against the port's xMem tensor peak, in its preset without cuBLAS's
    two 32 MiB workspaces (the process's, not the job's tensors; TensorSum
    sums tensors). TensorSum does not see the update phase: with an Adam
    update that holds four temporaries of a leaf's size at once
    (``p.sub_(1e-3 * m / (v.sqrt() + 1e-8))``) xMem's tensor peak is
    1,475,584 B, over TensorSum's 1,327,108 B."""
    job = _port_small_job()
    naive = TensorSumEstimator().estimate(job)
    rep = XMemEstimator.for_torch_gpu(cublas_workspace=0).estimate_training(
        job.fwd_bwd_fn, job.params, job.batch, update_fn=job.update_fn,
        opt_init_fn=job.opt_init_fn)
    assert naive > rep.peak_tensor_bytes   # no liveness: an overestimate


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("job", sorted(JOBS))
def test_dnnmem_peak_of_the_jax_lifecycles_is_bit_identical(monkeypatch,
                                                            job):
    jax_job = JOBS[job][0]()
    want, blocks = _reference_trace(
        monkeypatch, jdnn, "reconstruct_lifecycles",
        lambda: JaxDNNMem().estimate(jax_job))
    assert peak_from_lifecycles(_port_blocks(blocks)) == want > 0


def test_dnnmem_blind_to_optimizer():
    """DNNMem analyzes the forward/backward graph only: the same estimate
    for an SGD and an Adam job, where xMem's estimate of the whole step
    differs by the optimizer state."""
    est = DNNMemEstimator()
    adam, sgd = _port_small_job("adam"), _port_small_job("sgd")
    assert est.estimate(adam) == est.estimate(sgd) > 0
    xmem = XMemEstimator.for_torch_gpu(cublas_workspace=0)

    def peak(job):
        return xmem.estimate_training(
            job.fwd_bwd_fn, job.params, job.batch, update_fn=job.update_fn,
            opt_init_fn=job.opt_init_fn).peak_tensor_bytes
    assert peak(adam) > peak(sgd)
    # the model's own hooks: AdamW against SGD
    assert est.estimate(_port_job("qwen3-32b", "adamw")) == \
        est.estimate(_port_job("qwen3-32b", "sgd"))


def test_dnnmem_predicts_oom_without_reclaim():
    est = DNNMemEstimator()
    peak = est.estimate(_port_small_job(), capacity=1 << 40)
    assert not est.last_oom_prediction
    assert est.estimate(_port_small_job(), capacity=peak - 1) == peak
    assert est.last_oom_prediction and est.last_runtime_s > 0


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS[:4])
def test_baselines_give_the_same_estimate_from_the_cached_trace(arch):
    job = _port_job(arch)
    est = XMemEstimator.for_torch_gpu()
    est.trace_phases(job.fwd_bwd_fn, job.params, job.batch,
                     job.update_fn, job.opt_init_fn)
    hits = est.trace_cache.hits
    fwd, _, _ = est.trace_phases(job.fwd_bwd_fn, job.params, job.batch)
    assert est.trace_cache.hits == hits + 1
    for baseline in (TensorSumEstimator(), DNNMemEstimator()):
        assert baseline.estimate(job, trace=fwd.trace) == \
            baseline.estimate(job) > 0, baseline.name


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [2, 3, 4, 64])
@pytest.mark.parametrize("arch", ARCHS[:4])
def test_scale_batch_gives_the_reference_shapes(arch, factor):
    want = jdp._scale_batch(_jax_job(arch, batch=8).batch, factor)
    got = tdp._scale_batch(_port_job(arch, batch=8).batch, factor)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert t.element_size() == want[k].dtype.itemsize


def test_scale_batch_keeps_scalars():
    tree = {"n": torch.empty((), dtype=torch.int32, device="meta"),
            "x": torch.empty((8, 3), device="meta")}
    got = tdp._scale_batch(tree, 4)
    assert got["n"] is tree["n"] and tuple(got["x"].shape) == (2, 3)


def _injected_peaks(seed: int, n_full: int) -> dict:
    rng = np.random.default_rng(seed)
    return {b: int(x) for b, x in zip(range(1, n_full + 1),
                                      rng.integers(10**8, 10**10, n_full))}


@pytest.mark.parametrize("n_full,fractions", [
    (8, (4, 2)), (6, (4, 2)), (32, (4, 2)), (1, (4, 2)), (3, (4, 2)),
    (16, (8, 2)), (5, (5, 1))])
def test_directprobe_extrapolation_is_bit_identical(monkeypatch, n_full,
                                                     fractions):
    peaks = _injected_peaks(n_full, n_full)
    monkeypatch.setattr(jdp, "measured_peak", lambda job, batch=None: peaks[
        jax.tree_util.tree_leaves(batch)[0].shape[0]])
    want = JaxDirectProbe(fractions).estimate(
        _jax_job("qwen3-32b", batch=n_full))
    est = DirectProbeEstimator(fractions, measure=lambda job, batch: peaks[
        pytree.tree_leaves(batch)[0].shape[0]])
    assert est.estimate(_port_job("qwen3-32b", batch=n_full)) == want
    small, large = (max(n_full // f, 1) for f in fractions)
    assert est.last_probes == [(b, peaks[b]) for b in dict.fromkeys(
        (small, large))]
    assert est.last_runtime_s > 0


def test_directprobe_probe_over_capacity_raises_as_the_reference(monkeypatch):
    monkeypatch.setattr(jdp, "measured_peak", lambda job, batch=None: 10**9)
    with pytest.raises(jdp.ProbeOOMError):
        JaxDirectProbe(capacity=10**9 - 1).estimate(_jax_job("qwen3-32b"))
    est = DirectProbeEstimator(capacity=10**9 - 1,
                               measure=lambda job, batch: 10**9)
    with pytest.raises(ProbeOOMError):
        est.estimate(_port_job("qwen3-32b", batch=8))
    assert est.last_probes == [(2, 10**9)]


@pytest.mark.parametrize("fail_at", [0, 1])
def test_directprobe_out_of_memory_raises_probe_oom(fail_at):
    calls = []

    def measure(job, batch):
        calls.append(pytree.tree_leaves(batch)[0].shape[0])
        if len(calls) > fail_at:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return 10**9
    est = DirectProbeEstimator(measure=measure)
    with pytest.raises(ProbeOOMError, match="batch 4 ran out|batch 2 ran"):
        est.estimate(_port_job("qwen3-32b", batch=8))
    assert calls == [2, 4][:fail_at + 1]
    assert len(est.last_probes) == fail_at


def test_directprobe_without_a_card_raises_and_runs_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*args, **kw):
        raise AssertionError("a probe ran without a card")
    monkeypatch.setattr(tdp, "measured_training", never)
    monkeypatch.setattr(tdp, "_materialize", never)
    with pytest.raises(RuntimeError, match="CUDA device"):
        DirectProbeEstimator().estimate(_port_job("qwen3-32b", batch=8))

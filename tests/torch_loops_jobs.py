"""Shared cases of the step-loop composition tests
(``test_torch_loops*.py``): a smoke config with its chunk set, a phase
whose step loops are composed (``core/loops.py``) beside the phase
traced in full, and the check that they are equal column by column and
give reports equal to the byte."""
import dataclasses

from repro_torch.configs import registry as reg
from repro_torch.core import depth as D
from repro_torch.core import loops as L
from repro_torch.core.estimator import XMemEstimator, trace_entry
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_depth_jobs import phase_args

XLSTM, JAMBA, DENSE = "xlstm-1.3b", "jamba-1.5-large-398b", "qwen3-32b"
#: 4 chunks of the smoke configs' 16 steps
SEQ = 64
#: 16 chunks of 16 steps: the chunk loops are long too, and nest the
#: step loops (``nested``)
NESTED_SEQ = 256


def smoke(arch: str, chunk: int | None = None, **kw):
    """``arch``'s smoke config, its step loops' chunk set to ``chunk``."""
    cfg = dataclasses.replace(reg.get_smoke(arch), **kw)
    if chunk is None:
        return cfg
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunk=chunk))
    return dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, chunk=chunk))


def nested(arch: str, chunk: int = 16, **kw):
    """``arch``'s smoke config cut to one period of two layers whose
    loops nest at ``NESTED_SEQ``: xlstm one mLSTM block and one sLSTM,
    jamba one attention layer and one Mamba, each with its steps in
    chunks of ``chunk``; qwen3 one layer of chunked attention over
    query and key chunks of ``chunk`` positions."""
    cfg = reg.get_smoke(arch)
    if cfg.family == "ssm":
        kw.setdefault("n_layers", 2)
        return dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunk=chunk, slstm_every=2), **kw)
    if cfg.family == "hybrid":
        kw.setdefault("n_layers", 2)
        return dataclasses.replace(
            smoke(arch, chunk, **kw),
            attention=dataclasses.replace(cfg.attention, attn_every=2))
    kw.setdefault("n_layers", 1)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, impl="chunked", chunk_q=chunk, chunk_kv=chunk), **kw)


def composed_and_full(cfg, kind: str, seq: int = SEQ,
                      microbatches: int = 1):
    """The phase with its step loops composed, its loop info, and the
    phase traced in full."""
    fn, awk, opts = phase_args(cfg, kind, microbatches, seq)
    composed, _labels, info = L.compose_steps(
        lambda step_labeller, unit_labeller: trace_entry(
            fn, awk, labeller=unit_labeller, step_labeller=step_labeller,
            **opts))
    full, _ = trace_entry(fn, awk, **opts)
    return composed, info, full, awk


def _report(est, phases):
    rep = est.estimate_from_phases(*phases)
    return (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.oom, rep.num_events, rep.breakdown)


def assert_loops_compose(cfg, kind: str, seq: int = SEQ,
                         microbatches: int = 1) -> dict:
    """The loop-composed phase equals the full trace column by column,
    and, in training, the reports from them are equal to the byte.
    Returns the loop info."""
    composed, info, full, awk = composed_and_full(cfg, kind, seq,
                                                  microbatches)
    assert info["source"] == "composed", info
    # two probes a level: four when loops nest
    assert info["probes"] == len(L.PROBE_STEPS) ** len(info["by_level"])
    assert info["steps_traced"] < info["steps"]
    assert composed.trace.meta["loops"]["source"] == "composed"
    assert D.phases_equal(composed, full)
    if kind == "train":
        params, batch = awk[0][0], awk[1][0]
        fn, upd, init = make_estimator_hooks(cfg, TrainPolicy(
            microbatches=microbatches))
        est = XMemEstimator.for_torch_gpu()
        got = _report(est, est.trace_phases(fn, params, batch, upd, init,
                                            fwd=composed))
        want = _report(est, est.trace_phases(fn, params, batch, upd, init,
                                             fwd=full))
        assert got == want
    return info

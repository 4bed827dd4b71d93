"""Shared cases of the depth-composition tests (``test_torch_depth*.py``):
a smoke config at a number of repeating units, a phase's step and
arguments, and the check that its composed trace equals its full one."""
import dataclasses

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import depth as D
from repro_torch.core.estimator import (XMemEstimator, _fwd_out_kinds,
                                        trace_entry)
from repro_torch.core.events import BlockKind, Phase
from repro_torch.launch import serve as srv
from repro_torch.models import model as M
from repro_torch.train.train_step import (TrainPolicy, make_estimator_hooks,
                                          make_prefill_step, make_serve_step)

S, B = 16, 2
UNITS = 5


def at_units(arch: str, units: int, extra_layers: int = 0, **kw):
    """``arch``'s smoke config at ``units`` repeating units (plus
    ``extra_layers`` past them: gemma3's remainder)."""
    cfg = reg.get_smoke(arch)
    _, unit, rem = M.repeat_unit(cfg)
    return dataclasses.replace(cfg, n_layers=units * unit + rem
                               + extra_layers, **kw)


def phase_args(cfg, kind: str, microbatches: int = 1, seq: int = S):
    """(step, (tree, kind, name) arguments, trace options) of a phase
    over sequences of ``seq`` positions."""
    params = (M.abstract_params(cfg), BlockKind.PARAM, "params")
    if kind == "train":
        fn = make_estimator_hooks(cfg, TrainPolicy(
            microbatches=microbatches))[0]
        return fn, [params, (reg.input_specs(cfg, smoke_shape(seq, B)),
                             BlockKind.INPUT, "batch")], dict(
            phase=Phase.FORWARD_BACKWARD, out_kind_fn=_fwd_out_kinds,
            grad=True)
    if kind == "prefill":
        fn = make_prefill_step(cfg)
        batch = srv.prompt_specs(cfg, B, seq)
        return fn, [params, (batch, BlockKind.INPUT, "batch")], dict(
            phase=Phase.DECODE)
    fn = make_serve_step(cfg, seq // 2)
    return fn, [params, (M.init_cache(cfg, B, seq, device="meta"),
                         BlockKind.CACHE, "cache"),
                (srv.decode_input(cfg, B), BlockKind.INPUT, "batch")], dict(
        phase=Phase.DECODE)


def composed_and_full(cfg, kind: str, microbatches: int = 1,
                      seq: int = S):
    fn, awk, opts = phase_args(cfg, kind, microbatches, seq)

    def trace(f, a, labeller=None):
        return trace_entry(f, a, labeller=labeller, **opts)
    composed, info = D.compose(fn.depth_plan, awk, trace)
    full, _ = trace(fn, awk)
    return composed, info, full, awk


def _report(est, phases):
    rep = est.estimate_from_phases(*phases)
    return (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.oom, rep.num_events, rep.breakdown)


def assert_composed_equals_full(cfg, kind, microbatches=1, seq=S):
    composed, info, full, awk = composed_and_full(cfg, kind, microbatches,
                                                  seq)
    assert info["source"] == "composed", info
    assert info["units"] == M.repeat_unit(cfg)[0] >= UNITS
    assert D.phases_equal(composed, full)
    if kind != "train":
        return
    params, batch = awk[0][0], awk[1][0]
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy(
        microbatches=microbatches))
    est = XMemEstimator.for_torch_gpu()
    got = _report(est, est.trace_phases(fn, params, batch, upd, init,
                                        fwd=composed))
    want = _report(est, est.trace_phases(fn, params, batch, upd, init,
                                         fwd=full))
    assert got == want

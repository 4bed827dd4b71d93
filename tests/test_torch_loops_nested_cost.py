"""The nested composition's mechanism (``core/loops.py`` at two levels):

* A chunk loop nests its step loops from ``NEST_MIN`` chunks on; below
  it, it runs every chunk and its step loops compose a level up.
* Cost is flat in the sequence: the ops dispatched inside loops while
  one training phase of jamba-smoke is composed are the same at 16 and
  at 64 chunks of 16 steps (the counterpart of the reference's cap,
  which interprets a few iterations of every scan at any length).
* A nested loop whose chunks differ, or whose steps do, fails the fit
  or the check at its level, is traced in full, says why, and gives the
  full trace's bytes.
* The probes are per phase: a second layer with the same nested loops,
  or a second estimate that shares the phase, adds no probe.
* A nested-composed phase round-trips through the trace store; a
  restarted estimator over the store answers with no trace and no probe.
"""
import json

import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import depth as D
from repro_torch.core import loops as L
from repro_torch.core.cache import TraceCache
from repro_torch.core.estimator import XMemEstimator, trace_entry
from repro_torch.core.tracer import TorchMemoryTracer
from repro_torch.models import model as M
from repro_torch.models.steps import STEP_MARKS, stack_steps, step_range
from repro_torch.service import TraceStore
from repro_torch.service.store import phase_from_json, phase_to_json
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_depth_jobs import at_units, phase_args
from torch_loops_jobs import (DENSE, JAMBA, NESTED_SEQ, assert_loops_compose,
                              nested)


#: the threshold the estimator nests at
NEST_MIN = L.NEST_MIN


@pytest.fixture(autouse=True)
def _nest_16_chunks(monkeypatch):
    # the smoke configs' 16 chunks nest (the default NEST_MIN is 32, so
    # that each case traces 16 chunks in full, not 32)
    monkeypatch.setattr(L, "NEST_MIN", 16)


B = 2


def test_ops_dispatched_in_nested_loops_do_not_grow_with_the_chunks(
        monkeypatch):
    counts = {"ops": 0}
    dispatch = TorchMemoryTracer.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        hook = getattr(STEP_MARKS, "hook", None)
        if hook is not None and hook.label() >= 0:
            counts["ops"] += 1
        return dispatch(self, func, types, args, kwargs)
    monkeypatch.setattr(TorchMemoryTracer, "__torch_dispatch__", counting)

    def ops_at(seq):
        fn, awk, opts = phase_args(nested(JAMBA), "train", seq=seq)
        counts["ops"] = 0
        _phase, _labels, info = L.compose_steps(
            lambda step_labeller, unit_labeller: trace_entry(
                fn, awk, labeller=unit_labeller,
                step_labeller=step_labeller, **opts))
        assert info["source"] == "composed"
        # each chunk's steps in the forward and two recomputes
        assert info["by_level"][1]["steps"] == seq * 3
        return counts["ops"]
    # 16 and 64 chunks of 16 steps: the probes run as many of each
    assert ops_at(NESTED_SEQ) == ops_at(4 * NESTED_SEQ) > 0


@pytest.mark.parametrize("seq", [NESTED_SEQ, 2 * NESTED_SEQ])
def test_a_chunk_loop_nests_from_nest_min_chunks(monkeypatch, seq):
    # below NEST_MIN chunks the chunk loop runs every chunk and its step
    # loops compose a level up (two probes); from NEST_MIN on it nests
    # them (four); both to the full trace's columns
    monkeypatch.setattr(L, "NEST_MIN", NEST_MIN)
    info = assert_loops_compose(nested(JAMBA), "prefill", seq=seq)
    chunks = seq // 16
    assert info["signatures"] == ([[16, chunks, 0]] if chunks < NEST_MIN
                                  else [[chunks, 1, 0], [16, chunks, 1]])


def _nested_loop_step(cfg, differ: str):
    """A step with a loop of 16 chunks, each a loop of 16 steps, whose
    odd chunks (``differ="chunks"``) or odd steps (``"steps"``) make a
    temporary more."""
    def step(params, cache, batch):
        with torch.no_grad():
            x = batch["x"]
            outs = []
            for c in step_range(16):
                ys = []
                for t in step_range(16):
                    y = x @ params["w"]
                    if (c if differ == "chunks" else t) % 2:
                        y = y + torch.ones_like(y)
                    ys.append(y)
                outs.append(stack_steps(ys, 16).sum(0))
            return stack_steps(outs, 16).sum()
    return D.with_depth_plan(step, cfg,
                             lambda c: _nested_loop_step(c, differ),
                             lambda c, trees: trees)


@pytest.mark.parametrize("differ,level", [("chunks", 0), ("steps", 1)])
def test_nested_loop_whose_bodies_differ_is_traced_in_full(differ, level):
    step = _nested_loop_step(at_units(DENSE, 3), differ)
    params = {"w": torch.empty(16, 16, device="meta")}
    batch = {"x": torch.empty(4, 16, device="meta")}
    rep = XMemEstimator.for_torch_gpu().estimate_serving(step, params, {},
                                                         batch)
    loops = rep.depth["loops"]
    assert loops["source"] == "fallback"
    assert loops["why"] in (f"fit, level {level}",
                            f"check at 7 steps, level {level}")
    assert loops["signatures"] == [[16, 1, 0], [16, 16, 1]]
    # the probes the refusal took, then every step in full
    assert loops["steps_traced"] > loops["steps"] == 16 + 256
    assert L.note(D.summary(rep.depth)).startswith(", loops fallback (")
    plain = XMemEstimator.for_torch_gpu().estimate_serving(
        lambda p, c, b: step(p, c, b), params, {}, batch)   # no plan
    assert (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.num_events) == (plain.peak_bytes, plain.peak_tensor_bytes,
                                plain.persistent_bytes, plain.num_events)


def _estimate(cfg, est, optimizer="adamw"):
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy(
        optimizer=optimizer))
    return est.estimate_training(
        fn, M.abstract_params(cfg),
        reg.input_specs(cfg, smoke_shape(NESTED_SEQ, B)), update_fn=upd,
        opt_init_fn=init)


def test_nested_probes_are_per_phase():
    est = XMemEstimator.for_torch_gpu()
    one = _estimate(nested(JAMBA), est)                 # one period
    two = _estimate(nested(JAMBA, n_layers=4), est)     # two
    assert one.depth["loops"]["loops"] * 2 == two.depth["loops"]["loops"]
    assert one.depth["probe_traces"] == two.depth["probe_traces"] \
        == len(L.PROBE_STEPS) ** 2
    # another optimizer shares the forward+backward phase: no probe
    sgd = _estimate(nested(JAMBA, n_layers=4), est, optimizer="sgd")
    assert sgd.depth["probe_traces"] == 0
    assert sgd.depth["loops"] == two.depth["loops"]


def test_nested_composed_phase_round_trips_through_the_store(tmp_path):
    cfg = nested(JAMBA)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = M.abstract_params(cfg)
    batch = reg.input_specs(cfg, smoke_shape(NESTED_SEQ, B))
    store = str(tmp_path / "store")
    est = XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store)))
    first = est.estimate_training(fn, params, batch, update_fn=upd,
                                  opt_init_fn=init)
    assert first.depth["loops"]["source"] == "composed"
    assert len(first.depth["loops"]["by_level"]) == 2
    fwd = est.trace_phases(fn, params, batch)[0]
    back = phase_from_json(json.loads(json.dumps(phase_to_json(fwd))))
    assert D.phases_equal(back, fwd)
    assert back.trace.meta["loops"] == fwd.trace.meta["loops"]
    # a restarted estimator over the same store: no trace, no probe
    cold = XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store)))
    second = cold.estimate_training(fn, params, batch, update_fn=upd,
                                    opt_init_fn=init)
    assert second.cache_stats["misses"] == 0
    assert second.depth["probe_traces"] == 0 and cold.probe_traces == 0
    assert second.depth["loops"] == first.depth["loops"]
    assert (second.peak_bytes, second.peak_tensor_bytes,
            second.persistent_bytes) == (first.peak_bytes,
                                         first.peak_tensor_bytes,
                                         first.persistent_bytes)

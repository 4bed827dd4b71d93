"""The step-loop composition's mechanism (``core/loops.py``), on
xlstm-smoke and a step made to differ:

* A loop whose steps differ fails the fit or the check, is traced in
  full, says why, and gives the full trace's bytes; a loop shorter than
  its probes runs as it is.
* Cost is flat: the ops dispatched inside step loops in one training
  estimate are the same at chunk 16 and at chunk 64, with the chunk
  count held.
* The probes are per phase: a second layer with the same loops, or a
  second estimate that shares the phase, adds no probe.
* A composed phase round-trips through the trace store; a restarted
  estimator over the store answers with no trace and no probe.
* ``fastpath=False`` traces every step, to the same bytes.
"""
import json

import torch

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import depth as D
from repro_torch.core import loops as L
from repro_torch.core.cache import TraceCache
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.tracer import TorchMemoryTracer
from repro_torch.models import model as M
from repro_torch.models.steps import STEP_MARKS, stack_steps, step_range
from repro_torch.service import TraceStore
from repro_torch.service.store import phase_from_json, phase_to_json
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_depth_jobs import at_units
from torch_loops_jobs import SEQ, XLSTM, smoke

B = 2


def _uneven_loop_step(cfg):
    """A step with a loop of 16 steps whose odd steps make a temporary
    more: its steps really differ."""
    def step(params, cache, batch):
        with torch.no_grad():
            x = batch["x"]
            outs = []
            for t in step_range(16):
                y = x @ params["w"]
                if t % 2:
                    y = y + torch.ones_like(y)
                outs.append(y)
            return stack_steps(outs, 16).sum()
    return D.with_depth_plan(step, cfg, _uneven_loop_step,
                             lambda c, trees: trees)


def test_loop_whose_steps_differ_is_traced_in_full():
    step = _uneven_loop_step(at_units("qwen3-32b", 3))
    params = {"w": torch.empty(16, 16, device="meta")}
    batch = {"x": torch.empty(4, 16, device="meta")}
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_serving(step, params, {}, batch)
    loops = rep.depth["loops"]
    assert loops["source"] == "fallback"
    assert loops["why"] == "fit" or loops["why"].startswith("check")
    assert loops["probes"] == rep.depth["probe_traces"] == len(
        L.PROBE_STEPS)
    assert loops["steps"] == 16
    assert D.summary(rep.depth)["loops"] == {
        "source": "fallback", "why": loops["why"], "steps": 16,
        "steps_traced": 16 + sum(L.PROBE_STEPS)}
    assert L.note(D.summary(rep.depth)).startswith(", loops fallback (")
    plain = XMemEstimator.for_torch_gpu().estimate_serving(
        lambda p, c, b: step(p, c, b), params, {}, batch)   # no plan
    assert plain.depth == {}
    assert (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.num_events) == (plain.peak_bytes, plain.peak_tensor_bytes,
                                plain.persistent_bytes, plain.num_events)


def test_short_loops_are_traced_as_they_run():
    # 8 positions: every loop has fewer steps than its probes would run
    cfg = smoke(XLSTM)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fn, M.abstract_params(cfg), reg.input_specs(
        cfg, smoke_shape(8, B)), update_fn=upd, opt_init_fn=init)
    assert "loops" not in rep.depth and rep.depth["probe_traces"] == 0


# ---------------------------------------------------------------------------
def test_ops_dispatched_in_step_loops_do_not_grow_with_the_steps(
        monkeypatch):
    counts = {"ops": 0}
    dispatch = TorchMemoryTracer.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        hook = getattr(STEP_MARKS, "hook", None)
        if hook is not None and hook.label() >= 0:
            counts["ops"] += 1
        return dispatch(self, func, types, args, kwargs)
    monkeypatch.setattr(TorchMemoryTracer, "__torch_dispatch__", counting)

    def ops_at(chunk):
        cfg = smoke(XLSTM, chunk=chunk)
        fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
        counts["ops"] = 0
        rep = XMemEstimator.for_torch_gpu().estimate_training(
            fn, M.abstract_params(cfg),
            reg.input_specs(cfg, smoke_shape(4 * chunk, B)),
            update_fn=upd, opt_init_fn=init)
        assert rep.depth["loops"]["source"] == "composed"
        assert rep.depth["loops"]["steps"] == 24 * chunk
        return counts["ops"]
    # 4 chunks of 16 steps and 4 chunks of 64: the probes run as many
    assert ops_at(16) == ops_at(64) > 0


def test_probes_are_per_phase():
    def estimate(cfg, est, optimizer="adamw"):
        fn, upd, init = make_estimator_hooks(cfg, TrainPolicy(
            optimizer=optimizer))
        return est.estimate_training(
            fn, M.abstract_params(cfg),
            reg.input_specs(cfg, smoke_shape(SEQ, B)), update_fn=upd,
            opt_init_fn=init)
    est = XMemEstimator.for_torch_gpu()
    one = estimate(smoke(XLSTM, n_layers=4), est)      # one period
    two = estimate(smoke(XLSTM), est)                  # two
    assert one.depth["loops"]["loops"] * 2 == two.depth["loops"]["loops"]
    assert one.depth["probe_traces"] == two.depth["probe_traces"] == len(
        L.PROBE_STEPS)
    # another optimizer shares the forward+backward phase: no probe
    sgd = estimate(smoke(XLSTM), est, optimizer="sgd")
    assert sgd.depth["probe_traces"] == 0
    assert sgd.depth["loops"] == two.depth["loops"]


def test_composed_phase_round_trips_through_the_store(tmp_path):
    cfg = smoke(XLSTM)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = M.abstract_params(cfg)
    batch = reg.input_specs(cfg, smoke_shape(SEQ, B))
    store = str(tmp_path / "store")
    est = XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store)))
    first = est.estimate_training(fn, params, batch, update_fn=upd,
                                  opt_init_fn=init)
    assert first.depth["loops"]["source"] == "composed"
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


def test_the_frozen_pipeline_traces_every_step():
    cfg = smoke(XLSTM, n_layers=4)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    args = (fn, M.abstract_params(cfg),
            reg.input_specs(cfg, smoke_shape(SEQ, B)))
    fast = XMemEstimator.for_torch_gpu().estimate_training(
        *args, update_fn=upd, opt_init_fn=init)
    ref = XMemEstimator.for_torch_gpu(fastpath=False).estimate_training(
        *args, update_fn=upd, opt_init_fn=init)
    assert fast.depth["loops"]["source"] == "composed" and ref.depth == {}
    assert (ref.peak_bytes, ref.peak_tensor_bytes, ref.persistent_bytes,
            ref.oom) == (fast.peak_bytes, fast.peak_tensor_bytes,
                         fast.persistent_bytes, fast.oom)


def test_stack_steps_is_the_stack_outside_a_probe():
    xs = [torch.full((2, 3), float(i)) for i in range(5)]
    assert torch.equal(stack_steps(xs, 5, 1), torch.stack(xs, 1))
    assert list(step_range(5)) == [0, 1, 2, 3, 4]

"""Depth composition of the port's phase traces (``core/depth.py``).

* Composed equals full: a phase composed from probes of 2, 3 and 4
  repeating units equals the phase traced at the real depth column by
  column, and the reports from them are equal to the byte, for the
  dense (gemma3 with its remainder layer), MoE, VLM and audio families,
  training under ``remat`` full, dots and none and with 2 microbatches,
  prefill and decode, at 5 units (the hybrid and SSM families:
  ``test_torch_depth_recurrent.py``).
* A stack whose units differ fails the check, is traced in full, says
  so (``source`` "fallback") and gives the full trace's bytes.
* Cost is flat: the tracer dispatches as many ops for an estimate at 10
  layers as at 32 (past the 9 units the probes trace together; at fewer,
  a full trace costs less, and the estimator traces in full).
* Persistent bytes at the published depth against the JAX package:
  ``test_torch_depth_jax.py``.
* A composed phase round-trips through the trace store; a second
  estimate over the store is a hit with no trace and no probe.
* The serving steps are content-addressed: equal configs give equal
  trace keys, and a restarted admission service answers a serving
  request from the store with no trace.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import depth as D
from repro_torch.core.cache import (TraceCache, key_is_content_addressed,
                                    trace_key)
from repro_torch.core.estimator import XMemEstimator, flatten_kinds
from repro_torch.core.events import BlockKind, Phase
from repro_torch.core.tracer import TorchMemoryTracer
from repro_torch.launch import serve as srv
from repro_torch.models import model as M
from repro_torch.service import AdmissionService, TraceStore
from repro_torch.service.store import phase_from_json, phase_to_json
from repro_torch.train.train_step import (TrainPolicy, make_estimator_hooks,
                                          make_prefill_step, make_serve_step,
                                          params_at)
from torch_depth_jobs import (B, S, UNITS, assert_composed_equals_full,
                              at_units)

# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind,extra,microbatches", [
    ("qwen3-32b", dict(remat="full"), 0, 1),
    ("gemma3-4b", dict(remat="dots"), 1, 1),
    ("phi3.5-moe-42b-a6.6b", dict(remat="none"), 0, 1),
    ("kimi-k2-1t-a32b", dict(remat="full"), 0, 1),
    ("internvl2-1b", dict(remat="full"), 0, 2),
    ("musicgen-medium", dict(remat="dots"), 0, 1),
])
def test_composed_training_equals_full(arch, kind, extra, microbatches):
    assert_composed_equals_full(at_units(arch, UNITS, extra, **kind),
                                "train", microbatches)


@pytest.mark.parametrize("arch,kind,extra", [
    ("qwen3-32b", "prefill", 0), ("kimi-k2-1t-a32b", "prefill", 0),
    ("gemma3-4b", "decode", 1), ("phi3.5-moe-42b-a6.6b", "decode", 0),
    ("internvl2-1b", "decode", 0), ("musicgen-medium", "decode", 0)])
def test_composed_serving_equals_full(arch, kind, extra):
    assert_composed_equals_full(at_units(arch, UNITS, extra), kind)


def test_repeat_unit_by_family():
    def unit(arch, n):
        return M.repeat_unit(dataclasses.replace(
            reg.get_config(arch), n_layers=n))
    assert unit("qwen3-32b", 64) == (64, 1, 0)
    assert unit("gemma3-4b", 34) == (5, 6, 4)
    assert unit("jamba-1.5-large-398b", 72) == (9, 8, 0)
    assert unit("xlstm-1.3b", 48) == (6, 8, 0)
    assert M.repeat_unit(reg.get_smoke("jamba-1.5-large-398b")) == (2, 4, 0)
    plan = make_estimator_hooks(reg.get_config("gemma3-4b"),
                                TrainPolicy())[0].depth_plan
    # gemma3-4b's 5 units: fewer than its probes' 9, so traced in full
    assert plan.at(3).n_layers == 22 and plan.units == 5
    assert not plan.composes
    assert make_prefill_step(reg.get_config("qwen3-32b")).depth_plan.composes


# ---------------------------------------------------------------------------
def _uneven_step(cfg):
    """A stack whose unit ``u`` makes a temporary of ``u + 1`` rows: its
    units really differ."""
    def step(params, cache, batch):
        x = batch["x"]
        for u in range(M.repeat_unit(cfg)[0]):
            M._mark()
            x = x @ params["w"][u] + torch.ones(u + 1, x.shape[-1]).sum(0)
        M._mark()
        return x.sum()
    return D.with_depth_plan(step, cfg, _uneven_step, _uneven_args)


def _uneven_args(cfg, trees):
    d = trees[0]["w"].shape[-1]
    return [{"w": torch.empty(M.repeat_unit(cfg)[0], d, d,
                              device="meta")}, *trees[1:]]


def test_units_that_differ_are_traced_in_full():
    cfg = at_units("qwen3-32b", 10)
    step = _uneven_step(cfg)
    params = {"w": torch.empty(10, 16, 16, device="meta")}
    batch = {"x": torch.empty(4, 16, device="meta")}
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_serving(step, params, {}, batch)
    assert rep.depth["source"] == "fallback"
    assert rep.depth["why"].startswith("check")
    assert rep.depth["probe_traces"] == 3
    assert D.summary(rep.depth) == {"source": "fallback", "units": 10,
                                    "units_traced": 19}
    plain = XMemEstimator.for_torch_gpu().estimate_serving(
        lambda p, c, b: step(p, c, b), params, {}, batch)   # no plan
    assert plain.depth == {}
    assert (rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
            rep.num_events) == (plain.peak_bytes, plain.peak_tensor_bytes,
                                plain.persistent_bytes, plain.num_events)


def test_estimate_reports_its_source():
    cfg = at_units("qwen3-32b", 10)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params, batch = M.abstract_params(cfg), reg.input_specs(
        cfg, smoke_shape(S, B))
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(fn, params, batch, update_fn=upd,
                                opt_init_fn=init)
    assert rep.depth["source"] == "composed" and rep.depth["units"] == 10
    assert rep.depth["probe_units"] == [2, 3, 4]
    assert rep.depth["probe_traces"] == 3
    # one trace for each phase, the composed one at the real depth's key
    assert rep.cache_stats["misses"] == 3
    again = est.estimate_training(fn, params, batch, update_fn=upd,
                                  opt_init_fn=init)
    assert again.depth["probe_traces"] == 0
    assert again.cache_stats["misses"] == 0
    assert D.summary(rep.depth) == {"source": "composed", "units": 10,
                                    "units_traced": 9}
    # at the probes' 9 units a full trace costs less: no composition
    nine = at_units("qwen3-32b", 9)
    fn9, upd9, init9 = make_estimator_hooks(nine, TrainPolicy())
    nine_rep = XMemEstimator.for_torch_gpu().estimate_training(
        fn9, M.abstract_params(nine), batch, update_fn=upd9,
        opt_init_fn=init9)
    assert nine_rep.depth == {"source": "traced", "units": 9,
                              "units_traced": 9, "probe_traces": 0}
    # the frozen reference pipeline traces every layer
    ref = XMemEstimator.for_torch_gpu(fastpath=False).estimate_training(
        fn, params, batch, update_fn=upd, opt_init_fn=init)
    assert ref.depth == {}
    assert (ref.peak_bytes, ref.peak_tensor_bytes, ref.persistent_bytes,
            ref.oom) == (rep.peak_bytes, rep.peak_tensor_bytes,
                         rep.persistent_bytes, rep.oom)


def test_ops_dispatched_do_not_grow_with_depth(monkeypatch):
    counts = {"ops": 0}
    dispatch = TorchMemoryTracer.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        counts["ops"] += 1
        return dispatch(self, func, types, args, kwargs)
    monkeypatch.setattr(TorchMemoryTracer, "__torch_dispatch__", counting)

    def ops_at(n_layers):
        cfg = dataclasses.replace(reg.get_smoke("qwen3-32b"),
                                  n_layers=n_layers)
        fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
        counts["ops"] = 0
        rep = XMemEstimator.for_torch_gpu().estimate_training(
            fn, M.abstract_params(cfg),
            reg.input_specs(cfg, smoke_shape(S, B)), update_fn=upd,
            opt_init_fn=init)
        assert rep.depth["source"] == "composed"
        return counts["ops"]
    # past the 9 units the probes trace together
    assert ops_at(10) == ops_at(32) > 0


# ---------------------------------------------------------------------------
def test_composed_phase_round_trips_through_the_store(tmp_path):
    cfg = at_units("qwen3-32b", 10)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params, batch = M.abstract_params(cfg), reg.input_specs(
        cfg, smoke_shape(S, B))
    store = str(tmp_path / "store")
    est = XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store)))
    first = est.estimate_training(fn, params, batch, update_fn=upd,
                                  opt_init_fn=init)
    fwd = est.trace_phases(fn, params, batch)[0]
    back = phase_from_json(json.loads(json.dumps(phase_to_json(fwd))))
    assert D.phases_equal(back, fwd)
    assert back.trace.meta["depth"]["source"] == "composed"
    # a new process's estimator over the same store: no trace, no probe
    cold = XMemEstimator.for_torch_gpu(
        trace_cache=TraceCache(store=TraceStore(store)))
    second = cold.estimate_training(fn, params, batch, update_fn=upd,
                                    opt_init_fn=init)
    assert second.cache_stats["misses"] == 0
    assert second.cache_stats["global"]["store_hits"] == 3
    assert second.depth["source"] == "composed"
    assert second.depth["probe_traces"] == 0 and cold.probe_traces == 0
    assert (second.peak_bytes, second.peak_tensor_bytes,
            second.persistent_bytes) == (first.peak_bytes,
                                         first.peak_tensor_bytes,
                                         first.persistent_bytes)


def _serve_key(fn, cfg):
    args = [(M.abstract_params(cfg), BlockKind.PARAM, "params"),
            (M.init_cache(cfg, B, S, device="meta"), BlockKind.CACHE,
             "cache"), (srv.decode_input(cfg, B), BlockKind.INPUT, "batch")]
    flat, kinds, _ = flatten_kinds(args)
    return trace_key(fn, "serve", flat, tuple(
        pytree.tree_structure(t) for t, _, _ in args), kinds, Phase.DECODE)


def test_serving_steps_have_content_keys():
    cfg = reg.get_smoke("qwen3-32b")
    for make in (lambda c: make_serve_step(c, 3), srv.make_decode_fn,
                 srv.make_prefill_fn):
        a, b = _serve_key(make(cfg), cfg), _serve_key(make(cfg), cfg)
        assert key_is_content_addressed(a) and a == b
        other = dataclasses.replace(cfg, n_layers=3)
        assert _serve_key(make(other), other) != a
    prefill = make_prefill_step(cfg)
    assert key_is_content_addressed(trace_key(
        prefill, "serve", [], (), [], Phase.DECODE))


def test_restarted_service_serves_from_the_store(tmp_path):
    cfg = reg.get_smoke("qwen3-32b")
    store = str(tmp_path / "store")
    svc = AdmissionService(workers=1, store_dir=store)
    batch, gate = srv.pick_batch(cfg, S, 1 << 30, candidates=(2,),
                                 service=svc)
    assert batch == 2
    assert gate["candidates"][0]["source"] == "traced"
    svc.close()
    again = AdmissionService(workers=1, store_dir=store)
    batch2, gate2 = srv.pick_batch(cfg, S, 1 << 30, candidates=(2,),
                                   service=again)
    assert batch2 == 2 and gate2["candidates"][0]["source"] == "disk"
    for d in (gate2["prefill"], gate2["decode"]):
        assert d.provenance["trace_cache"]["misses"] == 0
    assert gate2["peak"] == gate["peak"]
    again.close()


def test_params_at_keeps_the_other_arguments():
    cfg = at_units("qwen3-32b", 3)
    batch = {"x": torch.empty(2, device="meta")}
    params, rest = params_at(cfg, [None, batch])
    assert rest is batch
    assert params["layers"]["ln1"].shape[0] == 3

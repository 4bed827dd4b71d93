"""Nested step loops (``core/loops.py`` at two levels) for jamba-smoke's
Mamba block: its chunk loop (16 chunks of 16 steps) composed over the
step loops inside its chunks equals the phase traced in full column by
column, and the reports are equal to the byte, in training under
``remat`` full, dots and none and at 2 microbatches, in prefill, for a
last chunk shorter than the probes run (traced in full inside its edge
chunk) and one long enough to compose at a step count of its own; and
nested in depth
probes: a stack deeper than the depth probes' 9 periods, each probe's
Mamba loops composed at two levels, to the bytes of the frozen pipeline.
"""
import dataclasses

import pytest

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import depth as D
from repro_torch.core import loops as L
from repro_torch.core.estimator import XMemEstimator
from repro_torch.launch import serve as srv
from repro_torch.models import model as M
from torch_loops_jobs import JAMBA, NESTED_SEQ, assert_loops_compose, nested


@pytest.fixture(autouse=True)
def _nest_16_chunks(monkeypatch):
    # the smoke configs' 16 chunks nest (the default NEST_MIN is 32, so
    # that each case traces 16 chunks in full, not 32)
    monkeypatch.setattr(L, "NEST_MIN", 16)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_mamba_chunk_loop_composes_over_its_step_loops(remat):
    info = assert_loops_compose(nested(JAMBA, remat=remat), "train",
                                seq=NESTED_SEQ)
    # the chunk loop in the forward (and the period's recompute); each
    # chunk's steps there and in the chunk's own recompute
    passes = 1 if remat == "none" else 2
    assert info["signatures"] == [[16, passes, 0],
                                  [16, 16 * (passes + 1), 1]]


def test_mamba_nested_loops_compose_with_two_microbatches():
    info = assert_loops_compose(nested(JAMBA), "train", seq=NESTED_SEQ,
                                microbatches=2)
    assert info["signatures"] == [[16, 4, 0], [16, 96, 1]]


def test_mamba_nested_loops_compose_in_prefill():
    info = assert_loops_compose(nested(JAMBA), "prefill", seq=NESTED_SEQ)
    assert info["signatures"] == [[16, 1, 0], [16, 16, 1]]


def test_mamba_shorter_last_chunk_is_an_edge_chunk():
    # 264 = 16 chunks of 16 steps and a last of 8, fewer than the probes
    # run: that chunk's steps are traced in full in every probe
    info = assert_loops_compose(nested(JAMBA), "train", seq=NESTED_SEQ + 8)
    assert info["signatures"] == [[17, 2, 0], [16, 48, 1]]
    # 336 = 16 chunks of 20 steps and a last of 16: its loop composes at
    # its own 16 steps
    info = assert_loops_compose(nested(JAMBA, chunk=20), "prefill", seq=336)
    assert info["signatures"] == [[17, 1, 0], [16, 1, 1], [20, 16, 1]]


def test_nested_loops_compose_inside_depth_probes():
    # 10 periods of one attention and one Mamba layer: composed by
    # depth from probes of 2, 3 and 4 periods, each composed by chunks
    # from four probes, each of those by steps
    cfg = dataclasses.replace(nested(JAMBA), n_layers=20)
    step, params = srv.make_prefill_fn(cfg), M.abstract_params(cfg)
    cache = M.init_cache(cfg, 2, NESTED_SEQ, device="meta")
    prompts = srv.prompt_specs(cfg, 2, NESTED_SEQ)
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_serving(step, params, cache, prompts)
    assert rep.depth["source"] == "composed" and rep.depth["units"] == 10
    loops = rep.depth["loops"]
    assert loops["source"] == "composed" and loops["in"] == "depth probes"
    # the depth probes' 2 + 3 + 4 Mamba layers, 16 chunks of 16 steps
    assert loops["signatures"] == [[16, 9, 0], [16, 9 * 16, 1]]
    assert rep.depth["probe_traces"] == 3 * len(L.PROBE_STEPS) ** 2 \
        == loops["probes"]
    assert D.summary(rep.depth)["loops"]["levels"] == 2
    assert L.note(D.summary(rep.depth)).endswith(", 2 levels")
    ref = XMemEstimator.for_torch_gpu(fastpath=False).estimate_serving(
        step, params, cache, prompts)
    assert (ref.peak_bytes, ref.peak_tensor_bytes, ref.persistent_bytes,
            ref.oom, ref.num_events) == (
        rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
        rep.oom, rep.num_events)

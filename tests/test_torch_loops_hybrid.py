"""Step-loop composition for jamba-smoke's Mamba loop (chunk 16), and
nested with depth composition (``core/loops.py`` inside
``core/depth.py``'s probes): the composed phase equals the full trace
column by column and the reports are equal to the byte, in training
under ``remat`` full, dots and none, in prefill, for a sequence whose
last chunk is shorter (traced in full at 8 steps; composed at a step
count of its own at 16), and for a stack deeper than the depth probes'
9 periods, estimated from 3 depth probes whose loops are composed. A
separate file from ``test_torch_loops.py``: the two take about as long.
"""
import pytest

from repro_torch.configs import registry as reg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import loops as L
from repro_torch.core.estimator import XMemEstimator
from repro_torch.models import model as M
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from torch_depth_jobs import at_units
from torch_loops_jobs import JAMBA, assert_loops_compose, smoke


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_mamba_loops_compose_in_training(remat):
    info = assert_loops_compose(smoke(JAMBA, remat=remat), "train")
    # 2 periods of 3 Mamba layers, 4 chunks each
    assert info["loops"] == 24 * (3 if remat != "none" else 2)


def test_mamba_loops_compose_in_prefill():
    info = assert_loops_compose(smoke(JAMBA), "prefill")
    assert info["signatures"] == [[16, 24, 0]]


def test_a_shorter_last_chunk_is_a_loop_of_its_own():
    # 72 = 4 chunks of 16 and a last of 8 steps, fewer than the probes
    # run: traced in full inside the composed phase
    info = assert_loops_compose(smoke(JAMBA), "train", seq=72)
    assert info["signatures"] == [[16, 72, 0]]
    # chunks of 32, 32 and 16: the last composes at its own 16 steps
    info = assert_loops_compose(smoke(JAMBA, chunk=32), "train", seq=80)
    assert info["signatures"] == [[16, 18, 0], [32, 36, 0]]


def test_loops_compose_inside_depth_probes():
    cfg = at_units(JAMBA, 10)
    fn, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    args = (fn, M.abstract_params(cfg),
            reg.input_specs(cfg, smoke_shape(32, 2)))
    est = XMemEstimator.for_torch_gpu()
    rep = est.estimate_training(*args, update_fn=upd, opt_init_fn=init)
    assert rep.depth["source"] == "composed" and rep.depth["units"] == 10
    loops = rep.depth["loops"]
    assert loops["source"] == "composed" and loops["in"] == "depth probes"
    # 2, 3 and 4 periods of 3 Mamba layers, 2 chunks each, 3 passes
    assert loops["loops"] == 9 * 3 * 2 * 3
    # each depth probe's loops composed from its step probes
    assert rep.depth["probe_traces"] == 3 * len(L.PROBE_STEPS) \
        == loops["probes"]
    ref = XMemEstimator.for_torch_gpu(fastpath=False).estimate_training(
        *args, update_fn=upd, opt_init_fn=init)
    assert (ref.peak_bytes, ref.peak_tensor_bytes, ref.persistent_bytes,
            ref.oom, ref.num_events) == (
        rep.peak_bytes, rep.peak_tensor_bytes, rep.persistent_bytes,
        rep.oom, rep.num_events)

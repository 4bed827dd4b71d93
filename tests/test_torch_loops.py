"""Step-loop composition of the port's phase traces (``core/loops.py``)
for xlstm-smoke's sLSTM steps and mLSTM chunks (chunk 16): a phase
whose step loops ran 6 and 7 steps in its probes, its trace at each
loop's real step count synthesized, equals the phase traced in full
column by column, and the reports from them are equal to the byte:
training under ``remat`` full, dots and none, 2 microbatches, prefill,
a sequence that is not a multiple of the chunk (the last chunk's zero
steps are steps of the same loop), and one long enough for the mLSTM's
chunk loops to compose too. Jamba's Mamba loop and the nesting with
depth composition: ``test_torch_loops_hybrid.py``; the mechanism (the
fallback, flat cost, probes per phase, the store):
``test_torch_loops_cost.py``.
"""
import pytest

from torch_loops_jobs import XLSTM, assert_loops_compose, smoke


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_slstm_loops_compose_in_training(remat):
    info = assert_loops_compose(smoke(XLSTM, remat=remat), "train")
    # 2 periods' sLSTM, 4 chunks each, in the forward and the chunks'
    # recompute (full and dots: the period's recompute too)
    assert info["signatures"] == [[16, info["loops"], 0]]
    assert info["loops"] == (24 if remat != "none" else 16)


def test_slstm_loops_compose_with_two_microbatches():
    # one period, 4 chunks a microbatch, 3 passes each
    info = assert_loops_compose(smoke(XLSTM, n_layers=4), "train",
                                microbatches=2)
    assert info["loops"] == 24


def test_slstm_loops_compose_in_prefill():
    info = assert_loops_compose(smoke(XLSTM), "prefill")
    assert info["loops"] == 8


def test_slstm_zero_steps_of_an_uneven_sequence_compose():
    # 72 = 4 chunks of 16 and one of 8 padded with 8 zero steps: each
    # chunk's loop runs 16 steps
    info = assert_loops_compose(smoke(XLSTM), "train", seq=72)
    assert info["signatures"] == [[16, 30, 0]]


def test_mlstm_chunk_loops_compose_beside_the_slstm_steps():
    # 256 positions: each mLSTM block's 16 chunks are a long loop too
    info = assert_loops_compose(smoke(XLSTM, n_layers=4), "train", seq=256)
    # one period: 3 mLSTM loops and the sLSTM's 16 chunks of 16 steps,
    # each in the forward and two recomputes (16 chunks are fewer than
    # NEST_MIN: the sLSTM's chunk loop runs every chunk)
    assert info["signatures"] == [[16, 3 * 3 + 16 * 3, 0]]

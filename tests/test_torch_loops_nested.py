"""Nested step loops (``core/loops.py`` at two levels) for xlstm-smoke's
sLSTM: its chunk loop (16 chunks of 16 steps) composed over the step
loops inside its chunks, from four probes of 6 or 7 chunks each of 6 or
7 steps, equals the phase traced in full column by column, and the
reports from them are equal to the byte: training under ``remat`` full,
dots and none, prefill, and a sequence whose last chunk is padded with
zero steps. Mamba's loops (2 microbatches among them) and the nesting
in depth probes: ``test_torch_loops_nested_hybrid.py``; chunked
attention's: ``test_torch_loops_nested_attention.py``; the mechanism
(flat cost, the fallback, probes per phase, the store):
``test_torch_loops_nested_cost.py``.
"""
import pytest

from repro_torch.core import loops as L
from torch_loops_jobs import NESTED_SEQ, XLSTM, assert_loops_compose, nested


@pytest.fixture(autouse=True)
def _nest_16_chunks(monkeypatch):
    # the smoke configs' 16 chunks nest (the default NEST_MIN is 32, so
    # that each case traces 16 chunks in full, not 32)
    monkeypatch.setattr(L, "NEST_MIN", 16)


def _levels(info) -> list:
    """Each level's real loops and steps."""
    return [(by["loops"], by["steps"]) for by in info["by_level"]]


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_slstm_chunk_loop_composes_over_its_step_loops(remat):
    info = assert_loops_compose(nested(XLSTM, remat=remat), "train",
                                seq=NESTED_SEQ)
    # the mLSTM's chunk loop in the forward (and, under remat, its
    # layer's and its period's recomputes) and the sLSTM's chunk loop
    # in the forward (and the period's recompute), 16 chunks each; each
    # sLSTM chunk's 16 steps in the forward, the recomputes and the
    # chunk's own recompute
    passes = 1 if remat == "none" else 2
    mlstm = 1 if remat == "none" else 3
    assert info["signatures"] == [[16, mlstm + passes, 0],
                                  [16, 16 * (passes + 1), 1]]
    assert _levels(info) == [(mlstm + passes, 16 * (mlstm + passes)),
                             (16 * (passes + 1), 256 * (passes + 1))]


def test_slstm_nested_loops_compose_in_prefill():
    info = assert_loops_compose(nested(XLSTM), "prefill", seq=NESTED_SEQ)
    assert info["signatures"] == [[16, 2, 0], [16, 16, 1]]


def test_slstm_padded_last_chunk_composes():
    # 264 = 16 chunks of 16 and one of 8 padded with 8 zero steps: 17
    # chunks, each of 16 steps, the last an edge chunk of its own
    info = assert_loops_compose(nested(XLSTM), "prefill",
                                seq=NESTED_SEQ + 8)
    assert info["signatures"] == [[17, 2, 0], [16, 17, 1]]

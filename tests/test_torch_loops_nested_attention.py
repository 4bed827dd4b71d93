"""Nested step loops (``core/loops.py`` at two levels) for chunked
attention: qwen3-smoke at one layer of ``impl="chunked"`` attention
over query and key chunks of 16 positions, at 256 positions 16 query
chunks (each checkpointed when it trains) over 16 key chunks each. The
query loop composed over its key loops equals the phase traced in full
column by column, and the reports are equal to the byte: training under
``remat`` full, dots and none, prefill, and a prefill whose last query
chunk and last key chunk are shorter (the last step of each loop, an
edge step of its own). A causal mask's fully masked key chunks run
every op all the same, so every body of a loop is alike.
"""
import pytest

from repro_torch.core import loops as L
from torch_loops_jobs import DENSE, NESTED_SEQ, assert_loops_compose, nested


@pytest.fixture(autouse=True)
def _nest_16_chunks(monkeypatch):
    # the smoke configs' 16 chunks nest (the default NEST_MIN is 32, so
    # that each case traces 16 chunks in full, not 32)
    monkeypatch.setattr(L, "NEST_MIN", 16)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_query_loop_composes_over_its_key_loops(remat):
    info = assert_loops_compose(nested(DENSE, remat=remat), "train",
                                seq=NESTED_SEQ)
    # the query loop in the forward (and the layer's recompute); each
    # query chunk's key loop there and in the chunk's own recompute
    passes = 1 if remat == "none" else 2
    assert info["signatures"] == [[16, passes, 0],
                                  [16, 16 * (passes + 1), 1]]


def test_attention_nested_loops_compose_in_prefill():
    info = assert_loops_compose(nested(DENSE), "prefill", seq=NESTED_SEQ)
    assert info["signatures"] == [[16, 1, 0], [16, 16, 1]]


def test_shorter_last_query_and_key_chunks_compose():
    # 264 = 16 chunks of 16 and one of 8, for the queries and the keys
    info = assert_loops_compose(nested(DENSE), "prefill",
                                seq=NESTED_SEQ + 8)
    assert info["signatures"] == [[17, 1, 0], [17, 17, 1]]

"""Depth composition for the hybrid and SSM families (jamba-smoke's
periods of one attention and three Mamba layers, xlstm-smoke's of three
mLSTM blocks and one sLSTM): training, prefill and decode composed from
probes of 2, 3 and 4 periods equal the trace at 5 periods column by
column, and the training reports are equal to the byte. A separate file
from ``test_torch_depth.py``: their step loops make them the slowest
families to trace."""
import pytest

from torch_depth_jobs import UNITS, assert_composed_equals_full, at_units


@pytest.mark.parametrize("arch,kind,remat", [
    ("jamba-1.5-large-398b", "train", "none"),
    ("xlstm-1.3b", "train", "full"),
    ("jamba-1.5-large-398b", "prefill", "full"),
    ("xlstm-1.3b", "prefill", "full"),
    ("jamba-1.5-large-398b", "decode", "full"),
    ("xlstm-1.3b", "decode", "full"),
])
def test_composed_recurrent_phase_equals_full(arch, kind, remat):
    # 8 positions: the step loops' cost grows with the sequence
    assert_composed_equals_full(at_units(arch, UNITS, remat=remat), kind,
                                seq=8)

"""The sweep service on the hybrid (jamba) and SSM (xLSTM) families.

A sweep equals sequential ``estimate_training`` to the byte (the same
standard as ``test_torch_sweep.py`` holds the other families to). Both
smoke configs are cut to one period, and the sequence to 16 positions:
their traces step through every position, the slowest to trace of the
families.

* xLSTM interpolates: the mLSTM and sLSTM step loops' traces are affine
  in the batch at a fixed sequence length.
* jamba's does not: its MoE layers' expert capacity,
  ``max(8, roundup8(ceil(k T cf / E)))`` with top-2 of 4 experts, factor
  1.5 and ``T = 16 b`` tokens, is 24, 40, 48, 64 at batches 2, 3, 4, 5:
  no line goes through the probes' (2, 24), (4, 48) and (5, 64), so the
  model refuses itself and batch 3 is traced for real (``fallback``):
  exact, not interpolated.
"""
import dataclasses

import pytest

from repro_torch.configs import registry as treg
from test_torch_sweep import sweep_against_sequential

# family -> (arch, one period of layers)
RECURRENT = {"hybrid": ("jamba-1.5-large-398b", 4),
             "ssm": ("xlstm-1.3b", 4)}


@pytest.mark.parametrize("family", sorted(RECURRENT))
def test_sweep_equals_sequential(family):
    arch, period = RECURRENT[family]
    cfg = dataclasses.replace(treg.get_smoke(arch), n_layers=period)
    res = sweep_against_sequential(cfg, (2, 3, 4, 5), seq=16)
    # probes 2, 4 and 5; 3 synthesized where the trace is affine
    if family == "hybrid":
        assert res.stats["model"] is None
        assert res.sources == ["probe", "fallback", "probe", "probe"]
        assert res.stats["interpolated"] == 0
    else:
        assert res.sources == ["probe", "interpolated", "probe", "probe"]
        assert res.stats["interpolated"] == 1
        assert res.stats["fallback"] == 0

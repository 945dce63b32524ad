"""spotrf over a P x Q process grid (DPLASMA testing_spotrf, lower, run
on several ranks): inputs, flops and the plain reference.

The grid changes where the tiles live, not what is computed, so this is
`reference/spotrf.py`'s, loaded from that file: the same test matrix
(`plghe`, every rank's tiles cut from one draw), DPLASMA's flop count
over the whole grid, the float64 factor (`torch.linalg.cholesky`) that
`check` judges the factor gathered from the ranks' device tiles
against, and the TF32 `control`.
"""
from __future__ import annotations

import os

from harness.core import load_module

_spotrf = load_module(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "spotrf")

plghe = _spotrf.plghe
inputs = _spotrf.inputs
flops = _spotrf.flops
offdiag_error = _spotrf.offdiag_error
check = _spotrf.check
cholesky_tf32 = _spotrf.cholesky_tf32
control = _spotrf.control
_factor64 = _spotrf._factor64

"""spotrf with the matrix in host memory (DPLASMA testing_spotrf -g 1,
lower): inputs, flops and the plain reference.

Where the tiles live changes how they reach the card, not what is
computed, so this is `reference/spotrf.py`'s, loaded from that file: the
same test matrix (`plghe`), DPLASMA's flop count, the float64 factor
(`torch.linalg.cholesky`) that `check` judges the factor read from the
host tiles against, and the TF32 `control`.
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

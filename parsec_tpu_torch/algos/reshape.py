"""Reshape: dtype/layout conversion between collections as a taskpool.

Reference analog (SURVEY.md §2.3 "reshape"): parsec/parsec_reshape.c
converts datacopies between datatypes/layouts through datacopy futures on
flow boundaries, locally or pre-send.  The TPU-native translation: layout
is XLA's concern on-device, so reshape is a *library algorithm* over
collections — per-tile dtype casts / element transforms ride the
map_operator taskpool (same geometry), and geometry changes (tile size,
distribution) ride redistribute.  Both compose with user DAGs like any
other taskpool, which is exactly how the reference packages its reshape
paths as PTG algorithms.

Port of parsec_tpu/algos/reshape.py; on the card the layout of a device
tile is torch's, so the translation is the same.
"""
from typing import Callable, Optional

import numpy as np

import parsec_tpu_torch as pt
from .matrix_ops import build_map_operator
from .redistribute import redistribute


def build_reshape_dtype(ctx: pt.Context, src, dst,
                        cast: Optional[Callable] = None,
                        src_name: str = "RSsrc", dst_name: str = "RSdst"):
    """Tile-by-tile dtype conversion src -> dst (same tile geometry).

    `cast(tile) -> np.ndarray` defaults to a plain astype onto the dst
    collection's dtype.  Returns the taskpool (run()/wait() to execute).
    """
    if (src.mt, src.nt) != (dst.mt, dst.nt):
        raise ValueError(
            f"reshape_dtype needs matching tile grids; "
            f"src {(src.mt, src.nt)} vs dst {(dst.mt, dst.nt)} "
            f"(use reshape_geometry for regridding)")
    to = np.dtype(dst.dtype)

    def op(src_tile, dst_tile, m, n):
        out = cast(src_tile) if cast is not None else src_tile
        return np.asarray(out, dtype=to)

    return build_map_operator(ctx, src, dst, op,
                              src_name=src_name, dst_name=dst_name)


def reshape_geometry(ctx: pt.Context, src, dst,
                     size_row: Optional[int] = None,
                     size_col: Optional[int] = None):
    """Regrid src's elements into dst (different mb/nb and/or distribution)
    — the redistribute path of the reference's reshape machinery."""
    return redistribute(ctx, src, dst,
                        size_row if size_row is not None else min(src.M,
                                                                  dst.M),
                        size_col if size_col is not None else min(src.N,
                                                                  dst.N))

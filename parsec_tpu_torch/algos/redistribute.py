"""Generic collection→collection redistribution.

Reference: parsec/data_dist/matrix/redistribute/ (redistribute.jdf +
redistribute_dtd.c + redistribute_wrapper.c — SURVEY.md §2.3): copy an
arbitrary M×N submatrix from a source tiled collection (any tile size,
any displacement) into a target collection (any tile size, any
displacement).  The reference JDF splits every target tile into nine
regions (NW/N/NE/W/I/E/SW/S/SE) against the source grid; here the DAG is
discovered dynamically (the reference ships a DTD variant too,
redistribute_dtd.c): one copy task per (source tile × target tile)
intersection, INPUT on the source tile and INOUT on the target tile —
the per-tile accessor chains serialize writers of the same target tile
while distinct tiles proceed fully in parallel, and in distributed mode
tasks run on the target tile's owner with source payloads shipped by the
comm engine.

This is also the framework's all-to-all resharding primitive (the dense-LA
analog of sequence/context resharding — SURVEY.md §5 long-context note).

Port of parsec_tpu/algos/redistribute.py.  The copy tasks are host
bodies: a source or target tile whose current bytes are a dirty
CudaDevice mirror is pulled to its host array by the task's read
(DtdView.data) first; the write then makes every device mirror of the
target stale (a newer copy version), so no stale mirror is read again.
"""
from __future__ import annotations

import numpy as np

from ..core.context import Context
from ..dsl.dtd import DtdTaskpool


def _tile_range(lo: int, hi: int, tb: int):
    """Tiles [t_lo, t_hi] covering element rows [lo, hi)."""
    return lo // tb, (hi - 1) // tb


def redistribute(ctx: Context, src, dst, size_row: int, size_col: int,
                 disi_src: int = 0, disj_src: int = 0,
                 disi_dst: int = 0, disj_dst: int = 0,
                 window: int = 8000) -> None:
    """Copy src[disi_src:disi_src+size_row, disj_src:disj_src+size_col]
    into dst[disi_dst:..., disj_dst:...].  Blocks until done."""
    if size_row <= 0 or size_col <= 0:
        return
    if disi_src + size_row > src.M or disj_src + size_col > src.N:
        raise ValueError("source region out of bounds")
    if disi_dst + size_row > dst.M or disj_dst + size_col > dst.N:
        raise ValueError("target region out of bounds")
    for coll in (src, dst):  # data_of needs a context to create Data handles
        if getattr(coll, "_ctx", None) is None:
            coll._ctx = ctx
    sdt, ddt = src.dtype, dst.dtype
    smb, snb, dmb, dnb = src.mb, src.nb, dst.mb, dst.nb

    tp = DtdTaskpool(ctx, window=window)
    try:
        # accumulate (body, args) specs; ONE native crossing per
        # dtd.insert_batch tasks (tp.insert_tasks) instead of a
        # begin/arg/submit triple per copy task
        batch = []
        tm_lo, tm_hi = _tile_range(disi_dst, disi_dst + size_row, dmb)
        tn_lo, tn_hi = _tile_range(disj_dst, disj_dst + size_col, dnb)
        for tm in range(tm_lo, tm_hi + 1):
            # target tile row-extent ∩ copied region, in "offset" space
            # (r = row index within the copied submatrix)
            r0 = max(tm * dmb, disi_dst) - disi_dst
            r1 = min((tm + 1) * dmb, disi_dst + size_row) - disi_dst
            for tn in range(tn_lo, tn_hi + 1):
                c0 = max(tn * dnb, disj_dst) - disj_dst
                c1 = min((tn + 1) * dnb, disj_dst + size_col) - disj_dst
                dst_tile = tp.tile_of(dst, tm, tn)
                # source tiles overlapped by this offset rectangle
                sm_lo, sm_hi = _tile_range(disi_src + r0, disi_src + r1, smb)
                sn_lo, sn_hi = _tile_range(disj_src + c0, disj_src + c1, snb)
                for sm in range(sm_lo, sm_hi + 1):
                    rr0 = max(r0, sm * smb - disi_src)
                    rr1 = min(r1, (sm + 1) * smb - disi_src)
                    for sn in range(sn_lo, sn_hi + 1):
                        cc0 = max(c0, sn * snb - disj_src)
                        cc1 = min(c1, (sn + 1) * snb - disj_src)
                        if rr1 <= rr0 or cc1 <= cc0:
                            continue
                        src_tile = tp.tile_of(src, sm, sn)
                        # local offsets of the intersection in each tile
                        si = disi_src + rr0 - sm * smb
                        sj = disj_src + cc0 - sn * snb
                        di = disi_dst + rr0 - tm * dmb
                        dj = disj_dst + cc0 - tn * dnb
                        h, w = rr1 - rr0, cc1 - cc0

                        def body(view, si=si, sj=sj, di=di, dj=dj, h=h, w=w):
                            s = view.data(0, sdt, (smb, snb))
                            d = view.data(1, ddt, (dmb, dnb))
                            d[di:di + h, dj:dj + w] = \
                                s[si:si + h, sj:sj + w].astype(ddt)

                        batch.append((body, ((src_tile, "INPUT"),
                                             (dst_tile, "INOUT"))))
        tp.insert_tasks(batch)
        tp.wait()
    finally:
        tp.destroy()

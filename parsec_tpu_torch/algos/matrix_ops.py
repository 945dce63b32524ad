"""Generic per-tile matrix operations as PTG taskpools: apply, map_operator
and row/column tree reductions.

Reference analogs (SURVEY.md §2.3 "matrix ops"):
  - apply.jdf / apply_wrapper.c:52-188  — unary operator on every tile of a
    triangle/full region, one task per tile, owner-computes affinity
  - map_operator.c                      — src→dst per-tile map (two
    collections, reads src, writes dst)
  - reduce_col.jdf / reduce_row.jdf / reduce_wrapper.c — binary-tree
    reduction of the tiles of each column/row into a destination tile

These are themselves taskpools (the reference builds them as JDFs); they
compose with user DAGs via Taskpool.run()/wait() or compose() chaining.
The tree reductions generalize the reference's power-of-two index tree with
existence guards so any mt/nt works.

Port of parsec_tpu/algos/matrix_ops.py.  The bodies run on the host: a
tile whose current bytes are a dirty CudaDevice mirror is pulled to its
host array by the task view's read (TaskView.data), before the operator
sees it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import parsec_tpu_torch as pt
from ..core.expr import shl


def _ceil_div_pow2(e, lvl):
    """ceil(e / 2**lvl) as a VM expression."""
    return (e + shl(1, lvl) - 1) // shl(1, lvl)


def build_apply(ctx: pt.Context, A, op: Callable, uplo: str = "full",
                name: str = "A") -> pt.Taskpool:
    """Apply `op(coll, m, n, tile)` to every stored tile of the region.

    uplo: "full" | "lower" (n <= m) | "upper" (m <= n).  The operator
    mutates the tile in place (RW flow, collection in/out — the reference's
    APPLY_L/APPLY_U/APPLY_DIAG pattern collapsed into guarded classes).
    """
    if uplo not in ("full", "lower", "upper"):
        raise ValueError(f"uplo must be full/lower/upper, got {uplo!r}")
    tp = pt.Taskpool(ctx, globals={"MT": A.mt - 1, "NT": A.nt - 1})
    m, n = pt.L("m"), pt.L("n")
    MT, NT = pt.G("MT"), pt.G("NT")
    dt = A.dtype
    shp = (A.mb, getattr(A, "nb", 1))

    def make_class(cname, m_lo, m_hi, n_lo, n_hi):
        tc = tp.task_class(cname)
        tc.param("m", m_lo, m_hi)
        tc.param("n", n_lo, n_hi)
        tc.affinity(name, m, n)
        tc.flow("T", "RW", pt.In(pt.Mem(name, m, n)),
                pt.Out(pt.Mem(name, m, n)))

        def body(t):
            tile = t.data("T", dt, shp)
            op(A, t.local("m"), t.local("n"), tile)

        tc.body(body)
        return tc

    # diagonal is its own class so the triangular regions exclude it
    # (reference: APPLY_DIAG, apply.jdf)
    if uplo in ("full", "lower", "upper"):
        make_class("APPLY_DIAG", 0, pt.minimum(MT, NT), m, m)
    if uplo in ("full", "lower"):
        make_class("APPLY_L", 1, MT, 0, pt.minimum(m - 1, NT))
    if uplo in ("full", "upper"):
        make_class("APPLY_U", 0, pt.minimum(MT, NT), m + 1, NT)
    return tp


def build_map_operator(ctx: pt.Context, src, dst, op: Callable,
                       src_name: str = "S", dst_name: str = "D"
                       ) -> pt.Taskpool:
    """Per-tile map: dst(m,n) = op(src_tile, dst_tile, m, n) over the
    common tile grid (reference: map_operator.c — sequential-ish chain per
    column there; fully parallel here, the stronger dataflow).

    `op(src_tile, dst_tile, m, n)` returns the new dst tile contents (or
    mutates dst_tile in place and returns None).
    """
    mt = min(src.mt, dst.mt)
    nt = min(getattr(src, "nt", 1), getattr(dst, "nt", 1))
    tp = pt.Taskpool(ctx, globals={"MT": mt - 1, "NT": nt - 1})
    m, n = pt.L("m"), pt.L("n")
    sdt, ddt = src.dtype, dst.dtype
    sshp = (src.mb, getattr(src, "nb", 1))
    dshp = (dst.mb, getattr(dst, "nb", 1))

    tc = tp.task_class("MAP")
    tc.param("m", 0, pt.G("MT"))
    tc.param("n", 0, pt.G("NT"))
    tc.affinity(dst_name, m, n)
    tc.flow("S", "READ", pt.In(pt.Mem(src_name, m, n)))
    tc.flow("D", "RW", pt.In(pt.Mem(dst_name, m, n)),
            pt.Out(pt.Mem(dst_name, m, n)))

    def body(t):
        s = t.data("S", sdt, sshp)
        d = t.data("D", ddt, dshp)
        r = op(s, d, t.local("m"), t.local("n"))
        if r is not None:
            d[...] = r

    tc.body(body)
    return tp


def _build_reduce(ctx: pt.Context, A, op: Callable, axis: int,
                  name: str, dest_name: Optional[str]) -> pt.Taskpool:
    """Binary-tree reduction of tiles along `axis` (0: reduce rows of each
    column — reduce_col.jdf; 1: reduce columns of each row — reduce_row.jdf).

    op(acc_tile, in_tile) -> new acc contents.  The reduced tile for
    column/row j lands in dest(0, j) / dest(j, 0) when a dest collection is
    given, else in A's tile (0, j) / (j, 0).

    DESTRUCTIVE on A either way: the accumulator rides the left spine of
    the tree in place (RW flow), so after completion the source tiles on
    each lane's left spine hold partial sums — exactly the reference's
    reduce_col.jdf RW Rtop semantics.  Copy A first if you need it intact.

    The reference's tree (reduce_col.jdf) assumes a power-of-two tile count;
    here nodes at (level, index) carry existence guards derived from
    ceil(extent / 2**level) so any extent works: a node whose right child
    is beyond the extent passes its left value through unchanged.
    """
    extent = A.mt if axis == 0 else A.nt
    lanes = A.nt if axis == 0 else A.mt
    depth = max(1, int(np.ceil(np.log2(max(2, extent)))))
    tp = pt.Taskpool(ctx, globals={"DEPTH": depth, "EXT": extent,
                                   "LANES": lanes - 1})
    lvl, idx, j = pt.L("level"), pt.L("index"), pt.L("j")
    DEPTH, EXT = pt.G("DEPTH"), pt.G("EXT")
    dt = A.dtype
    shp = (A.mb, getattr(A, "nb", 1))

    def mem(i, jj, coll=name):
        return pt.Mem(coll, i, jj) if axis == 0 else pt.Mem(coll, jj, i)

    # nodes at level L: ceil(EXT / 2**L); node (L, i) combines (L-1, 2i)
    # and (L-1, 2i+1); level-0 "nodes" are the tiles themselves.
    def nodes_at(level_e):
        return _ceil_div_pow2(EXT, level_e)

    tc = tp.task_class("REDUCE")
    tc.param("level", 1, DEPTH)
    tc.param("index", 0, nodes_at(lvl) - 1)
    tc.param("j", 0, pt.G("LANES"))
    # run where the left descendant tile lives (reference: : src(2*index, 0))
    if axis == 0:
        tc.affinity(name, shl(idx, lvl), j)
    else:
        tc.affinity(name, j, shl(idx, lvl))
    tc.priority((DEPTH - lvl) * 10)

    right_exists = (2 * idx + 1) <= (nodes_at(lvl - 1) - 1)
    # Rtop: the accumulator rides up the left spine
    top_in = [
        pt.In(mem(shl(idx, lvl), j), guard=(lvl == 1)),
        pt.In(pt.Ref("REDUCE", lvl - 1, 2 * idx, j, flow="T"),
              guard=(lvl > 1)),
    ]
    top_out = [
        pt.Out(pt.Ref("REDUCE", lvl + 1, idx // 2, j, flow="T"),
               guard=(lvl < DEPTH) & ((idx % 2) == 0)),
        pt.Out(pt.Ref("REDUCE", lvl + 1, idx // 2, j, flow="B"),
               guard=(lvl < DEPTH) & ((idx % 2) == 1)),
        pt.Out(mem(0, j, dest_name or name), guard=(lvl == DEPTH)),
    ]
    tc.flow("T", "RW", *(top_in + top_out))
    # Rbottom: right child (may not exist near the boundary)
    tc.flow("B", "READ",
            pt.In(mem(2 * idx + 1, j), guard=(lvl == 1) & right_exists),
            pt.In(pt.Ref("REDUCE", lvl - 1, 2 * idx + 1, j, flow="T"),
                  guard=(lvl > 1) & right_exists))

    def body(t):
        level, index = t.local("level"), t.local("index")
        n_prev = (extent + (1 << (level - 1)) - 1) >> (level - 1)
        acc = t.data("T", dt, shp)
        if 2 * index + 1 <= n_prev - 1:  # right child exists
            b = t.data("B", dt, shp)
            r = op(acc, b)
            if r is not None:
                acc[...] = r

    tc.body(body)
    return tp


def build_reduce_col(ctx, A, op, name="A", dest_name=None):
    """Tree-reduce the tiles of each column; result in (0, col)."""
    return _build_reduce(ctx, A, op, 0, name, dest_name)


def build_reduce_row(ctx, A, op, name="A", dest_name=None):
    """Tree-reduce the tiles of each row; result in (row, 0)."""
    return _build_reduce(ctx, A, op, 1, name, dest_name)

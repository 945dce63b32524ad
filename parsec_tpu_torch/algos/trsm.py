"""Tiled triangular solve L X = B (DPLASMA dtrsm Left/Lower/NoTrans) as
a PTG taskpool — forward substitution over tile columns:

  ReadDiag(k)   : broadcast L[k,k] to the solve row
  ReadL(k, m)   : broadcast L[m,k] (m > k) to the update row
  SOLVE(k, n)   : X[k,n] = L[k,k]^-1 B'[k,n]
  GEMM(k, m, n) : B'[m,n] -= L[m,k] X[k,n]        (m > k)

B is overwritten by X in place (the reference's dtrsm contract).  The L
tiles move by reader-task broadcasts placed AT their data, so L and B
may have different distributions.  Port of parsec_tpu/algos/trsm.py;
the device chores are torch functions on [lanes, *tile] stacks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ..device.cuda import CudaDevice
from ._util import as_device_list, refuse_tf32


def k_solve(t, c):
    """L^-1 C for every lane (the lower triangle of t is read)."""
    refuse_tf32(c, "k_solve")
    return torch.linalg.solve_triangular(t, c, upper=False)


def k_update(l, x, c):
    """C - L X."""
    refuse_tf32(c, "k_update")
    return torch.baddbmm(c, l, x, alpha=-1)


def build_trsm(ctx: pt.Context, L: TwoDimBlockCyclic, B: TwoDimBlockCyclic,
               dev: Optional[CudaDevice] = None,
               names=("L", "B")) -> pt.Taskpool:
    """Build the solve taskpool: L lower-triangular (mt == nt), B the
    right-hand sides (B.mt == L.mt), both registered with ctx."""
    assert L.mt == L.nt and B.mt == L.mt
    nt, nrhs = L.mt, B.nt
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1, "NR": nrhs - 1})
    k, m, n = pt.L("k"), pt.L("m"), pt.L("n")
    NT, NR = pt.G("NT"), pt.G("NR")
    ln, bn = names
    dt = B.dtype
    shp_l = (L.mb, L.nb)
    shp_b = (B.mb, B.nb)

    rd = tp.task_class("ReadDiag")
    rd.param("k", 0, NT)
    rd.affinity(ln, k, k)
    rd.flow("T", "READ",
            pt.In(pt.Mem(ln, k, k)),
            pt.Out(pt.Ref("SOLVE", k, pt.Range(0, NR), flow="T")))
    rd.body_noop()

    rl = tp.task_class("ReadL")
    rl.param("k", 0, NT)
    rl.param("m", k + 1, NT)
    rl.affinity(ln, m, k)
    rl.flow("L", "READ",
            pt.In(pt.Mem(ln, m, k)),
            pt.Out(pt.Ref("GEMM", k, m, pt.Range(0, NR), flow="L")))
    rl.body_noop()

    so = tp.task_class("SOLVE")
    so.param("k", 0, NT)
    so.param("n", 0, NR)
    so.affinity(bn, k, n)
    so.priority((NT - k) * 1000 - n)
    so.flow("T", "READ", pt.In(pt.Ref("ReadDiag", k, flow="T")))
    so.flow("X", "RW",
            pt.In(pt.Mem(bn, k, n), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, k, n, flow="C")),
            pt.Out(pt.Ref("GEMM", k, pt.Range(k + 1, NT), n, flow="X"),
                   guard=(k < NT)),
            pt.Out(pt.Mem(bn, k, n)))

    ge = tp.task_class("GEMM")
    ge.param("k", 0, NT)
    ge.param("m", k + 1, NT)
    ge.param("n", 0, NR)
    ge.affinity(bn, m, n)
    ge.priority((NT - k) * 1000 - m - n)
    ge.flow("L", "READ", pt.In(pt.Ref("ReadL", k, m, flow="L")))
    ge.flow("X", "READ", pt.In(pt.Ref("SOLVE", k, n, flow="X")))
    ge.flow("C", "RW",
            pt.In(pt.Mem(bn, m, n), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, m, n, flow="C")),
            pt.Out(pt.Ref("SOLVE", m, n, flow="X"), guard=(m == k + 1)),
            pt.Out(pt.Ref("GEMM", k + 1, m, n, flow="C"),
                   guard=(m > k + 1)))

    for d in as_device_list(dev):
        d.attach(so, tp, kernel=k_solve, reads=["T", "X"], writes=["X"],
                 shapes={"T": shp_l, "X": shp_b}, dtype=dt)
        d.attach(ge, tp, kernel=k_update, reads=["L", "X", "C"],
                 writes=["C"], shapes={"L": shp_l, "X": shp_b, "C": shp_b},
                 dtype=dt)

    def b_solve(t):
        l = np.tril(t.data("T", dt, shp_l))
        c = t.data("X", dt, shp_b)
        c[...] = np.linalg.solve(l, c)

    def b_update(t):
        l = t.data("L", dt, shp_l)
        x = t.data("X", dt, shp_b)
        c = t.data("C", dt, shp_b)
        c -= l @ x

    so.body(b_solve)
    ge.body(b_update)
    return tp

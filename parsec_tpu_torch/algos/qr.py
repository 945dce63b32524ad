"""Tiled QR factorization (DPLASMA dgeqrf dataflow) as a PTG taskpool:

  GEQRT(k)      : QR of the diagonal tile       A[k,k] -> Q_k, R
  UNMQR(k, n)   : apply Q_k^T to the row        A[k,n] = Q_k^T A[k,n]
  TSQRT(k, m)   : stacked QR of [R; A[m,k]]     eliminates tile A[m,k]
  TSMQR(k, m, n): apply the stacked reflector   [top; A[m,n]] update

Each factor task materializes its ORTHOGONAL Q explicitly (nb x nb for
the diagonal, 2nb x 2nb for the stacked elimination) and the apply tasks
are plain products; A is overwritten by R (upper triangular, eliminated
tiles zeroed).  Port of parsec_tpu/algos/qr.py; the device chores are
torch functions on [lanes, *tile] stacks.  Householder signs differ
between LAPACK and cuSOLVER, so R is defined up to the sign of each row:
compare R^T R (or |R| row by row), never raw Q/R across libraries.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ..device.cuda import CudaDevice
from ._util import as_device_list, refuse_tf32


# ---------------------------------------------------------------- kernels
def k_geqrt(a):
    """Full QR of the diagonal tile: returns (q, r) — r replaces the
    tile, q rides the Q flow."""
    refuse_tf32(a, "k_geqrt")
    q, r = torch.linalg.qr(a, mode="complete")
    return q, r


def k_unmqr(q, c):
    """q^T c."""
    refuse_tf32(c, "k_unmqr")
    return torch.matmul(q.mT, c)


def k_tsqrt(r, v):
    """Stacked QR of [r; v] (2nb x nb): new r, zeroed v, full q2."""
    refuse_tf32(r, "k_tsqrt")
    nb = r.shape[1]
    q2, rf = torch.linalg.qr(torch.cat([r, v], dim=1), mode="complete")
    return rf[:, :nb], v.new_zeros(v.shape), q2


def k_tsmqr(q2, top, bot):
    """q2^T [top; bot], split back into (top, bot)."""
    refuse_tf32(top, "k_tsmqr")
    nb = top.shape[1]
    out = torch.matmul(q2.mT, torch.cat([top, bot], dim=1))
    return out[:, :nb], out[:, nb:]


def build_geqrf(ctx: pt.Context, A: TwoDimBlockCyclic,
                dev: Optional[CudaDevice] = None,
                name: str = "A") -> pt.Taskpool:
    """Build the QR taskpool for square tiled `A` (registered under
    `name`).  On completion A holds R (upper triangular; tiles below the
    diagonal zeroed)."""
    nt = A.mt
    assert A.mt == A.nt and A.mb == A.nb
    nb = A.mb
    esize = int(np.dtype(A.dtype).itemsize)
    ctx.register_arena(f"{name}_qrq", nb * nb * esize)
    ctx.register_arena(f"{name}_qrq2", 4 * nb * nb * esize)
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    k, m, n = pt.L("k"), pt.L("m"), pt.L("n")
    NT = pt.G("NT")
    shp = (nb, nb)
    shp2 = (2 * nb, 2 * nb)
    dt = A.dtype

    # ------------------------------------------------------------ GEQRT(k)
    gq = tp.task_class("GEQRT")
    gq.param("k", 0, NT)
    gq.affinity(name, k, k)
    gq.priority((NT - k) * 1000)
    gq.flow("T", "RW",
            pt.In(pt.Mem(name, k, k), guard=(k == 0)),
            pt.In(pt.Ref("TSMQR", k - 1, k, k, flow="B")),
            pt.Out(pt.Ref("TSQRT", k, k + 1, flow="R"), guard=(k < NT)),
            pt.Out(pt.Mem(name, k, k), guard=(k == NT)))
    gq.flow("Q", "WRITE",
            pt.Out(pt.Ref("UNMQR", k, pt.Range(k + 1, NT), flow="Q"),
                   guard=(k < NT)),
            arena=f"{name}_qrq")

    # --------------------------------------------------------- UNMQR(k, n)
    un = tp.task_class("UNMQR")
    un.param("k", 0, NT)
    un.param("n", k + 1, NT)
    un.affinity(name, k, n)
    un.priority((NT - k) * 1000 - n)
    un.flow("Q", "READ", pt.In(pt.Ref("GEQRT", k, flow="Q")))
    un.flow("C", "RW",
            pt.In(pt.Mem(name, k, n), guard=(k == 0)),
            pt.In(pt.Ref("TSMQR", k - 1, k, n, flow="B")),
            pt.Out(pt.Ref("TSMQR", k, k + 1, n, flow="T")))

    # --------------------------------------------------------- TSQRT(k, m)
    ts = tp.task_class("TSQRT")
    ts.param("k", 0, NT)
    ts.param("m", k + 1, NT)
    ts.affinity(name, m, k)
    ts.priority((NT - k) * 1000 - m)
    ts.flow("R", "RW",
            pt.In(pt.Ref("GEQRT", k, flow="T"), guard=(m == k + 1)),
            pt.In(pt.Ref("TSQRT", k, m - 1, flow="R")),
            pt.Out(pt.Ref("TSQRT", k, m + 1, flow="R"), guard=(m < NT)),
            pt.Out(pt.Mem(name, k, k), guard=(m == NT)))
    ts.flow("V", "RW",
            pt.In(pt.Mem(name, m, k), guard=(k == 0)),
            pt.In(pt.Ref("TSMQR", k - 1, m, k, flow="B")),
            pt.Out(pt.Mem(name, m, k)))
    ts.flow("Q2", "WRITE",
            pt.Out(pt.Ref("TSMQR", k, m, pt.Range(k + 1, NT), flow="Q"),
                   guard=(k < NT)),
            arena=f"{name}_qrq2")

    # ------------------------------------------------------ TSMQR(k, m, n)
    tm = tp.task_class("TSMQR")
    tm.param("k", 0, NT)
    tm.param("m", k + 1, NT)
    tm.param("n", k + 1, NT)
    tm.affinity(name, m, n)
    tm.priority((NT - k) * 1000 - m - n)
    tm.flow("Q", "READ", pt.In(pt.Ref("TSQRT", k, m, flow="Q2")))
    tm.flow("T", "RW",
            pt.In(pt.Ref("UNMQR", k, n, flow="C"), guard=(m == k + 1)),
            pt.In(pt.Ref("TSMQR", k, m - 1, n, flow="T")),
            pt.Out(pt.Ref("TSMQR", k, m + 1, n, flow="T"),
                   guard=(m < NT)),
            pt.Out(pt.Mem(name, k, n), guard=(m == NT)))
    tm.flow("B", "RW",
            pt.In(pt.Mem(name, m, n), guard=(k == 0)),
            pt.In(pt.Ref("TSMQR", k - 1, m, n, flow="B")),
            pt.Out(pt.Ref("GEQRT", k + 1, flow="T"),
                   guard=(m == k + 1) & (n == k + 1)),
            pt.Out(pt.Ref("UNMQR", k + 1, n, flow="C"),
                   guard=(m == k + 1) & (n > k + 1)),
            pt.Out(pt.Ref("TSQRT", k + 1, m, flow="V"),
                   guard=(m > k + 1) & (n == k + 1)),
            pt.Out(pt.Ref("TSMQR", k + 1, m, n, flow="B"),
                   guard=(m > k + 1) & (n > k + 1)))

    # --------------------------------------------------------------- chores
    for d in as_device_list(dev):
        d.attach(gq, tp, kernel=k_geqrt, reads=["T"], writes=["Q", "T"],
                 shapes={"T": shp, "Q": shp}, dtype=dt)
        d.attach(un, tp, kernel=k_unmqr, reads=["Q", "C"], writes=["C"],
                 shapes={"Q": shp, "C": shp}, dtype=dt)
        d.attach(ts, tp, kernel=k_tsqrt, reads=["R", "V"],
                 writes=["R", "V", "Q2"],
                 shapes={"R": shp, "V": shp, "Q2": shp2}, dtype=dt)
        d.attach(tm, tp, kernel=k_tsmqr, reads=["Q", "T", "B"],
                 writes=["T", "B"],
                 shapes={"Q": shp2, "T": shp, "B": shp}, dtype=dt)

    def b_geqrt(t):
        a = t.data("T", dt, shp)
        q = t.data("Q", dt, shp)
        qq, rr = np.linalg.qr(a, mode="complete")
        q[...] = qq
        a[...] = rr

    def b_unmqr(t):
        q = t.data("Q", dt, shp)
        c = t.data("C", dt, shp)
        c[...] = q.T @ c

    def b_tsqrt(t):
        r = t.data("R", dt, shp)
        v = t.data("V", dt, shp)
        q2 = t.data("Q2", dt, shp2)
        s = np.concatenate([r, v], axis=0)
        qq, rr = np.linalg.qr(s, mode="complete")
        q2[...] = qq
        r[...] = rr[:nb]
        v[...] = 0

    def b_tsmqr(t):
        q2 = t.data("Q", dt, shp2)
        top = t.data("T", dt, shp)
        bot = t.data("B", dt, shp)
        s = q2.T @ np.concatenate([top, bot], axis=0)
        top[...] = s[:nb]
        bot[...] = s[nb:]

    gq.body(b_geqrt)
    un.body(b_unmqr)
    ts.body(b_tsqrt)
    tm.body(b_tsmqr)
    return tp


def geqrf_flops(N: int) -> float:
    return 4.0 * N ** 3 / 3.0

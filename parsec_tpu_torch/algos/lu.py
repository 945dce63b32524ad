"""Tiled LU factorization without pivoting (DPLASMA dgetrf_nopiv) as a
PTG taskpool over a 2D block-cyclic matrix:

  GETRF(k)     : diagonal tile LU          A[k,k] = L[k,k] U[k,k]
  TRSM_L(k, n) : row-panel solve           A[k,n] = L[k,k]^-1 A[k,n]
  TRSM_U(m, k) : column-panel solve        A[m,k] = A[m,k] U[k,k]^-1
  GEMM(k,m,n)  : trailing update           A[m,n] -= A[m,k] A[k,n]

Doolittle convention: L is unit-lower (diagonal implied), U upper — both
packed into the tile in place.  No pivoting means the input must be
(block) diagonally dominant or otherwise LU-stable.  Port of
parsec_tpu/algos/lu.py, panel variant included; the device chores are
torch functions on [lanes, *tile] stacks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ..device.cuda import CudaDevice
from ._util import (as_device_list, lane_rows, put_rows, refuse_tf32,
                    rows_from, take_rows)


# ---------------------------------------------------------------- kernels
def k_getrf_nopiv(a):
    """Packed no-pivot LU (unit-L below the diagonal, U on and above it)
    of every lane.  On the card one cuSOLVER getrf per lane without
    pivots (torch.linalg.lu_factor_ex(pivot=False)), whose packed output
    is this layout already: one library call instead of nb - 1 launched
    rank-1 steps.  PyTorch has no pivot-free LU on the CPU, so there the
    plain version is the Doolittle loop of the reference (_getrf_np), on
    a copy."""
    refuse_tf32(a, "k_getrf_nopiv")
    if a.is_cuda:
        return torch.linalg.lu_factor_ex(a, pivot=False).LU
    a = a.clone()
    n = a.shape[-1]
    for i in range(n - 1):
        a[:, i + 1:, i] /= a[:, i:i + 1, i]
        a[:, i + 1:, i + 1:] -= a[:, i + 1:, i:i + 1] * a[:, i:i + 1, i + 1:]
    return a


def k_trsm_l(t, c):
    """Row panel: L[k,k]^-1 C with unit-diagonal L."""
    refuse_tf32(c, "k_trsm_l")
    return torch.linalg.solve_triangular(t, c, upper=False,
                                         unitriangular=True)


def k_trsm_u(t, c):
    """Column panel: C U[k,k]^-1 (non-unit upper)."""
    refuse_tf32(c, "k_trsm_u")
    return torch.linalg.solve_triangular(t, c, upper=True, left=False)


def k_gemm_lu(a, b, c):
    """C - A B."""
    refuse_tf32(c, "k_gemm_lu")
    return torch.baddbmm(c, a, b, alpha=-1)


def _getrf_np(a):
    """Numpy Doolittle, in place (float32/float64 tile)."""
    n = a.shape[0]
    for i in range(n - 1):
        a[i + 1:, i] /= a[i, i]
        a[i + 1:, i + 1:] -= np.outer(a[i + 1:, i], a[i, i + 1:])
    return a


def build_getrf_nopiv(ctx: pt.Context, A: TwoDimBlockCyclic,
                      dev: Optional[CudaDevice] = None,
                      name: str = "A") -> pt.Taskpool:
    """Build the LU-nopiv taskpool for square tiled `A` (registered with
    ctx under `name`)."""
    nt = A.mt
    assert A.mt == A.nt and A.mb == A.nb
    nb = A.mb
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    k, m, n = pt.L("k"), pt.L("m"), pt.L("n")
    NT = pt.G("NT")
    shp = (nb, nb)
    dt = A.dtype

    # ------------------------------------------------------------ GETRF(k)
    gf = tp.task_class("GETRF")
    gf.param("k", 0, NT)
    gf.affinity(name, k, k)
    gf.priority((NT - k) * 1000)
    gf.flow("T", "RW",
            pt.In(pt.Mem(name, k, k), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, k, k, flow="C")),
            pt.Out(pt.Ref("TRSM_L", k, pt.Range(k + 1, NT), flow="T"),
                   guard=(k < NT)),
            # NB: TRSM_U's declared param order is (k, m)
            pt.Out(pt.Ref("TRSM_U", k, pt.Range(k + 1, NT), flow="T"),
                   guard=(k < NT)),
            pt.Out(pt.Mem(name, k, k)))

    # --------------------------------------------------------- TRSM_L(k, n)
    tl = tp.task_class("TRSM_L")
    tl.param("k", 0, NT)
    tl.param("n", k + 1, NT)
    tl.affinity(name, k, n)
    tl.priority((NT - k) * 1000 - n)
    tl.flow("T", "READ", pt.In(pt.Ref("GETRF", k, flow="T")))
    tl.flow("C", "RW",
            pt.In(pt.Mem(name, k, n), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, k, n, flow="C")),
            pt.Out(pt.Ref("GEMM", k, pt.Range(k + 1, NT), n, flow="B")),
            pt.Out(pt.Mem(name, k, n)))

    # --------------------------------------------------------- TRSM_U(m, k)
    tu = tp.task_class("TRSM_U")
    tu.param("k", 0, NT)
    tu.param("m", k + 1, NT)
    tu.affinity(name, m, k)
    tu.priority((NT - k) * 1000 - m)
    tu.flow("T", "READ", pt.In(pt.Ref("GETRF", k, flow="T")))
    tu.flow("C", "RW",
            pt.In(pt.Mem(name, m, k), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, m, k, flow="C")),
            pt.Out(pt.Ref("GEMM", k, m, pt.Range(k + 1, NT), flow="A")),
            pt.Out(pt.Mem(name, m, k)))

    # -------------------------------------------------------- GEMM(k, m, n)
    ge = tp.task_class("GEMM")
    ge.param("k", 0, NT)
    ge.param("m", k + 1, NT)
    ge.param("n", k + 1, NT)
    ge.affinity(name, m, n)
    ge.priority((NT - k) * 1000 - m - n)
    ge.flow("A", "READ", pt.In(pt.Ref("TRSM_U", k, m, flow="C")))
    ge.flow("B", "READ", pt.In(pt.Ref("TRSM_L", k, n, flow="C")))
    ge.flow("C", "RW",
            pt.In(pt.Mem(name, m, n), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, m, n, flow="C")),
            pt.Out(pt.Ref("GETRF", k + 1, flow="T"),
                   guard=(m == k + 1) & (n == k + 1)),
            pt.Out(pt.Ref("TRSM_L", k + 1, n, flow="C"),
                   guard=(m == k + 1) & (n > k + 1)),
            pt.Out(pt.Ref("TRSM_U", k + 1, m, flow="C"),
                   guard=(m > k + 1) & (n == k + 1)),
            pt.Out(pt.Ref("GEMM", k + 1, m, n, flow="C"),
                   guard=(m > k + 1) & (n > k + 1)))

    # --------------------------------------------------------------- chores
    for d in as_device_list(dev):
        d.attach(gf, tp, kernel=k_getrf_nopiv, reads=["T"], writes=["T"],
                 shapes={"T": shp}, dtype=dt)
        d.attach(tl, tp, kernel=k_trsm_l, reads=["T", "C"], writes=["C"],
                 shapes={"T": shp, "C": shp}, dtype=dt)
        d.attach(tu, tp, kernel=k_trsm_u, reads=["T", "C"], writes=["C"],
                 shapes={"T": shp, "C": shp}, dtype=dt)
        d.attach(ge, tp, kernel=k_gemm_lu, reads=["A", "B", "C"],
                 writes=["C"], shapes={"A": shp, "B": shp, "C": shp},
                 dtype=dt)

    def b_getrf(t):
        _getrf_np(t.data("T", dt, shp))

    def b_trsm_l(t):
        l = np.tril(t.data("T", dt, shp), -1) + np.eye(nb, dtype=dt)
        c = t.data("C", dt, shp)
        c[...] = np.linalg.solve(l, c)

    def b_trsm_u(t):
        u = np.triu(t.data("T", dt, shp))
        c = t.data("C", dt, shp)
        c[...] = np.linalg.solve(u.T, c.T).T

    def b_gemm(t):
        a = t.data("A", dt, shp)
        b = t.data("B", dt, shp)
        c = t.data("C", dt, shp)
        c -= a @ b

    gf.body(b_getrf)
    tl.body(b_trsm_l)
    tu.body(b_trsm_u)
    ge.body(b_gemm)
    return tp


def getrf_nopiv_reference(full: np.ndarray) -> np.ndarray:
    """Float64 no-pivot LU of the dense matrix, packed L\\U (oracle)."""
    a = full.astype(np.float64).copy()
    return _getrf_np(a)


def getrf_flops(N: int) -> float:
    return 2.0 * N ** 3 / 3.0


# ------------------------------------------------------ panel variant
# Same coarse right-looking shape as build_potrf_panels (one tall
# product per trailing-panel update, shared DAG in
# potrf._build_panel_factorization), LU math:
#   F(k)   : diag block -> packed L\U (Doolittle); rows below become
#            L_below = P_below U_kk^-1; rows ABOVE stay (they hold the
#            finalized U rows of earlier panels)
#   U(k,j) : u_kj = unit_lower_solve(L_kk, P_j[kblock]);
#            P_j[kblock] = u_kj; P_j[below] -= L_below @ u_kj


def k_panel_getrf(p, ks):
    """Returns (factored panel, ki): ki forwards the panel index to the
    U wave as data (U solves at row block k)."""
    refuse_tf32(p, "k_panel_getrf")
    nb = p.shape[2]
    rows = lane_rows(p, ks, nb)
    packed = k_getrf_nopiv(take_rows(p, rows))
    below = rows_from(p, rows[:, 0] + nb)
    # X U_kk = P_below, on the rows below the block only
    lb = torch.linalg.solve_triangular(packed.triu(),
                                       p.masked_fill(~below, 0),
                                       upper=True, left=False)
    out = torch.where(below, lb, p)
    return put_rows(out, rows, packed), ks.clone()


def k_panel_getrf_update(pk, ki, pj):
    refuse_tf32(pj, "k_panel_getrf_update")
    nb = pk.shape[2]
    rows = lane_rows(pk, ki, nb)
    ukj = torch.linalg.solve_triangular(take_rows(pk, rows),
                                        take_rows(pj, rows), upper=False,
                                        unitriangular=True)
    lmask = pk.masked_fill(~rows_from(pk, rows[:, 0] + nb), 0)
    return put_rows(torch.baddbmm(pj, lmask, ukj, alpha=-1), rows, ukj)


def _getrf_b_factor(nt, nb, pshp, dt):
    def b_factor(t):
        p = t.data("P", dt, pshp)
        kk = int(t.data("KS", np.int32, (1,))[0])
        t.data("KI", np.int32, (1,))[0] = kk
        off = kk * nb
        packed = _getrf_np(p[off:off + nb].copy())
        ukk = np.triu(packed)
        p[off + nb:] = np.linalg.solve(ukk.T, p[off + nb:].T).T
        p[off:off + nb] = packed
    return b_factor


def _getrf_b_update(nt, nb, pshp, dt):
    def b_update(t):
        pk_ = t.data("PK", dt, pshp)
        kk = int(t.data("KI", np.int32, (1,))[0])
        pj_ = t.data("PJ", dt, pshp)
        off = kk * nb
        lkk = np.tril(pk_[off:off + nb], -1) + np.eye(nb, dtype=dt)
        ukj = np.linalg.solve(lkk, pj_[off:off + nb])
        pj_[off + nb:] -= pk_[off + nb:] @ ukj
        pj_[off:off + nb] = ukj
    return b_update


def build_getrf_panels(ctx, A, dev=None, name: str = "A"):
    """Panel-granular no-pivot LU: the getrf analog of
    build_potrf_panels (same shared DAG; LU kernels/bodies).  Result
    layout per panel j: rows above j*nb = finalized U rows, the block =
    packed L\\U, rows below = L columns — assembling tril(,-1)+I and
    triu reproduces getrf_nopiv_reference's packed dense."""
    from .potrf import _build_panel_factorization
    return _build_panel_factorization(
        ctx, A, dev, name, k_panel_getrf, k_panel_getrf_update,
        _getrf_b_factor, _getrf_b_update, update_uses="k")

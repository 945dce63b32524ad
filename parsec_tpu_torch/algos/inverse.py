"""Tiled triangular inversion and SPD inverse — the DPLASMA inversion
chain (dtrtri + dlauum = dpotri, composed after dpotrf) as PTG taskpools.

  build_trtri : W = inv(L), L lower triangular (dtrtri_L role)
  build_lauum : C = W^T W, W lower triangular (dlauum role: the upper-
                times-lower product that finishes the SPD inverse)
  run_potri   : A^{-1} for SPD A = potrf -> trtri -> lauum (dpotri role)

Each stage writes a separate collection (no anti-dependencies, every
tile column of trtri independent: wide waves); the diagonal inverse is
computed once per diagonal tile (DIAG), every off-diagonal tile is a
batched product.  Port of parsec_tpu/algos/inverse.py; the device chores
are torch functions on [lanes, *tile] stacks.

Math (forward substitution by block column, W lower triangular):
  W[j][j] = inv(L[j][j])
  W[i][j] = -inv(L[i][i]) @ sum_{k=j..i-1} L[i][k] @ W[k][j]   (i > j)
LAUUM (lower result, i >= j):
  C[i][j] = sum_{k=max(i,j)..NT} W[k][i]^T @ W[k][j]
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
def k_tri_inv(t):
    """inv(tril(t)) for every lane (the solve reads t's lower triangle
    only, which is the reference's explicit tril)."""
    refuse_tf32(t, "k_tri_inv")
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    return torch.linalg.solve_triangular(t, eye.expand_as(t), upper=False)


def k_acc_ab(a, b, c):
    """c + a @ b."""
    refuse_tf32(c, "k_acc_ab")
    return torch.baddbmm(c, a, b)


def k_mul_ab(a, b):
    """a @ b (chain head: no accumulator)."""
    refuse_tf32(a, "k_mul_ab")
    return torch.matmul(a, b)


def k_neg_mul(d, s):
    """-(d @ s)."""
    refuse_tf32(s, "k_neg_mul")
    return torch.matmul(d, s).neg_()


def k_acc_atb(a, b, c):
    """c + a^T @ b."""
    refuse_tf32(c, "k_acc_atb")
    return torch.baddbmm(c, a.mT, b)


def trtri_flops(n: int) -> float:
    return n ** 3 / 3.0


def lauum_flops(n: int) -> float:
    return n ** 3 / 3.0


def build_trtri(ctx: pt.Context, L: TwoDimBlockCyclic,
                W: TwoDimBlockCyclic, dev: Optional[CudaDevice] = None,
                names=("L", "W")) -> pt.Taskpool:
    """W = inv(L) for lower-triangular L (square tiles, L.mt == L.nt).
    W is a same-geometry output collection; only its lower triangle is
    written (accumulators live in arena copies, not in W's tiles)."""
    assert L.mt == L.nt and L.mb == L.nb
    assert W.mt == L.mt and W.mb == L.mb
    nt, nb = L.mt, L.mb
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    i, j, k = pt.L("i"), pt.L("j"), pt.L("k")
    NT = pt.G("NT")
    ln, wn = names
    shp = (nb, nb)
    dt = L.dtype
    w_arena = f"trtri_w_{nb}_{np.dtype(dt).str}"
    ctx.register_arena(w_arena, nb * nb * np.dtype(dt).itemsize)

    # RdD(j): read L[j][j] AT L's distribution
    rd = tp.task_class("RdD")
    rd.param("j", 0, NT)
    rd.affinity(ln, j, j)
    rd.flow("T", "READ",
            pt.In(pt.Mem(ln, j, j)),
            pt.Out(pt.Ref("DIAG", j, flow="T")))
    rd.body_noop()

    # DIAG(j): W[j][j] = inv(L[j][j]); feeds row-j MULs (as the inverse)
    # and column-j chains (as W[j][j])
    dg = tp.task_class("DIAG")
    dg.param("j", 0, NT)
    dg.affinity(wn, j, j)
    dg.priority((NT - j) * 100)
    dg.flow("T", "READ", pt.In(pt.Ref("RdD", j, flow="T")))
    dg.flow("W", "W",
            pt.Out(pt.Ref("GEMM0", pt.Range(j + 1, NT), j, flow="B"),
                   guard=(j < NT)),
            pt.Out(pt.Ref("MUL", j, pt.Range(0, j - 1), flow="D"),
                   guard=(j > 0)),
            pt.Out(pt.Mem(wn, j, j)),
            arena=w_arena)

    # RdL(i, k): broadcast L[i][k] (i > k) to every product that uses it
    rl = tp.task_class("RdL")
    rl.param("k", 0, NT)
    rl.param("i", k + 1, NT)
    rl.affinity(ln, i, k)
    rl.flow("A", "READ",
            pt.In(pt.Mem(ln, i, k)),
            pt.Out(pt.Ref("GEMM0", i, k, flow="A")),
            pt.Out(pt.Ref("GEMM", i, pt.Range(0, k - 1), k, flow="A"),
                   guard=(k > 0)))
    rl.body_noop()

    # GEMM0(i, j): S = L[i][j] @ W[j][j] — the chain head.  The
    # accumulator lives in arena copies, NEVER in the W(i,j) tile itself:
    # MUL also writes that tile
    g0 = tp.task_class("GEMM0")
    g0.param("i", 1, NT)
    g0.param("j", 0, i - 1)
    g0.affinity(wn, i, j)
    g0.priority((NT - j) * 100 - i)
    g0.flow("A", "READ", pt.In(pt.Ref("RdL", j, i, flow="A")))
    g0.flow("B", "READ", pt.In(pt.Ref("DIAG", j, flow="W")))
    g0.flow("C", "W",
            pt.Out(pt.Ref("GEMM", i, j, j + 1, flow="C"),
                   guard=(i > j + 1)),
            pt.Out(pt.Ref("MUL", i, j, flow="S"), guard=(i == j + 1)),
            arena=w_arena)

    # GEMM(i, j, k): S[i][j] += L[i][k] @ W[k][j]   (j < k < i)
    ge = tp.task_class("GEMM")
    ge.param("i", 2, NT)
    ge.param("j", 0, i - 2)
    ge.param("k", j + 1, i - 1)
    ge.affinity(wn, i, j)
    ge.priority((NT - j) * 100 - i)
    ge.flow("A", "READ", pt.In(pt.Ref("RdL", k, i, flow="A")))
    ge.flow("B", "READ", pt.In(pt.Ref("MUL", k, j, flow="W")))
    ge.flow("C", "RW",
            pt.In(pt.Ref("GEMM0", i, j, flow="C"), guard=(k == j + 1)),
            pt.In(pt.Ref("GEMM", i, j, k - 1, flow="C")),
            pt.Out(pt.Ref("MUL", i, j, flow="S"), guard=(k == i - 1)),
            pt.Out(pt.Ref("GEMM", i, j, k + 1, flow="C"),
                   guard=(k < i - 1)))

    # MUL(i, j): W[i][j] = -inv(L[i][i]) @ S[i][j]   (i > j)
    mu = tp.task_class("MUL")
    mu.param("i", 1, NT)
    mu.param("j", 0, i - 1)
    mu.affinity(wn, i, j)
    mu.priority((NT - j) * 100 - i)
    mu.flow("D", "READ", pt.In(pt.Ref("DIAG", i, flow="W")))
    mu.flow("S", "READ",
            pt.In(pt.Ref("GEMM0", i, j, flow="C"), guard=(i == j + 1)),
            pt.In(pt.Ref("GEMM", i, j, i - 1, flow="C"),
                  guard=(i > j + 1)))
    mu.flow("W", "W",
            pt.Out(pt.Ref("GEMM", pt.Range(i + 1, NT), j, i, flow="B"),
                   guard=(i < NT)),
            pt.Out(pt.Mem(wn, i, j)),
            arena=w_arena)

    for d in as_device_list(dev):
        d.attach(dg, tp, kernel=k_tri_inv, reads=["T"], writes=["W"],
                 shapes={"T": shp, "W": shp}, dtype=dt)
        d.attach(g0, tp, kernel=k_mul_ab, reads=["A", "B"], writes=["C"],
                 shapes={"A": shp, "B": shp, "C": shp}, dtype=dt)
        d.attach(ge, tp, kernel=k_acc_ab, reads=["A", "B", "C"],
                 writes=["C"], shapes={"A": shp, "B": shp, "C": shp},
                 dtype=dt)
        d.attach(mu, tp, kernel=k_neg_mul, reads=["D", "S"], writes=["W"],
                 shapes={"D": shp, "S": shp, "W": shp}, dtype=dt)

    def b_diag(t):
        a = np.tril(t.data("T", dt, shp))
        w = t.data("W", dt, shp)
        w[...] = np.linalg.solve(a, np.eye(nb, dtype=dt))

    def b_gemm0(t):
        a = t.data("A", dt, shp)
        b = t.data("B", dt, shp)
        c = t.data("C", dt, shp)
        c[...] = a @ b

    def b_gemm(t):
        a = t.data("A", dt, shp)
        b = t.data("B", dt, shp)
        c = t.data("C", dt, shp)
        c += a @ b

    def b_mul(t):
        d = t.data("D", dt, shp)
        s = t.data("S", dt, shp)
        w = t.data("W", dt, shp)
        w[...] = -(d @ s)

    dg.body(b_diag)
    g0.body(b_gemm0)
    ge.body(b_gemm)
    mu.body(b_mul)
    return tp


def build_lauum(ctx: pt.Context, W: TwoDimBlockCyclic,
                C: TwoDimBlockCyclic, dev: Optional[CudaDevice] = None,
                names=("W", "C")) -> pt.Taskpool:
    """C = W^T @ W (lower triangle) for lower-triangular W — the dlauum
    role finishing the SPD inverse.  C must be ZERO-initialized; only
    its lower triangle is written."""
    assert W.mt == W.nt and W.mb == W.nb
    assert C.mt == W.mt and C.mb == W.mb
    nt, nb = W.mt, W.mb
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    i, j, k = pt.L("i"), pt.L("j"), pt.L("k")
    NT = pt.G("NT")
    wn, cn = names
    shp = (nb, nb)
    dt = W.dtype

    # RdW(k, i): broadcast W[k][i] (k >= i) to its products: the LEFT
    # operand of row i (any j <= i) and the RIGHT operand of column i
    # (any row i' with i <= i' <= k)
    rw = tp.task_class("RdW")
    rw.param("i", 0, NT)
    rw.param("k", i, NT)
    rw.affinity(wn, k, i)
    rw.flow("W", "READ",
            pt.In(pt.Mem(wn, k, i)),
            pt.Out(pt.Ref("UPD", i, pt.Range(0, i), k, flow="A")),
            pt.Out(pt.Ref("UPD", pt.Range(i, k), i, k, flow="B")))
    rw.body_noop()

    # UPD(i, j, k): C[i][j] += W[k][i]^T @ W[k][j]   (j <= i <= k)
    up = tp.task_class("UPD")
    up.param("i", 0, NT)
    up.param("j", 0, i)
    up.param("k", i, NT)
    up.affinity(cn, i, j)
    up.priority((NT - j) * 100 - i)
    up.flow("A", "READ", pt.In(pt.Ref("RdW", i, k, flow="W")))
    up.flow("B", "READ", pt.In(pt.Ref("RdW", j, k, flow="W")))
    up.flow("C", "RW",
            pt.In(pt.Mem(cn, i, j), guard=(k == i)),  # zero seed
            pt.In(pt.Ref("UPD", i, j, k - 1, flow="C")),
            pt.Out(pt.Ref("UPD", i, j, k + 1, flow="C"), guard=(k < NT)),
            pt.Out(pt.Mem(cn, i, j), guard=(k == NT)))

    for d in as_device_list(dev):
        d.attach(up, tp, kernel=k_acc_atb, reads=["A", "B", "C"],
                 writes=["C"], shapes={"A": shp, "B": shp, "C": shp},
                 dtype=dt)

    def b_upd(t):
        a = t.data("A", dt, shp)
        b = t.data("B", dt, shp)
        c = t.data("C", dt, shp)
        c += a.T @ b

    up.body(b_upd)
    return tp


def run_potri(ctx: pt.Context, A: TwoDimBlockCyclic,
              W: TwoDimBlockCyclic, C: TwoDimBlockCyclic,
              dev: Optional[CudaDevice] = None,
              names=("A", "W", "C")) -> None:
    """SPD inverse (dpotri role): A -> potrf in place -> W = inv(L) ->
    C = lower(A^{-1}) = W^T W.  W and C must be zero-initialized
    collections registered under names[1], names[2]."""
    from .potrf import build_potrf
    an, wn, cn = names
    tp = build_potrf(ctx, A, dev=dev, name=an)
    tp.run()
    tp.wait()
    tp = build_trtri(ctx, A, W, dev=dev, names=(an, wn))
    tp.run()
    tp.wait()
    tp = build_lauum(ctx, W, C, dev=dev, names=(wn, cn))
    tp.run()
    tp.wait()
    for d in as_device_list(dev):
        d.flush()

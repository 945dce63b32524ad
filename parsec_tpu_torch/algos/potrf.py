"""Tiled Cholesky factorization (lower) as a PTG taskpool — the DPLASMA
dpotrf_L dataflow (the BASELINE north-star workload), built from four task
classes over a 2D block-cyclic matrix:

  POTRF(k)    : diagonal tile factor        A[k,k] = chol(A[k,k])
  TRSM(m,k)   : panel solve                 A[m,k] = A[m,k] inv(L[k,k])^T
  SYRK(k,m)   : diagonal trailing update    A[m,m] -= A[m,k] A[m,k]^T
  GEMM(m,n,k) : off-diag trailing update    A[m,n] -= A[m,k] A[n,k]^T

plus the panel-granular variant (build_potrf_panels) and its solve
(build_potrs_panels).  Port of parsec_tpu/algos/potrf.py: the same DAGs,
priorities and numpy host bodies; the device chores are torch functions
on [lanes, *tile] stacks (cuSOLVER's batched Cholesky and triangular
solve, cuBLAS's batched products — none of the reference's chores is a
Pallas kernel).  A chore never writes an input stack: an input may be a
cached mirror, a row slice of another launch's output or a lane-stride-0
view that every lane reads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic, VectorCyclic
from ..device.cuda import CudaDevice
from ._util import (as_device_list, lane_rows, put_rows, refuse_tf32,
                    rows_from, take_rows)


def _eye_like(t: torch.Tensor) -> torch.Tensor:
    """The identity broadcast over t's lanes ([lanes, nb, nb], stride 0)."""
    return torch.eye(t.shape[-1], dtype=t.dtype,
                     device=t.device).expand_as(t)


# ---------------------------------------------------------------- kernels
def k_potrf(t):
    """[lanes, nb, nb] -> lower Cholesky factors (zeros above).  The _ex
    form checks no info flag, so it never syncs with the stream; a
    non-SPD tile leaves NaNs, as the reference's jnp.linalg.cholesky."""
    refuse_tf32(t, "k_potrf")
    return torch.linalg.cholesky_ex(t).L


def k_trsm(l, c):
    """X L^T = C for every lane."""
    refuse_tf32(c, "k_trsm")
    return torch.linalg.solve_triangular(l.mT, c, upper=True, left=False)


def k_potrf_inv(t):
    """POTRF that also emits inv(L): one triangular solve per panel turns
    every TRSM of the panel's wave into a batched product (k_trsm_mm)."""
    refuse_tf32(t, "k_potrf_inv")
    l = torch.linalg.cholesky_ex(t).L
    return l, torch.linalg.solve_triangular(l, _eye_like(l), upper=False)


def k_trsm_mm(linv, c):
    """TRSM as a product: X L^T = C  ->  X = C inv(L)^T."""
    refuse_tf32(c, "k_trsm_mm")
    return torch.matmul(c, linv.mT)


def k_syrk(a, t):
    """T - A A^T."""
    refuse_tf32(t, "k_syrk")
    return torch.baddbmm(t, a, a.mT, alpha=-1)


def k_gemm(a, b, c):
    """C - A B^T."""
    refuse_tf32(c, "k_gemm")
    return torch.baddbmm(c, a, b.mT, alpha=-1)


def build_potrf(ctx: pt.Context, A: TwoDimBlockCyclic,
                dev: Optional[CudaDevice] = None,
                name: str = "A",
                trsm_via_inverse: bool = True) -> pt.Taskpool:
    """Build the Cholesky taskpool for the square tiled SPD matrix `A`
    (registered with ctx under `name`).  A.mt == A.nt required.

    trsm_via_inverse (default): POTRF(k) additionally emits inv(L[k,k])
    through a W temp flow and TRSM becomes a batched product against it.
    Set False for the textbook triangular-solve dataflow."""
    nt = A.mt
    assert A.mt == A.nt and A.mb == A.nb
    nb = A.mb
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    k, m, n = pt.L("k"), pt.L("m"), pt.L("n")
    NT = pt.G("NT")
    shp = (nb, nb)
    dt = A.dtype
    if trsm_via_inverse:
        li_arena = f"potrf_li_{nb}_{np.dtype(dt).str}"
        if li_arena not in ctx.arenas:  # re-builds must not leak an id
            ctx.register_arena(li_arena, nb * nb * np.dtype(dt).itemsize)

    # ------------------------------------------------------------- POTRF(k)
    po = tp.task_class("POTRF")
    po.param("k", 0, NT)
    po.affinity(name, k, k)
    po.priority((NT - k) * 1000)
    if trsm_via_inverse:
        po.flow("T", "RW",
                pt.In(pt.Mem(name, k, k), guard=(k == 0)),
                pt.In(pt.Ref("SYRK", k - 1, k, flow="T")),
                pt.Out(pt.Mem(name, k, k)))
        # the panel inverse: consumed by every TRSM in this panel's wave
        po.flow("I", "W",
                pt.Out(pt.Ref("TRSM", k, pt.Range(k + 1, NT), flow="L"),
                       guard=(k < NT)),
                arena=li_arena)
    else:
        po.flow("T", "RW",
                pt.In(pt.Mem(name, k, k), guard=(k == 0)),
                pt.In(pt.Ref("SYRK", k - 1, k, flow="T")),
                pt.Out(pt.Ref("TRSM", k, pt.Range(k + 1, NT), flow="L"),
                       guard=(k < NT)),
                pt.Out(pt.Mem(name, k, k)))

    # ----------------------------------------------------------- TRSM(m, k)
    tr = tp.task_class("TRSM")
    tr.param("k", 0, NT)
    tr.param("m", k + 1, NT)
    tr.affinity(name, m, k)
    tr.priority((NT - k) * 1000 - m)
    tr.flow("L", "READ",
            pt.In(pt.Ref("POTRF", k, flow="I" if trsm_via_inverse
                         else "T")))
    # NB: GEMM's declared param order is (k, m, n) — Refs must match it
    tr.flow("C", "RW",
            pt.In(pt.Mem(name, m, k), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, m, k, flow="C")),
            # SYRK(k, m) updates diagonal (m, m) with this panel
            pt.Out(pt.Ref("SYRK", k, m, flow="A")),
            # GEMM row m: A[m, n] for k < n < m uses this as the A operand
            pt.Out(pt.Ref("GEMM", k, m, pt.Range(k + 1, m - 1), flow="A"),
                   guard=(m > k + 1)),
            # GEMM column m: A[mm, m] for m < mm <= NT uses it as B operand
            pt.Out(pt.Ref("GEMM", k, pt.Range(m + 1, NT), m, flow="B"),
                   guard=(m < NT)),
            pt.Out(pt.Mem(name, m, k)))

    # ----------------------------------------------------------- SYRK(k, m)
    sy = tp.task_class("SYRK")
    sy.param("k", 0, NT)
    sy.param("m", k + 1, NT)
    sy.affinity(name, m, m)
    sy.priority((NT - k) * 1000 - m)
    sy.flow("A", "READ", pt.In(pt.Ref("TRSM", k, m, flow="C")))
    sy.flow("T", "RW",
            pt.In(pt.Mem(name, m, m), guard=(k == 0)),
            pt.In(pt.Ref("SYRK", k - 1, m, flow="T")),
            pt.Out(pt.Ref("POTRF", m, flow="T"), guard=(m == k + 1)),
            pt.Out(pt.Ref("SYRK", k + 1, m, flow="T"), guard=(m > k + 1)))

    # -------------------------------------------------------- GEMM(m, n, k)
    ge = tp.task_class("GEMM")
    ge.param("k", 0, NT)
    ge.param("m", k + 2, NT)
    ge.param("n", k + 1, m - 1)
    ge.affinity(name, m, n)
    ge.priority((NT - k) * 1000 - m - n)
    ge.flow("A", "READ", pt.In(pt.Ref("TRSM", k, m, flow="C")))
    ge.flow("B", "READ", pt.In(pt.Ref("TRSM", k, n, flow="C")))
    ge.flow("C", "RW",
            pt.In(pt.Mem(name, m, n), guard=(k == 0)),
            pt.In(pt.Ref("GEMM", k - 1, m, n, flow="C")),
            pt.Out(pt.Ref("TRSM", n, m, flow="C"), guard=(n == k + 1)),
            pt.Out(pt.Ref("GEMM", k + 1, m, n, flow="C"), guard=(n > k + 1)))

    # --------------------------------------------------------------- chores
    # one or several devices: each attach adds a device chore; the native
    # best-device routing spreads task instances over their queues
    for d in as_device_list(dev):
        if trsm_via_inverse:
            d.attach(po, tp, kernel=k_potrf_inv, reads=["T"],
                     writes=["T", "I"], shapes={"T": shp, "I": shp},
                     dtype=dt)
            d.attach(tr, tp, kernel=k_trsm_mm, reads=["L", "C"],
                     writes=["C"], shapes={"L": shp, "C": shp}, dtype=dt)
        else:
            d.attach(po, tp, kernel=k_potrf, reads=["T"], writes=["T"],
                     shapes={"T": shp}, dtype=dt)
            d.attach(tr, tp, kernel=k_trsm, reads=["L", "C"],
                     writes=["C"], shapes={"L": shp, "C": shp}, dtype=dt)
        d.attach(sy, tp, kernel=k_syrk, reads=["A", "T"], writes=["T"],
                 shapes={"A": shp, "T": shp}, dtype=dt)
        d.attach(ge, tp, kernel=k_gemm, reads=["A", "B", "C"], writes=["C"],
                 shapes={"A": shp, "B": shp, "C": shp}, dtype=dt)

    def b_potrf(t):
        a = t.data("T", dt, shp)
        a[...] = np.linalg.cholesky(a)
        if trsm_via_inverse:
            li = t.data("I", dt, shp)
            li[...] = np.linalg.solve(a, np.eye(nb, dtype=dt))

    def b_trsm(t):
        l = t.data("L", dt, shp)  # inv(L) when trsm_via_inverse
        c = t.data("C", dt, shp)
        if trsm_via_inverse:
            c[...] = c @ l.T
        else:
            # X L^T = C -> X = (L^-1 C^T)^T ; use lapack-free solve
            c[...] = np.linalg.solve(l, c.T).T

    def b_syrk(t):
        a = t.data("A", dt, shp)
        x = t.data("T", dt, shp)
        x -= a @ a.T

    def b_gemm(t):
        a = t.data("A", dt, shp)
        b = t.data("B", dt, shp)
        c = t.data("C", dt, shp)
        c -= a @ b.T

    po.body(b_potrf, pure=True)
    tr.body(b_trsm, pure=True)
    sy.body(b_syrk, pure=True)
    ge.body(b_gemm, pure=True)
    return tp


# ------------------------------------------------------ panel variant
# Right-looking blocked Cholesky at PANEL granularity: tasks operate on
# full-height N x nb column panels instead of nb x nb tiles.  Same math
# as the tiled dataflow, coarser tasks: each trailing update U(k, j) is
# ONE (N x nb) @ (nb x nb) product, and a wave of them is one batched
# launch.
#
#   F(k)   : factor panel k   diag = chol(P[kb:kb+nb]); P = P inv(L)^T
#            (rows above kb zeroed, diag block set to L exactly)
#   U(k,j) : panel j trailing update   P_j -= P_k P_k[jb:jb+nb]^T
#
# Panel row offsets ride a tiny int32 index collection: the offset is
# data that arrives on the device as a [lanes, 1] flow, and lanes of one
# launch may carry different offsets.


def k_panel_factor(p, ks):
    refuse_tf32(p, "k_panel_factor")
    nb = p.shape[2]
    rows = lane_rows(p, ks, nb)
    l = torch.linalg.cholesky_ex(take_rows(p, rows)).L
    linv = torch.linalg.solve_triangular(l, _eye_like(l), upper=False)
    x = torch.matmul(p, linv.mT)
    x.masked_fill_(~rows_from(x, rows[:, 0]), 0)
    return put_rows(x, rows, l)


def k_panel_update(pk, js, pj):
    refuse_tf32(pj, "k_panel_update")
    rows = lane_rows(pk, js, pk.shape[2])
    return torch.baddbmm(pj, pk, take_rows(pk, rows).mT, alpha=-1)


def _register_pidx(ctx: pt.Context, A: TwoDimBlockCyclic, name: str):
    """Register (once) the int32 panel-index collection `name + "_pidx"`
    following A's panel-cyclic map, so every Mem(pidx, j) read is
    co-located with the task that issues it."""
    pidx_name = name + "_pidx"
    # guard on OUR registry, not ctx.collections: a user collection that
    # happens to be named <name>_pidx must not satisfy the early return
    if pidx_name in getattr(ctx, "_pidx_colls", {}):
        return pidx_name, ctx._pidx_colls[pidx_name]
    if pidx_name in ctx.collections:
        raise ValueError(
            f"collection name {pidx_name!r} is reserved for the panel "
            f"index of {name!r} but is already registered")
    pidx = VectorCyclic(A.nt, 1, nodes=A.nodes, myrank=A.myrank,
                        dtype=np.int32)
    for j in range(A.nt):
        pidx.seg(j)[0] = j
    pidx.register(ctx, pidx_name)
    if not hasattr(ctx, "_pidx_colls"):
        ctx._pidx_colls = {}
    ctx._pidx_colls[pidx_name] = pidx
    return pidx_name, pidx


def _build_panel_factorization(ctx: pt.Context, A: TwoDimBlockCyclic,
                               dev, name: str,
                               k_factor, k_update,
                               b_factor, b_update,
                               update_uses: str = "j") -> pt.Taskpool:
    """Shared panel-factorization DAG (right-looking, full-height
    panels): F(k) factors panel k, U(k, j) applies its rank-nb update to
    panel j, a U wave batches into one launch.  Cholesky
    (build_potrf_panels) and no-pivot LU (build_getrf_panels) share it.

      F(k)   : P RW (chain from U(k-1,k)), KS index READ
      U(k,j) : PK READ (broadcast from F(k)), an index flow, PJ RW chain

    update_uses selects which panel index U's kernel needs:
      "j" — the TARGET panel's index, read co-located from the pidx
            collection (Cholesky slices the source panel at row block j)
      "k" — the SOURCE panel's index; F(k) emits it as a tiny KI arena
            flow that broadcasts with the panel (LU solves at row block
            k).  k_factor then returns (panel, ki).

    Host bodies are built by b_factor/b_update factories given
    (nt, nb, pshp, dt)."""
    assert A.mt == 1 and A.M == A.N and A.M == A.mb, \
        "panel collection: mb == M (one block row of panels)"
    assert A.P == 1, "panels distribute 1-D: P must be 1 (Q = nodes)"
    nt = A.nt
    nb = A.nb
    NN = A.M
    dt = A.dtype
    pidx_name, pidx = _register_pidx(ctx, A, name)
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    k, j = pt.L("k"), pt.L("j")
    NT = pt.G("NT")

    # ------------------------------------------------------------- F(k)
    fa = tp.task_class("PF")
    fa.param("k", 0, NT)
    fa.affinity(name, 0, k)
    fa.priority((NT - k) * 1000 + 500)
    fa.flow("P", "RW",
            pt.In(pt.Mem(name, 0, k), guard=(k == 0)),
            pt.In(pt.Ref("PU", k - 1, k, flow="PJ")),
            pt.Out(pt.Ref("PU", k, pt.Range(k + 1, NT), flow="PK"),
                   guard=(k < NT)),
            pt.Out(pt.Mem(name, 0, k)))
    fa.flow("KS", "READ", pt.In(pt.Mem(pidx_name, k)))
    if update_uses == "k":
        ki_arena = f"panel_ki_{name}"
        if ki_arena not in ctx.arenas:  # re-builds must not leak an id
            ctx.register_arena(ki_arena, 4)
        fa.flow("KI", "W",
                pt.Out(pt.Ref("PU", k, pt.Range(k + 1, NT), flow="KI"),
                       guard=(k < NT)),
                arena=ki_arena)

    # ----------------------------------------------------------- U(k, j)
    up = tp.task_class("PU")
    up.param("k", 0, NT)
    up.param("j", k + 1, NT)
    up.affinity(name, 0, j)
    up.priority((NT - k) * 1000 - j)
    up.flow("PK", "READ", pt.In(pt.Ref("PF", k, flow="P")))
    if update_uses == "k":
        up.flow("KI", "READ", pt.In(pt.Ref("PF", k, flow="KI")))
    else:
        up.flow("JS", "READ", pt.In(pt.Mem(pidx_name, j)))
    up.flow("PJ", "RW",
            pt.In(pt.Mem(name, 0, j), guard=(k == 0)),
            pt.In(pt.Ref("PU", k - 1, j, flow="PJ")),
            pt.Out(pt.Ref("PF", j, flow="P"), guard=(j == k + 1)),
            pt.Out(pt.Ref("PU", k + 1, j, flow="PJ"), guard=(j > k + 1)))

    # --------------------------------------------------------------- chores
    pshp = (NN, nb)
    # pre-stage this rank's index segments as ONE stacked device tensor
    # per device: every wave's KS/JS gather is then a row slice of it
    local = [k2 for k2 in range(nt) if pidx.rank_of(k2) == pidx.myrank]
    seg_host = np.asarray(local, dtype=np.int32).reshape(-1, 1)
    for d in as_device_list(dev):
        if local:
            from ..device.bench_utils import install_device_segments
            install_device_segments(d, pidx, d._h2d_ahead(seg_host)[0])
        idxf = "KI" if update_uses == "k" else "JS"
        d.attach(fa, tp, kernel=k_factor, reads=["P", "KS"],
                 writes=["P", "KI"] if update_uses == "k" else ["P"],
                 shapes={"P": pshp, "KS": (1,), "KI": (1,)},
                 dtypes={"P": np.dtype(dt), "KS": np.dtype(np.int32),
                         "KI": np.dtype(np.int32)})
        d.attach(up, tp, kernel=k_update, reads=["PK", idxf, "PJ"],
                 writes=["PJ"],
                 shapes={"PK": pshp, idxf: (1,), "PJ": pshp},
                 dtypes={"PK": np.dtype(dt), idxf: np.dtype(np.int32),
                         "PJ": np.dtype(dt)})
        # speculative epilogue: the U(k, k+1) lane's output IS F(k+1)'s
        # input — factor it right after the wave's launch, so F(k+1)
        # completes from the parked result, version-checked.  potrf's
        # factor returns the panel; getrf's returns (panel, KI), matching
        # its two write flows
        d.attach_epilogue(
            up, fa, tp, src_flow="PJ", dst_in_flow="P",
            pick=lambda v: ((v.local("j"),)
                            if v.local("j") == v.local("k") + 1
                            else None),
            dst_params=lambda v: (v.local("k"),),
            kernel=k_factor,
            ops=lambda key: [np.asarray([key[0]], dtype=np.int32)],
            # KS is the pivot-index flow: constant per k and folded into
            # ops (single-varying-input contract, see attach_epilogue)
            const_flows=("KS",))

    fa.body(b_factor(nt, nb, pshp, dt))
    up.body(b_update(nt, nb, pshp, dt))
    return tp


def _potrf_b_factor(nt, nb, pshp, dt):
    def b_factor(t):
        p = t.data("P", dt, pshp)
        kk = int(t.data("KS", np.int32, (1,))[0])
        off = kk * nb
        diag = p[off:off + nb]
        l = np.linalg.cholesky(diag)
        linv = np.linalg.solve(l, np.eye(nb, dtype=dt))
        x = p @ linv.T
        x[:off] = 0
        x[off:off + nb] = l
        p[...] = x
    return b_factor


def _potrf_b_update(nt, nb, pshp, dt):
    def b_update(t):
        pk_ = t.data("PK", dt, pshp)
        jj = int(t.data("JS", np.int32, (1,))[0])
        pj_ = t.data("PJ", dt, pshp)
        off = jj * nb
        pj_ -= pk_ @ pk_[off:off + nb].T
    return b_update


def build_potrf_panels(ctx: pt.Context, A: TwoDimBlockCyclic,
                       dev: Optional[CudaDevice] = None,
                       name: str = "A") -> pt.Taskpool:
    """Panel-granular Cholesky taskpool.  `A` must be a single block row
    of N x nb panels: TwoDimBlockCyclic(N, N, N, nb) registered under
    `name`.  Also registers an int32 index collection under
    `name + "_pidx"`."""
    return _build_panel_factorization(
        ctx, A, dev, name, k_panel_factor, k_panel_update,
        _potrf_b_factor, _potrf_b_update)


def k_panel_fwd(p, ks, b):
    """Forward-substitution step on the whole RHS block: solve the
    diagonal rows against L_kk, then eliminate below."""
    refuse_tf32(b, "k_panel_fwd")
    nb = p.shape[2]
    rows = lane_rows(p, ks, nb)
    yk = torch.linalg.solve_triangular(take_rows(p, rows),
                                       take_rows(b, rows), upper=False)
    # rows above the block keep their solved values; the block row takes
    # y_k; rows below take the eliminated update
    out = torch.where(rows_from(b, rows[:, 0] + nb),
                      torch.baddbmm(b, p, yk, alpha=-1), b)
    return put_rows(out, rows, yk)


def k_panel_bwd(p, ks, b):
    """Backward-substitution step: x_k = L_kk^-T (y_k - L_below^T x_below)."""
    refuse_tf32(b, "k_panel_bwd")
    nb = p.shape[2]
    rows = lane_rows(p, ks, nb)
    # only the already-solved x rows BELOW the block contribute
    xbelow = b.masked_fill(~rows_from(b, rows[:, 0] + nb), 0)
    contrib = torch.matmul(p.mT, xbelow)
    xk = torch.linalg.solve_triangular(take_rows(p, rows).mT,
                                       take_rows(b, rows) - contrib,
                                       upper=True)
    return put_rows(b.clone(), rows, xk)


def build_potrs_panels(ctx: pt.Context, A: TwoDimBlockCyclic, B,
                       dev: Optional[CudaDevice] = None,
                       name: str = "A", bname: str = "B") -> pt.Taskpool:
    """Panel-granular triangular solve after build_potrf_panels (the
    dpotrs role; potrf_panels + potrs_panels = posv).  `A` holds the
    factored panels (same collection the factorization ran on); `B` is a
    single-tile (N, nrhs) collection registered under `bname`.  Forward
    substitution walks panels 0..NT-1, backward NT-1..0 — 2*NT tasks.
    Single-rank form."""
    assert A.mt == 1 and A.M == A.mb
    assert A.nodes == 1, \
        "potrs_panels is the single-rank solve (distributed: algos/trsm.py)"
    nt = A.nt
    nb = A.nb
    NN = A.M
    dt = A.dtype
    nrhs = B.nb
    assert B.mt == 1 and B.nt == 1 and B.mb == NN
    assert B.dtype == A.dtype, "A and B dtypes must match"
    pidx_name, _ = _register_pidx(ctx, A, name)
    tp = pt.Taskpool(ctx, globals={"NT": nt - 1})
    k = pt.L("k")
    NT = pt.G("NT")

    fw = tp.task_class("FWD")
    fw.param("k", 0, NT)
    fw.affinity(bname, 0, 0)
    fw.flow("P", "READ", pt.In(pt.Mem(name, 0, k)))
    fw.flow("KS", "READ", pt.In(pt.Mem(pidx_name, k)))
    fw.flow("B", "RW",
            pt.In(pt.Mem(bname, 0, 0), guard=(k == 0)),
            pt.In(pt.Ref("FWD", k - 1, flow="B")),
            pt.Out(pt.Ref("FWD", k + 1, flow="B"), guard=(k < NT)),
            pt.Out(pt.Ref("BWD", NT, flow="B"), guard=(k == NT)))

    bw = tp.task_class("BWD")
    bw.param("k", 0, NT)
    bw.affinity(bname, 0, 0)
    bw.flow("P", "READ", pt.In(pt.Mem(name, 0, k)))
    bw.flow("KS", "READ", pt.In(pt.Mem(pidx_name, k)))
    bw.flow("B", "RW",
            pt.In(pt.Ref("FWD", NT, flow="B"), guard=(k == NT)),
            pt.In(pt.Ref("BWD", k + 1, flow="B"), guard=(k < NT)),
            pt.Out(pt.Ref("BWD", k - 1, flow="B"), guard=(k > 0)),
            pt.Out(pt.Mem(bname, 0, 0), guard=(k == 0)))

    pshp, bshp = (NN, nb), (NN, nrhs)
    for d in as_device_list(dev):
        d.attach(fw, tp, kernel=k_panel_fwd, reads=["P", "KS", "B"],
                 writes=["B"], shapes={"P": pshp, "KS": (1,), "B": bshp},
                 dtypes={"P": np.dtype(dt), "KS": np.dtype(np.int32),
                         "B": np.dtype(dt)}, sync_mem_out=True)
        d.attach(bw, tp, kernel=k_panel_bwd, reads=["P", "KS", "B"],
                 writes=["B"], shapes={"P": pshp, "KS": (1,), "B": bshp},
                 dtypes={"P": np.dtype(dt), "KS": np.dtype(np.int32),
                         "B": np.dtype(dt)}, sync_mem_out=True)

    def b_fwd(t):
        p = t.data("P", dt, pshp)
        kk = int(t.data("KS", np.int32, (1,))[0])
        b = t.data("B", dt, bshp)
        off = kk * nb
        yk = np.linalg.solve(p[off:off + nb], b[off:off + nb])
        b[off:off + nb] = yk
        b[off + nb:] -= p[off + nb:] @ yk

    def b_bwd(t):
        p = t.data("P", dt, pshp)
        kk = int(t.data("KS", np.int32, (1,))[0])
        b = t.data("B", dt, bshp)
        off = kk * nb
        lkk = p[off:off + nb]
        contrib = p[off + nb:].T @ b[off + nb:]
        b[off:off + nb] = np.linalg.solve(lkk.T, b[off:off + nb] - contrib)

    fw.body(b_fwd)
    bw.body(b_bwd)
    return tp


def run_potrf(ctx, A, dev=None):
    tp = build_potrf(ctx, A, dev)
    tp.run()
    tp.wait()
    for d in as_device_list(dev):
        d.flush()


def potrf_flops(N: int) -> float:
    return N ** 3 / 3.0 + N ** 2 / 2.0 + N / 6.0

"""Tiled GEMM as a PTG taskpool over a 2D block-cyclic distribution.

C(m,n) += sum_k A(m,k) @ B(k,n): each Gemm(m,n,k) task carries the C tile
through a k-chain (owner-computes on C's placement), reading A/B tiles from
their collections.  Port of parsec_tpu/algos/gemm.py: build_gemm,
build_gemm_dist (the distributed builder, A/B moved by reader-task
broadcasts) and gemm_panel_reduce (the k-split GEMM with a cross-rank
panel reduction); with a CudaDevice a wave of Gemm tasks is one batched
product on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ..device.cuda import CudaDevice


def k_gemm_nn(a, b, c):
    """c + a @ b over lanes ([n, mb, kb] x [n, kb, nb]).  The reference
    computes this product outside any Pallas kernel (XLA's dot), so it
    stays a library product here.  TF32 is switched off explicitly: the
    product runs in full float32, like the reference's f32 accumulate.

    A lone lane runs as a two-lane call whose lane 0 is kept: on the
    card cuBLAS picks another algorithm for a one-lane batched product
    (a lone 512^2 tile fills 16 of 132 SMs), and a lane's bits would
    then depend on how many lanes its wave held.  The wider calls agree
    with each other bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.shape[0] == 1:
        a, b, c = (t.expand(2, -1, -1).contiguous() for t in (a, b, c))
        return torch.baddbmm(c, a, b)[:1]
    return torch.baddbmm(c, a, b)


def _gemm_class(tp, A, B, C, dev, cn, a_in, b_in):
    """The shared Gemm(m,n,k) class: owner-computes C k-chain; only the
    A/B input deps differ between the single-rank (collection reads) and
    distributed (reader-broadcast Refs) builders."""
    m, n, k = pt.L("m"), pt.L("n"), pt.L("k")
    g = tp.task_class("Gemm")
    g.param("m", 0, pt.G("MT"))
    g.param("n", 0, pt.G("NT"))
    g.param("k", 0, pt.G("KT"))
    g.affinity(cn, m, n)
    # deeper k first so the chain head is prioritized
    g.priority(pt.G("KT") - k)
    g.flow("A", "READ", a_in)
    g.flow("B", "READ", b_in)
    g.flow("C", "RW",
           pt.In(pt.Mem(cn, m, n), guard=(k == 0)),
           pt.In(pt.Ref("Gemm", m, n, k - 1, flow="C")),
           pt.Out(pt.Ref("Gemm", m, n, k + 1, flow="C"),
                  guard=(k < pt.G("KT"))),
           pt.Out(pt.Mem(cn, m, n), guard=(k == pt.G("KT"))))

    shp = {"A": (A.mb, A.nb), "B": (B.mb, B.nb), "C": (C.mb, C.nb)}
    if dev is not None:
        dev.attach(g, tp, kernel=k_gemm_nn, reads=["A", "B", "C"],
                   writes=["C"], shapes=shp, dtype=C.dtype)

    def cpu_body(t):
        a = t.data("A", C.dtype, shp["A"])
        b = t.data("B", C.dtype, shp["B"])
        c = t.data("C", C.dtype, shp["C"])
        c += a @ b

    g.body(cpu_body, pure=True)  # pure tile chore: fusion-eligible
    return g


def build_gemm(ctx: pt.Context, A: TwoDimBlockCyclic, B: TwoDimBlockCyclic,
               C: TwoDimBlockCyclic, dev: Optional[CudaDevice] = None,
               names=("A", "B", "C")) -> pt.Taskpool:
    """Build (but don't run) the GEMM taskpool.  Collections must already be
    registered with ctx under `names`."""
    mt, nt, kt = C.mt, C.nt, A.nt
    assert A.mt == mt and B.nt == nt and B.mt == kt
    tp = pt.Taskpool(ctx, globals={"MT": mt - 1, "NT": nt - 1, "KT": kt - 1})
    m, n, k = pt.L("m"), pt.L("n"), pt.L("k")
    an, bn, cn = names

    _gemm_class(tp, A, B, C, dev, cn,
                pt.In(pt.Mem(an, m, k)), pt.In(pt.Mem(bn, k, n)))
    return tp


def build_gemm_dist(ctx: pt.Context, A: TwoDimBlockCyclic,
                    B: TwoDimBlockCyclic, C: TwoDimBlockCyclic,
                    dev: Optional[CudaDevice] = None,
                    names=("A", "B", "C")) -> pt.Taskpool:
    """Distributed GEMM: owner-computes on C with A/B tiles moved by
    reader-task broadcasts placed AT their data.

    The single-rank builder reads A(m,k)/B(k,n) straight from the
    collections, which this runtime (deliberately) rejects cross-rank —
    memory reads must be affine with placement.  DPLASMA's answer is the
    one used here: ReadA(m,k) runs on A(m,k)'s owner and BROADCASTS the
    tile to the whole Gemm row m (all n at step k), ReadB(k,n) to the
    whole column — the reference's collective-propagation machinery
    carries the panels (remote_dep.c:39-47 bcast trees; dplasma gemm's
    read_A/read_B task classes).  Chain/binomial topologies apply via
    ctx.comm_set_topology."""
    mt, nt, kt = C.mt, C.nt, A.nt
    assert A.mt == mt and B.nt == nt and B.mt == kt
    tp = pt.Taskpool(ctx, globals={"MT": mt - 1, "NT": nt - 1, "KT": kt - 1})
    m, n, k = pt.L("m"), pt.L("n"), pt.L("k")
    an, bn, cn = names

    ra = tp.task_class("ReadA")
    ra.param("m", 0, pt.G("MT"))
    ra.param("k", 0, pt.G("KT"))
    ra.affinity(an, m, k)
    ra.flow("A", "READ",
            pt.In(pt.Mem(an, m, k)),
            pt.Out(pt.Ref("Gemm", m, pt.Range(0, pt.G("NT")), k,
                          flow="A")))
    ra.body_noop()

    rb = tp.task_class("ReadB")
    rb.param("k", 0, pt.G("KT"))
    rb.param("n", 0, pt.G("NT"))
    rb.affinity(bn, k, n)
    rb.flow("B", "READ",
            pt.In(pt.Mem(bn, k, n)),
            pt.Out(pt.Ref("Gemm", pt.Range(0, pt.G("MT")), n, k,
                          flow="B")))
    rb.body_noop()

    _gemm_class(tp, A, B, C, dev, cn,
                pt.In(pt.Ref("ReadA", m, k, flow="A")),
                pt.In(pt.Ref("ReadB", k, n, flow="B")))
    return tp


def run_gemm(ctx, A, B, C, dev=None) -> None:
    tp = build_gemm(ctx, A, B, C, dev)
    tp.run()
    tp.wait()
    if dev is not None:
        dev.flush()


def gemm_panel_reduce(ctx: pt.Context, a_slab: np.ndarray,
                      b_slab: np.ndarray, reduce: str = "coll",
                      topo=None, panel_rows: int = 0) -> np.ndarray:
    """k-split GEMM with a cross-rank panel reduction:
    C = sum_r a_slab_r @ b_slab_r, rank r holding k-slab r.  Returns the
    full C on every rank (all-reduce shape).

    reduce="coll": C is split into row panels and
    each Partial(r, p) feeds the runtime-native ptc_coll reduction the
    moment it completes — panel p's reduction (and its wire traffic)
    overlaps panel p+1's compute, so the collective starts after the
    FIRST panel, not the last (T3, arXiv:2401.16677).  Topology per the
    transfer-economics selector (PTC_MCA_coll_topo override).

    reduce="chain": the DAG-dependency baseline — each rank computes its
    WHOLE partial, a serial rank chain sums them, the result fans out —
    exactly how reductions were expressed before runtime-native
    collectives existed.  Bit-identical to "coll" on integer-valued
    inputs (both sum in rank order along their chains)."""
    from ..comm.coll import RefReduce, rank_affinity_collection

    M, _ = a_slab.shape
    Nc = b_slab.shape[1]
    R = max(1, ctx.nodes)
    if R == 1 or not ctx.comm_enabled:
        return (a_slab @ b_slab).astype(np.float32)
    if panel_rows <= 0:
        from ..utils import params as _mca
        q = _mca.get("coll.slice") or _mca.get("comm.chunk_size")
        panel_rows = max(1, min(M, int(q) // max(1, Nc * 4)))
    c_out = np.zeros((M, Nc), dtype=np.float32)
    rankc = rank_affinity_collection(ctx)
    r_, p_, t_, q_ = pt.L("r"), pt.L("p"), pt.L("t"), pt.L("q")

    if reduce == "coll":
        P = (M + panel_rows - 1) // panel_rows
        panel_bytes = panel_rows * Nc * 4
        tp = pt.Taskpool(ctx)
        part = tp.task_class("GemmPartial")
        part.param("r", 0, R - 1)
        part.param("p", 0, P - 1)
        part.affinity(rankc, r_)
        rr = RefReduce(
            ctx, tp, nseg=P,
            contributors_of=lambda p: [(r, (p, r)) for r in range(R)],
            root_of=lambda p: p % R,
            prod_class="GemmPartial", prod_flow="P", prod_nparams=2,
            prod_params_of=lambda cid: (cid[1], cid[0]),
            arena_bytes=panel_bytes, dtype=np.float32, topo=topo,
            bcast=True,
            fanout_sink=lambda seg, sl, arr: _store_panel(
                c_out, seg, panel_rows, arr))
        part.flow("P", "W",
                  *rr.producer_out_deps(lambda l, g: (l[1], l[0])),
                  arena=f"__ptc_coll_{rr.uid}")

        def part_body(view):
            p = view["p"]
            rows = slice(p * panel_rows, min(M, (p + 1) * panel_rows))
            out = (a_slab[rows] @ b_slab).astype(np.float32).ravel()
            view.data("P", dtype=np.float32)[:out.size] = out

        part.body(part_body)
        tp.run()
        tp.wait()
        return c_out

    if reduce != "chain":
        raise ValueError(f"gemm_panel_reduce: unknown reduce={reduce!r}")
    # DAG-dependency baseline: whole-matrix partials, serial rank chain
    from ..comm.coll import _next_uid
    full_bytes = M * Nc * 4
    arena = f"__gemm_chain_{_next_uid(ctx)}"
    ctx.register_arena(arena, full_bytes)
    tp = pt.Taskpool(ctx)
    whole = tp.task_class("GemmWhole")
    whole.param("r", 0, R - 1)
    whole.affinity(rankc, r_)
    whole.flow("W", "W", pt.Out(pt.Ref("GemmChain", r_, flow="B")),
               arena=arena)

    def whole_body(view):
        out = (a_slab @ b_slab).astype(np.float32).ravel()
        view.data("W", dtype=np.float32)[:out.size] = out

    whole.body(whole_body)
    chain = tp.task_class("GemmChain")
    chain.param("t", 0, R - 1)
    chain.affinity(rankc, t_)
    chain.flow("B", "READ", pt.In(pt.Ref("GemmWhole", t_, flow="W")),
               arena=arena)
    chain.flow("A", "READ", pt.In(pt.Ref("GemmChain", t_ - 1, flow="R")),
               arena=arena)
    chain.flow("R", "W",
               pt.Out(pt.Ref("GemmChain", t_ + 1, flow="A"),
                      guard=(t_ < R - 1)),
               pt.Out(pt.Ref("GemmFan", pt.Range(0, R - 1), flow="X"),
                      guard=(t_ == R - 1)),
               arena=arena)

    def chain_body(view):
        b = view.data("B", dtype=np.float32)
        r = view.data("R", dtype=np.float32)
        if view.data_ptr("A"):
            r[:] = view.data("A", dtype=np.float32) + b
        else:
            r[:b.size] = b

    chain.body(chain_body)
    fan = tp.task_class("GemmFan")
    fan.param("q", 0, R - 1)
    fan.affinity(rankc, q_)
    fan.flow("X", "READ", pt.In(pt.Ref("GemmChain", R - 1, flow="R")),
             arena=arena)

    def fan_body(view):
        x = view.data("X", dtype=np.float32)
        c_out[...] = x[:M * Nc].reshape(M, Nc)

    fan.body(fan_body)
    tp.run()
    tp.wait()
    return c_out


def _store_panel(c_out, seg, panel_rows, arr):
    M, Nc = c_out.shape
    rows = slice(seg * panel_rows, min(M, (seg + 1) * panel_rows))
    n = (rows.stop - rows.start) * Nc
    c_out[rows] = arr[:n].reshape(-1, Nc)

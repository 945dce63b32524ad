"""Run ptc-verify (parsec_tpu_torch.analysis) over every in-tree graph
generator: the algos/ PTG builders, the collective (ptc_coll_*) step
classes from comm/coll.py, and the ops-backed DAGs (ring attention, the
RMSNorm and flash-attention kernel DAGs of ops/, paged attention).

Each generator builds its taskpool(s) in a fresh Context -- nothing is
executed; verification happens on the task-class tables alone.  The
GENERATORS table is the one ptc_verify, plan_graphs, ptc_plan and
ptc_tune walk.

Usage: python -m parsec_tpu_torch.tools.verify_graphs [--json out.json]
           [-v] [only ...]

Port of tools/verify_graphs.py.
"""
import argparse
import json
import sys

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic


def _sq(ctx, name="A", nt=6, nb=8, dtype=np.float32):
    A = TwoDimBlockCyclic(nt * nb, nt * nb, nb, nb, dtype=dtype)
    A.register(ctx, name)
    return A


# ------------------------------------------------------------- generators
def g_potrf(ctx):
    from parsec_tpu_torch.algos.potrf import build_potrf
    return [("potrf", build_potrf(ctx, _sq(ctx)))]


def g_potrf_textbook(ctx):
    from parsec_tpu_torch.algos.potrf import build_potrf
    return [("potrf_textbook",
             build_potrf(ctx, _sq(ctx), trsm_via_inverse=False))]


def g_potrf_panels(ctx):
    from parsec_tpu_torch.algos.potrf import build_potrf_panels
    nt, nb = 6, 8
    A = TwoDimBlockCyclic(nt * nb, nt * nb, nt * nb, nb, dtype=np.float32)
    A.register(ctx, "A")
    return [("potrf_panels", build_potrf_panels(ctx, A))]


def g_potrs_panels(ctx):
    from parsec_tpu_torch.algos.potrf import build_potrs_panels
    nt, nb, nrhs = 6, 8, 8
    A = TwoDimBlockCyclic(nt * nb, nt * nb, nt * nb, nb, dtype=np.float32)
    A.register(ctx, "A")
    B = TwoDimBlockCyclic(nt * nb, nrhs, nt * nb, nrhs, dtype=np.float32)
    B.register(ctx, "B")
    return [("potrs_panels", build_potrs_panels(ctx, A, B))]


def g_gemm(ctx):
    from parsec_tpu_torch.algos.gemm import build_gemm
    A = _sq(ctx, "A", 4)
    B = _sq(ctx, "B", 4)
    C = _sq(ctx, "C", 4)
    return [("gemm", build_gemm(ctx, A, B, C))]


def g_gemm_dist(ctx):
    from parsec_tpu_torch.algos.gemm import build_gemm_dist
    A = _sq(ctx, "A", 4)
    B = _sq(ctx, "B", 4)
    C = _sq(ctx, "C", 4)
    return [("gemm_dist", build_gemm_dist(ctx, A, B, C))]


def g_trsm(ctx):
    from parsec_tpu_torch.algos.trsm import build_trsm
    nt, nb, nrhs = 6, 8, 16
    L = _sq(ctx, "L", nt, nb)
    B = TwoDimBlockCyclic(nt * nb, nrhs, nb, nb, dtype=np.float32)
    B.register(ctx, "B")
    return [("trsm", build_trsm(ctx, L, B))]


def g_qr(ctx):
    from parsec_tpu_torch.algos.qr import build_geqrf
    return [("geqrf", build_geqrf(ctx, _sq(ctx)))]


def g_lu(ctx):
    from parsec_tpu_torch.algos.lu import build_getrf_nopiv
    return [("getrf_nopiv", build_getrf_nopiv(ctx, _sq(ctx)))]


def g_lu_panels(ctx):
    from parsec_tpu_torch.algos.lu import build_getrf_panels
    nt, nb = 6, 8
    A = TwoDimBlockCyclic(nt * nb, nt * nb, nt * nb, nb, dtype=np.float32)
    A.register(ctx, "A")
    return [("getrf_panels", build_getrf_panels(ctx, A))]


def g_inverse(ctx):
    from parsec_tpu_torch.algos.inverse import build_lauum, build_trtri
    L = _sq(ctx, "L", 5)
    W = _sq(ctx, "W", 5)
    C = _sq(ctx, "C", 5)
    return [("trtri", build_trtri(ctx, L, W)),
            ("lauum", build_lauum(ctx, W, C, names=("W", "C")))]


def g_matrix_ops(ctx):
    from parsec_tpu_torch.algos.matrix_ops import (build_apply,
                                             build_reduce_col,
                                             build_reduce_row)
    A = _sq(ctx, "A", 5)

    def op(coll, m, n, tile):
        tile += 1

    def rop(acc, tile):
        return acc + tile

    out = []
    for uplo in ("full", "lower", "upper"):
        out.append((f"apply_{uplo}", build_apply(ctx, A, op, uplo=uplo)))
    out.append(("reduce_col", build_reduce_col(ctx, A, rop)))
    out.append(("reduce_row", build_reduce_row(ctx, A, rop)))
    return out


def g_map_operator(ctx):
    from parsec_tpu_torch.algos.matrix_ops import build_map_operator
    S = _sq(ctx, "S", 4)
    D = _sq(ctx, "D", 4)

    def op(s, d, m, n):
        return s + d

    return [("map_operator",
             build_map_operator(ctx, S, D, op))]


def g_reshape(ctx):
    from parsec_tpu_torch.algos.reshape import build_reshape_dtype
    src = _sq(ctx, "RSsrc", 4, dtype=np.float32)
    dst = TwoDimBlockCyclic(4 * 8, 4 * 8, 8, 8, dtype=np.float64)
    dst.register(ctx, "RSdst")
    return [("reshape_dtype", build_reshape_dtype(ctx, src, dst))]


def g_moe(ctx):
    from parsec_tpu_torch.algos.moe import build_moe, make_moe_collections
    S, T, d, f, E, K = 2, 8, 4, 6, 3, 2
    Xc, Yc, WGc, WUc, WDc = make_moe_collections(S, T, d, f, E)
    return [("moe", build_moe(ctx, Xc, Yc, WGc, WUc, WDc, E, k=K))]


def g_ring_attention(ctx):
    from parsec_tpu_torch.algos.ring_attention import (build_ring_attention,
                                                 make_collections)
    S, T, d = 4, 8, 4
    Qc, KVc, ACCc, Oc = make_collections(S, T, d)
    return [("ring_attention",
             build_ring_attention(ctx, Qc, KVc, ACCc, Oc))]


def g_ops_rms_norm(ctx):
    from parsec_tpu_torch.ops.rms_norm import build_rms_norm
    R, T, d = 4, 8, 16
    Xc = TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
    Wc = TwoDimBlockCyclic(1, d, 1, d, dtype=np.float32)
    Oc = TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
    return [("ops_rms_norm", build_rms_norm(ctx, Xc, Wc, Oc))]


def g_ops_flash_attention(ctx):
    from parsec_tpu_torch.ops.flash_attention import build_flash_attention
    NQ, T, d = 4, 8, 16
    Qc = TwoDimBlockCyclic(NQ * T, d, T, d, dtype=np.float32)
    Kc = TwoDimBlockCyclic(NQ * T, d, NQ * T, d, dtype=np.float32)
    Vc = TwoDimBlockCyclic(NQ * T, d, NQ * T, d, dtype=np.float32)
    Oc = TwoDimBlockCyclic(NQ * T, d, T, d, dtype=np.float32)
    return [("ops_flash_attention",
             build_flash_attention(ctx, Qc, Kc, Vc, Oc, causal=True))]


def g_paged_attention(ctx):
    """The serving runtime's paged KV-cache attention builders
    (ops/paged_attention): a ragged multi-sequence DECODE step (1/2/3
    pages per sequence — the pure-call lookup tables must verify
    exactly), a PREFILL with a partial last page, a WARM prefill whose
    shared-prefix pages read straight from the KV collections
    (ptc-share: PFILL's domain starts at the cold tail, one sequence
    fully warm prefilling ZERO pages), and the speculative VERIFY WAVE
    (pure fold chains over host-staged pages — the one-fused-launch
    batched verification graph)."""
    from parsec_tpu_torch.ops.paged_attention import (PagePool, SeqSpec,
                                                build_paged_decode,
                                                build_paged_prefill,
                                                build_paged_verify,
                                                make_slot_collections)
    pool = PagePool(ctx, 16, 4, 8, name="KV")
    _, _, _, _, names = make_slot_collections(ctx, 4, 8, name="PA")
    seqs = [SeqSpec(0, [0, 1, 2], 1), SeqSpec(1, [3], 0),
            SeqSpec(2, [4, 5], 3)]
    dec = build_paged_decode(ctx, pool, seqs, names)
    PRc = TwoDimBlockCyclic(8 * 4, 16, 4, 16, dtype=np.float32)
    PRc.register(ctx, "PR")
    pseqs = [SeqSpec(0, [6, 7], 2), SeqSpec(1, [8], 4)]
    pre = build_paged_prefill(ctx, pool, pseqs, names, "PR",
                              [[0, 1], [2]])
    # warm prefill: seq 0 shares its first page (cold tail = 1 page),
    # seq 1 is FULLY warm (PFILL empty; the fold still runs whole)
    wseqs = [SeqSpec(0, [9, 10], 3), SeqSpec(1, [11, 12], 4)]
    warm = build_paged_prefill(ctx, pool, wseqs, names, "PR",
                               [[3, 4], [5, 6]], warm=[1, 2])
    # speculative verify wave: 3 virtual queries over a shared frozen
    # prefix [13] with ragged private windows — the engine's k-token
    # batched verification shape
    vseqs = [SeqSpec(0, [13, 14], 2), SeqSpec(1, [13, 14, 15], 3),
             SeqSpec(2, [13], 4)]
    ver = build_paged_verify(ctx, pool, vseqs, names)
    return [("ops_paged_decode", dec), ("ops_paged_prefill", pre),
            ("ops_paged_prefill_warm", warm),
            ("ops_paged_spec_verify", ver)]


def g_coll(ctx):
    """The ptc_coll_* step/leaf/src/gw classes (comm/coll.py) for every
    reduction topology plus the fan-out leg, planned for a 4-rank shape
    on this single-rank context (nothing runs; class tables only)."""
    from parsec_tpu_torch.comm.coll import (_emit_fanout, _emit_reduce,
                                      _next_uid, _plan_reduce)
    R, nseg, ns = 4, 4, 2
    out = []
    for topo in ("star", "ring", "binomial"):
        uid = _next_uid(ctx)
        arena = f"__ptc_coll_{uid}"
        ctx.register_arena(arena, 64)
        plan = _plan_reduce(nseg, R, lambda s: s % R,
                            lambda s: [(r, r) for r in range(R)],
                            topo, ext=False)
        tp = pt.Taskpool(ctx)
        _emit_reduce(ctx, tp, uid, plan, ns, arena, np.add, np.float32,
                     local_read=lambda cid, seg, s: np.zeros(4,
                                                             np.float32),
                     final_sink=lambda seg, s, arr: None)
        out.append((f"coll_reduce_{topo}", tp))
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, 64)
    tp = pt.Taskpool(ctx)
    _emit_fanout(ctx, tp, uid, nseg, ns, R, lambda s: s % R, arena,
                 np.float32,
                 src_read=lambda s, slc: np.zeros(4, np.float32),
                 sink=lambda s, slc, arr: None)
    out.append(("coll_fanout", tp))
    return out


def g_tp_paged(ctx):
    """Tensor-parallel sharded serving graphs (ptc-shard): the DECODE
    and speculative-VERIFY builders with an embedded RefReduce
    all-reduce over the per-rank partial pre-logit projections.  Built
    for a 1-rank tp group on this single-rank context — the SPMD shape
    each rank compiles is IDENTICAL up to the contributor-id base, so
    the R=1 degenerate chain (local fold + fan-out, producer-domain
    selection, no dynamic guards on the coll step IN deps — V008)
    verifying exactly certifies the per-rank shard wave shape."""
    from parsec_tpu_torch.ops.paged_attention import (PagePool, SeqSpec,
                                                build_paged_decode,
                                                build_paged_verify,
                                                make_slot_collections)
    d, nh, dm = 8, 2, 16
    pool = PagePool(ctx, 16, 4, d, name="TKV")
    _, _, _, _, names = make_slot_collections(ctx, 4, d, name="TPA",
                                              nh=nh)
    wo = np.zeros((d, dm), np.float32)

    def mk_shard():
        return {"rank": 0, "nranks": 1, "dm": dm,
                "project": lambda o, w=wo: o @ w,
                "sink": lambda seg, slc, x: None}

    seqs = [SeqSpec(0, [0, 1], 2), SeqSpec(1, [2], 1)]
    dec = build_paged_decode(ctx, pool, seqs, names, nh=nh,
                             shard=mk_shard())
    vseqs = [SeqSpec(0, [3, 4], 2), SeqSpec(1, [3], 3)]
    ver = build_paged_verify(ctx, pool, vseqs, names, nh=nh,
                             shard=mk_shard())
    return [("ops_tp_paged_decode", dec), ("ops_tp_paged_verify", ver)]


GENERATORS = {
    "potrf": g_potrf,
    "potrf_textbook": g_potrf_textbook,
    "potrf_panels": g_potrf_panels,
    "potrs_panels": g_potrs_panels,
    "gemm": g_gemm,
    "gemm_dist": g_gemm_dist,
    "trsm": g_trsm,
    "qr": g_qr,
    "lu": g_lu,
    "lu_panels": g_lu_panels,
    "inverse": g_inverse,
    "matrix_ops": g_matrix_ops,
    "map_operator": g_map_operator,
    "reshape": g_reshape,
    "moe": g_moe,
    "ring_attention": g_ring_attention,
    "ops_rms_norm": g_ops_rms_norm,
    "ops_flash_attention": g_ops_flash_attention,
    "paged_attention": g_paged_attention,
    "coll": g_coll,
    "tp_paged": g_tp_paged,
}


def verify_all(only=None, verbose=False):
    """Build + verify every generator.  Yields (name, Report)."""
    from parsec_tpu_torch.analysis import verify_taskpool
    for gname, gen in GENERATORS.items():
        if only and gname not in only:
            continue
        with pt.Context(nb_workers=1) as ctx:
            for tpname, tp in gen(ctx):
                report = verify_taskpool(tp)
                if verbose:
                    print(f"--- {tpname}: {report.text()}")
                yield tpname, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("only", nargs="*", help="generator names (default all)")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    dirty = 0
    results = {}
    for name, report in verify_all(args.only or None, args.verbose):
        n_err, n_warn = len(report.errors), len(report.warnings)
        status = "clean" if report.ok() else (
            f"{n_err} error(s), {n_warn} warning(s)")
        print(f"{name:24s} {status}")
        if not report.ok():
            dirty += 1
            if not args.verbose:
                print(report.text())
        results[name] = report.to_json()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"verify-graphs: {len(results)} graph(s), {dirty} with findings")
    return 1 if dirty else 0


if __name__ == "__main__":
    sys.exit(main())

"""Mixture-of-Experts dispatch/combine through the task runtime.

Port of parsec_tpu/algos/moe.py.  The two all-to-all legs of an MoE layer
are ordinary runtime dependencies: dispatch tiles move shard-rank ->
expert-rank and result tiles move back, riding the comm engine like any
other tile.

DAG (S token shards of T tokens, E experts, capacity C):

  GATE(s):    X(s), WG          -> R(s)  (T, 2k) top-k ids + renorm probs
  DISP(s, e): R(s), X(s)        -> D     (C, d+2) = [x | token idx | prob]
  EXP(e, s):  D, WU(e), WD(e)   -> D     (result written over the x cols;
              affinity = expert e's rank: D moving here IS the dispatch
              leg, the result moving out IS the combine leg)
  ACC(s, e):  chain over e scatter-adding prob-weighted rows into Y(s)

Tokens beyond an expert's capacity are dropped in token order.  With a
CudaDevice, EXP runs as a device chore on lane stacks: two batched
products and the activation, the (token id, weight) columns passed
through.  A custom activation on the device needs its torch form,
`activation_torch=` (the reference's `activation_jax=`)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ._util import refuse_tf32


def _relu(x):
    return np.maximum(x, 0.0)


def _softmax(x):
    m = x.max(axis=-1, keepdims=True)
    p = np.exp(x - m)
    return p / p.sum(axis=-1, keepdims=True)


def _topk_gate(x, w_gate, k):
    """Shared routing rule for the runtime gate and the oracle: softmax
    over experts, stable top-k, renormalized top-k probabilities."""
    probs = _softmax(x @ w_gate)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    vals = np.take_along_axis(probs, idx, axis=-1)
    return idx, vals / vals.sum(axis=-1, keepdims=True)


def _scatter_rows(a, c, d):
    """a[token] += prob * row for every row of a combine tile c = [rows |
    token id | prob] with a nonzero prob.  A tile holds a token at most
    once (its top-k experts are distinct), so this is the reference's
    row-by-row loop, bit for bit, as one indexed add."""
    live = c[:, d + 1] != 0.0
    a[c[live, d].astype(np.int64)] += c[live, d + 1:d + 2] * c[live, :d]


def _ffn(dtile, wu, wd, act):
    """[act(D[:, :d] @ wu) @ wd | D[:, d:]] on lane stacks dtile
    [n, C, d+2], wu [n, d, f], wd [n, f, d] (stride-0 lanes when every
    lane reads one expert's tile)."""
    refuse_tf32(dtile, "EXP")
    d = wu.shape[-2]
    y = torch.bmm(act(torch.bmm(dtile[..., :d], wu)), wd)
    return torch.cat([y, dtile[..., d:]], dim=-1)


def _k_exp_relu(dtile, wu, wd):
    """Stock device chore for EXP (relu FFN over the packed dispatch
    tile)."""
    return _ffn(dtile, wu, wd, torch.relu)


def make_moe_collections(S, T, d, f, E, nodes=1, myrank=0, x=None,
                         w_gate=None, w_up=None, w_down=None):
    """Token shards X/Y (shard s on rank s%nodes), per-expert weights
    WU/WD (expert e on rank e%nodes), gate weights WG stored once per
    rank (every shard rank gates locally; WG is small and passed at
    init)."""
    def init_from(arr, rows):
        if arr is None:
            return None
        return lambda c, m, n: np.ascontiguousarray(
            arr[m * rows:(m + 1) * rows], dtype=np.float32)

    Xc = TwoDimBlockCyclic(S * T, d, T, d, P=nodes, Q=1, nodes=nodes,
                           myrank=myrank, dtype=np.float32,
                           init=init_from(x, T))
    Yc = TwoDimBlockCyclic(S * T, d, T, d, P=nodes, Q=1, nodes=nodes,
                           myrank=myrank, dtype=np.float32,
                           init=lambda c, m, n: np.zeros((T, d),
                                                         np.float32))
    WGc = TwoDimBlockCyclic(nodes * d, E, d, E, P=nodes, Q=1, nodes=nodes,
                            myrank=myrank, dtype=np.float32,
                            init=(lambda c, m, n: np.ascontiguousarray(
                                w_gate, dtype=np.float32))
                            if w_gate is not None else None)
    WUc = TwoDimBlockCyclic(E * d, f, d, f, P=nodes, Q=1, nodes=nodes,
                            myrank=myrank, dtype=np.float32,
                            init=init_from(
                                w_up.reshape(E * d, f) if w_up is not None
                                else None, d))
    WDc = TwoDimBlockCyclic(E * f, d, f, d, P=nodes, Q=1, nodes=nodes,
                            myrank=myrank, dtype=np.float32,
                            init=init_from(
                                w_down.reshape(E * f, d)
                                if w_down is not None else None, f))
    return Xc, Yc, WGc, WUc, WDc


def build_moe(ctx: pt.Context, Xc, Yc, WGc, WUc, WDc, E: int, k: int = 2,
              capacity: Optional[int] = None,
              activation: Callable = _relu,
              activation_torch: Optional[Callable] = None,
              dev=None, combine: str = "chain",
              coll_topo: Optional[str] = None) -> pt.Taskpool:
    """`activation` runs in the CPU bodies (numpy); when `dev` is given
    the EXP FFN runs on the device and needs a torch `activation_torch`
    (defaulted for the stock relu).

    combine="chain" (default): the expert-combine leg is a sequential
    ACC chain over e on the shard-owner rank — every expert's full
    dispatch tile crosses to the owner and the adds serialize.
    combine="coll": each expert rank first folds ITS experts'
    contributions into one Y-shaped partial locally (CMB, no wire
    traffic), then the per-rank partials ride a runtime-native ptc_coll
    reduction to the shard owner, which adds the result into Y (STORE)."""
    if combine not in ("chain", "coll"):
        raise ValueError(f"build_moe: unknown combine={combine!r}")
    k_exp = None
    if dev is not None:
        if activation_torch is not None:
            def k_exp(dtile, wu, wd, _act=activation_torch):
                return _ffn(dtile, wu, wd, _act)
        elif activation is _relu:
            k_exp = _k_exp_relu
        else:
            raise ValueError(
                "build_moe: a custom activation needs a torch "
                "activation_torch= for the device chore (the numpy "
                "activation cannot run on lane stacks)")
    S, T, d = Xc.mt, Xc.mb, Xc.nb
    f = WUc.nb
    C = capacity if capacity is not None else T
    Xc.register(ctx, "X")
    Yc.register(ctx, "Y")
    WGc.register(ctx, "WG")
    WUc.register(ctx, "WU")
    WDc.register(ctx, "WD")
    ctx.register_arena("moe_r", T * 2 * k * 4)
    ctx.register_arena("moe_d", C * (d + 2) * 4)
    ctx.register_arena("moe_y", T * d * 4)
    nodes = max(1, Xc.nodes)
    tp = pt.Taskpool(ctx, globals={"S": S - 1, "E": E - 1, "P": nodes})
    s, e = pt.L("s"), pt.L("e")
    Sg, Eg, Pg = pt.G("S"), pt.G("E"), pt.G("P")

    gate = tp.task_class("GATE")
    gate.param("s", 0, Sg)
    gate.affinity("X", s, 0)
    gate.flow("X", "READ", pt.In(pt.Mem("X", s, 0)))
    # WG is stored one tile per rank; the gate reads its own rank's
    gate.flow("WG", "READ", pt.In(pt.Mem("WG", s % Pg, 0)))
    gate.flow("R", "W",
              pt.Out(pt.Ref("DISP", s, pt.Range(0, Eg), flow="R")),
              arena="moe_r")

    disp = tp.task_class("DISP")
    disp.param("s", 0, Sg)
    disp.param("e", 0, Eg)
    disp.affinity("X", s, 0)
    disp.flow("R", "READ", pt.In(pt.Ref("GATE", s, flow="R")))
    disp.flow("X", "READ", pt.In(pt.Mem("X", s, 0)))
    disp.flow("D", "W", pt.Out(pt.Ref("EXP", e, s, flow="D")),
              arena="moe_d")

    exp = tp.task_class("EXP")
    exp.param("e", 0, Eg)
    exp.param("s", 0, Sg)
    exp.affinity("WU", e, 0)  # expert-owner computes: the all-to-all
    cmb_cls = "ACC" if combine == "chain" else "CMB"
    exp.flow("D", "RW", pt.In(pt.Ref("DISP", s, e, flow="D")),
             pt.Out(pt.Ref(cmb_cls, s, e, flow="C")), arena="moe_d")
    exp.flow("WU", "READ", pt.In(pt.Mem("WU", e, 0)))
    exp.flow("WD", "READ", pt.In(pt.Mem("WD", e, 0)))

    if combine == "chain":
        acc = tp.task_class("ACC")
        acc.param("s", 0, Sg)
        acc.param("e", 0, Eg)
        acc.affinity("X", s, 0)
        acc.flow("A", "RW",
                 pt.In(pt.Mem("Y", s, 0), guard=(e == 0)),
                 pt.In(pt.Ref("ACC", s, e - 1, flow="A")),
                 pt.Out(pt.Ref("ACC", s, e + 1, flow="A"), guard=(e < Eg)),
                 pt.Out(pt.Mem("Y", s, 0), guard=(e == Eg)), arena="moe_y")
        acc.flow("C", "READ", pt.In(pt.Ref("EXP", e, s, flow="D")),
                 arena="moe_d")
    else:
        from ..comm.coll import RefReduce

        # CMB(s, e): on the EXPERT rank, fold expert e's dispatch tile
        # into a Y-shaped partial (the elementwise-reducible form)
        cmb = tp.task_class("CMB")
        cmb.param("s", 0, Sg)
        cmb.param("e", 0, Eg)
        cmb.affinity("WU", e, 0)
        cmb.flow("C", "READ", pt.In(pt.Ref("EXP", e, s, flow="D")),
                 arena="moe_d")
        rr = RefReduce(
            ctx, tp, nseg=S,
            contributors_of=lambda ss: [(WUc.rank_of(ee, 0), (ss, ee))
                                        for ee in range(E)],
            root_of=lambda ss: Xc.rank_of(ss, 0),
            prod_class="CMB", prod_flow="P", prod_nparams=2,
            prod_params_of=lambda cid: cid,
            arena_bytes=T * d * 4, dtype=np.float32, topo=coll_topo)
        cmb.flow("P", "W",
                 *rr.producer_out_deps(lambda l, g: (l[0], l[1])),
                 arena="moe_y")

        def b_cmb(view):
            c = view.data("C", np.float32, (C, d + 2))
            p = view.data("P", np.float32)[:T * d].reshape(T, d)
            p[...] = 0.0
            _scatter_rows(p, c, d)

        cmb.body(b_cmb)
        # STORE(s): on the shard owner, add the reduced combine into Y
        store = tp.task_class("STORE")
        store.param("s", 0, Sg)
        store.affinity("X", s, 0)
        store.flow("C", "READ", rr.final_in_dep(0), arena="moe_y")
        store.flow("A", "RW", pt.In(pt.Mem("Y", s, 0)),
                   pt.Out(pt.Mem("Y", s, 0)), arena="moe_y")
        rr.wire_final_consumer(tp, "STORE", "C", lambda seg: (seg,))

        def b_store(view):
            a = view.data("A", np.float32, (T, d))
            a += view.data("C", np.float32)[:T * d].reshape(T, d)

        store.body(b_store)

    def b_gate(view):
        x = view.data("X", np.float32, (T, d))
        wg = view.data("WG", np.float32, (d, E))
        r = view.data("R", np.float32, (T, 2 * k))
        idx, vals = _topk_gate(x, wg, k)
        r[:, :k] = idx
        r[:, k:] = vals

    def b_disp(view):
        my_e = view.local("e")
        r = view.data("R", np.float32, (T, 2 * k))
        x = view.data("X", np.float32, (T, d))
        dtile = view.data("D", np.float32, (C, d + 2))
        dtile[...] = 0.0
        # (token, slot) pairs routed here in token order, the first C kept
        ts, js = np.nonzero(r[:, :k].astype(np.int64) == my_e)
        ts, js = ts[:C], js[:C]
        cnt = len(ts)
        dtile[:cnt, :d] = x[ts]
        dtile[:cnt, d] = ts
        dtile[:cnt, d + 1] = r[ts, k + js]
        # rows past cnt stay zero: prob 0 contributes nothing at combine

    def b_exp(view):
        dtile = view.data("D", np.float32, (C, d + 2))
        wu = view.data("WU", np.float32, (d, f))
        wd = view.data("WD", np.float32, (f, d))
        dtile[:, :d] = activation(dtile[:, :d] @ wu) @ wd

    def b_acc(view):
        _scatter_rows(view.data("A", np.float32, (T, d)),
                      view.data("C", np.float32, (C, d + 2)), d)

    if dev is not None:
        # the device chore is attached before the CPU bodies: the FLOPs
        # live in EXP
        dev.attach(exp, tp, kernel=k_exp, reads=["D", "WU", "WD"],
                   writes=["D"],
                   shapes={"D": (C, d + 2), "WU": (d, f), "WD": (f, d)},
                   dtype=np.float32)

    gate.body(b_gate)
    disp.body(b_disp)
    exp.body(b_exp)
    if combine == "chain":
        acc.body(b_acc)
    return tp


def moe_oracle(x, w_gate, w_up, w_down, k=2, activation=_relu):
    """Dense numpy oracle, same math as the reference's
    parallel/expert.py moe_ffn_reference (no capacity limit)."""
    T, d = x.shape
    idx, vals = _topk_gate(x, w_gate, k)
    y = np.zeros_like(x)
    for t in range(T):
        for j in range(k):
            e = idx[t, j]
            h = activation(x[t] @ w_up[e])
            y[t] += vals[t, j] * (h @ w_down[e])
    return y

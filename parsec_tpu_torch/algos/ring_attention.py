"""Ring attention as a PTG taskpool over a sequence-sharded collection.

Port of parsec_tpu/algos/ring_attention.py.  The sequence axis is tiled
into S shards; ATT(i, t) attends query shard i against the K/V block that
reaches it at ring step t, carrying streaming-softmax state (o, m, l)
task-to-task; the K/V blocks hop to the ring-left neighbour every step —
that hop IS a runtime dependency, so on multiple ranks the block rides
the comm engine (the device data plane or the rendezvous for big tiles)
like any other tile.

DAG (S shards, S steps, one softmax pass):

  ATT(i, t):   Q    <- Q(i)            (t == 0)  | ATT(i, t-1).Q
               KV   <- KV(i)           (t == 0)  | ATT((i+1)%S, t-1).KV
               ACC  <- ACC(i)          (t == 0)  | ATT(i, t-1).ACC
               KV   -> ATT((i-1+S)%S, t+1).KV    (t < S-1)
               ACC  -> ATT(i, t+1).ACC (t < S-1) | FIN(i).ACC
  FIN(i):      O(i) = ACC.o / ACC.l

ACC packs (o, m, l) as one (T, d+2) tile; KV packs K and V stacked as one
(2T, d) tile.  With a CudaDevice, ATT and FIN run as device chores on lane
stacks ([lanes, T, d], [lanes, 2T, d], [lanes, T, d+2]): k_att scores with
batched products and updates the running state with an explicit
exp/max/sum, k_fin divides O by l.  The taskpool has no head axis: one
(T, d) shard is one head's sequence block.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import parsec_tpu_torch as pt

from ..data.collections import TwoDimBlockCyclic
from ._util import as_device_list, refuse_tf32


# ---------------------------------------------------------------- chores
def k_att(q, kv, acc):
    """One online-softmax step on lane stacks: q [n, T, d], kv [n, 2T, d]
    (K above V), acc [n, T, d+2] = [O | m | l].  Returns (q, kv, acc')
    — Q and KV pass through unchanged (the device clones an output that
    aliases an input).  TF32 must be off: the reference's f32 math."""
    refuse_tf32(q, "k_att")
    T, d = q.shape[-2], q.shape[-1]
    k, v = kv[:, :T], kv[:, T:]
    o, m, l = acc[..., :d], acc[..., d:d + 1], acc[..., d + 1:d + 2]
    s = torch.bmm(q, k.transpose(1, 2)).div_(math.sqrt(d))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = s.sub_(m_new).exp_()
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    o_new = torch.baddbmm(alpha * o, p, v)
    return q, kv, torch.cat([o_new, m_new, l_new], dim=-1)


def k_fin(acc):
    """O / l on a lane stack acc [n, T, d+2] -> [n, T, d]."""
    d = acc.shape[-1] - 2
    return acc[..., :d] / acc[..., d + 1:d + 2]


def make_collections(S: int, T: int, d: int, nodes: int = 1, myrank: int = 0,
                     q=None, k=None, v=None):
    """Sequence-sharded collections for S shards of T tokens, head dim d.
    q/k/v: optional (S*T, d) dense arrays to initialize from (rank 0
    layout; each rank stores only its own shards)."""
    def init_from(dense):
        if dense is None:
            return None
        return lambda c, m, n: np.ascontiguousarray(
            dense[m * c.mb:(m + 1) * c.mb], dtype=np.float32)

    Qc = TwoDimBlockCyclic(S * T, d, T, d, P=nodes, Q=1, nodes=nodes,
                           myrank=myrank, dtype=np.float32,
                           init=init_from(q))
    kvd = None
    if k is not None:
        kv = np.concatenate(
            [np.stack([k[i * T:(i + 1) * T], v[i * T:(i + 1) * T]])
             .reshape(2 * T, d) for i in range(S)])
        kvd = init_from(kv)
    KVc = TwoDimBlockCyclic(S * 2 * T, d, 2 * T, d, P=nodes, Q=1,
                            nodes=nodes, myrank=myrank, dtype=np.float32,
                            init=kvd)

    def acc_init(c, m, n):
        t = np.zeros((T, d + 2), dtype=np.float32)
        t[:, d] = -np.inf  # running max
        return t

    ACCc = TwoDimBlockCyclic(S * T, d + 2, T, d + 2, P=nodes, Q=1,
                             nodes=nodes, myrank=myrank, dtype=np.float32,
                             init=acc_init)
    Oc = TwoDimBlockCyclic(S * T, d, T, d, P=nodes, Q=1, nodes=nodes,
                           myrank=myrank, dtype=np.float32)
    return Qc, KVc, ACCc, Oc


def build_ring_attention(ctx: pt.Context, Qc, KVc, ACCc, Oc,
                         dev=None) -> pt.Taskpool:
    """S = Qc.mt shards; registers the four collections as Q/KV/ACC/O."""
    S = Qc.mt
    T, d = Qc.mb, Qc.nb
    Qc.register(ctx, "Q")
    KVc.register(ctx, "KV")
    ACCc.register(ctx, "ACC")
    Oc.register(ctx, "O")
    ctx.register_arena("ra_kv", 2 * T * d * 4)
    ctx.register_arena("ra_acc", T * (d + 2) * 4)
    ctx.register_arena("ra_o", T * d * 4)
    tp = pt.Taskpool(ctx, globals={"S": S - 1})
    i, t = pt.L("i"), pt.L("t")
    Sg = pt.G("S")
    att = tp.task_class("ATT")
    att.param("i", 0, Sg)
    att.param("t", 0, Sg)
    att.affinity("Q", i, 0)
    att.priority(Sg - t)
    att.flow("Q", "RW",
             pt.In(pt.Mem("Q", i, 0), guard=(t == 0)),
             pt.In(pt.Ref("ATT", i, t - 1, flow="Q")),
             pt.Out(pt.Ref("ATT", i, t + 1, flow="Q"), guard=(t < Sg)))
    att.flow("KV", "RW",
             pt.In(pt.Mem("KV", i, 0), guard=(t == 0)),
             pt.In(pt.Ref("ATT", (i + 1) % (Sg + 1), t - 1, flow="KV")),
             pt.Out(pt.Ref("ATT", (i - 1 + (Sg + 1)) % (Sg + 1), t + 1,
                           flow="KV"),
                    guard=(t < Sg)),
             arena="ra_kv")
    att.flow("ACC", "RW",
             pt.In(pt.Mem("ACC", i, 0), guard=(t == 0)),
             pt.In(pt.Ref("ATT", i, t - 1, flow="ACC")),
             pt.Out(pt.Ref("ATT", i, t + 1, flow="ACC"), guard=(t < Sg)),
             pt.Out(pt.Ref("FIN", i, flow="ACC"), guard=(t == Sg)))
    fin = tp.task_class("FIN")
    fin.param("i", 0, Sg)
    fin.affinity("O", i, 0)
    fin.flow("ACC", "READ", pt.In(pt.Ref("ATT", i, Sg, flow="ACC")),
             arena="ra_acc")
    fin.flow("O", "W", pt.Out(pt.Mem("O", i, 0)), arena="ra_o")

    for dv in as_device_list(dev):
        dv.attach(att, tp, kernel=k_att, reads=["Q", "KV", "ACC"],
                  writes=["Q", "KV", "ACC"],
                  shapes={"Q": (T, d), "KV": (2 * T, d),
                          "ACC": (T, d + 2)}, dtype=np.float32)
        # O is written into a DIFFERENT collection tile at release: the
        # host copy must be coherent when the memcpy runs
        dv.attach(fin, tp, kernel=k_fin, reads=["ACC"], writes=["O"],
                  shapes={"ACC": (T, d + 2), "O": (T, d)},
                  dtype=np.float32, sync_mem_out=True)

    def b_att(view):
        qv = view.data("Q", np.float32, (T, d))
        kv = view.data("KV", np.float32, (2 * T, d))
        ac = view.data("ACC", np.float32, (T, d + 2))
        kk, vv = kv[:T], kv[T:]
        o, m, l = ac[:, :d], ac[:, d:d + 1], ac[:, d + 1:d + 2]
        s = (qv @ kk.T) / math.sqrt(d)
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        p = np.exp(s - m_new)
        alpha = np.exp(m - m_new)
        l_new = alpha * l + p.sum(axis=-1, keepdims=True)
        o_new = alpha * o + p @ vv
        ac[:, :d] = o_new
        ac[:, d:d + 1] = m_new
        ac[:, d + 1:d + 2] = l_new

    def b_fin(view):
        ac = view.data("ACC", np.float32, (T, d + 2))
        ov = view.data("O", np.float32, (T, d))
        ov[...] = ac[:, :d] / ac[:, d + 1:d + 2]

    att.body(b_att)
    fin.body(b_fin)
    return tp


def run_ring_attention(ctx, S, T, d, q, k, v, dev=None, nodes=1, myrank=0):
    """Build collections from dense (S*T, d) q/k/v, run, and return the
    output collection (valid on the owning ranks' shards)."""
    Qc, KVc, ACCc, Oc = make_collections(S, T, d, nodes, myrank, q, k, v)
    tp = build_ring_attention(ctx, Qc, KVc, ACCc, Oc, dev=dev)
    tp.run()
    tp.wait()
    for dv in as_device_list(dev):
        dv.flush()
    return Oc


def dense_reference(q, k, v):
    """Oracle: plain softmax attention in float64."""
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = q64 @ k64.T / math.sqrt(q.shape[1])
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return (p @ v64).astype(np.float32)

"""Content-hash KV page migration.

Port of parsec_tpu/comm/migrate.py.  Moves FROZEN prefix-cache pages
between PagePools — the fleet tier's prefill->decode handoff.  Two
transports, one contract:

  migrate_keys           in-process pool-to-pool copy (replicas sharing
                         a process, and the unit-testable core)
  build_page_migration   an SPMD taskpool over the comm engine: the
                         source rank stages each wanted page's exported
                         payload into a flow, the destination rank's
                         receive task (placed by affinity) pulls it
                         through the ordinary remote-dep protocol — so
                         a page above the eager limit rides the chunked
                         rendezvous (ranged GET/PUT_CHUNK streaming,
                         rails, peer-loss reaping) with NO new frame
                         type

Dedup is RECEIVER-DRIVEN and decided before anything moves: the wanted
set is computed against the receiver's key digest (Server.advertise),
so a key the receiver already holds produces no task, no GET and zero
payload bytes — the content-hash key makes every transfer idempotent
(the bytes are a pure function of the key; re-sending can only write
what is already there, and PagePool.import_frozen refuses duplicates
at refcount-exact cost).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["migrate_keys", "wanted_keys", "build_page_migration",
           "migration_class", "migration_cost", "relay_rank_for"]


def migration_class(src_rank: int, dst_rank: int, topo=None) -> str:
    """Link class a (src -> dst) page migration rides: a cross-island
    move crosses the DCN and is priced there, not at the flat 'ici'
    rate."""
    if topo is None:
        from .topology import default_topology
        topo = default_topology(max(src_rank, dst_rank) + 1)
    return topo.class_of(src_rank, dst_rank)


def migration_cost(nbytes: int, src_rank: int, dst_rank: int,
                   topo=None, econ=None) -> float:
    """Modeled seconds to migrate `nbytes` of pages src -> dst, priced
    at the link class of that leg (DCN for cross-island moves)."""
    if econ is None:
        from .economics import default_economics
        econ = default_economics()
    return econ.cost(int(nbytes), "rdv",
                     cls=migration_class(src_rank, dst_rank, topo))


def relay_rank_for(nbytes: int, src_rank: int, dst_rank: int,
                   topo=None, econ=None) -> Optional[int]:
    """The island-leader relay rank for an inter-island migration when
    forwarding through it is modeled cheaper than the direct classed
    leg (topology.relay_beats_direct), else None.  The relay is the
    DESTINATION island's leader — the provisioned DCN endpoint closest
    to the receiver — unless that leader is one of the endpoints, in
    which case the source island's leader is tried instead."""
    if topo is None:
        from .topology import default_topology
        topo = default_topology(max(src_rank, dst_rank) + 1)
    from .topology import relay_beats_direct
    if not relay_beats_direct(int(nbytes), src_rank, dst_rank,
                              topo, econ):
        return None
    ld = topo.leader_of(topo.island_of(dst_rank))
    if ld not in (src_rank, dst_rank):
        return ld
    ls = topo.leader_of(topo.island_of(src_rank))
    if ls not in (src_rank, dst_rank):
        return ls
    return None


def wanted_keys(dst_pool, keys: Sequence) -> List:
    """The subset of `keys` the destination pool does NOT hold — the
    receiver-driven dedup decision (zero payload bytes for the rest)."""
    return [k for k in keys if dst_pool.probe([k]) == 0]


def migrate_keys(src_pool, dst_pool, keys: Sequence) -> Dict[str, int]:
    """Copy frozen pages `keys` from src_pool to dst_pool, skipping
    keys the receiver already holds (zero bytes moved for those) and
    keys the source no longer holds (evicted: counted, not fatal).
    Idempotent: running it twice transfers nothing the second time.
    Returns {"requested", "transferred", "skipped_held",
    "skipped_missing", "bytes"}."""
    out = {"requested": len(list(keys)), "transferred": 0,
           "skipped_held": 0, "skipped_missing": 0, "bytes": 0}
    for key in keys:
        if dst_pool.probe([key]):
            out["skipped_held"] += 1
            continue
        payload = src_pool.export_frozen(key)
        if payload is None:
            out["skipped_missing"] += 1
            continue
        if dst_pool.import_frozen(key, payload[0], payload[1]):
            out["transferred"] += 1
            out["bytes"] += dst_pool.bytes_per_page
        else:
            out["skipped_held"] += 1  # lost a concurrent import race
    return out


def build_page_migration(pt, ctx, keys: Sequence, wanted_idx: Sequence[int],
                         src_pool=None, dst_pool=None,
                         src_rank: int = 0, dst_rank: int = 1,
                         page: Optional[int] = None,
                         d: Optional[int] = None,
                         coll_name: str = "MIG",
                         topo=None, econ=None, relay=None):
    """Build the SPMD page-migration taskpool (both ranks run this with
    the SAME keys and wanted_idx — the execution space must agree).

    MSRC(j), placed on `src_rank`, exports frozen page
    keys[wanted_idx[j]] into its payload flow; MRECV(j), placed on
    `dst_rank`, receives the (page, 2d) k|v tile through the remote-dep
    protocol and imports it under the same key.  With the eager path
    off (PTC_MCA_comm_eager_limit=0) and chunk_size below the payload,
    every page streams as ranged GET/PUT_CHUNK frames — the existing
    chunked pull path, unchanged.

    `src_pool` is required on the source rank, `dst_pool` on the
    destination rank (an SPMD caller passes its local pool as both —
    only the rank-local one is touched).  `page`/`d` default from
    whichever pool is present.  Returns the taskpool, or None when
    wanted_idx is empty (nothing to migrate — zero tasks, zero bytes).

    Topology: when the (src, dst) leg crosses islands and forwarding
    through an island leader is modeled cheaper than the penalized
    direct DCN leg (relay_rank_for), an MFWD(j) pass-through task is
    inserted on the leader — MSRC -> MFWD -> MRECV — so the bulk pull
    rides the provisioned leader uplink.  `relay` overrides the
    decision: None = auto, False = never, an int = relay through that
    rank unconditionally.  All ranks must agree (SPMD): pass the same
    topo/econ/relay on every rank."""
    wanted = [int(j) for j in wanted_idx]
    if not wanted:
        return None
    pool = src_pool if src_pool is not None else dst_pool
    P = int(page if page is not None else pool.page)
    D = int(d if d is not None else pool.d)
    size = P * 2 * D * 4  # one f32 k|v payload tile
    relay_rank: Optional[int] = None
    if relay is None:
        relay_rank = relay_rank_for(size * len(wanted), src_rank,
                                    dst_rank, topo=topo, econ=econ)
    elif relay is not False:
        relay_rank = int(relay)
        if relay_rank in (src_rank, dst_rank):
            relay_rank = None
    nodes = getattr(ctx, "nodes", 1) or 1
    arr = np.zeros((max(nodes, 2), P * 2 * D), dtype=np.float32)
    ctx.register_linear_collection(coll_name, arr, elem_size=size,
                                   nodes=nodes,
                                   myrank=getattr(ctx, "rank", 0))
    ctx.register_arena(f"{coll_name}_t", size)
    tp = pt.Taskpool(ctx, globals={"NM": len(wanted) - 1})
    j = pt.L("j")
    msrc = tp.task_class("MSRC")
    msrc.param("j", 0, pt.G("NM"))
    msrc.affinity(coll_name, src_rank)
    mrecv = tp.task_class("MRECV")
    mrecv.param("j", 0, pt.G("NM"))
    mrecv.affinity(coll_name, dst_rank)

    def src_body(view):
        key = keys[wanted[view["j"]]]
        payload = src_pool.export_frozen(key)
        assert payload is not None, f"source lost frozen key {key}"
        buf = view.data("P", dtype=np.float32, shape=(P, 2 * D))
        buf[:, :D] = payload[0]
        buf[:, D:] = payload[1]

    recv_src = "MSRC"
    if relay_rank is not None:
        mfwd = tp.task_class("MFWD")
        mfwd.param("j", 0, pt.G("NM"))
        mfwd.affinity(coll_name, relay_rank)
        mfwd.flow("X", "R", pt.In(pt.Ref("MSRC", j, flow="P")),
                  arena=f"{coll_name}_t")
        mfwd.flow("P", "W", pt.Out(pt.Ref("MRECV", j, flow="P")),
                  arena=f"{coll_name}_t")

        def fwd_body(view):
            x = view.data("X", dtype=np.float32, shape=(P, 2 * D))
            p = view.data("P", dtype=np.float32, shape=(P, 2 * D))
            p[:] = x

        mfwd.body(fwd_body)
        msrc.flow("P", "W", pt.Out(pt.Ref("MFWD", j, flow="X")),
                  arena=f"{coll_name}_t")
        recv_src = "MFWD"
    else:
        msrc.flow("P", "W", pt.Out(pt.Ref("MRECV", j, flow="P")),
                  arena=f"{coll_name}_t")
    msrc.body(src_body)

    def recv_body(view):
        key = keys[wanted[view["j"]]]
        buf = view.data("P", dtype=np.float32, shape=(P, 2 * D))
        dst_pool.import_frozen(key, buf[:, :D], buf[:, D:])

    mrecv.flow("P", "R", pt.In(pt.Ref(recv_src, j, flow="P")),
               arena=f"{coll_name}_t")
    mrecv.body(recv_body)
    return tp

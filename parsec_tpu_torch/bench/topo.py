"""The topology suite (bench.py's `--topo`): four host ranks in two
islands (spec "0,1;2,3") under the island emulator's per-peer receive
delays — ring against hierarchical all_reduce, and the pair-chain DAG
at identity placement against the searched rank remap.  No device.
"""
from __future__ import annotations

import time

import numpy as np

from .common import host_provenance, spawn_ranks


def _topo_bench_worker(rank, port, spec, coll_bytes, reps, hops, elems,
                       delay_us, env, q):
    """One rank of the 4-rank two-island topology soak.  Two sections,
    one spawn:

      allreduce  ring against hierarchical two-level all_reduce of the
                 same payload — bit-exact against the numpy sum in both
                 modes, per-mode wall and per-class wire split
      remap      the pair-chain DAG whose identity placement crosses
                 the DCN on every hop: identity run, then
                 Taskpool.run(remap=True) under plan.remap_ranks() —
                 per-class byte deltas for both, per-rank wire_out_bound
                 soundness, payload-term tightness, bit-exactness
                 asserted inside every task body
    """
    try:
        import os
        for k2, v in env.items():
            os.environ[k2] = v
        os.environ["PTC_MCA_comm_topology"] = spec
        import parsec_tpu_torch as pt
        from parsec_tpu_torch.comm import coll
        from parsec_tpu_torch.comm.topology import TopologyModel
        from parsec_tpu_torch.utils.faults import (comm_fault_env,
                                                   island_delay_map)

        tmref = TopologyModel.parse(spec)
        nodes = tmref.nranks
        if delay_us:
            os.environ.update(comm_fault_env(
                delay_map=island_delay_map(rank, tmref, delay_us)))
        ctx = pt.Context(nb_workers=1)
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
        res = {}

        def snap():
            return {c: row["bytes_sent"] for c, row in
                    ctx.comm_topo_stats()["classes"].items()}

        with ctx:
            # ---- section A: ring vs hier all_reduce ----
            celems = max(1, coll_bytes // 4)
            arrs = [np.random.default_rng(r)
                    .integers(-4, 4, size=celems).astype(np.float32)
                    for r in range(nodes)]
            ref = sum(arrs).astype(np.float32)
            ar = {}
            for topo in ("ring", "hier"):
                walls = []
                ctx.comm_fence()
                b0 = snap()
                for rep in range(reps + 1):  # rep 0 = warmup
                    ctx.comm_fence()
                    t0 = time.perf_counter()
                    out = coll.all_reduce(ctx, arrs[rank], topo=topo)
                    ctx.comm_fence()
                    walls.append(time.perf_counter() - t0)
                    assert (out == ref).all(), topo  # bit-exact
                b1 = snap()
                ar[topo] = {"ms": round(min(walls[1:]) * 1e3, 3),
                            "dcn_bytes": b1["dcn"] - b0["dcn"]}
            res["allreduce"] = ar

            # ---- section B: identity vs remapped pair chain ----
            data = np.arange(elems, dtype=np.float32)
            # identical per-slot payload: any ownership permutation reads
            # identical bytes, so the remapped run's bit-exactness is
            # decided by the body asserts
            arr = np.tile(data, (nodes, 1))
            ctx.register_linear_collection("A", arr, elem_size=elems * 4,
                                           nodes=nodes, myrank=rank)
            ctx.register_arena("t", elems * 4)

            def build():
                tp = pt.Taskpool(ctx, globals={"NB": hops})
                c, k = pt.L("c"), pt.L("k")
                tc = tp.task_class("Hop")
                tc.param("c", 0, 1)
                tc.param("k", 0, pt.G("NB"))
                tc.affinity("A", c + 2 * (k % 2))
                tc.flow("A", "RW",
                        pt.In(pt.Mem("A", c), guard=(k == 0)),
                        pt.In(pt.Ref("Hop", c, k - 1, flow="A")),
                        pt.Out(pt.Ref("Hop", c, k + 1, flow="A"),
                               guard=(k < pt.G("NB"))),
                        arena="t")

                def body(view):
                    a = view.data("A", dtype=np.float32)
                    np.testing.assert_array_equal(a, data + view["k"])
                    a += 1.0

                tc.body(body)
                return tp

            tp = build()
            plan = tp.plan()
            b0 = snap()
            tp.run()
            tp.wait()
            ctx.comm_fence()
            b1 = snap()
            m_ident = {c: b1[c] - b0[c] for c in b1}
            # per-rank plan soundness: the measured per-class sends never
            # exceed the plan's classed wire_out_bound for this rank
            sound = all(m_ident[c] <= plan.wire_out_bound(rank, c)
                        for c in m_ident if c != "loopback")
            # payload-term tightness: on classes this rank sends bulk
            # over, the measured bytes sit within 25% of the modeled
            # payload
            tm = plan._tmodel()
            payload = {c: 0 for c in m_ident}
            for (s, d), b in plan.edges_bytes.items():
                if s == rank:
                    payload[tm.class_of(s, d)] += b
            tight = all(abs(m_ident[c] - p) <= 0.25 * p
                        for c, p in payload.items() if p >= 65536)

            arr[:] = data  # k==0 owner reads bumped the collection
            tp2 = build()
            perm = tp2.plan().remap_ranks()
            b0 = snap()
            tp2.run(remap=True)
            tp2.wait()
            ctx.comm_fence()
            b1 = snap()
            assert tp2.remap_applied == perm, (tp2.remap_applied, perm)
            m_remap = {c: b1[c] - b0[c] for c in b1}
            res["remap"] = {
                "perm": perm,
                "measured_ident": m_ident,
                "measured_remap": m_remap,
                "payload_ident": payload,
                "predicted_ident": plan.class_bytes(),
                "predicted_remap": plan.class_bytes(perm=perm),
                "rank_sound": bool(sound),
                "rank_payload_within_25pct": bool(tight),
            }
            ctx.set_rank_map(None)
            ctx.comm_fence()
            ctx.comm_fini()
        ctx.destroy()
        q.put(("ok", rank, res))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc()))


def _run_topo_quad(spec, coll_bytes, reps, hops, elems, delay_us, base,
                   env):
    """Spawn the 4-rank topology mesh (its ports from
    comm.launch.free_port_base when `base` is None) and return {rank:
    result}."""
    from parsec_tpu_torch.comm.launch import free_port_base
    from parsec_tpu_torch.comm.topology import TopologyModel
    nodes = TopologyModel.parse(spec).nranks
    if base is None:
        base = free_port_base(nodes)
    by_rank = spawn_ranks(_topo_bench_worker,
                          lambda r: (r, base, spec, coll_bytes, reps, hops,
                                     elems, delay_us, dict(env)), nodes)
    return {r: res[2] for r, res in by_rank.items()}


def bench_topo_suite(spec="0,1;2,3", coll_bytes=1 << 20, reps=3, hops=8,
                     elems=1 << 16, delay_us=500, base=None):
    """The topology document: the 4-rank two-island soak under the island
    emulator's receive delays.  The searched rank remap must cut the
    measured dcn bytes of the pair-chain DAG >= 30% against identity,
    the plan's per-class byte split must be sound (measured <= classed
    wire_out_bound on every rank, payload term within 25%), and every
    payload, hierarchical collectives included, bit-identical."""
    from parsec_tpu_torch.comm.topology import LINK_CLASSES
    by_rank = _run_topo_quad(spec, coll_bytes, reps, hops, elems,
                             delay_us, base, {})
    nodes = len(by_rank)
    doc = {
        "bench": "topo",
        "when": time.strftime("%Y-%m-%dT%H:%M:%S"),
        **host_provenance(threads=nodes),
        "knobs": {"spec": spec, "coll_bytes": coll_bytes, "reps": reps,
                  "hops": hops, "elems": elems, "delay_us": delay_us},
    }
    # slowest rank's best wall per mode; dcn bytes summed over ranks
    ar = {}
    for topo in ("ring", "hier"):
        ar[f"{topo}_ms"] = max(r["allreduce"][topo]["ms"]
                               for r in by_rank.values())
        ar[f"dcn_bytes_{topo}"] = sum(r["allreduce"][topo]["dcn_bytes"]
                                      for r in by_rank.values())
    ar["hier_vs_ring"] = (round(ar["hier_ms"] / ar["ring_ms"], 4)
                          if ar["ring_ms"] else None)
    ar["dcn_ratio_hier_vs_ring"] = (
        round(ar["dcn_bytes_hier"] / ar["dcn_bytes_ring"], 4)
        if ar["dcn_bytes_ring"] else None)
    ar["bit_identical"] = True  # workers assert it per rep, both modes
    doc["allreduce"] = ar

    r0 = by_rank[0]["remap"]
    measured = {}
    for key in ("measured_ident", "measured_remap"):
        measured[key] = {c: sum(r["remap"][key][c]
                                for r in by_rank.values())
                         for c in LINK_CLASSES}
    ident_dcn = measured["measured_ident"]["dcn"]
    remap_dcn = measured["measured_remap"]["dcn"]
    reduction = (round(1.0 - remap_dcn / ident_dcn, 4)
                 if ident_dcn else None)
    doc["remap"] = {
        "perm": r0["perm"],
        "ident_dcn_bytes": ident_dcn,
        "remap_dcn_bytes": remap_dcn,
        "dcn_reduction": reduction,
        "predicted_ident": r0["predicted_ident"],
        "predicted_remap": r0["predicted_remap"],
        "measured_ident": measured["measured_ident"],
        "measured_remap": measured["measured_remap"],
        "predicted_sound": all(r["remap"]["rank_sound"]
                               for r in by_rank.values()),
        "payload_within_25pct": all(
            r["remap"]["rank_payload_within_25pct"]
            for r in by_rank.values()),
    }
    doc["bit_identical"] = True  # every body/collective assert passed
    # the acceptance floor: fail the suite loudly
    if reduction is None or reduction < 0.30:
        raise AssertionError(f"dcn reduction below 0.30: {doc['remap']}")
    if not doc["remap"]["predicted_sound"]:
        raise AssertionError(f"plan not sound: {doc['remap']}")
    return doc

"""The cross-rank streaming suite (bench.py's `--stream`): a rank-hopping
RW chain of device chores on two spawned ranks, each with a CudaDevice
on the chosen device (both on the one card by default), the serialized
serve against the streamed pipeline and one rail against two, and the
tuner's (chunk x rails) proposals validated with real pairs.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .common import host_provenance, spawn_ranks, torch_device


def _stream_bump(x):
    # module-level: a spawned rank imports it by name
    return x + 1.0


def _stream_worker(rank, port, size, hops, reps, env, device, q):
    """One rank of the cross-rank device-to-device streaming sweep: a
    rank-hopping RW chain of device chores whose datum is a `size`-byte
    tile — every hop a full cross-rank device move (producer d2h, wire,
    consumer h2d).  One persistent process pair serves all reps (rep 0
    carries the session setup and is reported apart)."""
    try:
        import os
        for k, v in env.items():
            os.environ[k] = v
        import parsec_tpu_torch as pt
        from parsec_tpu_torch.device import CudaDevice

        ctx = pt.Context(nb_workers=1)
        ctx.set_rank(rank, 2)
        ctx.comm_init(port)
        dev = CudaDevice(ctx, device=device)
        elems = max(1, size // 4)
        arr = np.zeros((2, elems), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=size,
                                       nodes=2, myrank=rank)
        ctx.register_arena("t", size)
        k = pt.L("k")

        def build():
            tp = pt.Taskpool(ctx, globals={"NB": hops})
            tc = tp.task_class("Hop")
            tc.param("k", 0, pt.G("NB"))
            tc.affinity("A", k % 2)
            tc.flow("A", "RW",
                    pt.In(pt.Mem("A", 0), guard=(k == 0)),
                    pt.In(pt.Ref("Hop", k - 1, flow="A")),
                    pt.Out(pt.Ref("Hop", k + 1, flow="A"),
                           guard=(k < pt.G("NB"))),
                    arena="t")
            dev.attach(tc, tp, kernel=_stream_bump, reads=["A"],
                       writes=["A"], shapes={"A": (elems,)},
                       dtype=np.float32)
            return tp

        walls = []
        for rep in range(reps + 1):  # rep 0 = setup, reported apart
            tp = build()
            ctx.comm_fence()
            t0 = time.perf_counter()
            tp.run()
            tp.wait()
            ctx.comm_fence()
            walls.append(time.perf_counter() - t0)
        stream = ctx.comm_stream_stats()
        dstats = {k2: dev.stats.get(k2, 0) for k2 in
                  ("stream_serves", "stream_slices", "stream_d2h_ns",
                   "stream_bytes", "prefetch_wakeups", "dp_recv_bytes",
                   "h2d_stall_ns")}
        dp_errors = dev.stats.get("dp_errors", 0)
        dev.stop()
        ctx.comm_fini()
        ctx.destroy()
        if dp_errors:
            raise RuntimeError(f"rank {rank}: {dp_errors} data-plane "
                               "errors")
        q.put(("ok", rank, walls, stream, dstats))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc(), None, None))


def _stream_pair(size, hops, reps, port, stream, rails,
                 chunk=1 << 20, inflight=4, device="cuda"):
    """Run one knob configuration on a fresh persistent 2-process pair
    (its ports from comm.launch.free_port_base when `port` is None);
    returns per-transfer latency and the producer-side span evidence."""
    from parsec_tpu_torch.comm.launch import free_port_base
    if port is None:
        port = free_port_base(2)
    env = {"PTC_MCA_comm_eager_limit": "0",
           "PTC_MCA_comm_chunk_size": str(chunk),
           "PTC_MCA_comm_inflight": str(inflight),
           "PTC_MCA_comm_stream": str(stream),
           "PTC_MCA_comm_rails": str(rails)}
    by_rank = spawn_ranks(_stream_worker,
                          lambda r: (r, port, size, hops, reps, env, device))
    walls = [max(by_rank[0][2][i], by_rank[1][2][i])
             for i in range(reps + 1)]
    per = [w / hops for w in walls[1:]]
    best = min(per)
    # span evidence accumulates on both ranks (each serves the hops it
    # produced): sum the windows for the pair-level overlap fraction
    s0, s1 = by_rank[0][3], by_rank[1][3]
    d2h = s0["d2h_ns"] + s1["d2h_ns"]
    overlap = s0["overlap_ns"] + s1["overlap_ns"]
    return {
        "size_bytes": size, "stream": bool(stream), "rails": rails,
        "setup_ms": round(walls[0] * 1e3, 2),
        "per_transfer_ms": round(best * 1e3, 3),
        "per_transfer_ms_all": [round(t * 1e3, 3) for t in per],
        "gbps": round(size * 8 / best / 1e9, 3),
        "sessions": s0["sessions"] + s1["sessions"],
        "parked_gets": s0["parked_gets"] + s1["parked_gets"],
        "d2h_ns": d2h, "wire_ns": s0["wire_ns"] + s1["wire_ns"],
        "overlap_ns": overlap,
        "overlap_fraction": round(overlap / d2h, 4) if d2h else None,
        "device": {r: by_rank[r][4] for r in (0, 1)},
    }


def bench_stream_tuned(size, hops, reps, base=None, device="cuda"):
    """Plan-driven autotuning of the streamed cross-rank tile chain: the
    fitted transfer-economics model proposes (chunk quantum x rails)
    vectors, the top-k and the defaults are validated with real
    2-process pairs (interleaved rounds, the median per candidate), and
    the winner persists keyed by (workload key, host fingerprint).
    `base` (None: free ports per pair) is the first pair's port."""
    from parsec_tpu_torch.analysis.tune import (TuneStore, host_fingerprint,
                                                propose_stream)
    from parsec_tpu_torch.comm.topology import comm_knob
    from parsec_tpu_torch.utils import params as _mca
    topk = 3 if reps >= 2 else 2        # see bench_collective_tuned
    rounds = 3 if reps >= 2 else 1
    props = propose_stream(size, hops, topk=topk)
    dk = {"comm.chunk_size": _mca.get("comm.chunk_size"),
          "comm.rails": comm_knob("comm.rails")}
    samples = {i: [] for i in range(len(props))}
    for rnd in range(rounds):
        for i, p in enumerate(props):
            r = _stream_pair(size, hops, reps,
                             None if base is None else
                             base + 4 * (rnd * len(props) + i),
                             stream=1,
                             rails=int(p["knobs"]["comm.rails"]),
                             chunk=int(p["knobs"]["comm.chunk_size"]),
                             device=device)
            samples[i].append(r["per_transfer_ms"])
    validated = [{"knobs": p["knobs"],
                  "predicted_ns": round(p["predicted_ns"]),
                  "per_transfer_ms": sorted(samples[i])[rounds // 2],
                  "per_transfer_ms_rounds": samples[i]}
                 for i, p in enumerate(props)]
    default = next(r for r in validated if r["knobs"] == dk)
    winner = min(validated, key=lambda r: (r["per_transfer_ms"],
                                           r["predicted_ns"]))
    ratio = (winner["per_transfer_ms"] / default["per_transfer_ms"]
             if default["per_transfer_ms"] else None)
    host = host_fingerprint()
    TuneStore().put(f"stream:{size}:{hops}:2", host, {
        "knobs": winner["knobs"],
        "predicted_ns": winner["predicted_ns"],
        "measured_s": winner["per_transfer_ms"] / 1e3,
        "critpath_ratio": None,
        "source": "bench-stream",
    })
    return {
        "workload": "device_tile_chain", "size_bytes": size,
        "hops": hops, "reps": reps, "host": host,
        "default_knobs": dk,
        "default_per_transfer_ms": default["per_transfer_ms"],
        "winner_knobs": winner["knobs"],
        "winner_per_transfer_ms": winner["per_transfer_ms"],
        "tuned_vs_default": round(ratio, 4) if ratio else None,
        "beats_default": bool(ratio is not None and ratio <= 1.0),
        "validated": validated,
        "persisted": True,
    }


def bench_stream_suite(size=4 << 20, hops=8, reps=3, chunk=1 << 20,
                       inflight=4, device="cuda"):
    """The stream document: steady-state cross-rank device-to-device
    tile latency with the streaming pipeline on (progressive serve, 2
    rails) against the serialized serve (stream off, 1 rail), plus one
    rail against two at stream on.  Per-hop span evidence (d2h window,
    wire window, their overlap) from the engine's stream stats; the
    ratio is streamed/serialized per-transfer latency (target <= 0.6).
    Each pair's ports come from comm.launch.free_port_base (a fixed
    base can fall in the kernel's ephemeral range)."""
    from parsec_tpu_torch.comm.topology import comm_knob
    from parsec_tpu_torch.utils import params as _mca
    device = str(torch_device(str(device)))
    # per rank: worker + comm thread + device manager + writeback +
    # prefetch lane, two ranks
    doc = {
        "bench": "stream",
        **host_provenance(threads=2 * 5),
        "knobs": {"comm_rails": int(comm_knob("comm.rails")),
                  "comm_chunk_size": chunk,
                  "comm_inflight": inflight,
                  "comm_stream": bool(_mca.get("comm.stream")),
                  "comm_eager_limit": 0,
                  "size_bytes": size, "hops": hops, "reps": reps},
    }
    doc["serialized"] = _stream_pair(size, hops, reps, None, stream=0,
                                     rails=1, chunk=chunk,
                                     inflight=inflight, device=device)
    doc["streamed"] = _stream_pair(size, hops, reps, None, stream=1,
                                   rails=2, chunk=chunk,
                                   inflight=inflight, device=device)
    doc["rails1_streamed"] = _stream_pair(size, hops, reps, None,
                                          stream=1, rails=1, chunk=chunk,
                                          inflight=inflight, device=device)
    doc["tuned"] = bench_stream_tuned(size, hops, max(1, reps - 1),
                                      device=device)
    ser = doc["serialized"]["per_transfer_ms"]
    stm = doc["streamed"]["per_transfer_ms"]
    doc["stream_vs_serialized_ratio"] = round(stm / ser, 4) if ser else None
    doc["ratio_target"] = 0.6
    r1 = doc["rails1_streamed"]["gbps"]
    r2 = doc["streamed"]["gbps"]
    doc["rails2_vs_rails1_throughput"] = round(r2 / r1, 4) if r1 else None
    if doc["oversubscribed"]:
        doc["caveat"] = (
            f"pipeline threads ({doc['pipeline_threads']}) > cores "
            f"({doc['host']['cpu_count']}): the producer's d2h slicer, "
            "both comm threads and the consumer's prefetch lane "
            "timeshare, so the measured overlap/ratio understate what "
            "distinct cores deliver — re-run on a multicore host for "
            "the real pipeline number")
        sys.stderr.write(f"bench-stream WARNING: {doc['caveat']}\n")
    return doc

"""The collective suite (bench.py's `--collective`): the k-split GEMM
panel reduction on two spawned host ranks, the DAG-dependency chain
against the runtime-native streamed collective, their merged traces'
lost time and overlap, the tuner's proposals validated with real pairs,
and the library collective beside them: torch.distributed.all_reduce of
the same payloads over the two ranks on the chosen device, over gloo
(NCCL refuses two ranks on one card).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from .common import host_provenance, spawn_ranks, torch_device


def _coll_bench_worker(rank, port, sizes, reps, trace_dir, env, q):
    """One rank of the 2-rank collective bench: k-split GEMM with a
    cross-rank panel reduction per message size (C = sum_r A_r @ B_r,
    the C matrix is the reduced message), the DAG-dependency chain
    against the runtime-native streamed collective.  The largest size's
    final rep also runs at trace level 2 and saves per-mode .ptt files
    for the parent's lost-time / overlap analysis."""
    try:
        for k2, v in env.items():
            os.environ[k2] = v
        import parsec_tpu_torch as pt
        from parsec_tpu_torch.algos.gemm import gemm_panel_reduce
        from parsec_tpu_torch.profiling import take_trace

        ctx = pt.Context(nb_workers=1)
        ctx.set_rank(rank, 2)
        ctx.comm_init(port)
        Nc, K = 256, 128
        ks = K // 2
        rng = np.random.default_rng(11)
        sweep = []
        with ctx:
            for si, size in enumerate(sizes):
                M = max(2, size // (4 * Nc))
                a = rng.integers(-4, 4, size=(M, K)).astype(np.float32)
                b = rng.integers(-4, 4, size=(K, Nc)).astype(np.float32)
                a_slab = a[:, rank * ks:(rank + 1) * ks].copy()
                b_slab = b[rank * ks:(rank + 1) * ks].copy()
                ref = sum(a[:, r * ks:(r + 1) * ks] @ b[r * ks:(r + 1) * ks]
                          for r in range(2)).astype(np.float32)
                entry = {"size_bytes": M * Nc * 4}
                traced = trace_dir and si == len(sizes) - 1
                # 4 row panels: panel p's reduction overlaps panel p+1's
                # compute in coll mode
                prow = max(1, M // 4)
                for mode in ("chain", "coll"):
                    walls = []
                    for rep in range(reps + 1):  # rep 0 = warmup
                        trace_this = traced and rep == reps
                        if trace_this:
                            ctx.profile_enable(2)
                        ctx.comm_fence()
                        t0 = time.perf_counter()
                        c = gemm_panel_reduce(ctx, a_slab, b_slab,
                                              reduce=mode,
                                              panel_rows=prow)
                        ctx.comm_fence()
                        walls.append(time.perf_counter() - t0)
                        if trace_this:
                            take_trace(ctx).save(os.path.join(
                                trace_dir, f"{mode}_r{rank}.ptt"))
                    assert (c == ref).all(), mode  # bit-exact, both modes
                    entry[f"{mode}_ms"] = round(min(walls[1:]) * 1e3, 3)
                sweep.append(entry)
            st = ctx.coll_stats()
            ctx.comm_fini()
        ctx.destroy()
        q.put(("ok", rank, sweep, st))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc(), None))


def _all_reduce_worker(rank, port, sizes, reps, device, q):
    """One rank of the library baseline: torch.distributed.all_reduce
    (gloo) of size/2 bytes a rank on `device`, every result checked
    against the sum of both contributions; rank 0 reports the best of
    `reps` timed calls per size (rep 0 warms up)."""
    try:
        import torch
        import torch.distributed as dist
        dev = torch.device(device)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        out = {}
        try:
            for size in sizes:
                elems = max(1, size // 8)  # 2 contributions of size/2
                xs = [np.random.default_rng(r).integers(
                    -4, 4, size=elems).astype(np.float32) for r in range(2)]
                want = torch.from_numpy(xs[0] + xs[1]).to(dev)
                ts = []
                for _ in range(reps + 1):
                    t = torch.tensor(xs[rank], device=dev)  # a copy
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    dist.barrier()
                    t0 = time.perf_counter()
                    dist.all_reduce(t)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    ts.append(time.perf_counter() - t0)
                    if not torch.equal(t, want):
                        raise AssertionError(f"all_reduce of {size} B "
                                             "differs from the sum")
                out[str(size)] = round(min(ts[1:]) * 1e3, 3)
        finally:
            dist.destroy_process_group()
        q.put(("ok", rank, out))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc()))


def _torch_all_reduce_baseline(sizes, reps, device="cuda"):
    """The library collective of the same payload sizes: whole-array
    torch.distributed.all_reduce over two spawned ranks on `device`
    (gloo), {str(size): best ms} — the bulk-synchronous call the
    runtime-native path replaces."""
    from parsec_tpu_torch.comm.launch import free_port_base
    port = free_port_base(1)
    by_rank = spawn_ranks(_all_reduce_worker,
                          lambda r: (r, port, list(sizes), reps, device))
    return by_rank[0][2]


def _coll_trace_metrics(trace_dir, mode):
    """Merged-trace evidence for one gemm mode: lost-time totals
    (comm_wait + coll_wait = wire starvation) and the compute/wire
    overlap fraction — |union(EXEC) ∩ union(wire in-flight)| over
    |union(wire in-flight)|, wire intervals from matched send->recv flow
    pairs after clock sync."""
    from parsec_tpu_torch.profiling import Trace, lost_time
    from parsec_tpu_torch.profiling.critpath import _union_ns
    from parsec_tpu_torch.profiling.trace import KEY_EXEC

    traces = [Trace.load(os.path.join(trace_dir, f"{mode}_r{r}.ptt"))
              for r in range(2)]
    m = Trace.merge(traces)
    lt = lost_time(m)["totals"]
    t = m._spans_table()
    exec_iv = [(int(b), int(e))
               for b, e in t[t[:, 2] == KEY_EXEC][:, 7:9]]
    fl = m.flows()
    wire_iv = [(int(r[4]), int(r[5])) for r in fl if r[5] > r[4]]
    wire_ns = _union_ns(list(wire_iv))
    inter = (_union_ns(list(exec_iv)) + wire_ns
             - _union_ns(list(exec_iv) + list(wire_iv)))
    return {
        "lost_time_totals": {k: int(v) for k, v in lt.items()},
        "comm_plus_coll_wait_ns": int(lt["comm_wait"] + lt["coll_wait"]),
        "wire_inflight_ns": int(wire_ns),
        "matched_flows": int(len(fl)),
        "overlap_fraction": (round(inter / wire_ns, 4)
                             if wire_ns else None),
    }


def _run_coll_pair(sizes, reps, base, env, trace_dir=""):
    """Spawn the 2-rank collective bench pair (optionally under extra
    env — the tuner's knob spelling; `base` None takes free ports) and
    return {rank: result}."""
    from parsec_tpu_torch.comm.launch import free_port_base
    port = free_port_base(2) if base is None else base
    return spawn_ranks(_coll_bench_worker,
                       lambda r: (r, port, list(sizes), reps, trace_dir,
                                  dict(env)))


def bench_collective_tuned(size, reps=2, base=None):
    """Plan-driven autotuning of the runtime-native collective: the
    closed-form transfer-economics model proposes topology x slicing
    vectors for the largest reduction, the top-k and the defaults are
    validated with real 2-rank gemm_panel_reduce runs (knobs cross into
    the ranks as PTC_MCA_* env; interleaved rounds, the median per
    candidate), and the winner persists keyed by (workload key, host
    fingerprint).  Bit-exactness holds in every validation run (the
    worker asserts it)."""
    from parsec_tpu_torch.analysis.tune import (TuneStore, host_fingerprint,
                                                knob_env, propose_collective)
    from parsec_tpu_torch.utils import params as _mca
    # schema-smoke runs (reps <= 1) shrink the validation matrix
    topk = 3 if reps >= 2 else 2
    rounds = 3 if reps >= 2 else 1
    props = propose_collective(size, 2, topk=topk)
    dk = {"coll.topo": _mca.get("coll.topo"),
          "coll.max_slices": _mca.get("coll.max_slices"),
          "comm.eager_limit": _mca.get("comm.eager_limit")}
    samples = {i: [] for i in range(len(props))}
    for rnd in range(rounds):
        for i, p in enumerate(props):
            by_rank = _run_coll_pair(
                [size], reps,
                None if base is None else base + 4 * (rnd * len(props) + i),
                knob_env(p["knobs"]))
            samples[i].append(max(by_rank[0][2][0]["coll_ms"],
                                  by_rank[1][2][0]["coll_ms"]))
    validated = [{"knobs": p["knobs"],
                  "predicted_ns": round(p["predicted_ns"]),
                  "coll_ms": sorted(samples[i])[rounds // 2],
                  "coll_ms_rounds": samples[i]}
                 for i, p in enumerate(props)]
    default = next(r for r in validated if r["knobs"] == dk)
    winner = min(validated, key=lambda r: (r["coll_ms"],
                                           r["predicted_ns"]))
    ratio = (winner["coll_ms"] / default["coll_ms"]
             if default["coll_ms"] else None)
    host = host_fingerprint()
    TuneStore().put(f"coll:{size}:2", host, {
        "knobs": winner["knobs"],
        "predicted_ns": winner["predicted_ns"],
        "measured_s": winner["coll_ms"] / 1e3,
        "critpath_ratio": None,
        "source": "bench-collective",
    })
    return {
        "workload": "gemm_panel_reduce", "size_bytes": size,
        "reps": reps, "host": host,
        "default_knobs": dk, "default_coll_ms": default["coll_ms"],
        "winner_knobs": winner["knobs"],
        "winner_coll_ms": winner["coll_ms"],
        "tuned_vs_default": round(ratio, 4) if ratio else None,
        "beats_default": bool(ratio is not None and ratio <= 1.0),
        "validated": validated,
        "persisted": True,
    }


def bench_collective_suite(sizes=(64 << 10, 512 << 10, 2 << 20), reps=3,
                           device="cuda"):
    """The collective document: the DAG-dependency reduction (whole-array
    partials, a serial rank chain) against the runtime-native streamed
    collective (panels feed the ptc_coll_* reduction as they complete)
    across message sizes on a 2-rank pair, plus the library
    torch.distributed.all_reduce of the same sizes on `device`.  The
    largest size carries level-2 traces: comm_wait+coll_wait should
    shrink and the compute/wire overlap rise for coll against chain.
    Oversubscribed hosts are flagged."""
    from parsec_tpu_torch.comm.topology import comm_knob
    from parsec_tpu_torch.utils import params as _mca

    device = str(torch_device(str(device)))
    base = int(os.environ["PTC_PORT"]) if os.environ.get("PTC_PORT") \
        else None
    trace_dir = tempfile.mkdtemp(prefix="bench_coll_")
    by_rank = _run_coll_pair(list(sizes), reps, base, {}, trace_dir)
    sweep = []
    for i, size in enumerate(sizes):
        e0, e1 = by_rank[0][2][i], by_rank[1][2][i]
        entry = {"size_bytes": e0["size_bytes"]}
        for mode in ("chain", "coll"):
            entry[f"{mode}_ms"] = max(e0[f"{mode}_ms"], e1[f"{mode}_ms"])
        entry["coll_vs_chain_ratio"] = (
            round(entry["coll_ms"] / entry["chain_ms"], 4)
            if entry["chain_ms"] else None)
        sweep.append(entry)
    # per rank: 2 workers + comm thread
    doc = {
        "bench": "collective",
        **host_provenance(threads=2 * 2),
        "knobs": {
            "coll_topo": _mca.get("coll.topo"),
            "coll_slice": _mca.get("coll.slice"),
            "coll_max_slices": _mca.get("coll.max_slices"),
            "comm_chunk_size": _mca.get("comm.chunk_size"),
            "comm_rails": comm_knob("comm.rails"),
            "comm_stream": bool(_mca.get("comm.stream")),
            "sizes": list(sizes), "reps": reps, "nodes": 2,
        },
        "sweep": sweep,
        "coll_topology_ops": by_rank[0][3]["by_topo"],
    }
    gemm = {}
    for mode in ("chain", "coll"):
        gemm[mode] = _coll_trace_metrics(trace_dir, mode)
    waits = {m: gemm[m]["comm_plus_coll_wait_ns"]
             for m in ("chain", "coll")}
    gemm["wait_reduction"] = (
        round(1.0 - waits["coll"] / waits["chain"], 4)
        if waits["chain"] else None)
    ov = {m: gemm[m]["overlap_fraction"] for m in ("chain", "coll")}
    gemm["overlap_fraction_gain"] = (
        round(ov["coll"] - ov["chain"], 4)
        if ov["coll"] is not None and ov["chain"] is not None else None)
    doc["gemm_panel"] = gemm
    doc["torch_all_reduce_ms"] = _torch_all_reduce_baseline(sizes, reps,
                                                            device)
    big = sweep[-1]
    doc["coll_vs_chain_ratio"] = big["coll_vs_chain_ratio"]
    doc["tuned"] = bench_collective_tuned(
        sizes[-1], reps=max(1, reps - 1),
        base=None if base is None else base + 40)
    if doc["oversubscribed"]:
        doc["caveat"] = (
            f"bench threads ({doc['pipeline_threads']}) > cores "
            f"({doc['host']['cpu_count']}): both ranks' workers and "
            "comm threads timeshare, so panel compute cannot truly "
            "overlap the reduction wire — ratios and overlap fractions "
            "understate what distinct cores deliver, and the "
            "comm_wait+coll_wait totals INFLATE for the streamed mode "
            "(its many small deliveries tag the timesharing gaps as "
            "wire starvation) — wait_reduction is only meaningful on "
            "a multicore host")
        sys.stderr.write(f"bench-collective WARNING: {doc['caveat']}\n")
    return doc

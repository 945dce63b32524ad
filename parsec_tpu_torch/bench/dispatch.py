"""Host dispatch suites: the single-chain and contended dispatch
latencies, the plan-driven autotuned chain, and the embarrassingly
parallel scheduler sweep (bench.py's `--dispatch`, `--dispatch-mt`,
`--ep`).  No device: these measure the task runtime alone.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

import parsec_tpu_torch as pt

from .common import host_provenance


def _chain_taskpool(ctx, nb_tasks):
    """The Ex04-style single-RW-chain pool every dispatch bench (and
    the ptc-tune dispatch workload) measures."""
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": nb_tasks - 1})
    k = pt.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("Task", k - 1, flow="A")),
            pt.Out(pt.Ref("Task", k + 1, flow="A"),
                   guard=(k < pt.G("NB"))),
            arena="t")
    tc.body_noop()
    return tp


def bench_dispatch_chain(nb_tasks: int = 20000, reps: int = 5):
    """Single-chain steady-state dispatch latency: p50/p99 of successor
    EXEC-begin deltas on an Ex04-style RW chain, 1 worker, span tracing
    on.  Returns the best rep's percentiles plus that run's
    Context.sched_stats() (the bypass/freelist counters show the fast
    path ran)."""
    best = None
    for _ in range(reps):
        with pt.Context(nb_workers=1) as ctx:
            ctx.profile_enable(1)  # EXEC spans only: keep the hot path lean
            tp = _chain_taskpool(ctx, nb_tasks)
            tp.run()
            tp.wait()
            ev = ctx.profile_take()
            stats = ctx.sched_stats()
        begins = ev[(ev[:, 0] == 0) & (ev[:, 1] == 0)]
        order = np.argsort(begins[:, 3])   # sort by l0 = k
        t = begins[order, 7]               # t_ns (8-word event format)
        deltas_us = np.diff(t) / 1e3
        deltas_us = deltas_us[len(deltas_us) // 10:]
        rep = {"p50_us": round(float(np.percentile(deltas_us, 50)), 3),
               "p99_us": round(float(np.percentile(deltas_us, 99)), 3)}
        if best is None or rep["p50_us"] < best["p50_us"]:
            best = rep
            best["sched_stats"] = stats
    best.update(tasks=nb_tasks, reps=reps, workers=1)
    return best


def bench_dispatch_mt(nb_tasks: int = 4000, lanes: int = 8, workers: int = 4,
                      reps: int = 5):
    """Multi-worker dispatch latency: `lanes` independent RW chains on
    `workers` workers, every release_deps hitting the dense dep engine
    while other workers do the same; p50/p99 of intra-chain
    successor-begin deltas across all lanes.  Records os.cpu_count() and
    the effective worker count, and flags oversubscription (workers >
    cores measures context-switch luck, not lock contention)."""
    best = None
    eff_workers = workers
    for _ in range(reps):
        with pt.Context(nb_workers=workers) as ctx:
            eff_workers = ctx.nb_workers
            ctx.profile_enable(1)
            ctx.register_arena("t", 8)
            tp = pt.Taskpool(ctx, globals={"NB": nb_tasks - 1,
                                           "L": lanes - 1})
            k, l = pt.L("k"), pt.L("l")
            tc = tp.task_class("Task")
            tc.param("l", 0, pt.G("L"))
            tc.param("k", 0, pt.G("NB"))
            tc.flow("A", "RW",
                    pt.In(None, guard=(k == 0)),
                    pt.In(pt.Ref("Task", l, k - 1, flow="A")),
                    pt.Out(pt.Ref("Task", l, k + 1, flow="A"),
                           guard=(k < pt.G("NB"))),
                    arena="t")
            tc.body_noop()
            tp.run()
            tp.wait()
            ev = ctx.profile_take()
            stats = ctx.sched_stats()
        begins = ev[(ev[:, 0] == 0) & (ev[:, 1] == 0)]
        deltas = []
        for lane in range(lanes):
            lane_ev = begins[begins[:, 3] == lane]  # l0 = l
            order = np.argsort(lane_ev[:, 4])       # l1 = k
            t = lane_ev[order, 7]
            d = np.diff(t) / 1e3
            deltas.append(d[len(d) // 10:])
        deltas = np.concatenate(deltas)
        rep = {"p50_us": round(float(np.percentile(deltas, 50)), 3),
               "p99_us": round(float(np.percentile(deltas, 99)), 3)}
        if best is None or rep["p50_us"] < best["p50_us"]:
            best = rep
            best["sched_stats"] = stats
    prov = host_provenance(threads=eff_workers)
    over = prov["oversubscribed"]
    best.update(tasks=nb_tasks, lanes=lanes, reps=reps,
                workers_requested=workers, workers=eff_workers,
                cpu_count=prov["host"]["cpu_count"], oversubscribed=over)
    if over:
        best["caveat"] = (
            f"workers ({eff_workers}) > cores "
            f"({best['cpu_count']}): workers "
            "timeshare, so this measures scheduling luck, NOT lock "
            "contention — re-run on a multicore host for a real "
            "contended number")
        sys.stderr.write(f"bench-dispatch-mt WARNING: {best['caveat']}\n")
    return best


def bench_ep(nb_tasks=100000, workers=(1, 2, 4, 8), scheds=None):
    """Embarrassingly-parallel scheduler throughput (the reference
    vehicle: tests/runtime/scheduling/ep.jdf).  Native noop bodies: no
    GIL, pure dispatch path.  Prints a (scheduler x workers) tasks/s
    table to stderr and returns the matrix."""
    if scheds is None:
        scheds = ["lfq", "lws", "ll", "ltq", "pbq", "lhq", "gd", "ap",
                  "spq", "ip", "rnd"]
    results = {}
    steals = {}
    for w in workers:
        for s in scheds:
            with pt.Context(nb_workers=w, scheduler=s) as ctx:
                tp = pt.Taskpool(ctx, globals={"NB": nb_tasks - 1})
                tc = tp.task_class("EP")
                tc.param("k", 0, pt.G("NB"))
                tc.body_noop()
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                dt = time.perf_counter() - t0
                stl = sum(ctx.worker_steals())
            results[(s, w)] = nb_tasks / dt
            steals[(s, w)] = stl
    sys.stderr.write("ep tasks/s (%d tasks; (steals) per cell)\n%-6s"
                     % (nb_tasks, "sched"))
    for w in workers:
        sys.stderr.write(f"{w:>12d}w")
    sys.stderr.write("\n")
    for s in scheds:
        sys.stderr.write("%-6s" % s)
        for w in workers:
            sys.stderr.write(
                f"{results[(s, w)]:>13,.0f}({steals[(s, w)]})")
        sys.stderr.write("\n")
    return results


def _ep_json():
    res = bench_ep()
    best = max(res, key=res.get)
    return json.dumps({
        "metric": "ep_tasks_per_sec",
        "value": round(res[best], 0),
        "unit": "tasks/s",
        "vs_baseline": round(res[best] / 1e6, 3),  # 1M tasks/s target
        "config": {"sched": best[0], "workers": best[1]},
    })


def _dispatch_json(single=None):
    if single is None:
        single = bench_dispatch_chain()
    p50_us = single["p50_us"]
    return json.dumps({
        "metric": "task_dispatch_p50",
        "value": round(p50_us, 3),
        "unit": "us",
        "vs_baseline": round(5.0 / p50_us, 3),
    })


def bench_dispatch_tuned(tasks=20000, reps=3, topk=3):
    """Plan-driven autotuning of the dispatch chain (ptc-tune): warm a
    chain run so the always-on histograms seed the CostModel, let the
    schedule simulator propose knob vectors, validate the top-k and the
    defaults with real chain runs under apply_knobs (fresh contexts, so
    the env-read native knobs bind), and persist the winner keyed by
    (graph signature, host fingerprint).  tuned_vs_default (<= 1.0: the
    autotuner beat or matched the defaults) and beats_default are
    recorded."""
    from parsec_tpu_torch.analysis import CostModel, autotune
    from parsec_tpu_torch.analysis.tune import apply_knobs, default_knobs
    from parsec_tpu_torch.profiling import take_trace

    def measure(knobs):
        """Best-of-reps chain wall time under the vector; the last rep
        carries a level-2 trace so the validator records the
        predicted-vs-measured critical path ratio per run."""
        best, trace = None, None
        with apply_knobs(knobs):
            for rep in range(reps + 1):  # rep 0: untimed warmup
                with pt.Context(nb_workers=1) as ctx:
                    ctx.profile_enable(2)
                    tp = _chain_taskpool(ctx, tasks)
                    t0 = time.perf_counter()
                    tp.run()
                    tp.wait()
                    dt = time.perf_counter() - t0
                    tr = take_trace(ctx)
                if rep == 0:
                    continue
                if best is None or dt < best:
                    best, trace = dt, tr
        return best, trace

    with pt.Context(nb_workers=1) as ctx:
        warm = _chain_taskpool(ctx, tasks)
        warm.run()
        warm.wait()
        cost = CostModel.from_context(ctx)
        res = autotune(warm, measure=measure, topk=topk, cost=cost,
                       workers=1)
    # the default vector always rides along (propose() guarantees it)
    dk = default_knobs()
    default = next(r for r in res["validated"] if r["knobs"] == dk)
    winner = res["winner"]
    ratio = (winner["measured_s"] / default["measured_s"]
             if default["measured_s"] else None)
    return {
        "workload": "single_chain", "tasks": tasks, "reps": reps,
        "signature": res["signature"], "host": res["host"],
        "default_knobs": dk,
        "default_wall_s": round(default["measured_s"], 6),
        "default_us_per_task": round(
            default["measured_s"] / tasks * 1e6, 4),
        "winner_knobs": winner["knobs"],
        "winner_wall_s": round(winner["measured_s"], 6),
        "winner_us_per_task": round(
            winner["measured_s"] / tasks * 1e6, 4),
        "tuned_vs_default": round(ratio, 4) if ratio else None,
        "beats_default": bool(ratio is not None and ratio <= 1.0),
        "critpath_ratio": winner.get("critpath_ratio"),
        "validated": [
            {"knobs": r["knobs"],
             "predicted_ns": round(r["predicted_ns"]),
             "measured_s": round(r["measured_s"], 6),
             "predicted_vs_wall": r.get("predicted_vs_wall"),
             "critpath_ratio": r.get("critpath_ratio")}
            for r in res["validated"]],
        "persisted": res["persisted"],
    }


def bench_dispatch_suite(tasks=20000, mt_tasks=4000, reps=5, workers=4,
                         lanes=8):
    """The dispatch document: single-chain and contended dispatch
    percentiles, each with the sched_stats counters that show which
    fast paths fired, host provenance, and the autotuned-vs-default
    section."""
    from parsec_tpu_torch.utils import params as _mca
    single = bench_dispatch_chain(tasks, reps)
    contended = bench_dispatch_mt(mt_tasks, lanes, workers, reps)
    tuned = bench_dispatch_tuned(tasks, reps=max(2, reps - 2))
    return {
        "bench": "dispatch",
        **host_provenance(),
        "sched": _mca.get("runtime.sched"),
        "sched_bypass": bool(_mca.get("sched.bypass")),
        "budget_us": 5.0,
        "single_chain": single,
        "contended": contended,
        "tuned": tuned,
    }

"""Tracing-cost suites (bench.py's `--profov` and `--trace`): the noop
chain's wall per task at trace levels 0, 1 and 2, under the ring buffer,
with the always-on histograms on and off, and with a live journal.  Host
only.
"""
from __future__ import annotations

import json
import tempfile
import time

import parsec_tpu_torch as pt
from parsec_tpu_torch.profiling.blackbox import Journal

from .common import host_provenance
from .dispatch import _chain_taskpool


def bench_profiling_overhead(nb_tasks: int = 20000, reps: int = 5):
    """Tracing cost per task: wall time of the noop chain at trace level
    0 (off), 1 (EXEC spans) and 2 (+RELEASE spans +EDGE pairs)."""
    walls = {}
    for level in (0, 1, 2):
        best = None
        for _ in range(reps):
            with pt.Context(nb_workers=1) as ctx:
                if level:
                    ctx.profile_enable(level)
                tp = _chain_taskpool(ctx, nb_tasks)
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                dt = time.perf_counter() - t0
            if best is None or dt < best:
                best = dt
        walls[level] = best
    per = {lv: walls[lv] / nb_tasks * 1e9 for lv in walls}
    return json.dumps({
        "metric": "profiling_overhead_ns_per_task",
        "value": round(per[1] - per[0], 1),
        "unit": "ns (level 1 spans vs off)",
        "vs_baseline": None,
        "config": {"tasks": nb_tasks,
                   "ns_per_task": {str(lv): round(per[lv], 1)
                                   for lv in per}},
    })


def bench_trace_suite(tasks: int = 20000, reps: int = 5,
                      ring_bytes: int = 1 << 16):
    """Tracing-cost ladder (the trace document): wall per task of the
    noop chain at levels 0, 1, 2 and at level 1 under the flight-recorder
    ring, whose ratio to unbounded level 1 must stay within noise of 1.0
    (recorded with the dropped-event count that shows the ring wrapped);
    level 0 with the histograms on and force-disabled (adjacent runs, the
    < 1.05 ratio); the chain with a live Journal and without (<= 1.05),
    and the buffered record() cost."""
    def run(level, ring, metrics=True):
        best, dropped = None, 0
        for _ in range(reps):
            with pt.Context(nb_workers=1) as ctx:
                if level:
                    ctx.profile_enable(level)
                if ring:
                    ctx.profile_ring(ring)
                if not metrics:
                    ctx.metrics_enable(False)
                tp = _chain_taskpool(ctx, tasks)
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                dt = time.perf_counter() - t0
                if ring:
                    dropped = max(dropped, ctx.profile_dropped())
            if best is None or dt < best:
                best = dt
        return best, dropped

    walls = {lv: run(lv, 0)[0] for lv in (0, 1, 2)}
    ring_wall, ring_dropped = run(1, ring_bytes)
    # the metrics on/off pair back to back: the ratio is a ~4% effect,
    # the drift across the other runs is the same order
    met_on_wall = run(0, 0)[0]
    met_off_wall = run(0, 0, metrics=False)[0]

    def run_journal(enabled):
        best = None
        for _ in range(reps):
            with tempfile.TemporaryDirectory() as td, \
                    pt.Context(nb_workers=1) as ctx:
                jr = Journal(ctx, dirpath=td, fsync_s=0.2,
                             checkpoint_s=0.5) if enabled else None
                tp = _chain_taskpool(ctx, tasks)
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                dt = time.perf_counter() - t0
                if jr is not None:
                    jr.stop()
            if best is None or dt < best:
                best = dt
        return best

    jr_on_wall = run_journal(True)
    jr_off_wall = run_journal(False)
    n_recs = 50000
    with tempfile.TemporaryDirectory() as td, \
            pt.Context(nb_workers=1) as ctx:
        jr = Journal(ctx, dirpath=td, fsync_s=0.2, checkpoint_s=1e9,
                     arm_crash=False)
        t0 = time.perf_counter()
        for i in range(n_recs):
            jr.record("serve", op="admit", tenant="bench", scope_id=i)
            if i % 8192 == 0:
                jr.flush(fsync=False)  # keep the pending list bounded
        rec_wall = time.perf_counter() - t0
        jr.stop()
    per = {lv: walls[lv] / tasks * 1e9 for lv in walls}
    ring_per = ring_wall / tasks * 1e9
    met_on_per = met_on_wall / tasks * 1e9
    met_off_per = met_off_wall / tasks * 1e9
    return {
        "schema": "bench-trace-v1",
        "knobs": {"tasks": tasks, "reps": reps, "ring_bytes": ring_bytes},
        "ns_per_task": {str(lv): round(per[lv], 1) for lv in per},
        "metrics": {
            "ns_per_task_on": round(met_on_per, 1),
            "ns_per_task_off": round(met_off_per, 1),
            "overhead_ratio": (round(met_on_per / met_off_per, 3)
                               if met_off_per else None),
        },
        "journal": {
            "ns_per_task_on": round(jr_on_wall / tasks * 1e9, 1),
            "ns_per_task_off": round(jr_off_wall / tasks * 1e9, 1),
            "overhead_ratio": (round(jr_on_wall / jr_off_wall, 3)
                               if jr_off_wall else None),
            "within_gate": bool(jr_off_wall
                                and jr_on_wall / jr_off_wall <= 1.05),
            "ns_per_record": round(rec_wall / n_recs * 1e9, 1),
        },
        "overhead_ns_per_task": {
            "level1": round(per[1] - per[0], 1),
            "level2": round(per[2] - per[0], 1),
            "ring_level1": round(ring_per - per[0], 1),
        },
        "ring": {
            "ns_per_task": round(ring_per, 1),
            "dropped_events": int(ring_dropped),
            # ring mode vs unbounded level 1 (1.0 = identical; < 1.1)
            "vs_unbounded_level1": (round(ring_per / per[1], 3)
                                    if per[1] else None),
        },
        **host_provenance(threads=1),
    }

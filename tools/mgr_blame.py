"""Where the card's idle time goes, from the device manager's own spans.

Runs one benchmark cell's driver (benchmark/drivers, set up as
benchmark/harness/core.py sets it up) and measures two things on it:

  cost   the median solve time with the program's trace off, then at
         ctx.profile_enable(1) (the manager's spans on), `--solves`
         solves each, in turns off, on, on, off
  blame  `--seconds` of back-to-back solves under ctx.profile_enable(1)
         and torch.profiler (the card's ops): the manager's four
         counters over that window, their residual against the loop's
         wall time, each bucket's spans inside the window beside its
         counter, the trace clock's drift against the wall clock
         between its anchors, and lost_time's manager row over the
         window with the card's idle time blamed on the manager span
         open at each idle gap's midpoint, and the manager's buckets
         and dispatches inside each of the driver's phases (build,
         run_wait, drain)

and prints one JSON line (written to `--out` too).  On the card:

    python3 tools/mgr_blame.py --workload spotrf.panel --seed 7

On the host, at a small size: `--device cpu --n 2048` (no device ops
there: the blame is left out).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUCKETS = ("mgr_wait_ns", "mgr_plan_ns", "mgr_dispatch_ns",
           "mgr_complete_ns")


def _solve_s(drv) -> float:
    spans = drv.solve()
    return max(b for _, b in spans.values()) - \
        min(a for a, _ in spans.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--solves", type=int, default=4)
    ap.add_argument("--n", type=int, default=0,
                    help="the cell's N instead of its own (host runs)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
    import torch
    from harness import core
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import (KEY_DEVICE, KEY_DEVICE_COMPLETE,
                                            KEY_DEVICE_PLAN,
                                            KEY_DEVICE_WAIT, KEY_GC_PAUSE,
                                            lost_time, take_trace)
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = torch.device(args.device).type == "cuda"
    cell = core.Cell(ROOT, args.workload)
    if args.n:
        cell.traffic["N"] = args.n
    driver = core.load_module(ROOT, "drivers", cell.traffic["driver"])
    reference = core.load_module(ROOT, "reference", cell.config_name)
    st = cell.config["user_settings"]

    def sync():
        if on_card:
            torch.cuda.synchronize(args.device)

    out = {"workload": args.workload, "N": cell.traffic["N"],
           "device": torch.cuda.get_device_name(args.device) if on_card
           else "cpu"}
    ctx = pt.Context(nb_workers=int(st["nb_workers"]))
    try:
        dev = CudaDevice(ctx, device=args.device,
                         cache_bytes=int(st["cache_bytes"]))
        drv = driver.Driver(ctx, dev, cell.config, cell.traffic,
                            reference.inputs(args.seed, cell.traffic,
                                             cell.config, args.device))
        drv.reinstall()
        sync()
        _solve_s(drv)                     # every shape once

        # ---- cost: solve time with the trace off and on, in turns
        times = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            ctx.profile_enable(1 if mode == "on" else 0)
            for _ in range(args.solves):
                drv.reinstall()
                sync()
                times[mode].append(_solve_s(drv))
            take_trace(ctx)               # drop what the solves traced
        ctx.profile_enable(0)
        out["solve_s"] = {m: statistics.median(v) for m, v in times.items()}
        out["trace_cost"] = out["solve_s"]["on"] / out["solve_s"]["off"] - 1

        # ---- blame: a traced window with the card's timeline; the
        # profiler starts and stops outside it
        ctx.profile_enable(1)
        tracer = None
        if on_card:
            from harness.trace import Tracer
            tracer = Tracer()
            tracer.start()
        drv.reinstall()
        sync()
        take_trace(ctx)                   # the window's first anchor
        time.sleep(0.2)  # the manager's wait begins its span at a poll
        s0 = dev.info()["stats"]
        w0 = time.time_ns()
        t0 = time.perf_counter()
        to_wall = w0 - int(t0 * 1e9)      # perf_counter s -> wall ns
        phases = []  # the driver's spans: (name, start, end) wall ns
        while time.perf_counter() - t0 < args.seconds:
            drv.reinstall()
            phases += [(k, int(a * 1e9) + to_wall, int(b * 1e9) + to_wall)
                       for k, (a, b) in drv.solve().items()]
        solves = sum(1 for k, _, _ in phases if k == "build")
        w1 = time.time_ns()
        s1 = dev.info()["stats"]
        tr = take_trace(ctx)              # anchors close around the window
        sync()
        if tracer is not None:
            tracer.stop()
        ctx.profile_enable(0)
        drv.reinstall()
        sync()
        dev.stop()
    finally:
        ctx.destroy()

    delta = {k: s1[k] - s0[k] for k in BUCKETS + (
        "mgr_wall_ns", "gc_pause_ns", "gc_full_passes", "tasks")}
    total = sum(delta[k] for k in BUCKETS)
    out["solves"] = solves
    out["window_counters"] = delta
    out["residual"] = 1 - total / delta["mgr_wall_ns"]
    out["split"] = {k: delta[k] / total for k in BUCKETS}
    anchors = tr.meta["wall_anchors"]
    out["anchors_span_s"] = (anchors[-1][1] - anchors[0][1]) / 1e9
    out["drift_ns"] = tr.wall_drift_ns()
    ops = None
    if tracer is not None:
        ops = [(n, a, b) for n, _, a, b in tracer.ops]
        out["device_ops"] = len(ops)
    wall = tr.to_wall()
    starts = np.array(sorted(sp[7] for sp in wall.spans()
                             if sp[2] == KEY_DEVICE), dtype=np.int64)
    lt = lost_time(wall, device_ops=ops, window=(w0, w1))
    out["window_s"] = (w1 - w0) / 1e9
    row = next(iter(lt.get("manager", {}).values()), {})
    out["manager_row"] = {k: v for k, v in row.items()
                          if k != "device_idle"}
    # the spans inside the window (the manager row) against the counters
    out["span_vs_counter"] = {
        k: row.get(name, 0) / max(1, delta[k]) for k, name in
        zip(BUCKETS + ("gc_pause_ns",),
            ("wait", "plan", "dispatch", "complete", "gc"))}
    # the manager's buckets inside each of the driver's phases (build,
    # run_wait, drain), and the dispatch spans begun there; one device's
    # manager spans do not overlap, nor do GC pauses
    names = {KEY_DEVICE_WAIT: "wait", KEY_DEVICE_PLAN: "plan",
             KEY_DEVICE: "dispatch", KEY_DEVICE_COMPLETE: "complete",
             KEY_GC_PAUSE: "gc"}
    mspans = [(sp[7], sp[8], names[sp[2]]) for sp in wall.spans()
              if sp[1] == -1 and sp[2] in names]
    by_phase = {}
    for name, a, b in phases:
        rec = by_phase.setdefault(name, dict.fromkeys(
            ("ns", "dispatches", *names.values()), 0))
        rec["ns"] += b - a
        for sa, sb, k in mspans:
            if sb > a and sa < b:
                rec[k] += min(sb, b) - max(sa, a)
        rec["dispatches"] += int(np.sum((starts >= a) & (starts < b)))
    out["by_phase"] = by_phase
    if "device_idle" in row:
        idle = row["device_idle"]
        named = sum(v for k, v in idle.items() if k != "gc")
        out["device_idle_ns"] = idle
        out["device_idle_share"] = named / row["window_ns"]
        out["device_idle_split"] = {k: v / named for k, v in idle.items()
                                    if named}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

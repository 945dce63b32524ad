#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path (one card).

    python3 tools/torch_path_profile.py [--serve-only | --dense-only |
                                         --pipeline-only] [--trace-dir DIR]

(from the repo root.)  Drives the same paths as chip_smoke.py — GEMM,
NORM and FATT taskpools at full width through Context -> Taskpool ->
CudaDevice, then the serving path (chip_smoke.serve_path: the two-tenant
engine run and the speculative run), each result checked as the smoke
checks it — with every taskpool run, and each engine's decode loop,
under torch.profiler (CPU + CUDA activities).  --serve-only keeps the
serving path alone; --dense-only runs phase 6 alone
(chip_smoke.dense_la_path: its untimed warm-up pass, then every dense
path traced, the flush included); --pipeline-only traces phase 7a
(chip_smoke.pipeline_path: NORM with the prefetch lane off, then on,
one run each) and adds, per CUDA stream, the device time and count of
its kernels and of its HtoD and DtoH copies, and how much of the copies'
time overlaps kernels on other streams (from the exported Chrome trace,
written to --trace-dir, build/traces by default, relative to the repo
root).  Prints one JSON line per path: the traced wall time, the
device's busy time (union of its kernel and copy intervals) and idle
share of the wall, device time and item count by kernel or copy name,
the host's time by CUDA runtime call and operator (self time), and the
device module's staging counters where given.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arg(flag: str, default: str) -> str:
    """The value after `flag` on the command line, or `default`."""
    if flag in sys.argv[:-1]:
        return sys.argv[sys.argv.index(flag) + 1]
    return default


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _union(intervals):
    """Disjoint sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(xs, ys):
    """Length of the intersection of two interval sets' unions."""
    xs, ys = _union(xs), _union(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_breakdown(trace_path):
    """Per CUDA stream of a Chrome trace (torch.profiler's export): device
    ms and count of kernels, HtoD, DtoH and DtoD copies; and for HtoD and
    DtoH, the ms of their union that overlaps kernels running on the
    streams that carry no copy of that kind."""
    with open(trace_path) as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    per, spans = {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel",
                                                      "gpu_memcpy"):
            continue
        name = e.get("name", "")
        kind = "kernel" if e["cat"] == "kernel" else next(
            (k for k in ("HtoD", "DtoH", "DtoD") if k in name), "memcpy")
        sid = str(e.get("args", {}).get("stream", e.get("tid")))
        rec = per.setdefault(sid, {}).setdefault(kind, [0.0, 0])
        rec[0] += e["dur"] / 1e3
        rec[1] += 1
        spans.setdefault((sid, kind), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    out = {"streams": per}
    for kind in ("HtoD", "DtoH"):
        copy_streams = {s for s, k in spans if k == kind}
        copies = [iv for (s, k), v in spans.items() if k == kind
                  for iv in v]
        kern = [iv for (s, k), v in spans.items()
                if k == "kernel" and s not in copy_streams for iv in v]
        out[f"{kind}_ms"] = sum(b - a for a, b in _union(copies)) / 1e3
        out[f"{kind}_overlapping_kernels_ms"] = _overlap_us(copies,
                                                            kern) / 1e3
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_path_profile: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from parsec_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()

    def traced(label, fn, stats=None, streams=False):
        """Run fn() under the profiler and print its row: wall, device
        busy/idle, device time by name, the device module's staging
        counters when given, and with streams=True the per-stream
        breakdown of the exported trace."""
        kernels.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        spans, by_name, count = [], {}, {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            name = ev.name[:60]
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            count[name] = count.get(name, 0) + 1
        busy = _busy_us(spans)
        host = sorted(((e.key, e.self_cpu_time_total, e.count)
                       for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda r: -r[1])[:8]
        row = {"path": label, "launches": dict(kernels.LAUNCHES),
               "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
               "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
               "device_items": len(spans),
               "device_ms_by_name": {k: [v / 1e3, count[k]] for k, v in
                                     sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:8]},
               "host_self_ms_by_name": {k[:60]: [t / 1e3, n]
                                        for k, t, n in host}}
        if stats is not None:
            st = stats()
            row.update(tasks=st["tasks"], batches=st["batches"],
                       h2d_stall_ms=st["h2d_stall_ns"] / 1e6,
                       h2d_bytes=st["h2d_bytes"], d2h_bytes=st["d2h_bytes"])
        if streams:
            out_dir = os.path.join(ROOT, _arg("--trace-dir",
                                              os.path.join("build",
                                                           "traces")))
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "trace_" + "".join(
                c if c.isalnum() else "_" for c in label)[:80] + ".json")
            prof.export_chrome_trace(path)
            row.update(stream_breakdown(path), trace=os.path.relpath(
                path, ROOT))
        print(json.dumps(row), flush=True)

    def drive(label, tp, dev, ntasks):
        def run():
            tp.run()
            tp.wait()
            dev.flush()
        traced(label, run, lambda: dev.stats)
        return dict(kernels.LAUNCHES)

    print(torch.cuda.get_device_name(0))
    dev_t = torch.device("cuda", 0)
    if "--dense-only" in sys.argv:
        chip_smoke.dense_la_path(dev_t, observe=traced)
        return 0
    if "--pipeline-only" in sys.argv:
        chip_smoke.pipeline_path(
            dev_t, dict(chip_smoke.PIPE, reps=1), ooc=False,
            observe=lambda label, fn: traced(label, fn, streams=True))
        return 0
    if "--serve-only" not in sys.argv:
        chip_smoke.main_path(np.random.default_rng(chip_smoke.SEED), dev_t,
                             drive)
    # the serving path: each engine's decode loop (prefills included,
    # which run concurrently with it) traced whole
    chip_smoke.serve_path(dev_t, observe=traced)
    return 0


if __name__ == "__main__":
    sys.exit(main())

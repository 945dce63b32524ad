#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path (one card).

    python3 tools/torch_path_profile.py [--serve-only | --dense-only]

(from the repo root.)  Drives the same paths as chip_smoke.py — GEMM,
NORM and FATT taskpools at full width through Context -> Taskpool ->
CudaDevice, then the serving path (chip_smoke.serve_path: the two-tenant
engine run and the speculative run), each result checked as the smoke
checks it — with every taskpool run, and each engine's decode loop,
under torch.profiler (CPU + CUDA activities).  --serve-only keeps the
serving path alone; --dense-only runs phase 6 alone
(chip_smoke.dense_la_path: its untimed warm-up pass, then every dense
path traced, the flush included).  Prints one JSON line per path: the
traced wall time, the device's busy time (union of its kernel and copy
intervals) and idle share of the wall, device time and item count by
kernel or copy name, the host's time by CUDA runtime call and operator
(self time), and the device module's staging counters where given.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

    def traced(label, fn, stats=None):
        """Run fn() under the profiler and print its row: wall, device
        busy/idle, device time by name, and the device module's staging
        counters when given."""
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
    if "--serve-only" not in sys.argv:
        chip_smoke.main_path(np.random.default_rng(chip_smoke.SEED), dev_t,
                             drive)
    # the serving path: each engine's decode loop (prefills included,
    # which run concurrently with it) traced whole
    chip_smoke.serve_path(dev_t, observe=traced)
    return 0


if __name__ == "__main__":
    sys.exit(main())

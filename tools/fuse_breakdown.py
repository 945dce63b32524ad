#!/usr/bin/env python3
"""Where the device manager's time goes with wave and chain fusion on and
off (device.wave_fuse), on phase 4's GEMM (4096^2 in 512^2 tiles, an
8-deep k chain, 512 tasks).

    python3 tools/fuse_breakdown.py [--turns N] [--cpu]

(from the repo root.)  Runs the pool unfused, fused, fused, unfused,
`--turns` times (2 by default), each on a fresh CudaDevice at the
device's default batch_wait_ms (0), and splits each run's wall (tp.run()
to the flush and a synchronize) by the manager thread's host time in:
its pops of the device queue (waiting included), the wave compiler's
certificates (WaveFuser._state_for), the chains' marshaling of their
consumer levels (WaveFuser._marshal), the rest of the chains (the
products and the effects), the parked results' consumption
(WaveFuser.consume_group) and the plain launches (CudaDevice._launch).
The host time is wall-clock time of those calls on the manager thread,
so a card's work appears only where a call waits for it.  Prints one
JSON line per run and a last line with the medians of each mode.
--cpu runs it with CudaDevice(device="cpu") at 1024^2 in 128^2 tiles
(a rehearsal: its times are no device measurement).  Exits non-zero
without a CUDA card unless --cpu is given.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    cpu = "--cpu" in sys.argv
    turns = int(sys.argv[sys.argv.index("--turns") + 1]) \
        if "--turns" in sys.argv[:-1] else 2
    if not cpu and not torch.cuda.is_available():
        print("fuse_breakdown: no CUDA card", file=sys.stderr)
        return 2
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.convert import to_collection
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.cuda import CudaDevice as Dev
    from parsec_tpu_torch.device.fuse import WaveFuser
    from parsec_tpu_torch.utils import params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev_t = torch.device("cpu") if cpu else torch.device("cuda", 0)
    n, nb = (1024, 128) if cpu else (4096, 512)

    # host ms of each call on the manager thread (named by its thread)
    spent = defaultdict(float)
    calls = defaultdict(int)

    def timed(cls, name, key):
        f = getattr(cls, name)

        def g(*a, **k):
            if threading.current_thread().name != "ptc-cuda-manager":
                return f(*a, **k)
            t = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent[key] += (time.perf_counter() - t) * 1e3
                calls[key] += 1
        setattr(cls, name, g)
    timed(pt.Context, "device_pop", "pop")
    timed(WaveFuser, "_state_for", "certificates")
    timed(WaveFuser, "_marshal", "chain_marshal")
    timed(WaveFuser, "_chain_exec", "chain")
    timed(WaveFuser, "consume_group", "consume")
    timed(Dev, "_launch", "launch")

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    if not cpu:
        smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip()
        print(smi)
    rows = {True: [], False: []}
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        for _ in range(turns):
            for fused in (False, True, True, False):
                for t_ in C._tiles.values():
                    t_[...] = 0
                params.set("device.wave_fuse", fused)
                try:
                    dev = CudaDevice(ctx, device=dev_t)
                finally:
                    params.unset("device.wave_fuse")
                tp = build_gemm(ctx, A, B, C, dev)
                spent.clear()
                calls.clear()
                if not cpu:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                tp.run()
                tp.wait()
                dev.flush()
                if not cpu:
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
                dev.stop()
                row = {"fused": fused, "wall_ms": wall,
                       "manager_ms": dict(spent), "calls": dict(calls),
                       # the chain's own time, its marshaling apart
                       "chain_rest_ms": spent["chain"]
                       - spent["chain_marshal"],
                       "fuse": {k: v for k, v in dev.info()["fuse"].items()
                                if k in ("fused_chains", "chain_waves",
                                         "chain_hits", "chain_misses")},
                       "device": "cpu" if cpu
                       else torch.cuda.get_device_name(0)}
                rows[fused].append(row)
                print(json.dumps(row))
    med = {}
    for fused, rs in rows.items():
        keys = set().union(*(r["manager_ms"] for r in rs))
        med["fused" if fused else "unfused"] = {
            "wall_ms": sorted(r["wall_ms"] for r in rs)[len(rs) // 2],
            "manager_ms": {k: sorted(r["manager_ms"].get(k, 0.0)
                                     for r in rs)[len(rs) // 2]
                           for k in sorted(keys)}}
    print(json.dumps({"medians": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

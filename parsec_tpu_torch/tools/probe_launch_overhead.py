"""Per-call overhead of a kernel launch on the card.

A runtime that dispatches one small chore per task pays this cost per
task, so it bounds the dispatch rate before any FLOP counts.  Two
numbers separate what the cost is made of:

  * dependent chain: each call consumes the previous call's output
  * independent burst: the same input every time

torch enqueues both asynchronously on one stream, so on a card both are
the host's enqueue cost (the card runs a 128 x 128 add in far less); a
dependent chain well above the burst would show the card in the way.

Emits one JSON line:
  {"metric": "launch_overhead", "dep_us_per_call": ..,
   "indep_us_per_call": .., "big_matmul_4096_ms": .., "chip_kind": ..}

Method: x -> x + 1 on a 128x128 f32, 100 calls a run, the host clock
from the first call to a synchronize after the last; everything warmed
first.  A third number times one large product (4096^3 f32, TF32 off
as torch's default; `--big` sets its side) with CUDA events, for scale.

    python -m parsec_tpu_torch.tools.probe_launch_overhead [--device cuda]

Port of tools/probe_launch_overhead.py.
"""
import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--big", type=int, default=4096,
                    help="side of the scale-bar product (default 4096)")
    args = ap.parse_args(argv)

    import torch

    from parsec_tpu_torch.tools import device_kind, median_s, sync, \
        torch_device
    dev = torch_device(args.device)
    n = 100

    def bump(x):
        return x + 1.0

    x0 = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    bump(x0)
    sync(dev)

    # dependent chain: each call consumes the previous result
    x = x0
    t0 = time.perf_counter()
    for _ in range(n):
        x = bump(x)
    sync(dev)
    dep_us = (time.perf_counter() - t0) / n * 1e6

    # independent burst: same input every time
    t0 = time.perf_counter()
    ys = [bump(x0) for _ in range(n)]
    sync(dev)
    indep_us = (time.perf_counter() - t0) / n * 1e6
    del ys

    # scale bar: one large product (float32; TF32 is off by default)
    a = torch.ones((args.big, args.big), dtype=torch.float32, device=dev)
    big_ms = median_s(lambda: a @ a, dev, reps=1) * 1e3

    print(json.dumps({
        "metric": "launch_overhead",
        "dep_us_per_call": round(dep_us, 1),
        "indep_us_per_call": round(indep_us, 1),
        "big_matmul_4096_ms": round(big_ms, 2),
        "chip_kind": device_kind(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read the lower-precision control of a cell: its reference computed in
the precision below the configuration's, judged by the cell's own
comparison at the cell's own size.  The benchmark's runs never run it;
it sets the upper reading that each limit lies under.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line per seed on standard output: the compared numbers beside
the cell's limits.  Runs on the card (--device cpu for a small cell in
the tests).

    python3 benchmark/control.py --workload <cell> --program --seconds <s>
        --seeds <n> [<n> ...]

reads the limits' lower readings instead: a run of the cell on each
seed, all in this one process, with a window of `s` seconds (long enough
for the sampled solves), and the numbers its check compares.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read(cell, seed: int, device: str) -> dict:
    """The control's numbers for `cell` on `seed`."""
    from harness import core
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    reference = core.load_module(cell.root, "reference", cell.config_name)
    return reference.control(seed, cell.traffic, cell.config, device)


def program(cell, seed: int, seconds: float, device: str) -> dict:
    """The program's numbers for `cell` on `seed`: one run's check."""
    from harness import core
    r = core.run_cell(cell, seed, seconds, False, device,
                      time.perf_counter())
    return {k: c["value"] for k, c in r["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from harness import core
    cell = core.Cell(ROOT, args.workload)
    limits = cell.traffic["limits"]
    for seed in args.seeds:
        if args.program:
            got = program(cell, seed, args.seconds, args.device)
        else:
            got = read(cell, seed, args.device)
        side = "program" if args.program else "control"
        print(json.dumps({"workload": cell.name, "seed": seed, side: got,
                          "limits": limits,
                          "fails": {k: v is None or v > limits[k]
                                    for k, v in got.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

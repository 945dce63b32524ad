"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared with its
limit (also the last lines of standard error).  No CUDA card, fewer
cards than the cell asks for, a cell that is not complete, or a JAX
module in the process once the window has closed: a non-zero exit and
no result.  See benchmark/README.md.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from harness import core
    try:
        cell = core.Cell(ROOT, args.workload)
    except core.CellError as e:
        sys.stderr.write(f"{e}\n")
        return 2
    device = core.require_device(cell.chips)
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Medians and spreads of a set of runs, from their result lines.

    python3 benchmark/spreads.py RUN_OUTPUT [RUN_OUTPUT ...]

Each argument is a file holding a run's standard output (its last JSON
line is read).  Prints, per metric: the number of runs, the median, and
the spread (third quartile - first quartile) / median of Python's
`statistics.quantiles(values, n=4)`, the spread a bound is set from;
and how many runs were correct.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def last_result(path: str):
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def main(paths) -> int:
    from harness.arith import quartile_spread
    results = [r for r in map(last_result, paths) if r is not None]
    values = {}
    for r in results:
        for k, m in r["metrics"].items():
            values.setdefault(k, []).append(m["value"])
    print(f"runs {len(results)} of {len(paths)}, correct "
          f"{sum(bool(r['correct']) for r in results)}")
    for k, xs in sorted(values.items()):
        spread = quartile_spread(xs) if len(xs) >= 2 else float("nan")
        print(f"{k}: n {len(xs)} median {statistics.median(xs)} "
              f"spread {spread}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

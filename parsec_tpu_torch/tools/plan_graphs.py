"""Run ptc-plan (parsec_tpu_torch.analysis.plan) over every in-tree
graph generator -- the same GENERATORS table verify_graphs walks -- and
assert the plan baseline: every graph plans CLEAN (no enumeration
refusal at the default tilings, finite residency/makespan bounds) and
the potrf bench tiling (NT=16, the BENCH_r05 rung-5 grid) plans inside
its latency budget.

`--json` writes the graphs' rows, the NT=16 timing and the host's
provenance where it says (never to the repo's PLAN_graphs.json, the
reference's record).

Usage: python -m parsec_tpu_torch.tools.plan_graphs [--json out.json]
           [-v] [only ...]

Port of tools/plan_graphs.py.
"""
import argparse
import json
import sys
import time

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic
from parsec_tpu_torch.tools import host_provenance, verify_graphs

# analyzer latency budget on the potrf bench tiling (seconds), the
# reference's
POTRF_NT16_BUDGET_S = 5.0


def plan_all(only=None, verbose=False):
    """Build + plan every generator.  Yields (name, Plan)."""
    from parsec_tpu_torch.analysis import plan_taskpool
    for gname, gen in verify_graphs.GENERATORS.items():
        if only and gname not in only:
            continue
        with pt.Context(nb_workers=1) as ctx:
            for tpname, tp in gen(ctx):
                plan = plan_taskpool(tp)
                if verbose:
                    print(f"--- {tpname}:\n{plan.text()}")
                yield tpname, plan


def plan_issues(plan) -> list:
    """Baseline violations for one graph's plan: enumeration refusals,
    unbounded/absent residency or makespan numbers, waves without an
    explicit fusability verdict (certify/refuse — silent skips are a
    baseline violation, refusals are not)."""
    issues = []
    if plan.bounded:
        issues.append("enumeration refused (symbolic fallback)")
        return issues
    if not plan.per_rank:
        issues.append("no per-rank rows")
    if plan.est_bytes() is None:
        issues.append("unbounded residency estimate")
    if plan.stats.get("waves", 0) <= 0:
        issues.append("no wave schedule")
    m = plan.makespan
    if not m or m.get("lower_bound_ns", 0) <= 0:
        issues.append("no finite makespan lower bound")
    waves = {(r, row["wave"]) for r, rows in plan.waves.items()
             for row in rows}
    certified = {(c["rank"], c["wave"]) for c in plan.fusability}
    missing = waves - certified
    if missing:
        issues.append(f"{len(missing)} wave(s) without a fusability "
                      "verdict")
    return issues


def potrf_nt16_ms() -> float:
    """Plan the potrf bench tiling (NT=16 -> 816 instances; tiles
    shrunk to 8 wide — analysis cost depends only on the tile grid)."""
    from parsec_tpu_torch.algos.potrf import build_potrf
    from parsec_tpu_torch.analysis import plan_taskpool
    with pt.Context(nb_workers=1) as ctx:
        A = TwoDimBlockCyclic(16 * 8, 16 * 8, 8, 8, dtype=np.float32)
        A.register(ctx, "A")
        tp = build_potrf(ctx, A)
        t0 = time.perf_counter()
        plan = plan_taskpool(tp)
        dt = time.perf_counter() - t0
    assert plan.stats["instances"] == 816, plan.stats
    return dt * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("only", nargs="*", help="generator names (default all)")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    dirty = 0
    results = {}
    for name, plan in plan_all(args.only or None, args.verbose):
        issues = plan_issues(plan)
        peak = plan.peak_bytes()
        status = ("clean" if not issues else "; ".join(issues))
        fus = plan.fusable_waves()
        chained = plan.chained_waves()
        print(f"{name:24s} {status}  "
              f"[{plan.stats.get('instances', 0)} inst, "
              f"{plan.stats.get('waves', 0)} wave(s), "
              f"{fus} fusable, {chained} chained, peak {peak} B, "
              f"{plan.stats.get('elapsed_ms', 0):.0f} ms]")
        if issues:
            dirty += 1
        results[name] = {
            "issues": issues,
            "instances": plan.stats.get("instances", 0),
            "waves": plan.stats.get("waves", 0),
            "fusable_waves": fus,
            "chained_waves": chained,
            "chain_pairs": len(plan.chains),
            "certified_waves": len(plan.fusability),
            "peak_bytes": peak,
            "est_bytes": plan.est_bytes(),
            "comm_bytes": plan.comm_bytes(),
            "coll_bytes": plan.coll_bytes(),
            "coll_legs": len(plan.coll_legs()),
            "makespan_lower_ns": plan.makespan.get("lower_bound_ns", 0),
            "elapsed_ms": round(plan.stats.get("elapsed_ms", 0), 2),
        }
    timing_ms = None
    if not args.only:
        timing_ms = potrf_nt16_ms()
        over = timing_ms / 1e3 > POTRF_NT16_BUDGET_S
        print(f"potrf NT=16 plan: {timing_ms:.1f} ms "
              f"(budget {POTRF_NT16_BUDGET_S:.0f} s)"
              + (" OVER BUDGET" if over else ""))
        if over:
            dirty += 1
    if args.json:
        prov = host_provenance()
        payload = {
            "graphs": results,
            "potrf_nt16_ms": (round(timing_ms, 1)
                              if timing_ms is not None else None),
            "potrf_nt16_budget_s": POTRF_NT16_BUDGET_S,
        }
        payload.update(prov)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
    print(f"plan-graphs: {len(results)} graph(s), {dirty} with issues")
    return 1 if dirty else 0


if __name__ == "__main__":
    sys.exit(main())

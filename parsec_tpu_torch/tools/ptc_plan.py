"""ptc-plan CLI: static resource & schedule analysis of PTG task graphs
(parsec_tpu_torch/analysis/plan.py -- peak tile residency, wave
decomposition, comm volume, makespan lower bounds).

Input is either a .jdf file (compiled, never executed) or the name of
an in-tree graph generator from parsec_tpu_torch.tools.verify_graphs:

    python -m parsec_tpu_torch.tools.ptc_plan potrf
    python -m parsec_tpu_torch.tools.ptc_plan prog.jdf --global N=10 --waves
    python -m parsec_tpu_torch.tools.ptc_plan gemm --json plan.json
    python -m parsec_tpu_torch.tools.ptc_plan potrf --profile prof.json \\
        --trace run.ptt

`--waves` prints the per-rank wave table (the ready fronts grouped by
task class -- the mega-kernelization prep artifact).  `--profile` seeds
the cost model from a recorded {"classes": {name: ns}} JSON; `--trace`
loads a level-2 .ptt (written by either package) and prints
predicted-vs-EXECUTED critical path -- the regression signal that keeps
the model honest.

Exit status: 0 on a finite plan, 1 when enumeration was refused
(symbolic fallback) or the analysis found nothing to bound, 2 on usage
errors.

Port of tools/ptc_plan.py.
"""
import argparse
import json
import os
import sys

from parsec_tpu_torch.tools import (jdf_program, parse_globals, plan_graphs,
                                    verify_graphs)
from parsec_tpu_torch.tools.ptc_verify import unknown_generator


def _plan_jdf(args, cost):
    from parsec_tpu_torch.analysis import extract_flowgraph, plan_graph
    with open(args.target) as f:
        src = f.read()
    with jdf_program(args.target, src, parse_globals(args.globs),
                     args.collection, args.size) as b:
        fg = extract_flowgraph(b.tp)
        plan = plan_graph(fg, max_instances=args.max_instances, cost=cost)
        return {os.path.basename(args.target): plan}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("target",
                    help=".jdf file, in-tree generator name, or 'all'")
    ap.add_argument("--global", dest="globs", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--collection", default="mydata",
                    help="collection name bound to memory references")
    ap.add_argument("--size", type=int, default=256,
                    help="elements in the throwaway collection")
    ap.add_argument("--max-instances", type=int, default=200_000,
                    help="concrete-enumeration budget (past it the "
                         "analysis degrades to interval bounds)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="cost-model JSON ({'classes': {name: ns}})")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="level-2 .ptt: print predicted vs EXECUTED "
                         "critical path")
    ap.add_argument("--waves", action="store_true",
                    help="print the per-rank wave table")
    ap.add_argument("--json", dest="json_out", metavar="PATH",
                    default=None)
    args = ap.parse_args(argv)

    cost = None
    if args.profile:
        from parsec_tpu_torch.analysis import CostModel
        cost = CostModel.from_json(args.profile)

    if os.path.exists(args.target):
        plans = _plan_jdf(args, cost)
    else:
        if args.target != "all" \
                and args.target not in verify_graphs.GENERATORS:
            return unknown_generator("ptc-plan", args.target)
        # plan_all ignores `cost` (generator pools are cold); a
        # --profile cost model only applies to .jdf targets
        only = None if args.target == "all" else [args.target]
        plans = dict(plan_graphs.plan_all(only=only))

    rc = 0
    for name, plan in plans.items():
        if len(plans) > 1:
            print(f"=== {name}")
        print(plan.text(waves=args.waves))
        if plan.bounded or not plan.per_rank:
            rc = 1
        if args.trace:
            from parsec_tpu_torch.analysis import compare_critpath
            from parsec_tpu_torch.profiling.trace import Trace
            cmp = compare_critpath(plan, Trace.load(args.trace))
            print(f"  critpath predicted {cmp['predicted_ns'] / 1e6:.3f} ms "
                  f"vs executed {cmp['executed_ns'] / 1e6:.3f} ms "
                  f"(ratio {cmp['ratio']}; predicted path "
                  f"{cmp['predicted_path_len']} task(s), executed "
                  f"{cmp['executed_path_len']})")
    if args.json_out:
        payload = {n: p.to_json() for n, p in plans.items()}
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())

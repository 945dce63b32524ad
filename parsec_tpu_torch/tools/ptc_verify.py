"""ptc-verify CLI: static dataflow verification of PTG task graphs
(rules V001-V008, parsec_tpu_torch/analysis/verify.py).

Input is either a .jdf file (compiled, never executed) or the name of
an in-tree graph generator from parsec_tpu_torch.tools.verify_graphs:

    python -m parsec_tpu_torch.tools.ptc_verify prog.jdf --global N=10
    python -m parsec_tpu_torch.tools.ptc_verify potrf
    python -m parsec_tpu_torch.tools.ptc_verify prog.jdf \\
        --json report.json --dot g.dot

Exit status: 0 clean (or warnings only with --ok-warn), 1 when any
error-severity finding exists, 2 on usage errors.  `--dot` writes the
concretized instance DAG with findings overlaid in red.

Port of tools/ptc_verify.py.
"""
import argparse
import json
import os
import sys

from parsec_tpu_torch.tools import jdf_program, parse_globals, verify_graphs


def _verify_jdf(args):
    from parsec_tpu_torch.analysis import (extract_flowgraph,
                                           flowgraph_to_dot, verify_graph)
    with open(args.target) as f:
        src = f.read()
    with jdf_program(args.target, src, parse_globals(args.globs),
                     args.collection, args.size) as b:
        fg = extract_flowgraph(b.tp)
        report, cg = verify_graph(fg, max_instances=args.max_instances)
        if args.dot:
            with open(args.dot, "w") as f:
                f.write(flowgraph_to_dot(cg, report.findings) + "\n")
        return {os.path.basename(args.target): report}


def unknown_generator(tool: str, target: str) -> int:
    """The usage error of a target that is neither a file nor an in-tree
    generator (exit status 2)."""
    print(f"{tool}: no file and no in-tree generator named {target!r}; "
          f"generators: {', '.join(sorted(verify_graphs.GENERATORS))}",
          file=sys.stderr)
    return 2


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
                         "instance-level rules degrade to symbolic)")
    ap.add_argument("--json", dest="json_out", metavar="PATH", default=None)
    ap.add_argument("--dot", metavar="PATH", default=None,
                    help="write the instance DAG with findings in red "
                         "(.jdf targets only)")
    ap.add_argument("--ok-warn", action="store_true",
                    help="exit 0 when only warnings remain")
    args = ap.parse_args(argv)

    if os.path.exists(args.target):
        reports = _verify_jdf(args)
    else:
        if args.dot:
            print("ptc-verify: --dot needs a .jdf target",
                  file=sys.stderr)
            return 2
        if args.target != "all" \
                and args.target not in verify_graphs.GENERATORS:
            return unknown_generator("ptc-verify", args.target)
        only = None if args.target == "all" else [args.target]
        reports = dict(verify_graphs.verify_all(only=only))

    errors = warnings = 0
    for name, report in reports.items():
        if len(reports) > 1:
            print(f"=== {name}")
        print(report.text())
        errors += len(report.errors)
        warnings += len(report.warnings)
    if args.json_out:
        payload = {n: r.to_json() for n, r in reports.items()}
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
    if errors:
        return 1
    if warnings and not args.ok_warn:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

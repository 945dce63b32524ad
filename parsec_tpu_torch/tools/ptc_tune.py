"""ptc-tune CLI: static schedule simulation + plan-driven knob search
over PTG task graphs (parsec_tpu_torch/analysis/tune.py).

Targets are in-tree graph generator names from
parsec_tpu_torch.tools.verify_graphs (or 'all'):

    python -m parsec_tpu_torch.tools.ptc_tune potrf       # simulate + certify
    python -m parsec_tpu_torch.tools.ptc_tune gemm_dist --search
    python -m parsec_tpu_torch.tools.ptc_tune all --json out.json
    python -m parsec_tpu_torch.tools.ptc_tune --check     # the gate

`--check` (no target) runs the full in-tree sweep as a gate: every
graph must plan concretely (NO enumeration refusal), every wave must
carry an explicit fusability certify/refuse verdict (no silent skips),
and the simulator must price the default knob vector to a finite,
reproducible makespan (priced twice, compared bit-for-bit -- the
determinism contract).  Exit 1 on any violation.

Real-run validation of proposals lives where workloads are runnable:
`autotune(tp, measure=...)` for user pools.

Port of tools/ptc_tune.py.
"""
import argparse
import json
import sys

import parsec_tpu_torch as pt
from parsec_tpu_torch.tools import verify_graphs


def tune_all(only=None, topk=3, search=False):
    """Build + plan + simulate every generator.  Yields
    (name, plan, sim_result, proposals|None, issues)."""
    from parsec_tpu_torch.analysis import plan_taskpool
    from parsec_tpu_torch.analysis.tune import ScheduleSimulator
    for gname, gen in verify_graphs.GENERATORS.items():
        if only and gname not in only:
            continue
        with pt.Context(nb_workers=1) as ctx:
            for tpname, tp in gen(ctx):
                plan = plan_taskpool(tp)
                issues = []
                sim_res = None
                props = None
                if plan.bounded:
                    issues.append("enumeration refused "
                                  "(symbolic fallback): cannot simulate")
                else:
                    sim = ScheduleSimulator(plan, workers=1)
                    sim_res = sim.simulate()
                    again = sim.simulate()
                    if sim_res != again:
                        issues.append("simulator non-deterministic")
                    if not sim_res["makespan_ns"] > 0:
                        issues.append("non-finite simulated makespan")
                    # verdict completeness: every (rank, wave) with
                    # members carries an explicit certificate
                    waves = {(r, row["wave"])
                             for r, rows in plan.waves.items()
                             for row in rows}
                    certified = {(c["rank"], c["wave"])
                                 for c in plan.fusability}
                    missing = waves - certified
                    if missing:
                        issues.append(
                            f"{len(missing)} wave(s) without a "
                            f"fusability verdict: {sorted(missing)[:4]}")
                    if search:
                        props = sim.propose(topk=topk)
                yield tpname, plan, sim_res, props, issues


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("target", nargs="?", default=None,
                    help="in-tree generator name or 'all'")
    ap.add_argument("--search", action="store_true",
                    help="run the coordinate-descent knob search and "
                         "print the ranked proposals")
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--check", action="store_true",
                    help="gate mode over all graphs")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if not args.check and args.target is None:
        print("ptc-tune: a target generator (or 'all' / --check) is "
              "required", file=sys.stderr)
        return 2
    if args.target and args.target != "all" \
            and args.target not in verify_graphs.GENERATORS:
        print(f"ptc-tune: no in-tree generator named {args.target!r}; "
              f"generators: {', '.join(sorted(verify_graphs.GENERATORS))}",
              file=sys.stderr)
        return 2
    only = None if (args.check or args.target == "all") \
        else [args.target]

    dirty = 0
    results = {}
    for name, plan, sim_res, props, issues in tune_all(
            only, args.topk, search=args.search and not args.check):
        fus = plan.fusable_waves()
        nwaves = len(plan.fusability)
        status = "clean" if not issues else "; ".join(issues)
        mk = (f"{sim_res['makespan_ns'] / 1e6:.3f} ms"
              if sim_res else "-")
        print(f"{name:24s} {status}  [sim {mk}, fusable {fus}/{nwaves} "
              f"wave(s)]")
        if issues:
            dirty += 1
        if args.verbose:
            for c in plan.fusability:
                why = "" if c["fusable"] else \
                    f"  ({'; '.join(c['reasons'])})"
                print(f"    rank {c['rank']} wave {c['wave']:3d} "
                      f"{(c['cls'] or '<mixed>'):16s} x{c['width']:<4d} "
                      f"{'fusable' if c['fusable'] else 'refused'}{why}")
        row = {
            "issues": issues,
            "fusable_waves": fus,
            "waves": nwaves,
            "simulated_makespan_ns": (sim_res or {}).get("makespan_ns"),
        }
        if props:
            row["proposals"] = [
                {"knobs": p["knobs"],
                 "predicted_ns": p["predicted_ns"]} for p in props]
            for p in props[:args.topk]:
                print(f"    proposal {p['predicted_ns'] / 1e6:9.3f} ms  "
                      + ", ".join(f"{k.split('.')[-1]}={v}"
                                  for k, v in sorted(p["knobs"].items())))
        results[name] = row
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")
    verb = "tune-check" if args.check else "ptc-tune"
    print(f"{verb}: {len(results)} graph(s), {dirty} with refusals")
    return 1 if dirty else 0


if __name__ == "__main__":
    sys.exit(main())

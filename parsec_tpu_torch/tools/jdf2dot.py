"""Enumerate a JDF program's task DAG and emit DOT + per-class counts
(reference: tools/dagenum.c + the --parsec dot grapher), optionally with
a weighted list-scheduling simulation (reference: the JDF body `weight`
property feeding the simulation/dagenum cost model, parsec.y body
properties).

Usage: python -m parsec_tpu_torch.tools.jdf2dot prog.jdf out.dot
           [--global N=10 ...] [--simulate P]

The DAG comes from the SAME symbolic flow-graph extraction the static
verifier uses (parsec_tpu_torch/analysis/flowgraph.py): the program is
compiled but never executed -- dep targets, guards, broadcast ranges and
control gathers are enumerated over the execution space exactly as the
native engine would resolve them.  Verifier findings (rules V001-V008)
overlay the DOT in red; dynamically-guarded maybe-edges draw dashed.
--simulate P list-schedules the extracted DAG on P virtual workers
using per-task costs from `BODY [weight = <expr>]` (a Python expression
over the task's first two parameters; default cost 1) and reports total
work, critical path, makespan, speedup, and efficiency.

Port of tools/jdf2dot.py.
"""
import argparse
import json
import os
import re
import sys

from parsec_tpu_torch.analysis import (extract_flowgraph, flowgraph_to_dot,
                                       verify_graph)
from parsec_tpu_torch.tools import jdf_program, parse_globals


def _noopify(src: str) -> str:
    """Replace every BODY block's code with 'pass', preserving the body
    properties ([type=..] selection and [weight=..] simulation costs)."""
    return re.sub(
        r"BODY(\s*\[[^\]]*\])?\s*(?:\{.*?\}\s*)?END",
        lambda m: f"BODY{m.group(1) or ''}\n{{\npass\n}}\nEND",
        src, flags=re.S)


def simulate(nodes_edges, prog, gvals, nb_workers):
    """List-schedule the extracted DAG on `nb_workers` virtual workers.

    `nodes_edges` is ((cid, l0, l1) node list, (src, dst) edge list).
    Costs come from each class's first BODY carrying a `weight` property
    (a Python expression over the task's first two declared parameters
    and the program globals; default 1).  Returns a dict with total
    work, weighted critical path, greedy makespan, speedup, and
    efficiency — the JDF-simulation cost model (reference: body weight
    properties + the simulation dag enumerators)."""
    import heapq

    node_list, edge_list = nodes_edges
    weight_src = {}
    pnames = {}
    for i, jt in enumerate(prog.tasks):
        pnames[i] = jt.params[:2]
        for body in jt.bodies:
            w = body.props.get("weight")
            if w is not None:
                weight_src[i] = compile(w, f"<weight-{jt.name}>", "eval")
                break

    def cost(cid, l0, l1):
        code = weight_src.get(cid)
        if code is None:
            return 1
        env = dict(gvals)
        names = pnames.get(cid, [])
        if len(names) > 0:
            env[names[0]] = l0
        if len(names) > 1:
            env[names[1]] = l1
        return max(1, int(eval(code, {}, env)))

    nodes = {}
    for (cid, l0, l1) in node_list:
        nodes[(cid, l0, l1)] = cost(cid, l0, l1)
    succs = {n: [] for n in nodes}
    npred = {n: 0 for n in nodes}
    for src, dst in edge_list:
        if src in nodes and dst in nodes:
            succs[src].append(dst)
            npred[dst] += 1
    # weighted critical path (DAG longest path, reverse topological)
    order = []
    stack = [n for n in nodes if npred[n] == 0]
    indeg = dict(npred)
    while stack:
        n = stack.pop()
        order.append(n)
        for s in succs[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                stack.append(s)
    dist = {n: nodes[n] for n in nodes}
    for n in order:
        for s in succs[n]:
            if dist[n] + nodes[s] > dist[s]:
                dist[s] = dist[n] + nodes[s]
    critical = max(dist.values(), default=0)
    total = sum(nodes.values())
    # greedy list scheduling on P workers
    ready = [(0, n) for n in nodes if npred[n] == 0]
    heapq.heapify(ready)
    workers = [0] * max(1, nb_workers)
    heapq.heapify(workers)
    indeg = dict(npred)
    avail = {}
    makespan = 0
    scheduled = 0
    while ready:
        t_ready, n = heapq.heappop(ready)
        scheduled += 1
        t_start = max(t_ready, heapq.heappop(workers))
        t_end = t_start + nodes[n]
        heapq.heappush(workers, t_end)
        makespan = max(makespan, t_end)
        for s in succs[n]:
            avail[s] = max(avail.get(s, 0), t_end)
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (avail[s], s))
    if scheduled != len(nodes):
        # classes with >2 parameters alias to one (cid, l0, l1) node and
        # can fabricate cycles — silent makespan underestimates lie
        print(f"simulate: WARNING {len(nodes) - scheduled} of "
              f"{len(nodes)} tasks never became ready (node aliasing "
              "on classes with >2 parameters?); makespan/critical-path "
              "are lower bounds", file=sys.stderr)
    return {
        "tasks": len(nodes),
        "total_work": total,
        "critical_path": critical,
        "workers": nb_workers,
        "makespan": makespan,
        "speedup": round(total / makespan, 3) if makespan else 0.0,
        "efficiency": round(total / (makespan * nb_workers), 3)
                      if makespan else 0.0,
    }


def _sim_view(cg):
    """(cid, l0, l1) nodes + deduped edges from a concretized flow
    graph (the shape the trace-based enumerator used to produce)."""

    def key(node):
        cid, params = node
        p = tuple(params) + (0, 0)
        return (cid, p[0], p[1])

    nodes = [key((cid, params))
             for cid, plist in cg.instances.items() for params in plist]
    edges = [(key(src), key(dst))
             for src, outs in cg.succ.items() for dst, _ in outs]
    return nodes, edges


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("jdf")
    ap.add_argument("out")
    ap.add_argument("--global", dest="globs", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--collection", default="mydata",
                    help="name bound to memory references (default mydata)")
    ap.add_argument("--size", type=int, default=256,
                    help="elements in the throwaway collection")
    ap.add_argument("--simulate", type=int, default=0, metavar="P",
                    help="list-schedule the DAG on P virtual workers "
                         "using BODY [weight=..] costs")
    args = ap.parse_args(argv)

    with open(args.jdf) as f:
        src = _noopify(f.read())
    with jdf_program(args.jdf, src, parse_globals(args.globs),
                     args.collection, args.size) as b:
        fg = extract_flowgraph(b.tp)
        report, cg = verify_graph(fg)

    dot = flowgraph_to_dot(cg, report.findings,
                           name=re.sub(r"\W", "_",
                                       os.path.basename(args.jdf)))
    with open(args.out, "w") as f:
        f.write(dot + "\n")
    print(f"{cg.nb_instances()} tasks, {cg.nb_edges} edges -> "
          f"{args.out}; findings: {len(report.findings)}")
    if report.findings:
        print(report.text(), file=sys.stderr)
    if args.simulate > 0:
        sim = simulate(_sim_view(cg), b.prog, b.gvals, args.simulate)
        print("simulate: " + json.dumps(sim))
    return 0


if __name__ == "__main__":
    sys.exit(main())

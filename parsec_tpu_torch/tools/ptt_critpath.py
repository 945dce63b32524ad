"""Critical-path / lost-time / wire-latency report over .ptt traces
(reference role: the trace-table analyses PaRSEC runs on merged dbp
files — "where did the time go" for a distributed run).

Usage:
  python -m parsec_tpu_torch.tools.ptt_critpath r0.ptt [r1.ptt ...] \
      [--json out.json]

Multiple per-rank files are merged with cross-rank clock sync (header-v2
clock_offset_ns) and causal enforcement, then:
  - the executed DAG's critical path (needs level-2 traces: EDGE pairs),
  - a per-(rank, worker) lost-time breakdown
    (compute / release / h2d stall / comm wait / coll wait / idle),
  - the matched-flow wire-latency summary per (src, dst) pair.

Reads the #PTCPROF files either package writes.  Port of
tools/ptt_critpath.py.
"""
import argparse
import json
import sys

import numpy as np

from parsec_tpu_torch.profiling import Trace, critical_path, lost_time


def _fmt_ns(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.3f}s"
    if ns >= 1_000_000:
        return f"{ns / 1e6:.3f}ms"
    return f"{ns / 1e3:.1f}us"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("traces", nargs="+")
    ap.add_argument("--json", help="also write the report as JSON")
    ap.add_argument("--scope", default=None,
                    help="restrict the analysis to ONE request scope: a "
                         "scope id, or 'list' to enumerate the scopes "
                         "present (ptc-scope; the critical-path and "
                         "lost-time splits then describe that request "
                         "alone)")
    args = ap.parse_args(argv)
    traces = [Trace.load(p) for p in args.traces]
    merged = Trace.merge(traces) if len(traces) > 1 else traces[0]
    if args.scope == "list":
        legend = merged.meta.get("scopes") or {}
        for t in traces:
            legend.update(t.meta.get("scopes") or {})
        for sid in merged.scope_ids():
            who = legend.get(str(sid), {})
            extra = "".join(f" {k}={who[k]}" for k in
                            ("tenant", "kind", "rid") if who.get(k)
                            is not None)
            print(f"scope {sid}{extra}")
        return 0
    scope = None
    if args.scope is not None:
        scope = int(args.scope)
        merged = merged.filter_scope(scope)
        print(f"scope {scope}: {len(merged.events)} event(s)")
    report = {"files": list(args.traces),
              "ranks": sorted({int(t.rank) for t in traces}),
              "events": int(len(merged.events)),
              "scope": scope,
              "clock_offsets_ns": merged.meta.get("clock_offsets_ns", {}),
              "clamped_recvs": merged.meta.get("clamped_recvs", 0)}

    # ---------------------------------------------------- critical path
    try:
        cp = critical_path(merged)
    except ValueError as e:
        cp = None
        print(f"critical path: unavailable ({e})")
    if cp is not None:
        if cp["path"]:
            print(f"critical path: {len(cp['path'])} task(s), "
                  f"{_fmt_ns(cp['total_ns'])} "
                  f"({cp['coverage'] * 100:.1f}% of total EXEC time)")
            for cname, l0, l1, d in cp["path"]:
                print(f"  {cname}({l0},{l1})  {_fmt_ns(d)}")
            print("per-class time on the critical path:")
            for cname, ns in sorted(cp["per_class_ns"].items(),
                                    key=lambda kv: -kv[1]):
                print(f"  {cname}: {_fmt_ns(ns)}")
        else:
            print("critical path: no EXEC/EDGE events (trace level < 2?)")
        report["critical_path"] = cp

    # -------------------------------------------------------- lost time
    lt = lost_time(merged)
    if lt["workers"]:
        print("lost time per (rank, worker):")
        for (rank, worker), b in sorted(lt["workers"].items()):
            print(f"  r{rank}/w{worker}: "
                  f"compute {_fmt_ns(b['compute'])}  "
                  f"release {_fmt_ns(b['release'])}  "
                  f"h2d_stall {_fmt_ns(b['h2d_stall'])}  "
                  f"comm_wait {_fmt_ns(b['comm_wait'])}  "
                  f"coll_wait {_fmt_ns(b['coll_wait'])}  "
                  f"idle {_fmt_ns(b['idle'])}")
        report["lost_time_totals"] = lt["totals"]
        report["lost_time"] = {f"r{r}_w{w}": b
                               for (r, w), b in lt["workers"].items()}

    # ----------------------------------------------------- wire latency
    fl = merged.flows()
    if len(fl):
        print(f"wire latency ({len(fl)} matched message(s)):")
        pairs = {}
        for row in fl:
            pairs.setdefault((int(row[0]), int(row[1])), []).append(
                (int(row[6]), int(row[3])))
        wl = {}
        for (src, dst), items in sorted(pairs.items()):
            lats = np.array([i[0] for i in items], dtype=np.int64)
            byt = sum(i[1] for i in items)
            print(f"  {src} -> {dst}: n={len(lats)} "
                  f"p50={_fmt_ns(int(np.percentile(lats, 50)))} "
                  f"max={_fmt_ns(int(lats.max()))} bytes={byt}")
            wl[f"{src}->{dst}"] = {
                "n": int(len(lats)),
                "p50_ns": int(np.percentile(lats, 50)),
                "max_ns": int(lats.max()), "bytes": int(byt)}
        report["wire_latency"] = wl
    else:
        print("wire latency: no matched flows "
              "(single-rank trace, or pre-v2 files)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Critical-path & lost-time analysis over executed-DAG traces.

Reference role: PaRSEC's trace-table tooling answers "where did the time
go" from dbp files — per-class span sums, comm matching, and the
critical path of the executed DAG (SURVEY §L7; the overlap papers T3,
arXiv:2401.16677 make the same walk to attribute compute/collective
overlap).  This module runs on a (merged) Trace:

  critical_path(trace)  — longest duration-weighted chain through the
        EDGE-captured DAG (level-2 tracing), EXEC spans as node weights.
        The path is exact for the executed DAG, not a model: a diamond
        A->{B,C}->D with a slow B returns [A, B, D].
  lost_time(trace)      — per-(rank, worker) wall breakdown: compute /
        release / h2d_stall / comm_wait / coll_wait / idle, from the
        non-overlapping union of that worker's spans; idle gaps that end
        at a COMM_RECV delivery on the same rank are attributed to
        comm_wait — or to coll_wait when the delivery targeted a
        ptc_coll_* collective step (KEY_COLL instants, comm.cpp).
  wire latency rides on Trace.wire_latency() (flow-correlated COMM
        events) — see profiling.trace.

All functions take the merged Trace so multi-rank DAGs (EDGE events are
emitted on the producing rank, EXEC on the executing one) resolve.

Port of parsec_tpu/profiling/critpath.py.  The device's spans come from
its manager and lane threads, which are not workers (worker -1): they
are left out of lost_time's per-worker rows, as in the reference, and
read from the trace's DEVICE_DISPATCH / DEVICE_H2D spans instead."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import (KEY_COLL, KEY_COMM_RECV, KEY_EXEC, KEY_H2D,
                    KEY_RELEASE, KEY_STREAM, Trace)

Node = Tuple[int, int, int]  # (class_id, l0, l1) — the EDGE identity


def _exec_durations(trace: Trace) -> Dict[Node, int]:
    """EXEC duration per task node; a node seen on several ranks (SPMD
    duplicates never happen for EXEC, but merged re-runs may collide)
    keeps the longest span."""
    dur: Dict[Node, int] = {}
    for row in trace._spans_table():
        if row[2] != KEY_EXEC:
            continue
        node = (int(row[3]), int(row[4]), int(row[5]))
        d = int(row[8] - row[7])
        if d > dur.get(node, -1):
            dur[node] = d
    return dur


def critical_path(trace: Trace) -> dict:
    """Longest duration-weighted path through the executed DAG.

    Needs level-2 tracing (EDGE pairs).  Returns
      {"path": [(class_name, l0, l1, dur_ns), ...]  (source -> sink),
       "total_ns": int,          # sum of EXEC durations on the path
       "per_class_ns": {class_name: ns on the path},
       "nodes": int, "edges": int,
       "coverage": fraction of total EXEC time that sits on the path}
    Raises ValueError when the captured edges contain a cycle (a
    corrupted or truncated trace — a real executed DAG cannot)."""
    edges = trace.edges()
    dur = _exec_durations(trace)
    succs: Dict[Node, List[Node]] = {}
    indeg: Dict[Node, int] = {}
    nodes = set(dur)
    for s, d in edges:
        succs.setdefault(s, []).append(d)
        indeg[d] = indeg.get(d, 0) + 1
        nodes.add(s)
        nodes.add(d)
    # Kahn topological order; dist = best finish time into the node
    ready = [n for n in nodes if indeg.get(n, 0) == 0]
    dist: Dict[Node, int] = {n: dur.get(n, 0) for n in ready}
    best_pred: Dict[Node, Optional[Node]] = {n: None for n in ready}
    seen = 0
    order: List[Node] = []
    while ready:
        n = ready.pop()
        order.append(n)
        seen += 1
        for m in succs.get(n, ()):
            cand = dist[n] + dur.get(m, 0)
            if m not in dist or cand > dist[m]:
                dist[m] = cand
                best_pred[m] = n
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if seen != len(nodes):
        raise ValueError(
            f"trace DAG has a cycle ({len(nodes) - seen} node(s) never "
            "became ready) — truncated or corrupted EDGE capture")
    if not dist:
        return {"path": [], "total_ns": 0, "per_class_ns": {},
                "nodes": 0, "edges": 0, "coverage": 0.0}
    sink = max(dist, key=lambda n: dist[n])
    path: List[Node] = []
    n: Optional[Node] = sink
    while n is not None:
        path.append(n)
        n = best_pred.get(n)
    path.reverse()
    per_class: Dict[str, int] = {}
    out_path = []
    for n in path:
        cname = trace._cname(n[0])
        d = dur.get(n, 0)
        per_class[cname] = per_class.get(cname, 0) + d
        out_path.append((cname, n[1], n[2], d))
    total_exec = sum(dur.values())
    return {
        "path": out_path,
        "total_ns": int(dist[sink]),
        "per_class_ns": per_class,
        "nodes": len(nodes),
        "edges": len(edges),
        "coverage": (round(dist[sink] / total_exec, 4)
                     if total_exec else 0.0),
    }


def _union_ns(iv: List[Tuple[int, int]]) -> int:
    """Total length of the union of [begin, end) intervals."""
    if not iv:
        return 0
    iv.sort()
    tot, cur_b, cur_e = 0, iv[0][0], iv[0][1]
    for b, e in iv[1:]:
        if b > cur_e:
            tot += cur_e - cur_b
            cur_b, cur_e = b, e
        else:
            cur_e = max(cur_e, e)
    return tot + (cur_e - cur_b)


def lost_time(trace: Trace, comm_wait_window_ns: int = 50_000) -> dict:
    """Per-(rank, worker) wall-clock breakdown over the trace window.

    Buckets (ns):
      compute    — EXEC spans (union; nested/overlapping spans count once)
      release    — RELEASE_DEPS spans outside compute
      h2d_stall  — dispatch-time DEVICE_H2D spans (aux lane 0: the h2d a
                   wave WAITED on; prefetch-lane h2d overlaps compute by
                   construction and is not lost time)
      comm_wait  — idle gaps that end at (or within
                   `comm_wait_window_ns` after the start of) a COMM_RECV
                   delivery on the same rank: the worker was starved
                   waiting for a remote dependency
      coll_wait  — the subset of that starvation whose delivery targeted
                   a ptc_coll_* collective step (a COLL_RECV instant with
                   the same (src, corr) flow id rode along): time spent
                   waiting on the collective's wire traffic, split out of
                   comm_wait so a reduction misfiled as generic comm (or
                   idle) is visible on its own line
      idle       — the rest of the gap time
    Returns {"workers": {(rank, worker): {...}}, "totals": {...}} where
    every bucket also exists summed in "totals"."""
    t = trace._spans_table()
    ev, rk = trace.events, trace.ranks
    buckets = ("compute", "release", "h2d_stall", "comm_wait",
               "coll_wait", "idle")
    out: Dict[Tuple[int, int], Dict[str, int]] = {}
    if not len(t):
        return {"workers": {}, "totals": {b: 0 for b in buckets}}
    # trace window per rank (instants included — comm events stretch it)
    win: Dict[int, Tuple[int, int]] = {}
    for r in np.unique(rk):
        ts = ev[rk == r, 7]
        win[int(r)] = (int(ts.min()), int(ts.max()))
    # COMM_RECV delivery times per rank (sorted, for the gap classifier),
    # each tagged collective when a COLL_RECV instant with the same
    # (source rank, correlation cookie) flow id exists on that rank —
    # comm.cpp emits the two instants for the same delivered frame
    recv_at: Dict[int, np.ndarray] = {}
    recv_coll: Dict[int, np.ndarray] = {}
    rm = (ev[:, 0] == KEY_COMM_RECV) & (ev[:, 1] == 0)
    cm = (ev[:, 0] == KEY_COLL) & (ev[:, 1] == 0)
    for r in np.unique(rk[rm]):
        rows = ev[rm & (rk == r)]
        order = np.argsort(rows[:, 7])
        rows = rows[order]
        coll_ids = {(int(s), int(c))
                    for s, c in ev[cm & (rk == r)][:, 3:5]}
        recv_at[int(r)] = rows[:, 7]
        recv_coll[int(r)] = np.array(
            [(int(s), int(c)) in coll_ids for s, c in rows[:, 3:5]],
            dtype=bool)
    workers = {}
    wk = t[:, 1] >= 0  # device/comm thread rows (worker -1) excluded
    for key in {(int(r), int(w)) for r, w in t[wk][:, :2]}:
        rows = t[(t[:, 0] == key[0]) & (t[:, 1] == key[1])]
        ex = [(int(b), int(e)) for b, e in
              rows[rows[:, 2] == KEY_EXEC][:, 7:9]]
        rel = [(int(b), int(e)) for b, e in
               rows[rows[:, 2] == KEY_RELEASE][:, 7:9]]
        h2d = [(int(b), int(e)) for b, e in
               rows[(rows[:, 2] == KEY_H2D) & (rows[:, 6] == 0)][:, 7:9]]
        d2h = [(int(b), int(e)) for b, e in
               rows[rows[:, 2] == KEY_STREAM][:, 7:9]]
        compute = _union_ns(list(ex))
        release = _union_ns(rel)
        h2d_stall = _union_ns(h2d)
        busy = list(ex) + rel + h2d + d2h
        busy_ns = _union_ns(list(busy))
        w0, w1 = win[key[0]]
        gap_ns = max(0, (w1 - w0) - busy_ns)
        # classify idle gaps: walk the busy union's complement.  The
        # credited starvation interval splits per delivery: the segment
        # ending at each delivery takes THAT delivery's category
        # (collective step vs generic activation), so one gap fed by
        # both kinds attributes each portion to the right bucket.
        comm_wait = 0
        coll_wait = 0
        busy.sort()
        cursor = w0
        rts = recv_at.get(key[0])
        cfl = recv_coll.get(key[0])
        merged: List[Tuple[int, int]] = []
        for b, e in busy:
            if merged and b <= merged[-1][1]:
                merged[-1] = (merged[-1][0],
                              max(merged[-1][1], e))
            else:
                merged.append((b, e))
        for b, e in merged + [(w1, w1)]:
            if b > cursor and rts is not None and len(rts):
                # a delivery inside (or just after) the gap starved us
                lo = np.searchsorted(rts, cursor)
                hi = np.searchsorted(rts, b + comm_wait_window_ns)
                prev = cursor
                for j in range(lo, hi):
                    tj = int(min(int(rts[j]), b))
                    if tj <= prev:
                        continue
                    if cfl[j]:
                        coll_wait += tj - prev
                    else:
                        comm_wait += tj - prev
                    prev = tj
            cursor = max(cursor, e)
        idle = max(0, gap_ns - comm_wait - coll_wait)
        workers[key] = {
            "compute": compute, "release": release,
            "h2d_stall": h2d_stall, "comm_wait": comm_wait,
            "coll_wait": coll_wait, "idle": idle,
            "window_ns": w1 - w0,
        }
    totals = {b: sum(w[b] for w in workers.values()) for b in buckets}
    return {"workers": workers, "totals": totals}

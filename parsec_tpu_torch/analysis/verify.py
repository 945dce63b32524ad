"""ptc-verify: static dataflow verification of PTG task graphs.

The reference's parsec_ptgpp compiler statically sanity-checks a JDF
before any task runs (dangling flows, malformed dep targets — SURVEY
§L1).  This is the equivalent pass for our table-compiled task classes,
run over the shared `analysis.flowgraph` extraction.  Each rule has a
stable ID and reports class/flow/dep source locations:

  V001  dangling IN: an input counted as a task delivery that no
        producer OUT dep ever emits (guaranteed hang)
  V002  `%{ %}` escape guard on a data input in a flow with a memory
        fallback (the documented wait-forever case — see dsl/jdf.py
        dynamic-guard semantics; promoted from comment to error)
  V003  dependency cycle in the concretized DAG
  V004  dep target index outside the target class's execution space
        for EVERY emission (statically dead edge; per-instance
        boundary drops are JDF semantics and stay silent)
  V005  two unordered OUT deps writing the same tile version
        (write-write race on a collection datum)
  V006  never-read OUT: a delivery no consumer input expects
        (dead dataflow -> wasted comm, and a spurious dependency-count
        decrement on the receiver)
  V007  dtype/shape mismatch across an edge (wire datatype names
        disagree, or arena payload sizes differ with no declared
        reshape)
  V008  ptc_coll_* usage-contract violation (the collectives' constraints: data IN
        deps of collective step classes must carry no guards — a
        guarded IN would be counted as a maybe-input and wait forever)
  V009  rank-mapping soundness: a data input read straight from a
        collection datum whose owner rank differs from the consuming
        instance's placement rank — memory reads are affine with
        placement in this runtime (there is no wire path for a Mem
        IN), so the consumer reads an uninitialized local mirror
  V010  wave-fusability soundness: a wave the plan layer marks
        homogeneous fails its fusability certificate STRUCTURALLY —
        an intra-wave dependency (cycle tail) or a datum written by
        one member while another member touches it with no ordering
        between them.  The engine schedules wave members in arbitrary
        order, so such a pair is a latent race today and a corruption
        once the wave fuses into one executable (MPK prep; see
        analysis/plan.py certify()).  Body opacity and tile-signature
        mismatches refuse the certificate WITHOUT tripping V010 —
        they are legal graphs, just not fusable

Affine/interval reasoning handles what it can prove symbolically
(V004's never-in-domain proof); bounded concrete enumeration of the
execution space is the exact fallback for the instance-level rules
(V001/V003/V005/V006).  Enumeration past `max_instances` degrades to
symbolic-only with an explicit note — never a silent truncation.

Port of parsec_tpu/analysis/verify.py.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from .. import _native as N
from ..core.expr import Range
from ..core.taskclass import Mem, Ref
from .flowgraph import (ConcreteGraph, FlowGraph, expr_is_dynamic,
                        extract_flowgraph, interval_of)

RULES: Dict[str, str] = {
    "V001": "dangling IN dependency (no producing OUT -> hang)",
    "V002": "escape guard on a data input with a memory fallback",
    "V003": "dependency cycle in the concretized DAG",
    "V004": "dep target never inside the target execution space",
    "V005": "unordered writes to the same collection datum",
    "V006": "never-read OUT dependency (dead dataflow)",
    "V007": "dtype/shape mismatch across an edge",
    "V008": "ptc_coll_* usage-contract violation",
    "V009": "memory read of a remote-owned collection datum",
    "V010": "homogeneous wave fails its fusability certificate",
}

_MAX_SAMPLES = 4


class Finding:
    """One verifier finding: rule + class/flow/dep + source location."""

    __slots__ = ("rule", "severity", "cls", "flow", "dep", "loc",
                 "message", "count", "instances")

    def __init__(self, rule: str, severity: str, cls: str,
                 flow: Optional[str], dep: Optional[int],
                 loc: Optional[str], message: str, count: int = 1,
                 instances: Optional[Sequence[tuple]] = None):
        self.rule = rule
        self.severity = severity
        self.cls = cls
        self.flow = flow
        self.dep = dep
        self.loc = loc
        self.message = message
        self.count = count
        self.instances = [tuple(i) for i in (instances or [])]

    def where(self) -> str:
        w = self.cls
        if self.flow is not None:
            w += f".{self.flow}"
        if self.dep is not None:
            w += f"[dep {self.dep}]"
        return w

    def __repr__(self):
        return (f"{self.rule} {self.severity} {self.where()}"
                + (f" ({self.loc})" if self.loc else "")
                + f": {self.message}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "class": self.cls, "flow": self.flow, "dep": self.dep,
                "loc": self.loc, "message": self.message,
                "count": self.count,
                "instances": [list(i) for i in self.instances]}


class Report:
    def __init__(self, findings: List[Finding], notes: List[str],
                 stats: dict):
        order = {"error": 0, "warning": 1, "note": 2}
        self.findings = sorted(
            findings, key=lambda f: (order.get(f.severity, 3), f.rule,
                                     f.cls, f.flow or "", f.dep or 0))
        self.notes = notes
        self.stats = stats

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def ok(self) -> bool:
        return not self.findings

    def text(self) -> str:
        lines = []
        for f in self.findings:
            loc = f" ({f.loc})" if f.loc else ""
            lines.append(f"{f.rule} {f.severity:7s} {f.where()}{loc}: "
                         f"{f.message}")
            if f.instances:
                inst = ", ".join(
                    "(" + ", ".join(str(v) for v in i) + ")"
                    for i in f.instances[:_MAX_SAMPLES])
                more = (f" ... x{f.count}" if f.count > len(f.instances)
                        else "")
                lines.append(f"       instances: {inst}{more}")
        for n in self.notes:
            lines.append(f"note: {n}")
        s = self.stats
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} "
            f"warning(s) over {s.get('classes', 0)} class(es), "
            f"{s.get('instances', 0)} instance(s), "
            f"{s.get('edges', 0)} edge(s) "
            f"[{s.get('elapsed_ms', 0):.0f} ms]")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"findings": [f.to_json() for f in self.findings],
                "notes": list(self.notes), "stats": dict(self.stats)}


class VerifyError(RuntimeError):
    """Raised by verify= enforcement when error-severity findings
    exist."""

    def __init__(self, report: Report):
        self.report = report
        errs = report.errors
        head = "; ".join(repr(f) for f in errs[:3])
        more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
        super().__init__(f"ptc-verify: {len(errs)} error(s): {head}{more}")


# ===================================================================== rules

def _is_data(cm, fi) -> bool:
    return cm.flows[fi].access != N.FLOW_CTL


def _v002_escape_guard_with_mem_fallback(fg: FlowGraph) -> List[Finding]:
    out = []
    for cm in fg.classes:
        for fi, fl in enumerate(cm.flows):
            if not _is_data(cm, fi):
                continue
            has_mem_in = any(d.direction == 0 and isinstance(d.target, Mem)
                             for d in fl.deps)
            if not has_mem_in:
                continue
            for di, d in enumerate(fl.deps):
                if d.direction == 0 and isinstance(d.target, Ref) \
                        and expr_is_dynamic(d.guard):
                    out.append(Finding(
                        "V002", "error", cm.name, fl.name, di,
                        cm.dep_loc(fi, di),
                        "dynamic (escape) guard on a data input whose "
                        "flow has a memory fallback: the instance is "
                        "counted as WAITING for the task delivery and "
                        "the fallback can never fire — if no producer "
                        "chooses it, the taskpool hangs; write the "
                        "guard as a plain expression instead"))
    return out


def _v008_coll_contract(fg: FlowGraph) -> List[Finding]:
    out = []
    for cm in fg.classes:
        if not cm.is_coll:
            continue
        for fi, fl in enumerate(cm.flows):
            if not _is_data(cm, fi):
                continue
            for di, d in enumerate(fl.deps):
                if d.direction == 0 and d.guard is not None:
                    out.append(Finding(
                        "V008", "error", cm.name, fl.name, di,
                        cm.dep_loc(fi, di),
                        "guarded data IN dep on a collective step "
                        "class: ptc_coll_* input selection must ride "
                        "the producer-domain check (a guard holding an "
                        "escape is counted as a maybe-input and the "
                        "step waits forever; see comm/coll.py)"))
    return out


def _v007_dtype_shape(fg: FlowGraph) -> List[Finding]:
    out = []
    for cm in fg.classes:
        for fi, fl in enumerate(cm.flows):
            for di, d in enumerate(fl.deps):
                if d.direction != 1 or not isinstance(d.target, Ref):
                    continue
                peer = fg.by_name.get(d.target.task)
                pfi = cm.peer_flow_index(fi, di)
                if peer is None or pfi is None:
                    continue
                pfl = peer.flows[pfi]
                in_dtypes = {x.dtype for x in pfl.deps
                             if x.direction == 0 and x.dtype is not None}
                if d.dtype is not None and in_dtypes \
                        and d.dtype not in in_dtypes:
                    # Context.datatype_bytes tells a true layout
                    # mismatch (different payload sizes -> corruption)
                    # from a rename of the same layout (warning)
                    db = fg.datatype_bytes
                    sz = db.get(d.dtype)
                    peer_sz = {db.get(x) for x in in_dtypes}
                    rename_only = (sz is not None and peer_sz == {sz})
                    out.append(Finding(
                        "V007", "warning" if rename_only else "error",
                        cm.name, fl.name, di, cm.dep_loc(fi, di),
                        f"wire datatype {d.dtype!r}"
                        + (f" ({sz} B)" if sz is not None else "")
                        + f" sent to {peer.name}.{pfl.name}, whose "
                        f"input deps declare {sorted(in_dtypes)!r}"
                        + (" of the same payload size (rename?)"
                           if rename_only else
                           " with a different payload layout")))
                    continue
                # shape: arena payload sizes must agree unless a
                # reshape is declared on either endpoint
                asz = fg.arena_sizes
                src_a = fl.arena
                dst_a = pfl.arena
                retyped = (d.dtype is not None or d.ltype is not None
                           or any(x.ltype is not None or
                                  x.dtype is not None
                                  for x in pfl.deps if x.direction == 0))
                if (not retyped and src_a and dst_a
                        and src_a in asz and dst_a in asz
                        and asz[src_a] != asz[dst_a]):
                    out.append(Finding(
                        "V007", "warning", cm.name, fl.name, di,
                        cm.dep_loc(fi, di),
                        f"arena payload size mismatch across the edge "
                        f"to {peer.name}.{pfl.name}: {src_a!r} is "
                        f"{asz[src_a]} B, {dst_a!r} is {asz[dst_a]} B "
                        "and no reshape datatype is declared"))
    return out


def _v004_symbolic(fg: FlowGraph) -> List[Finding]:
    """Interval proof that an OUT dep's target can never be inside the
    peer's execution space — works even when enumeration is refused."""
    out = []
    for cm in fg.classes:
        ivals = cm.space_intervals()
        for fi, fl in enumerate(cm.flows):
            for di, d in enumerate(fl.deps):
                if d.direction != 1 or not isinstance(d.target, Ref):
                    continue
                if expr_is_dynamic(d.guard):
                    continue
                peer = fg.by_name.get(d.target.task)
                if peer is None or len(d.target.params) \
                        != len(peer.range_slots):
                    continue
                peer_iv = peer.space_intervals()
                dead_axis = None
                for ax, p in enumerate(d.target.params):
                    if p is None or isinstance(p, Range):
                        continue
                    tiv = interval_of(p, ivals, cm.names, fg.gdict)
                    ps = peer.range_slots[ax]
                    piv = peer_iv.get(ps)
                    if tiv is None or piv is None:
                        continue
                    if tiv[1] < piv[0] or tiv[0] > piv[1]:
                        dead_axis = (ax, tiv, piv)
                        break
                if dead_axis is not None:
                    ax, tiv, piv = dead_axis
                    out.append(Finding(
                        "V004", "error", cm.name, fl.name, di,
                        cm.dep_loc(fi, di),
                        f"target {peer.name} param {ax} evaluates in "
                        f"[{tiv[0]}, {tiv[1]}] but the execution space "
                        f"bounds it to [{piv[0]}, {piv[1]}]: the edge "
                        "can never land (every emission is dropped)"))
    return out


def _v004_concrete(cg: ConcreteGraph) -> List[Finding]:
    out = []
    fg = cg.fg
    for (cid, fi, di), (attempts, landed, oob) in cg.emit_stats.items():
        cm = fg.classes[cid]
        d = cm.flows[fi].deps[di]
        if not isinstance(d.target, Ref):
            continue
        if attempts > 0 and landed == 0 and oob > 0:
            out.append(Finding(
                "V004", "error", cm.name, cm.flows[fi].name, di,
                cm.dep_loc(fi, di),
                f"all {attempts} emission(s) target "
                f"{d.target.task} instances outside its execution "
                "space: the edge never lands (statically dead)",
                count=attempts))
    return out


def _v001_dangling_in(cg: ConcreteGraph) -> List[Finding]:
    out: Dict[tuple, Finding] = {}
    fg = cg.fg
    for (node, fi), expected in cg.expected.items():
        have = cg.ncert.get((node, fi), 0) + cg.nmaybe.get((node, fi), 0)
        if have >= expected:
            continue
        cid, params = node
        cm = fg.classes[cid]
        di = cg.selected.get((node, fi))
        key = (cid, fi, di)
        f = out.get(key)
        if f is None:
            what = ("control gather" if cm.is_ctl(fi)
                    else "task-delivery input")
            f = out[key] = Finding(
                "V001", "error", cm.name, cm.flows[fi].name, di,
                cm.dep_loc(fi, di) if di is not None else
                getattr(cm.flows[fi], "srcloc", None),
                f"{what} counted as expected but no producer OUT dep "
                "ever delivers to it: the instance waits forever "
                "(and no memory fallback applies)", count=0)
        f.count += 1
        if len(f.instances) < _MAX_SAMPLES:
            f.instances.append(params)
    return list(out.values())


def _v006_never_read_out(cg: ConcreteGraph) -> List[Finding]:
    out: Dict[tuple, Finding] = {}
    fg = cg.fg
    for (node, fi), ncert in cg.ncert.items():
        expected = cg.expected.get((node, fi), 0)
        extra = ncert - expected
        if extra <= 0:
            continue
        # attribute to the producing deps we sampled
        srcs = [s for s in cg.src_sample.get((node, fi), []) if s[2]]
        dep_keys = {s[1] for s in srcs} or {None}
        cid, params = node
        cm = fg.classes[cid]
        for dk in dep_keys:
            f = out.get(dk if dk else (node, fi))
            if f is None:
                if dk is not None:
                    scm = fg.classes[dk[0]]
                    f = Finding(
                        "V006", "warning", scm.name,
                        scm.flows[dk[1]].name, dk[2],
                        scm.dep_loc(dk[1], dk[2]),
                        f"delivers to {cm.name}.{cm.flows[fi].name} "
                        "instances whose input selection never expects "
                        "it: dead dataflow (wasted comm, and each "
                        "delivery decrements the receiver's dependency "
                        "count it never budgeted)", count=0)
                else:
                    f = Finding(
                        "V006", "warning", cm.name, cm.flows[fi].name,
                        None, getattr(cm.flows[fi], "srcloc", None),
                        "receives deliveries its input selection never "
                        "expects", count=0)
                out[dk if dk else (node, fi)] = f
            f.count += extra
            if len(f.instances) < _MAX_SAMPLES:
                f.instances.append(params)
    return list(out.values())


def _v003_cycles(cg: ConcreteGraph) -> List[Finding]:
    """Tarjan SCC (iterative) over the concrete delivery edges."""
    succ = cg.succ
    index: Dict[tuple, int] = {}
    low: Dict[tuple, int] = {}
    onstack = set()
    stack: List[tuple] = []
    sccs: List[List[tuple]] = []
    counter = [0]

    for root in list(succ):
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                onstack.add(node)
            recurse = False
            outs = succ.get(node, ())
            for i in range(pi, len(outs)):
                w = outs[i][0]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in onstack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or any(
                        d == node for d, _ in succ.get(node, ())):
                    sccs.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    out = []
    for comp in sccs:
        members = set(comp)
        certain_only = all(
            c for n in comp for (d, c) in cg.succ.get(n, ())
            if d in members)
        sample = ", ".join(cg.node_name(n) for n in comp[:4])
        more = f" ... ({len(comp)} tasks)" if len(comp) > 4 else ""
        cm = cg.fg.classes[comp[0][0]]
        out.append(Finding(
            "V003", "error" if certain_only else "warning",
            cm.name, None, None, getattr(cm.tc, "srcloc", None),
            f"dependency cycle in the concretized DAG: {sample}{more}"
            + ("" if certain_only else
               " (through dynamically-guarded edges; may or may not "
               "materialize at runtime)"),
            count=len(comp),
            instances=[n[1] for n in comp[:_MAX_SAMPLES]]))
    return out


def _v005_write_races(cg: ConcreteGraph) -> List[Finding]:
    out = []
    fg = cg.fg
    adj: Dict[tuple, List[tuple]] = {}
    for src, outs in cg.succ.items():
        adj[src] = [d for d, _ in outs]
    reach_cache: Dict[tuple, set] = {}

    def reaches(a: tuple, b: tuple) -> bool:
        seen = reach_cache.get(a)
        if seen is None:
            seen = set()
            frontier = [a]
            while frontier:
                n = frontier.pop()
                for d in adj.get(n, ()):
                    if d not in seen:
                        seen.add(d)
                        frontier.append(d)
            reach_cache[a] = seen
        return b in seen

    for datum, writers in cg.mem_writes.items():
        certain = [(n, dk) for (n, dk, c) in writers if c]
        if len(certain) < 2:
            continue
        nodes = {}
        for n, dk in certain:
            nodes.setdefault(n, []).append(dk)
        race = None
        nlist = list(nodes)
        for n, dks in nodes.items():
            if len(dks) > 1:  # same instance writes the datum twice
                race = (n, n, dks[0], dks[1])
                break
        if race is None:
            for i in range(len(nlist)):
                for j in range(i + 1, len(nlist)):
                    a, b = nlist[i], nlist[j]
                    if not reaches(a, b) and not reaches(b, a):
                        race = (a, b, nodes[a][0], nodes[b][0])
                        break
                if race:
                    break
        if race is None:
            continue
        a, b, dka, dkb = race
        cm = fg.classes[dka[0]]
        coll, idx = datum
        out.append(Finding(
            "V005", "error", cm.name, cm.flows[dka[1]].name, dka[2],
            cm.dep_loc(dka[1], dka[2]),
            f"unordered write-write to {coll}"
            f"[{', '.join(str(v) for v in idx)}]: "
            f"{cg.node_name(a)} and {cg.node_name(b)} both write it "
            "with no dependency path between them (final value is a "
            "race)", count=len(certain),
            instances=[a[1], b[1]]))
    return out


def _v010_wave_fusability(fg: FlowGraph, cg: ConcreteGraph) -> List[Finding]:
    """V010: homogeneous waves whose fusability certificate refuses for
    a STRUCTURAL reason (intra-wave dependency / intra-wave datum
    conflict).  One finding per affected class, counting its refused
    waves."""
    from .plan import certify_waves
    out: Dict[str, Finding] = {}
    for cert in certify_waves(fg, cg):
        if not cert.get("homogeneous") or not cert.get("structural"):
            continue
        cm = fg.by_name.get(cert["cls"])
        f = out.get(cert["cls"])
        if f is None:
            f = out[cert["cls"]] = Finding(
                "V010", "error", cert["cls"], None, None,
                getattr(cm.tc, "srcloc", None) if cm else None,
                "homogeneous wave fails its fusability certificate "
                f"structurally: {'; '.join(cert['reasons'])} — wave "
                "members execute in arbitrary order, so this is a "
                "latent race per-task and a certain corruption under "
                "wave fusion", count=0)
        f.count += 1
        if len(f.instances) < _MAX_SAMPLES:
            f.instances.append((cert["rank"], cert["wave"]))
    return list(out.values())


def _v009_rank_mapping(cg: ConcreteGraph) -> List[Finding]:
    """V009: a concretized instance whose SELECTED data input is a Mem
    read of a collection datum owned by a different rank than the one
    the instance executes on (placement affinity).  Unlike task
    deliveries — which ride the wire — a Mem IN has no transport: the
    consuming rank reads its local mirror buffer, which was never
    materialized (gemm_dist's docstring: memory reads must be affine
    with placement; the fix is a reader task placed AT the datum that
    forwards it as a task dependency)."""
    out: Dict[tuple, Finding] = {}
    fg = cg.fg
    for cm in fg.classes:
        if cm._aff_coll is None:
            continue  # placement unknowable: nothing provable
        mem_fis = [
            (fi, ) for fi in range(len(cm.flows))
            if not cm.is_ctl(fi)
            and any(d.direction == 0 and isinstance(d.target, Mem)
                    for d in cm.flows[fi].deps)]
        if not mem_fis:
            continue
        for params in cg.instances.get(cm.id, []):
            node = (cm.id, params)
            l = cm.fill_locals(params)
            trank = cm.rank_of_instance(l)
            if trank is None:
                continue
            for (fi, ) in mem_fis:
                di = cg.selected.get((node, fi))
                if di is None:
                    continue
                info = cm._dep_info[(fi, di)]
                if info["kind"] != "mem":
                    continue
                orank = cm.mem_owner_rank(fi, di, l)
                if orank is None or orank == trank:
                    continue
                key = (cm.id, fi, di)
                f = out.get(key)
                if f is None:
                    f = out[key] = Finding(
                        "V009", "error", cm.name, cm.flows[fi].name, di,
                        cm.dep_loc(fi, di),
                        f"memory read of {info['coll']!r} data owned "
                        "by another rank: the instance executes where "
                        "its affinity datum lives but this IN has no "
                        "wire path — the rank reads an uninitialized "
                        "local mirror.  Read it through a task placed "
                        "at the datum instead (gemm_dist ReadA/ReadB "
                        "pattern)", count=0)
                f.count += 1
                if len(f.instances) < _MAX_SAMPLES:
                    f.instances.append(params)
    return list(out.values())


# ================================================================ driver

def verify_graph(fg: FlowGraph, max_instances: int = 200_000,
                 ignore: Sequence[str] = ()) -> Report:
    """Run the V001-V010 rule engine over an extracted flow graph."""
    t0 = time.perf_counter()
    findings: List[Finding] = []
    notes: List[str] = []
    # symbolic rules (always available)
    findings += _v002_escape_guard_with_mem_fallback(fg)
    findings += _v008_coll_contract(fg)
    findings += _v007_dtype_shape(fg)
    sym_v004 = _v004_symbolic(fg)
    # concrete rules (bounded enumeration)
    cg = fg.concretize(max_instances=max_instances)
    notes += cg.notes
    if not cg.bounded:
        conc_v004 = _v004_concrete(cg)
        seen = {(f.cls, f.flow, f.dep) for f in conc_v004}
        findings += conc_v004
        findings += [f for f in sym_v004
                     if (f.cls, f.flow, f.dep) not in seen]
        findings += _v001_dangling_in(cg)
        findings += _v003_cycles(cg)
        findings += _v005_write_races(cg)
        findings += _v006_never_read_out(cg)
        findings += _v009_rank_mapping(cg)
        findings += _v010_wave_fusability(fg, cg)
    else:
        findings += sym_v004
        notes.append("instance-level rules (V001/V003/V005/V006/V009/"
                     "V010) skipped: raise max_instances to enable")
    if ignore:
        ign = set(ignore)
        findings = [f for f in findings if f.rule not in ign]
    stats = {
        "classes": len(fg.classes),
        "instances": cg.nb_instances(),
        "edges": cg.nb_edges,
        "bounded": cg.bounded,
        "elapsed_ms": (time.perf_counter() - t0) * 1e3,
    }
    return Report(findings, notes, stats), cg


def verify_taskpool(tp, max_instances: int = 200_000,
                    ignore: Sequence[str] = ()) -> Report:
    """Extract + verify a Taskpool's task-class tables (nothing is
    executed).  Returns the Report."""
    fg = extract_flowgraph(tp)
    report, _cg = verify_graph(fg, max_instances=max_instances,
                               ignore=ignore)
    return report

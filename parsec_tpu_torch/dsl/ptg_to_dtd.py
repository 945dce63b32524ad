"""Runtime PTG -> DTD conversion — a correctness cross-check tool.

Reference: parsec/mca/pins/ptg_to_dtd, which re-executes a PTG taskpool
through the DTD engine so the two dataflow front-ends validate each
other (the PTG compiler's dependency iterators against DTD's
access-order discovery).  Here the conversion is a library function: it
interprets the PYTHON-side task-class spec (the same declarations the
native spec blob is compiled from) with a small expression evaluator,
enumerates every instance, resolves each flow to its ROOT datum by
walking In-dep chains back to a Mem reference (or to a fresh transient
datum for `In(None)` chain heads), topologically orders the instances,
and re-submits them as DTD tasks whose tile access order reproduces the
PTG dataflow.  Running both and comparing collection contents
cross-validates the dense/hash dependency engines, guard evaluation,
and release_deps against DTD's data-driven discovery.

Scope (the tool's contract, mirroring the reference tool's limits):
CPU-body pools with expression guards; bracketed dep iterators and CTL
flows are rejected loudly.  DTD serializes tile access, so a converted
pool may run MORE ordered than the PTG original — results, not
schedules, are what is compared.

Port of parsec_tpu/dsl/ptg_to_dtd.py (host Python over the port's own
core.expr and task-class objects).
"""
from __future__ import annotations

import ctypes as C
from typing import Dict, List, Optional

import numpy as np

from .. import _native as N
from ..core.context import Context, Data
from ..core.expr import BinOp, Compr, Const, G, L, Select, UnOp
from ..core.taskclass import Mem, Ref, TaskClass
from ..core.taskpool import Taskpool
from .dtd import DtdTaskpool


def _tdiv(a: int, b: int) -> int:
    """C++ TRUNCATING int division — the native VM's semantics
    (core.cpp OP_DIV); Python's floor division differs for mixed
    signs, which would make guards diverge from the engine under
    cross-check."""
    if b == 0:
        return 0
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _tmod(a: int, b: int) -> int:
    """C++ truncating remainder: sign follows the dividend."""
    if b == 0:
        return 0
    return a - _tdiv(a, b) * b


_BINOPS = {
    N.OP_ADD: lambda a, b: a + b,
    N.OP_SUB: lambda a, b: a - b,
    N.OP_MUL: lambda a, b: a * b,
    N.OP_DIV: _tdiv,
    N.OP_MOD: _tmod,
    N.OP_EQ: lambda a, b: int(a == b),
    N.OP_NE: lambda a, b: int(a != b),
    N.OP_LT: lambda a, b: int(a < b),
    N.OP_LE: lambda a, b: int(a <= b),
    N.OP_GT: lambda a, b: int(a > b),
    N.OP_GE: lambda a, b: int(a >= b),
    N.OP_AND: lambda a, b: int(bool(a) and bool(b)),
    N.OP_OR: lambda a, b: int(bool(a) or bool(b)),
    N.OP_MIN: min,
    N.OP_MAX: max,
    N.OP_SHL: lambda a, b: a << b,
    N.OP_SHR: lambda a, b: a >> b,
}
_UNOPS = {
    N.OP_NEG: lambda a: -a,
    N.OP_NOT: lambda a: int(not a),
}


def eval_expr(e, loc: Dict[str, int], glb: Dict[str, int]) -> int:
    """Evaluate a Python-side Expr tree (the same trees compile_expr
    serializes for the native VM) against named locals/globals."""
    if isinstance(e, bool):
        return int(e)
    if isinstance(e, (int, np.integer)):
        return int(e)
    if isinstance(e, Const):
        return int(e.v)
    if isinstance(e, L):
        return int(loc[e.name])
    if isinstance(e, G):
        return int(glb[e.name])
    if isinstance(e, BinOp):
        return _BINOPS[e.op](eval_expr(e.a, loc, glb),
                             eval_expr(e.b, loc, glb))
    if isinstance(e, UnOp):
        return _UNOPS[e.op](eval_expr(e.a, loc, glb))
    if isinstance(e, Select):
        return eval_expr(e.a if eval_expr(e.c, loc, glb) else e.b,
                         loc, glb)
    if isinstance(e, str):
        return int(glb[e])
    raise NotImplementedError(
        f"ptg_to_dtd: unsupported expression node {type(e).__name__} "
        "(UDF calls need the native VM)")


def _walk(lo: int, hi: int, st: int):
    """The native enumeration walk: ascending for st>0, DESCENDING for
    st<0 (lo down to hi), empty for st==0 — matching enumerate_class."""
    if st == 0:
        return range(0)
    if st > 0:
        return range(lo, hi + 1, st)
    return range(lo, hi - 1, st)


def _instances(tc: TaskClass, glb: Dict[str, int]):
    """Enumerate the class domain as {name: value} dicts, honoring
    range, derived, and comprehension locals in declaration order."""
    out: List[Dict[str, int]] = [{}]
    for (name, is_range, payload) in tc.locals:
        nxt = []
        for loc in out:
            if isinstance(payload, Compr):
                it = payload.iter_name or name
                lo = eval_expr(payload.lo, loc, glb)
                hi = eval_expr(payload.hi, loc, glb)
                st = eval_expr(payload.step, loc, glb)
                for i in _walk(lo, hi, st):
                    l2 = dict(loc)
                    l2[it] = i
                    l2[name] = eval_expr(payload.value, l2, glb)
                    if it != name:
                        del l2[it]
                    nxt.append(l2)
            elif is_range:
                lo = eval_expr(payload.lo, loc, glb)
                hi = eval_expr(payload.hi, loc, glb)
                st = eval_expr(payload.step, loc, glb)
                for v in _walk(lo, hi, st):
                    l2 = dict(loc)
                    l2[name] = v
                    nxt.append(l2)
            else:  # derived local
                l2 = dict(loc)
                l2[name] = eval_expr(payload, loc, glb)
                nxt.append(l2)
        out = nxt
    return out


class _NativeColl:
    """data_of/rank_of adapter over a NATIVELY-registered collection
    (e.g. register_linear_collection) so DtdTaskpool.tile_of can key
    tiles on it when no Python collection object exists."""

    class _D:
        __slots__ = ("_ptr",)

        def __init__(self, ptr):
            self._ptr = ptr

    def __init__(self, ctx: Context, dc_id: int):
        self.ctx = ctx
        self.dc_id = dc_id

    def data_of(self, *idx):
        arr = (C.c_int64 * max(1, len(idx)))(*idx)
        p = N.lib.ptc_dc_data_of(self.ctx._ptr, self.dc_id, arr, len(idx))
        return self._D(p) if p else None

    def rank_of(self, *idx):
        arr = (C.c_int64 * max(1, len(idx)))(*idx)
        return N.lib.ptc_dc_rank_of(self.ctx._ptr, self.dc_id, arr,
                                    len(idx))


class _ConvView:
    """TaskView-compatible adapter handed to the original PTG bodies:
    locals come from the enumeration, flow data from the DTD view."""

    def __init__(self, dtd_view, loc, glb, flow_slot):
        self._v = dtd_view
        self._loc = loc
        self._glb = glb
        self._slot = flow_slot

    def local(self, name: str) -> int:
        return self._loc[name]

    def __getitem__(self, name: str) -> int:
        return self.local(name)

    def global_(self, name: str) -> int:
        return self._glb[name]

    def data(self, flow: str, dtype=np.uint8, shape=None,
             sync: bool = True) -> np.ndarray:
        return self._v.data(self._slot[flow], dtype=dtype, shape=shape)


def run_ptg_as_dtd(ctx: Context, tp: Taskpool,
                   collections: Dict[str, object],
                   window: Optional[int] = None) -> Dict[str, int]:
    """Re-execute a (not-yet-run) PTG taskpool spec through DTD.

    `collections` maps the Mem names used in the spec to their Python
    collection objects (rank_of/data_of), or to None for collections
    registered natively (register_linear_collection) — those are
    reached through the ptc_dc_data_of tool ABI.  Runs to completion;
    returns {"tasks": N, "classes": C}.  The caller compares collection
    contents against a PTG run of the same spec."""
    collections = {
        name: (c if c is not None
               else _NativeColl(ctx, ctx.collections[name]))
        for name, c in collections.items()}
    glb = {name: N.lib.ptc_tp_global(tp._ptr, i)
           for name, i in tp.globals_map.items()}
    classes = {tc.name: tc for tc in tp.classes}

    # ---- per-instance flow roots (memoized), via active-In resolution
    roots: Dict[tuple, tuple] = {}
    transients: Dict[tuple, Data] = {}
    tkey = [1000]

    def peer_locals(ref: Ref, loc) -> Dict[str, int]:
        """Full locals of the peer instance a Ref names: Ref params bind
        the range/comprehension slots in declaration order; derived
        locals re-derive from them (the native dep-param translation)."""
        pview = tuple(eval_expr(p, loc, glb) for p in ref.params)
        ptc = classes[ref.task]
        ploc: Dict[str, int] = {}
        ri = 0
        for (n, is_range, payload) in ptc.locals:
            if isinstance(payload, Compr) or is_range:
                ploc[n] = pview[ri]
                ri += 1
            else:
                ploc[n] = eval_expr(payload, ploc, glb)
        return ploc

    def active_in(tc: TaskClass, fl, loc):
        for d in fl.deps:
            if d.direction != 0:
                continue
            if d.iters:
                raise NotImplementedError(
                    "ptg_to_dtd: bracketed dep iterators")
            if d.guard is None or eval_expr(d.guard, loc, glb):
                return d
        return None

    _IN_PROGRESS = ("...",)  # cycle-guard sentinel (never a real root)

    def root_of(cname: str, params: tuple, fname: str):
        key = (cname, params, fname)
        if key in roots:
            r = roots[key]
            if r is _IN_PROGRESS:
                # re-entered while resolving this very instance: the In
                # chain loops.  Raise here — letting the sentinel escape
                # surfaces later as an opaque tuple-unpack ValueError at
                # the caller, far from the cycle.
                raise ValueError(
                    f"ptg_to_dtd: cyclic In chain at {cname}/{fname} "
                    f"(params {params})")
            return r
        roots[key] = _IN_PROGRESS
        tc = classes[cname]
        loc = dict(zip([n for n, _, _ in tc.locals], params))
        # re-derive non-param locals (params covers ALL locals here
        # because instances carry every local)
        fl = next(f for f in tc.flows if f.name == fname)
        d = active_in(tc, fl, loc)
        if d is None or d.target is None:
            # chain head: a fresh transient datum (the arena copy)
            size = ctx.arena_sizes.get(fl.arena, 64) if fl.arena else 64
            tkey[0] += 1
            td = Data(tkey[0], np.zeros(size, np.uint8))
            transients[key] = td
            r = ("data", td)
        elif isinstance(d.target, Mem):
            idx = tuple(eval_expr(i, loc, glb) for i in d.target.idx)
            r = ("mem", d.target.collection, idx)
        elif isinstance(d.target, Ref):
            pflow = d.target.flow or fname
            ploc = peer_locals(d.target, loc)
            r = root_of(d.target.task,
                        tuple(ploc[n] for n, _, _ in
                              classes[d.target.task].locals), pflow)
        else:
            raise NotImplementedError(
                f"ptg_to_dtd: unsupported In target {d.target!r}")
        roots[key] = r
        return r

    # ---- enumerate + topologically order (Kahn over producer edges)
    insts = []  # (cname, params(dict))
    for tc in tp.classes:
        for loc in _instances(tc, glb):
            insts.append((tc.name, loc))
    idx_of = {(c, tuple(l.values())): i for i, (c, l) in enumerate(insts)}
    succs: List[List[int]] = [[] for _ in insts]
    preds = [0] * len(insts)
    for i, (cname, loc) in enumerate(insts):
        tc = classes[cname]
        for fl in tc.flows:
            if fl.access == N.FLOW_CTL:
                raise NotImplementedError("ptg_to_dtd: CTL flows")
            d = active_in(tc, fl, loc)
            if d is not None and isinstance(d.target, Ref):
                ploc = peer_locals(d.target, loc)
                j = idx_of.get((d.target.task, tuple(ploc.values())))
                if j is not None:
                    succs[j].append(i)
                    preds[i] += 1
    order: List[int] = [i for i in range(len(insts)) if preds[i] == 0]
    qi = 0
    while qi < len(order):
        for s in succs[order[qi]]:
            preds[s] -= 1
            if preds[s] == 0:
                order.append(s)
        qi += 1
    if len(order) != len(insts):
        raise ValueError("ptg_to_dtd: dependency cycle in the PTG spec")

    # ---- insert in topo order; DTD rediscovers the DAG from access
    # order.  Specs accumulate into a batch stream: ONE native crossing
    # per dtd.insert_batch tasks (ptc_dtask_insert_batch) instead of the
    # per-task begin/arg/submit triple — access order is the batch
    # stream's order, so the discovered DAG is identical.
    dtp = DtdTaskpool(ctx, window=window)
    n_inserted = 0
    batch_stream = []

    def _copy_body(v):
        src = v.data(0)
        dst = v.data(1)
        k = min(len(src), len(dst))
        dst[:k] = src[:k]

    for i in order:
        cname, loc = insts[i]
        tc = classes[cname]
        body = next((ch.body for ch in tc.chores
                     if ch.body_kind == N.BODY_CB and ch.body), None)
        params = tuple(loc.values())
        args = []
        slot = {}
        writebacks = []  # (root tile, dst tile): PTG's release-time
        #                  cross-tile Mem memcpy, as explicit copy tasks
        for fl in tc.flows:
            r = root_of(cname, params, fl.name)
            if r[0] == "data":
                tile = dtp.tile_of(r[1])
            else:
                _, collname, idx = r
                tile = dtp.tile_of(collections[collname], *idx)
            mode = {N.FLOW_READ: "INPUT", N.FLOW_WRITE: "OUTPUT",
                    N.FLOW_RW: "INOUT"}[fl.access]
            slot[fl.name] = len(args)
            args.append((tile, mode))
            for d in fl.deps:
                if d.direction != 1 or not isinstance(d.target, Mem):
                    continue
                if d.guard is not None and not eval_expr(d.guard, loc,
                                                         glb):
                    continue
                if d.ltype is not None:
                    raise NotImplementedError(
                        "ptg_to_dtd: reshaped Mem writeback ([type=..])")
                idx = tuple(eval_expr(x, loc, glb) for x in d.target.idx)
                dst = ("mem", d.target.collection, idx)
                if dst != r:
                    writebacks.append(
                        (tile, dtp.tile_of(
                            collections[d.target.collection], *idx)))

        def mk(body, loc, slot):
            if body is None:
                return lambda v: None
            return lambda v: body(_ConvView(v, loc, glb, slot))

        batch_stream.append((mk(body, dict(loc), dict(slot)), tuple(args)))
        n_inserted += 1
        for src_tile, dst_tile in writebacks:
            batch_stream.append((_copy_body, ((src_tile, "INPUT"),
                                              (dst_tile, "INOUT"))))
    dtp.insert_tasks(batch_stream)
    dtp.wait()
    dtp.destroy()  # tiles go before their transient Data backings
    for d in transients.values():
        d.destroy()
    return {"tasks": n_inserted, "classes": len(tp.classes)}

"""Symbolic flow-graph extraction from compiled PTG task-class tables.

One extractor, two consumers: the `verify` rule engine and the
tools/jdf2dot.py visualizer both read the graph produced here, so what
the verifier checks is exactly what the grapher draws.

The extraction mirrors the native dependency engine's semantics
(native/core.cpp) rather than re-inventing them:

  - expression evaluation replicates the stack-VM opcode semantics
    (C truncating division/modulo, shift clamps, div-by-zero -> 0);
  - execution-space membership replicates `task_params_in_domain`
    (per-axis bounds with the candidate params bound, comprehension
    value-set walks);
  - input selection replicates `select_input_dep` — first guard-true
    dep with an existing producer; in COUNTING (conservative) mode a
    dynamic guard (one containing a Python escape) on a task source is
    treated as a potential delivery, exactly like the native counter;
  - producer emission replicates the `release_deps` walk: per-dep
    bracketed iterators, range (broadcast) expansion, and silent
    dropping of out-of-domain successors.

Two analysis levels:

  symbolic   — the classes/flows/deps structure with guard classification
               and interval (affine) bounds reasoning; always available.
  concrete   — bounded enumeration of the execution space producing the
               exact instance DAG (expected input counts vs actual
               deliveries, memory reads/writes).  `FlowGraph.concretize`
               refuses past `max_instances` and records a note instead
               of silently truncating.

Port of parsec_tpu/analysis/flowgraph.py.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import _native as N
from ..core import expr as E
from ..core.taskclass import Mem, Ref


# ------------------------------------------------------------------ C-ops
def _tdiv(a: int, b: int) -> int:
    """C truncating integer division; div-by-zero -> 0 (native VM)."""
    if b == 0:
        return 0
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _tmod(a: int, b: int) -> int:
    if b == 0:
        return 0
    return a - _tdiv(a, b) * b


def _shclamp(b: int) -> int:
    return 0 if b < 0 else (62 if b > 62 else b)


def _jdf_nodes():
    from ..dsl import jdf
    return jdf._Name, jdf._PyEscape


def expr_nodes(e):
    """Iterate an expression tree (Expr objects, ints excluded)."""
    stack = [e]
    while stack:
        x = stack.pop()
        if not isinstance(x, E.Expr):
            continue
        yield x
        if isinstance(x, E.BinOp):
            stack += [x.a, x.b]
        elif isinstance(x, E.UnOp):
            stack.append(x.a)
        elif isinstance(x, E.Select):
            stack += [x.c, x.a, x.b]


def expr_is_dynamic(e) -> bool:
    """Does the expression call into Python (a `%{ %}` escape or
    pt.call)?  Mirrors the native guard_dyn classification
    (core.cpp expr_has_call): such an expression may read state task
    bodies write later, so the ENGINE counts it conservatively —
    whether or not it is declared pure."""
    if e is None or isinstance(e, int):
        return False
    _Name, _PyEscape = _jdf_nodes()
    return any(isinstance(x, (E.Call, _PyEscape)) for x in expr_nodes(e))


def expr_is_impure(e) -> bool:
    """Is analysis-time evaluation NOT binding?  True for `%{ %}`
    escapes and undeclared pt.call callbacks; False for pt.call(...,
    pure=True) frozen tables, whose value the verifier may trust."""
    if e is None or isinstance(e, int):
        return False
    _Name, _PyEscape = _jdf_nodes()
    for x in expr_nodes(e):
        if isinstance(x, _PyEscape):
            return True
        if isinstance(x, E.Call) and not getattr(x, "pure", False):
            return True
    return False


# ------------------------------------------------------------- intervals
def interval_of(e, ivals: Dict[int, Tuple[int, int]], names: Dict[str, int],
                gdict: Dict[str, int]):
    """Affine/interval bound of an expression: (lo, hi) or None when the
    expression leaves the affine fragment (escapes, div/mod).  `ivals`
    maps local slots to their (lo, hi) bounds."""
    if e is None:
        return None
    if isinstance(e, int):
        return (e, e)
    _Name, _PyEscape = _jdf_nodes()
    if isinstance(e, E.Const):
        return (e.v, e.v)

    def name_iv(nm):
        if nm in names and names[nm] in ivals:
            return ivals[names[nm]]
        if nm in gdict:
            return (gdict[nm], gdict[nm])
        return None

    if isinstance(e, E.L):
        return name_iv(e.name)
    if isinstance(e, _Name):
        return name_iv(e.name)
    if isinstance(e, E.G):
        return (gdict[e.name], gdict[e.name]) if e.name in gdict else None
    if isinstance(e, E.UnOp):
        a = interval_of(e.a, ivals, names, gdict)
        if e.op == N.OP_NEG:
            return (-a[1], -a[0]) if a else None
        if e.op == N.OP_NOT:
            return (0, 1)
        return None
    if isinstance(e, E.Select):
        a = interval_of(e.a, ivals, names, gdict)
        b = interval_of(e.b, ivals, names, gdict)
        if a and b:
            return (min(a[0], b[0]), max(a[1], b[1]))
        return None
    if isinstance(e, E.BinOp):
        if e.op in (N.OP_EQ, N.OP_NE, N.OP_LT, N.OP_LE, N.OP_GT, N.OP_GE,
                    N.OP_AND, N.OP_OR):
            return (0, 1)
        a = interval_of(e.a, ivals, names, gdict)
        b = interval_of(e.b, ivals, names, gdict)
        if not a or not b:
            return None
        if e.op == N.OP_ADD:
            return (a[0] + b[0], a[1] + b[1])
        if e.op == N.OP_SUB:
            return (a[0] - b[1], a[1] - b[0])
        if e.op == N.OP_MUL:
            ps = (a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1])
            return (min(ps), max(ps))
        if e.op == N.OP_MIN:
            return (min(a[0], b[0]), min(a[1], b[1]))
        if e.op == N.OP_MAX:
            return (max(a[0], b[0]), max(a[1], b[1]))
        return None
    return None


# -------------------------------------------------------- expr -> lambda
class ExprCompiler:
    """Compile Expr trees to Python lambdas over a locals list `l`.

    Globals are constant per taskpool and folded in; `pt.call`
    callbacks receive (locals_list, globals_dict) like the native
    OP_CALL bridge; JDF `%{ %}` escapes are evaluated over the program
    scope with task locals bound by name — both exactly as at runtime.
    """

    def __init__(self, gdict: Dict[str, int], scope: Optional[dict]):
        self.gdict = gdict
        self.scope = scope
        self._cache: Dict[tuple, Callable] = {}
        self._esc_code: Dict[int, object] = {}

    def compile(self, e, names: Dict[str, int],
                default: int = 0) -> Callable[[list], int]:
        if e is None:
            return lambda l, _d=default: _d
        key = (id(e), id(names))
        fn = self._cache.get(key)
        if fn is None:
            closures: List = []
            src = self._gen(e if isinstance(e, E.Expr) else E.Const(int(e)),
                            names, closures)
            env = {"_tdiv": _tdiv, "_tmod": _tmod, "_sc": _shclamp,
                   "_g": self.gdict, "min": min, "max": max, "int": int}
            for i, c in enumerate(closures):
                env[f"_f{i}"] = c
            fn = eval(f"lambda l: ({src})", env)
            fn._expr = e  # keep-alive: id(e) keys the cache
            self._cache[key] = fn
        return fn

    def _gen(self, e, names, closures) -> str:
        _Name, _PyEscape = _jdf_nodes()
        if isinstance(e, E.Const):
            return repr(int(e.v))
        if isinstance(e, (E.L, _Name)):
            nm = e.name
            if nm in names:
                return f"l[{names[nm]}]"
            if isinstance(e, _Name) and nm in self.gdict:
                return repr(int(self.gdict[nm]))
            if nm in self.gdict:  # L() cannot name a global natively,
                raise KeyError(f"unknown local {nm!r}")  # mirror that
            raise KeyError(f"unknown symbol {nm!r}")
        if isinstance(e, E.G):
            if e.name not in self.gdict:
                raise KeyError(f"unknown global {e.name!r}")
            return repr(int(self.gdict[e.name]))
        if isinstance(e, _PyEscape):
            code = self._esc_code.get(id(e))
            if code is None:
                code = compile(e.code, "<jdf-escape>", "eval")
                self._esc_code[id(e)] = code
            pairs = tuple(names.items())
            scope = self.scope if self.scope is not None else {}
            gd = self.gdict

            def esc(l, _c=code, _p=pairs, _s=scope, _g=gd):
                env = dict(_g)
                for n, s in _p:
                    env[n] = l[s]
                return int(eval(_c, _s, env))

            closures.append(esc)
            return f"_f{len(closures) - 1}(l)"
        if isinstance(e, E.Call):
            fn = e.fn
            gd = self.gdict
            closures.append(lambda l, _fn=fn, _g=gd: int(_fn(l, _g)))
            return f"_f{len(closures) - 1}(l)"
        if isinstance(e, E.UnOp):
            a = self._gen(e.a, names, closures)
            if e.op == N.OP_NEG:
                return f"(-{a})"
            if e.op == N.OP_NOT:
                return f"(0 if {a} else 1)"
            raise ValueError(f"unknown unop {e.op}")
        if isinstance(e, E.Select):
            c = self._gen(e.c, names, closures)
            a = self._gen(e.a, names, closures)
            b = self._gen(e.b, names, closures)
            return f"({a} if {c} else {b})"
        if isinstance(e, E.BinOp):
            a = self._gen(e.a, names, closures)
            b = self._gen(e.b, names, closures)
            op = e.op
            simple = {N.OP_ADD: "+", N.OP_SUB: "-", N.OP_MUL: "*",
                      N.OP_EQ: "==", N.OP_NE: "!=", N.OP_LT: "<",
                      N.OP_LE: "<=", N.OP_GT: ">", N.OP_GE: ">="}
            if op in simple:
                return f"({a}{simple[op]}{b})"
            if op == N.OP_DIV:
                return f"_tdiv({a},{b})"
            if op == N.OP_MOD:
                return f"_tmod({a},{b})"
            if op == N.OP_AND:
                return f"(1 if ({a}!=0 and {b}!=0) else 0)"
            if op == N.OP_OR:
                return f"(1 if ({a}!=0 or {b}!=0) else 0)"
            if op == N.OP_MIN:
                return f"min({a},{b})"
            if op == N.OP_MAX:
                return f"max({a},{b})"
            if op == N.OP_SHL:
                return f"({a}<<_sc({b}))"
            if op == N.OP_SHR:
                return f"({a}>>_sc({b}))"
            raise ValueError(f"unknown binop {op}")
        raise TypeError(f"cannot compile {e!r} as an expression")


def _in_range(v: int, lo: int, hi: int, st: int) -> bool:
    """Stride-range membership (native in_range)."""
    if st > 0:
        return lo <= v <= hi and (v - lo) % st == 0
    return hi <= v <= lo and (lo - v) % (-st) == 0


def _steps(lo: int, hi: int, st: int):
    if st == 0:
        st = 1
    v = lo
    while (v <= hi) if st > 0 else (v >= hi):
        yield v
        v += st


class SpaceTooLarge(Exception):
    """Concrete enumeration refused: past the instance budget."""


# ------------------------------------------------------------ class model
class ClassModel:
    """One task class: precompiled bounds/guards/targets + the native
    domain-membership and input-selection rules."""

    def __init__(self, fg: "FlowGraph", tc):
        self.fg = fg
        self.tc = tc
        self.name = tc.name
        self.id = tc.id
        self.is_coll = tc.name.startswith("ptc_coll_")
        self.locals: List[Tuple[str, str, object]] = []
        for (nm, is_range, payload) in tc.locals:
            if isinstance(payload, E.Compr):
                kind = "compr"
            elif is_range:
                kind = "range"
            else:
                kind = "derived"
            self.locals.append((nm, kind, payload))
        self.nb_locals = len(self.locals)
        self.slot_of = {nm: i for i, (nm, _, _) in enumerate(self.locals)}
        self.names = dict(self.slot_of)
        self.range_slots = [i for i, (_, k, _) in enumerate(self.locals)
                            if k != "derived"]
        self.param_names = [self.locals[s][0] for s in self.range_slots]
        self.flows = list(tc.flows)
        cc = fg.cc
        # locals machinery
        self._local_fns = []
        for (nm, kind, payload) in self.locals:
            if kind == "derived":
                self._local_fns.append(("derived",
                                        cc.compile(payload, self.names)))
            elif kind == "range":
                self._local_fns.append(
                    ("range", (cc.compile(payload.lo, self.names),
                               cc.compile(payload.hi, self.names),
                               cc.compile(payload.step, self.names, 1))))
            else:  # compr: value reads its own slot as the iterator
                vnames = self.names
                if payload.iter_name:
                    vnames = dict(self.names)
                    vnames[payload.iter_name] = self.slot_of[nm]
                self._local_fns.append(
                    ("compr", (cc.compile(payload.lo, self.names),
                               cc.compile(payload.hi, self.names),
                               cc.compile(payload.step, self.names, 1),
                               cc.compile(payload.value, vnames))))
        # per-dep machinery: guard fn, guard_dyn, iters, params
        self._dep_info: Dict[Tuple[int, int], dict] = {}
        for fi, fl in enumerate(self.flows):
            for di, d in enumerate(fl.deps):
                self._dep_info[(fi, di)] = self._prep_dep(d)
        self._domain_cache = None  # None = undecided; False = dynamic
        # placement affinity (": desc(m, n)"): the instance executes on
        # rank_of(*idx) of the affinity collection — the rank mapping
        # that V009 and the ptc-plan residency/comm analyses evaluate
        aff = getattr(tc, "_affinity", None)
        self._aff_coll = aff.collection if aff is not None else None
        self._aff_fns = ([cc.compile(e, self.names) for e in aff.idx]
                         if aff is not None else [])

    def rank_of_instance(self, l: list) -> Optional[int]:
        """Rank this instance executes on (affinity collection's
        rank_of over the evaluated placement indices), or None when the
        mapping is unknowable statically (no affinity declared, no
        Python collection object registered, or rank_of raising on an
        out-of-range probe)."""
        if self._aff_coll is None:
            return None
        coll = self.fg.collection_objs.get(self._aff_coll)
        if coll is None:
            return None
        try:
            return int(coll.rank_of(*[fn(l) for fn in self._aff_fns]))
        except Exception:
            return None

    def mem_owner_rank(self, fi: int, di: int, l: list) -> Optional[int]:
        """Owner rank of the collection datum a Mem dep addresses, or
        None when unknowable (same caveats as rank_of_instance)."""
        info = self._dep_info[(fi, di)]
        if info.get("kind") != "mem":
            return None
        coll = self.fg.collection_objs.get(info["coll"])
        if coll is None:
            return None
        try:
            return int(coll.rank_of(*[fn(l) for fn in info["idx"]]))
        except Exception:
            return None

    # ------------------------------------------------------------ prep
    def _prep_dep(self, d) -> dict:
        cc = self.fg.cc
        names = dict(self.names)
        iters = []
        for k, (inm, lo, hi, st) in enumerate(d.iters):
            # iterator k's own bounds see only earlier iterators
            bnames = dict(names)
            iters.append((cc.compile(lo, bnames), cc.compile(hi, bnames),
                          cc.compile(st, bnames, 1)))
            names[inm] = self.nb_locals + k
        info = {
            "guard": cc.compile(d.guard, names, 1),
            "guard_dyn": expr_is_dynamic(d.guard),
            "guard_imp": expr_is_impure(d.guard),
            "iters": iters,
            "names": names,
            "kind": ("task" if isinstance(d.target, Ref)
                     else "mem" if isinstance(d.target, Mem) else "none"),
        }
        if info["kind"] == "task":
            params = []
            for p in d.target.params:
                if isinstance(p, E.Range):
                    params.append(("range", (cc.compile(p.lo, names),
                                             cc.compile(p.hi, names),
                                             cc.compile(p.step, names, 1))))
                else:
                    params.append(("scalar", cc.compile(p, names)))
            info["params"] = params
            info["peer"] = d.target.task
            info["peer_flow"] = d.target.flow
        elif info["kind"] == "mem":
            info["coll"] = d.target.collection
            info["idx"] = [cc.compile(x, names) for x in d.target.idx]
        return info

    # ------------------------------------------------- space enumeration
    def instances(self, budget: List[int]) -> List[tuple]:
        """Enumerate the execution space (list of range-param tuples).
        `budget` is a single-element mutable countdown shared across
        classes; exhausting it raises SpaceTooLarge."""
        out: List[tuple] = []
        nb = self.nb_locals
        vals = [0] * nb

        def rec(i: int):
            if i == nb:
                budget[0] -= 1
                if budget[0] < 0:
                    raise SpaceTooLarge(self.name)
                out.append(tuple(vals[s] for s in self.range_slots))
                return
            kind, fns = self._local_fns[i]
            if kind == "derived":
                vals[i] = fns(vals)
                rec(i + 1)
            elif kind == "range":
                lo, hi, st = fns[0](vals), fns[1](vals), fns[2](vals)
                for v in _steps(lo, hi, st):
                    vals[i] = v
                    rec(i + 1)
                vals[i] = 0
            else:  # compr: dedupe repeated values at this level
                lo, hi, st = fns[0](vals), fns[1](vals), fns[2](vals)
                seen = {}
                for it in _steps(lo, hi, st):
                    vals[i] = it
                    seen.setdefault(fns[3](vals), None)
                for v in seen:
                    vals[i] = v
                    rec(i + 1)
                vals[i] = 0

        rec(0)
        return out

    def space_intervals(self) -> Dict[int, Tuple[int, int]]:
        """Per-slot interval bounds of the execution space (affine
        reasoning; slots whose bounds leave the affine fragment are
        omitted)."""
        ivals: Dict[int, Tuple[int, int]] = {}
        gd = self.fg.gdict
        for i, (nm, kind, payload) in enumerate(self.locals):
            if kind == "derived":
                iv = interval_of(payload, ivals, self.names, gd)
            elif kind == "range":
                lo = interval_of(payload.lo, ivals, self.names, gd)
                hi = interval_of(payload.hi, ivals, self.names, gd)
                iv = (lo[0], hi[1]) if lo and hi else None
            else:
                iv = interval_of(payload.value, ivals, self.names, gd)
            if iv is not None:
                ivals[i] = iv
        return ivals

    # ------------------------------------------------------ domain check
    def fill_locals(self, params: tuple) -> list:
        l = [0] * self.nb_locals
        for i, s in enumerate(self.range_slots):
            l[s] = params[i]
        for i, (kind, fns) in enumerate(self._local_fns):
            if kind == "derived":
                l[i] = fns(l)
        return l

    def _decide_domain_cache(self):
        """Mirror the native pool-const fast path: when every range
        bound reads nothing but globals/consts (and a comprehension
        value nothing but its own slot), membership is per-axis
        constant ranges / value sets."""
        _Name, _PyEscape = _jdf_nodes()

        def const_expr(e, allowed_slot=None):
            if e is None or isinstance(e, int):
                return True
            for x in expr_nodes(e):
                if isinstance(x, (E.Call, _PyEscape)):
                    return False
                if isinstance(x, (E.L, _Name)):
                    nm = x.name
                    if nm in self.names and self.names[nm] != allowed_slot:
                        return False
                    if nm not in self.names and nm not in self.fg.gdict:
                        return False
            return True

        axes = []
        zeros = [0] * self.nb_locals
        for s in self.range_slots:
            nm, kind, payload = self.locals[s]
            _, fns = self._local_fns[s]
            if not (const_expr(payload.lo) and const_expr(payload.hi)
                    and const_expr(payload.step)):
                self._domain_cache = False
                return
            if kind == "compr":
                if not const_expr(payload.value, allowed_slot=s):
                    self._domain_cache = False
                    return
                lo, hi = fns[0](zeros), fns[1](zeros)
                st = fns[2](zeros) or 1
                n = (hi - lo) // st + 1 if st > 0 else (lo - hi) // (-st) + 1
                if n > 65536:
                    self._domain_cache = False
                    return
                vals = set()
                for it in _steps(lo, hi, st):
                    zeros[s] = it
                    vals.add(fns[3](zeros))
                zeros[s] = 0
                axes.append(("set", vals))
            else:
                st = fns[2](zeros) or 1
                axes.append(("range", (fns[0](zeros), fns[1](zeros), st)))
        self._domain_cache = axes

    def in_domain(self, params) -> bool:
        """task_params_in_domain mirror."""
        if len(params) != len(self.range_slots):
            return False
        if self._domain_cache is None:
            self._decide_domain_cache()
        if self._domain_cache:
            for (kind, ax), v in zip(self._domain_cache, params):
                if kind == "set":
                    if v not in ax:
                        return False
                elif not _in_range(v, *ax):
                    return False
            return True
        # dynamic bounds: evaluate in declaration order with the
        # candidate params bound
        l = self.fill_locals(tuple(params))
        for i, s in enumerate(self.range_slots):
            nm, kind, payload = self.locals[s]
            _, fns = self._local_fns[s]
            lo, hi = fns[0](l), fns[1](l)
            st = fns[2](l) or 1
            if kind == "compr":
                found = False
                for it in _steps(lo, hi, st):
                    l[s] = it
                    if fns[3](l) == params[i]:
                        found = True
                        break
                l[s] = params[i]  # restore for later range bounds
                if not found:
                    return False
                continue
            if not _in_range(params[i], lo, hi, st):
                return False
        return True

    # --------------------------------------------------- input selection
    def producer_in_domain(self, fi: int, di: int, l: list) -> bool:
        """dep_producer_in_domain mirror (range params -> True, the
        caller expands and checks per instance)."""
        info = self._dep_info[(fi, di)]
        peer = self.fg.by_name.get(info["peer"])
        if peer is None:
            return False
        vals = []
        for kind, fn in info["params"]:
            if kind == "range":
                return True
            vals.append(fn(l))
        return peer.in_domain(tuple(vals))

    def select_input_dep(self, fi: int, l: list,
                         conservative: bool = False) -> Optional[int]:
        """select_input_dep mirror: dep index into flows[fi].deps or
        None."""
        fl = self.flows[fi]
        for di, d in enumerate(fl.deps):
            if d.direction != 0:
                continue
            info = self._dep_info[(fi, di)]
            if conservative and info["guard_dyn"]:
                if info["kind"] != "task":
                    continue  # dynamic memory source: cannot deliver
                if not self.producer_in_domain(fi, di, l):
                    continue
                return di
            if not info["guard"](l):
                continue
            if info["kind"] == "task" \
                    and not self.producer_in_domain(fi, di, l):
                continue
            return di
        return None

    def _iters_walk(self, info: dict, l: list, fn: Callable[[list], None]):
        """walk_dep_iters mirror: bind scratch slots nb_locals+k."""
        iters = info["iters"]
        if not iters:
            fn(l)
            return
        ext = l + [0] * len(iters)

        def rec(k: int):
            if k == len(iters):
                fn(ext)
                return
            lo, hi, st = (iters[k][0](ext), iters[k][1](ext),
                          iters[k][2](ext) or 1)
            for v in _steps(lo, hi, st):
                ext[self.nb_locals + k] = v
                rec(k + 1)

        rec(0)

    def count_ctl_inputs(self, fi: int, l: list) -> int:
        """count_task_inputs mirror for one CTL flow."""
        fl = self.flows[fi]
        count = 0
        for di, d in enumerate(fl.deps):
            if d.direction != 0:
                continue
            info = self._dep_info[(fi, di)]
            if info["kind"] != "task":
                continue
            peer = self.fg.by_name.get(info["peer"])
            if peer is None:
                continue

            def per_combo(lx):
                nonlocal count
                if not info["guard"](lx):
                    return
                for vals in self._expand_params(info, lx):
                    if peer.in_domain(vals):
                        count += 1

            self._iters_walk(info, l, per_combo)
        return count

    def _expand_params(self, info: dict, l: list):
        """Expand a dep's params (odometer over Range params) ->
        concrete target tuples."""
        params = info["params"]
        vals = [0] * len(params)
        ranges = []
        for i, (kind, fn) in enumerate(params):
            if kind == "scalar":
                vals[i] = fn(l)
            else:
                ranges.append(i)
        if not ranges:
            yield tuple(vals)
            return

        def rec(j: int):
            if j == len(ranges):
                yield tuple(vals)
                return
            i = ranges[j]
            fns = params[i][1]
            for v in _steps(fns[0](l), fns[1](l), fns[2](l) or 1):
                vals[i] = v
                yield from rec(j + 1)

        yield from rec(0)

    def out_emissions(self, fi: int, di: int, l: list):
        """release_deps emission mirror for one OUT dep of one instance:
        yields ("task", vals, certain) / ("oob", vals, certain) /
        ("mem", (coll, idx), certain).  `certain` is False when the
        guard is dynamic (evaluated for real only at completion time)."""
        d = self.flows[fi].deps[di]
        info = self._dep_info[(fi, di)]
        out: List[tuple] = []

        def per_combo(lx):
            if info["guard_imp"]:
                # impure guard: its analysis-time value is not binding
                # (evaluated for real only at completion time) — every
                # combination is a maybe-edge
                certain = False
            else:
                # pure (possibly table-driven) guard: the value is
                # frozen for the pool's life, so evaluation is exact
                if not info["guard"](lx):
                    return
                certain = True
            if info["kind"] == "task":
                peer = self.fg.by_name.get(info["peer"])
                for vals in self._expand_params(info, lx):
                    if peer is not None and peer.in_domain(vals):
                        out.append(("task", vals, certain))
                    else:
                        out.append(("oob", vals, certain))
            elif info["kind"] == "mem":
                idx = tuple(fn(lx) for fn in info["idx"])
                out.append(("mem", (info["coll"], idx), certain))

        self._iters_walk(info, l, per_combo)
        return out

    def dep(self, fi: int, di: int):
        return self.flows[fi].deps[di]

    def dep_loc(self, fi: int, di: int) -> Optional[str]:
        d = self.flows[fi].deps[di]
        return getattr(d, "srcloc", None) \
            or getattr(self.flows[fi], "srcloc", None) \
            or getattr(self.tc, "srcloc", None)

    def is_ctl(self, fi: int) -> bool:
        return self.flows[fi].access == N.FLOW_CTL

    def peer_flow_index(self, fi: int, di: int):
        """Resolve the peer flow index of a task dep (taskclass.compile
        rule: explicit flow name, else position-matched)."""
        info = self._dep_info[(fi, di)]
        peer = self.fg.by_name.get(info["peer"])
        if peer is None:
            return None
        if info["peer_flow"] is not None:
            for i, f in enumerate(peer.flows):
                if f.name == info["peer_flow"]:
                    return i
            return None
        if peer.flows:
            # positional fallback mirrors TaskClass.compile
            return min(len(peer.flows) - 1, fi)
        return None


# -------------------------------------------------------------- flow graph
class FlowGraph:
    """Symbolic flow graph of one (uncommitted or committed) Taskpool."""

    def __init__(self, tp):
        self.tp = tp
        self.globals_map = dict(tp.globals_map)
        self.gdict = {nm: int(N.lib.ptc_tp_global(tp._ptr, idx))
                      for nm, idx in tp.globals_map.items()}
        self.scope = getattr(tp, "jdf_scope", None)
        self.cc = ExprCompiler(self.gdict, self.scope)
        ctx = tp.ctx
        self.arena_sizes = dict(getattr(ctx, "arena_sizes", {}))
        self.datatype_bytes = dict(getattr(ctx, "datatype_bytes", {}))
        self.collections = dict(getattr(ctx, "collections", {}))
        # name -> the Python collection object (rank_of + geometry);
        # native-only (linear) collections register a shim with the same
        # duck type, so rank mapping and tile-byte sizing stay uniform
        self.collection_objs = dict(getattr(ctx, "collection_objs", {}))
        self.classes: List[ClassModel] = [ClassModel(self, tc)
                                          for tc in tp.classes]
        self.by_name = {cm.name: cm for cm in self.classes}

    def concretize(self, max_instances: int = 200_000) -> "ConcreteGraph":
        return ConcreteGraph(self, max_instances)


class ConcreteGraph:
    """Exact instance-level dataflow: expected input counts (the native
    counting rule) vs actual deliveries (the native release walk)."""

    def __init__(self, fg: FlowGraph, max_instances: int):
        self.fg = fg
        self.bounded = False
        self.notes: List[str] = []
        self.instances: Dict[int, List[tuple]] = {}
        budget = [max_instances]
        for cm in fg.classes:
            try:
                self.instances[cm.id] = cm.instances(budget)
            except SpaceTooLarge:
                self.bounded = True
                self.notes.append(
                    f"execution space past {max_instances} instances at "
                    f"class {cm.name}; concrete rules skipped")
                self.instances = {}
                break
        # node = (class_id, params)
        self.expected: Dict[tuple, int] = {}     # (node, fi) -> count
        self.selected: Dict[tuple, int] = {}     # (node, fi) -> dep idx
        self.ncert: Dict[tuple, int] = {}        # (node, fi) -> deliveries
        self.nmaybe: Dict[tuple, int] = {}
        self.src_sample: Dict[tuple, List] = {}  # (node, fi) -> [(src,
        #                                          (cid, fi, di), certain)]
        self.succ: Dict[tuple, List] = {}        # node -> [(node, certain)]
        self.mem_writes: Dict[tuple, List] = {}  # (coll, idx) -> [(node,
        #                                          (cid, fi, di), certain)]
        self.emit_stats: Dict[tuple, List[int]] = {}  # (cid, fi, di) ->
        #                                          [attempts, landed, oob]
        self.nb_edges = 0
        if not self.bounded:
            self._build()

    def _build(self):
        fg = self.fg
        for cm in fg.classes:
            for params in self.instances[cm.id]:
                node = (cm.id, params)
                l = cm.fill_locals(params)
                # consumer side: expected deliveries per flow
                for fi in range(len(cm.flows)):
                    if cm.is_ctl(fi):
                        n = cm.count_ctl_inputs(fi, l)
                        if n:
                            self.expected[(node, fi)] = n
                    else:
                        di = cm.select_input_dep(fi, l, conservative=True)
                        if di is not None:
                            self.selected[(node, fi)] = di
                            info = cm._dep_info[(fi, di)]
                            if info["kind"] == "task":
                                self.expected[(node, fi)] = 1
                # producer side: the release walk
                for fi, fl in enumerate(cm.flows):
                    for di, d in enumerate(fl.deps):
                        if d.direction != 1:
                            continue
                        info = cm._dep_info[(fi, di)]
                        stats = self.emit_stats.setdefault(
                            (cm.id, fi, di), [0, 0, 0])
                        if info["kind"] == "none":
                            continue
                        for kind, payload, certain in \
                                cm.out_emissions(fi, di, l):
                            stats[0] += 1
                            if kind == "mem":
                                self.mem_writes.setdefault(
                                    payload, []).append(
                                        (node, (cm.id, fi, di), certain))
                                stats[1] += 1
                                continue
                            if kind == "oob":
                                stats[2] += 1
                                continue
                            stats[1] += 1
                            peer = fg.by_name[info["peer"]]
                            pfi = cm.peer_flow_index(fi, di)
                            if pfi is None:
                                continue
                            dst = (peer.id, payload)
                            key = (dst, pfi)
                            if certain:
                                self.ncert[key] = \
                                    self.ncert.get(key, 0) + 1
                            else:
                                self.nmaybe[key] = \
                                    self.nmaybe.get(key, 0) + 1
                            s = self.src_sample.setdefault(key, [])
                            if len(s) < 8:
                                s.append((node, (cm.id, fi, di), certain))
                            self.succ.setdefault(node, []).append(
                                (dst, certain))
                            self.nb_edges += 1

    # ------------------------------------------------------------- helpers
    def node_name(self, node) -> str:
        cm = self.fg.classes[node[0]]
        return f"{cm.name}({', '.join(str(v) for v in node[1])})"

    def nb_instances(self) -> int:
        return sum(len(v) for v in self.instances.values())


def collection_tile_bytes(coll) -> Optional[int]:
    """Per-datum payload bytes of a collection, from its declared
    geometry (the full mb x nb allocation the device stages and the
    arena-backed wire path assumes; boundary tiles are padded to it).
    None when the collection exposes no recognizable geometry."""
    if coll is None:
        return None
    try:
        if hasattr(coll, "mb") and hasattr(coll, "nb") \
                and hasattr(coll, "dtype"):
            return int(coll.mb) * int(coll.nb) * \
                int(np.dtype(coll.dtype).itemsize)
        if hasattr(coll, "nb") and hasattr(coll, "dtype"):
            return int(coll.nb) * int(np.dtype(coll.dtype).itemsize)
        if hasattr(coll, "elem_size"):
            return int(coll.elem_size)
    except Exception:
        return None
    return None


class LinearCollectionShim:
    """Stand-in for natively-registered linear collections
    (Context.register_linear_collection): rank_of(k) = k % nodes and a
    fixed elem_size — enough for rank mapping + byte sizing."""

    def __init__(self, nodes: int, elem_size: int):
        self.nodes = nodes
        self.elem_size = elem_size

    def rank_of(self, k: int) -> int:
        return int(k) % max(1, self.nodes)


def extract_flowgraph(tp) -> FlowGraph:
    """Extract the symbolic flow graph of a Taskpool (committed or not).
    Works on the Python task-class tables; nothing is executed."""
    return FlowGraph(tp)


def flowgraph_to_dot(cg: ConcreteGraph, findings=None,
                     name: str = "ptg") -> str:
    """Instance-level DOT of a concretized flow graph.  `findings`
    (from analysis.verify) overlay in red: edges emitted by an
    implicated dep, and implicated instances' nodes."""
    bad_deps = set()
    bad_nodes = set()
    for f in (findings or []):
        cm = cg.fg.by_name.get(f.cls)
        if cm is None:
            continue
        if f.flow is not None and f.dep is not None:
            fi = next((i for i, fl in enumerate(cm.flows)
                       if fl.name == f.flow), None)
            if fi is not None:
                bad_deps.add((cm.id, fi, f.dep))
        for params in f.instances:
            bad_nodes.add((cm.id, tuple(params)))
    lines = [f'digraph "{name}" {{', "  rankdir=LR;",
             "  node [shape=box, fontsize=10];"]
    ids = {}
    for cid, plist in cg.instances.items():
        for params in plist:
            node = (cid, params)
            ids[node] = f"n{len(ids)}"
            style = ", color=red, penwidth=2" if node in bad_nodes else ""
            lines.append(
                f'  {ids[node]} [label="{cg.node_name(node)}"{style}];')
    for src, outs in cg.succ.items():
        for dst, certain in outs:
            if src not in ids or dst not in ids:
                continue
            attrs = []
            if not certain:
                attrs.append("style=dashed")
            lines.append(f"  {ids[src]} -> {ids[dst]}"
                         + (f" [{', '.join(attrs)}]" if attrs else "")
                         + ";")
    # red overlay: re-emit implicated dep edges in red
    for (cid, fi, di) in bad_deps:
        cm = cg.fg.classes[cid]
        for params in cg.instances.get(cid, []):
            node = (cid, params)
            l = cm.fill_locals(params)
            info = cm._dep_info[(fi, di)]
            if cm.flows[fi].deps[di].direction != 1 \
                    or info["kind"] != "task":
                continue
            pfi = cm.peer_flow_index(fi, di)
            peer = cg.fg.by_name.get(info["peer"])
            for kind, payload, certain in cm.out_emissions(fi, di, l):
                if kind != "task" or peer is None or pfi is None:
                    continue
                dst = (peer.id, payload)
                if node in ids and dst in ids:
                    lines.append(f"  {ids[node]} -> {ids[dst]} "
                                 "[color=red, penwidth=2];")
    lines.append("}")
    return "\n".join(lines)

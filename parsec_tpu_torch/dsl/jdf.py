"""PTG front-end: the JDF language, compiled to table-driven task classes.

Reference: the parsec_ptgpp compiler (parsec/interfaces/ptg/ptg-compiler:
parsec.l flex lexer, parsec.y bison grammar, jdf2c.c generator — SURVEY.md
§2.7/§3.6).  This implementation keeps the JDF *surface syntax* — globals,
parameter ranges, derived locals, `: coll(...)` affinity, guarded/ternary
dataflow deps with ranges, CTL flows, NEW/NULL, multiple BODY incarnations
— but compiles to the native expression-VM spec via the TaskClass builder
instead of generating C, and bodies are Python (CPU chore) or torch code
run on a CudaDevice (`BODY [type=CUDA]`) instead of inline C.

Port of parsec_tpu/dsl/jdf.py.  Only the device incarnation differs: its
body code runs with `torch` in scope (the reference's has `jnp`), on the
CudaDevice passed as `dev=`.  `type=CUDA` is upstream PaRSEC's spelling;
`type=TPU` names the same incarnation, so the reference's JDF sources
compile unchanged.  A batched body (`batch` unset or 1) sees each read
flow as a [lanes, *shape] stack and returns [lanes, *shape] stacks
(CudaDevice.attach); `batch=0` runs one task per launch, on 1-lane
stacks.

Supported grammar (subset, expanding):

    extern "C" %{ <python prologue> %}      # exec'd into the program scope
    %option name = value                     # taskpool options (parsec.y
                                             #   jdf_set_default_properties)
    NAME [type="int"] [hidden=on] [default=<expr>]
    Task(k, m) [ make_key_fn = fn startup_fn = fn ... ]   # class properties
    k = lo .. hi [.. step]                   # range parameter
    loc = <expr>                             # derived local
    : coll(<expr>, ...)                      # affinity
    priority = <expr>                        # optional
    RW|READ|WRITE|CTL F <- <dep>  -> <dep> ...
    BODY [type=CUDA reads=.. writes=.. batch=0|1] { <python/torch code> }
        END / BODY END

    <dep> := [(guard) | %{..%} ?] <target> [: <target>] [ [props] ]
    <target> := F Task(e, lo..hi, ...) | coll(e, ...) | NEW | NULL

Expressions: C-style with ? :, && || !, comparisons, + - * / %, and
`%{ <python expr> %}` escapes evaluated over locals, int globals, and the
program scope (prologue definitions + objects bound via builder.scope).

Dynamic-guard semantics (matches the reference): a data-input dep whose
guard contains a `%{ %}` escape cannot be pruned statically — the escape
may read state task bodies write later (the choice pattern) — so the
instance is counted as WAITING for that delivery rather than evaluated
now.  If no producer ever chooses it, retire it via
`taskpool.addto_nb_tasks(-1)` (what choice-style DAGs do); a pure
always-false escape guard on a data input with a memory fallback would
therefore wait forever — write such guards as plain expressions instead.

User-defined functions (reference: tests/dsl/ptg/user-defined-functions):
  %option nb_local_tasks_fn = fn   — fn(taskpool) -> int overrides the
      enumerated local-task count used for termination detection.
  startup_fn = fn (class property) — fn(taskpool, class_name) hook invoked
      at run() before tasks execute.
  make_key_fn / hash_struct — parsed and validated against the program
      scope, then intentionally unused: the native dependency engine keys
      on the exact parameter vector (collision-safe full-key record,
      native/core.cpp DepEntry), so user key packing has nothing to fix.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.taskclass import In, Mem, Out, Ref, TaskClass
from ..core.taskpool import Taskpool

# ------------------------------------------------------------------ lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<escape>%\{.*?%\})
  | (?P<num>\d+)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<str>"[^"]*")
  | (?P<arrow_in><-)
  | (?P<arrow_out>->)
  | (?P<dotdot>\.\.)
  | (?P<op>==|!=|<=|>=|&&|\|\||[-+*/%()\[\],:?=<>!;{}])
""", re.VERBOSE | re.DOTALL)


class Tok:
    def __init__(self, kind: str, val: str, pos: int):
        self.kind = kind
        self.val = val
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.val!r}"


def _lex(src: str) -> List[Tok]:
    toks = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise SyntaxError(f"jdf: cannot tokenize at {src[i:i+40]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append(Tok(kind, m.group(), m.start()))
    toks.append(Tok("eof", "", len(src)))
    return toks


# ------------------------------------------------------------------ AST

class JdfGlobal:
    def __init__(self, name, typ="int", hidden=False, default=None):
        self.name, self.typ, self.hidden, self.default = \
            name, typ, hidden, default


class JdfDepTarget:
    def __init__(self, kind, name=None, flow=None, args=None, iters=None):
        self.kind = kind  # "task" | "mem" | "new" | "null"
        self.name = name  # task or collection name
        self.flow = flow  # flow name on the peer (task kind)
        self.args = args or []
        self.iters = iters or []  # target-level bracketed iterators


class JdfDep:
    def __init__(self, direction, guard, target, alt=None, props=None,
                 iters=None, pos=-1):
        self.direction = direction  # 0 in, 1 out
        self.guard = guard          # Expr | None
        self.target = target        # JdfDepTarget
        self.alt = alt              # else-branch target
        self.props = props or {}    # [type=.. layout=.. count=.. displ=..]
        self.iters = iters or []    # dep-level bracketed iterators
        self.pos = pos              # source offset (for verifier locs)


class JdfCompr:
    """Comprehension local: name = [ it = lo .. hi .. st ] value."""

    def __init__(self, iter_name, lo, hi, st, value):
        self.iter_name = iter_name
        self.lo, self.hi, self.st = lo, hi, st
        self.value = value


class JdfFlow:
    def __init__(self, access, name):
        self.access = access
        self.name = name
        self.deps: List[JdfDep] = []


class JdfBody:
    def __init__(self, props, code):
        self.props = props  # dict
        self.code = code


class JdfTask:
    def __init__(self, name, params, props=None, pos=-1):
        self.name = name
        self.params = params  # [str]
        self.pos = pos        # source offset (for verifier locs)
        self.props = props or {}  # class properties [make_key_fn = ...]
        self.locals: List[Tuple[str, object]] = []  # (name, Range|Expr)
        self.affinity: Optional[Tuple[str, list]] = None
        self.priority = None
        self.flows: List[JdfFlow] = []
        self.bodies: List[JdfBody] = []


class JdfProgram:
    def __init__(self):
        self.prologue = ""
        self.options: Dict[str, str] = {}  # %option lines
        self.globals: List[JdfGlobal] = []
        self.tasks: List[JdfTask] = []
        self.src = ""  # body-stripped source (token pos -> line)


# ------------------------------------------------------------------ parser

_ACCESS = {"RW": "RW", "READ": "READ", "WRITE": "WRITE", "CTL": "CTL"}

# BODY [type = ...] values naming the device incarnation: CUDA, and TPU,
# the reference's spelling of the same accelerator chore
_DEVICE_TYPES = ("CUDA", "TPU")

# %option names accepted at program level (reference: parsec.y
# jdf_set_default_properties; no_taskpool_instance et al.)
_KNOWN_OPTIONS = {"no_taskpool_instance", "nb_local_tasks_fn"}


# braces are optional: `BODY\nEND` is an empty body (reference:
# tests/dsl/ptg/complex_deps.jdf FCT1..FCT5)
_BODY_RE = re.compile(
    r"BODY(?P<props>\s*\[[^\]]*\])?\s*(?:\{(?P<code>.*?)\}\s*)?END",
    re.DOTALL)


def _extract_bodies(src: str):
    """Replace BODY [...] { python } END blocks with `BODY <idx>` markers so
    the JDF lexer never sees Python code."""
    bodies = []

    def repl(m):
        bodies.append((m.group("props") or "", m.group("code") or "pass"))
        # newline-preserving so token positions keep mapping to the
        # original source lines (findings/locations stay accurate)
        return f"BODY {len(bodies) - 1}" + "\n" * max(
            1, m.group(0).count("\n"))

    return _BODY_RE.sub(repl, src), bodies


class _Parser:
    def __init__(self, toks: List[Tok], src: str, bodies):
        self.toks = toks
        self.i = 0
        self.src = src
        self.bodies = bodies

    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val) -> Tok:
        t = self.next()
        if t.val != val:
            raise SyntaxError(f"jdf: expected {val!r}, got {t.val!r} "
                              f"near {self.src[t.pos:t.pos+40]!r}")
        return t

    def accept(self, val) -> bool:
        if self.peek().val == val:
            self.i += 1
            return True
        return False

    # ------------------------------------------------------- program level
    def parse(self) -> JdfProgram:
        prog = JdfProgram()
        while self.peek().kind != "eof":
            t = self.peek()
            if t.kind == "id" and t.val == "extern":
                self.next()
                self.expect('"C"') if self.peek().val == '"C"' else None
                esc = self.next()
                if esc.kind != "escape":
                    raise SyntaxError("jdf: expected %{ ... %} after extern")
                prog.prologue += esc.val[2:-2] + "\n"
            elif t.kind == "escape":
                self.next()
                prog.prologue += t.val[2:-2] + "\n"
            elif t.val == "%" and self.peek(1).val == "option":
                # %option name = value (value: one id/num/string token)
                self.next()
                self.next()
                name = self.next().val
                if name not in _KNOWN_OPTIONS:
                    # a typo'd option (e.g. nb_local_task_fn) silently
                    # ignored can hang a DAG relying on it — fail loudly
                    raise SyntaxError(
                        f"jdf: unknown %option {name!r}; known: "
                        f"{sorted(_KNOWN_OPTIONS)}")
                self.expect("=")
                prog.options[name] = self.next().val.strip('"')
            elif t.kind == "id" and self.peek(1).val == "[":
                prog.globals.append(self._parse_global())
            elif t.kind == "id" and self.peek(1).val == "(":
                prog.tasks.append(self._parse_task())
            elif t.kind == "id":
                # global without properties: NAME
                prog.globals.append(JdfGlobal(self.next().val))
            else:
                raise SyntaxError(f"jdf: unexpected {t.val!r}")
        return prog

    def _parse_props(self) -> Dict[str, str]:
        props: Dict[str, str] = {}
        self.expect("[")
        while not self.accept("]"):
            key = self.next().val
            self.expect("=")
            vals = []
            while self.peek().val not in ("]",) and not (
                    self.peek().kind == "id" and self.peek(1).val == "="):
                vals.append(self.next().val)
            props[key] = " ".join(vals)
        return props

    def _parse_global(self) -> JdfGlobal:
        name = self.next().val
        props = self._parse_props()
        typ = props.get("type", '"int"').strip('"')
        hidden = props.get("hidden", "off") in ("on", "ON", "true")
        default = props.get("default")
        return JdfGlobal(name, typ, hidden, default)

    # ------------------------------------------------------- task level
    def _parse_task(self) -> JdfTask:
        name_tok = self.next()
        name = name_tok.val
        self.expect("(")
        params = []
        while not self.accept(")"):
            params.append(self.next().val)
            self.accept(",")
        props = self._parse_props() if self.peek().val == "[" else {}
        task = JdfTask(name, params, props, pos=name_tok.pos)
        # locals until ':' (affinity) — every line `id = ...`
        while True:
            t = self.peek()
            if t.val == ":":
                break
            if t.kind == "id" and self.peek(1).val == "=":
                nm = self.next().val
                self.expect("=")
                if self._at_iter_bracket():
                    # comprehension local (local indices):
                    #   nm = [ it = lo .. hi [.. st] ] value
                    its = self._parse_iters()
                    if len(its) != 1:
                        raise SyntaxError(
                            "jdf: comprehension locals take exactly one "
                            "iterator")
                    it_name, lo, hi, st = its[0]
                    val = self._parse_expr()
                    task.locals.append(
                        (nm, JdfCompr(it_name, lo, hi, st, val)))
                    continue
                first = self._parse_expr()
                if self.accept(".."):
                    hi = self._parse_expr()
                    step = self._parse_expr() if self.accept("..") else 1
                    if nm == "priority":
                        raise SyntaxError("jdf: priority cannot be a range")
                    task.locals.append((nm, E.Range(first, hi, step)))
                elif nm == "priority":
                    task.priority = first
                else:
                    task.locals.append((nm, first))
            else:
                break
        if self.accept(":"):
            coll = self.next().val
            self.expect("(")
            args = []
            while not self.accept(")"):
                args.append(self._parse_expr())
                self.accept(",")
            task.affinity = (coll, args)
        # priority may also follow affinity
        while self.peek().kind == "id" and self.peek().val == "priority" \
                and self.peek(1).val == "=":
            self.next()
            self.expect("=")
            task.priority = self._parse_expr()
        # flows
        while self.peek().kind == "id" and self.peek().val in _ACCESS:
            task.flows.append(self._parse_flow())
        # reference priority clause between dataflow and BODY: `; expr`
        # (tests/dsl/ptg/startup.jdf `; prio`)
        if self.accept(";"):
            task.priority = self._parse_expr()
        # bodies
        while self.peek().kind == "id" and self.peek().val == "BODY":
            task.bodies.append(self._parse_body())
        if not task.bodies:
            raise SyntaxError(f"jdf: task {name} has no BODY")
        return task

    def _parse_flow(self) -> JdfFlow:
        access = self.next().val
        name = self.next().val
        fl = JdfFlow(_ACCESS[access], name)
        while self.peek().val in ("<-", "->"):
            direction = 0 if self.next().val == "<-" else 1
            fl.deps.append(self._parse_dep(direction))
        return fl

    def _at_iter_bracket(self) -> bool:
        """A '[' opening an iterator list: `[ id = ... ]` (dep properties
        also look like `[ id = ... ]` but only appear AFTER a target)."""
        return (self.peek().val == "[" and self.peek(1).kind == "id"
                and self.peek(2).val == "=")

    def _parse_iters(self):
        """[ i = lo .. hi [.. st] (, j = ...)* ]"""
        its = []
        self.expect("[")
        while True:
            name = self.next().val
            self.expect("=")
            lo = self._parse_expr()
            self.expect("..")
            hi = self._parse_expr()
            st = self._parse_expr() if self.accept("..") else 1
            its.append((name, lo, hi, st))
            if not self.accept(","):
                break
        self.expect("]")
        return its

    def _parse_dep(self, direction: int) -> JdfDep:
        guard = None
        alt = None
        dep_pos = self.peek().pos
        # dep-level bracketed iterators (local indices):
        #   [ i = 0 .. odd ] guard ? target : target
        iters = self._parse_iters() if self._at_iter_bracket() else []
        if self.peek().val == "(" or self.peek().kind == "escape":
            # or-level, not ternary: the dep's own `?` must stay unconsumed.
            # A %{ ... %} escape can itself be the whole guard (reference:
            # tests/dsl/ptg/choice/choice.jdf).
            guard = self._or()
            self.expect("?")
            target = self._parse_target()
            if self.accept(":"):
                alt = self._parse_target()
        else:
            # unparenthesized guards (`odd < 4 ? A t(..) : ...`,
            # tests/dsl/ptg/local-indices) are indistinguishable from a
            # target without lookahead: try guard-form, backtrack to
            # target-form (a bare flow name never survives expect('?')).
            # When BOTH forms fail, report whichever parse got further —
            # the shorter one's error points at the wrong token.
            save = self.i
            try:
                guard = self._or()
                self.expect("?")
                target = self._parse_target()
                if self.accept(":"):
                    alt = self._parse_target()
            except SyntaxError as guard_err:
                guard_pos = self.i
                self.i = save
                guard = None
                try:
                    target = self._parse_target()
                except SyntaxError:
                    if guard_pos > self.i:
                        self.i = guard_pos
                        raise guard_err from None
                    raise
        # trailing dep properties: [type = X displ_remote = e ...]
        props = self._parse_props() if self.peek().val == "[" else {}
        return JdfDep(direction, guard, target, alt, props, iters,
                      pos=dep_pos)

    def _parse_target(self) -> JdfDepTarget:
        # target-level iterators: `? [ j = 0 .. e .. 2 ] A tA(...)`
        iters = self._parse_iters() if self._at_iter_bracket() else []
        t = self.next()
        if t.kind != "id":
            raise SyntaxError(f"jdf: bad dep target {t.val!r}")
        if t.val == "NEW":
            return JdfDepTarget("new")
        if t.val == "NULL":
            return JdfDepTarget("null")
        if self.peek().val == "(":
            # collection reference: coll(args)
            self.expect("(")
            args = []
            while not self.accept(")"):
                args.append(self._parse_range_or_expr())
                self.accept(",")
            return JdfDepTarget("mem", name=t.val, args=args, iters=iters)
        # flow Task(args)
        flow = t.val
        tname = self.next().val
        self.expect("(")
        args = []
        while not self.accept(")"):
            args.append(self._parse_range_or_expr())
            self.accept(",")
        return JdfDepTarget("task", name=tname, flow=flow, args=args,
                            iters=iters)

    def _parse_body(self) -> JdfBody:
        """Bodies are pre-extracted (their code is Python, not lexable as
        JDF): the preprocessor replaced each with `BODY <idx>`."""
        self.next()  # BODY
        idx = int(self.next().val)
        props_str, code = self.bodies[idx]
        props = dict(re.findall(r'(\w+)\s*=\s*("[^"]*"|[^\s\]]+)', props_str))
        props = {k: v.strip('"') for k, v in props.items()}
        return JdfBody(props, code)

    # ------------------------------------------------------- expressions
    def _parse_range_or_expr(self):
        e = self._parse_expr()
        if self.accept(".."):
            hi = self._parse_expr()
            step = self._parse_expr() if self.accept("..") else 1
            return E.Range(e, hi, step)
        return e

    def _parse_expr(self):
        return self._ternary()

    def _ternary(self):
        c = self._or()
        if self.accept("?"):
            a = self._ternary()
            self.expect(":")
            b = self._ternary()
            return E.select(c, a, b)
        return c

    def _or(self):
        a = self._and()
        while self.peek().val == "||":
            self.next()
            a = E.BinOp(E.N.OP_OR, a, self._and())
        return a

    def _and(self):
        a = self._cmp()
        while self.peek().val == "&&":
            self.next()
            a = E.BinOp(E.N.OP_AND, a, self._cmp())
        return a

    _CMPOPS = {"==": E.N.OP_EQ, "!=": E.N.OP_NE, "<": E.N.OP_LT,
               "<=": E.N.OP_LE, ">": E.N.OP_GT, ">=": E.N.OP_GE}

    def _cmp(self):
        a = self._add()
        while self.peek().val in self._CMPOPS:
            op = self.next().val
            a = E.BinOp(self._CMPOPS[op], a, self._add())
        return a

    def _add(self):
        a = self._mul()
        while self.peek().val in ("+", "-"):
            op = self.next().val
            b = self._mul()
            a = E.BinOp(E.N.OP_ADD if op == "+" else E.N.OP_SUB, a, b)
        return a

    def _mul(self):
        a = self._unary()
        while self.peek().val in ("*", "/", "%"):
            op = self.next().val
            b = self._unary()
            a = E.BinOp({"*": E.N.OP_MUL, "/": E.N.OP_DIV,
                         "%": E.N.OP_MOD}[op], a, b)
        return a

    def _unary(self):
        if self.accept("-"):
            return E.UnOp(E.N.OP_NEG, self._unary())
        if self.accept("!"):
            return E.UnOp(E.N.OP_NOT, self._unary())
        return self._primary()

    def _primary(self):
        t = self.next()
        if t.kind == "num":
            return E.Const(int(t.val))
        if t.kind == "escape":
            code = t.val[2:-2].strip()
            if code.startswith("return"):
                code = code[len("return"):].strip().rstrip(";")
            return _PyEscape(code)
        if t.kind == "id":
            return _Name(t.val)
        if t.val == "(":
            e = self._parse_expr()
            self.expect(")")
            return e
        raise SyntaxError(f"jdf: bad expression token {t.val!r}")


class _Name(E.Expr):
    """Deferred local-or-global reference, resolved at build time."""

    def __init__(self, name):
        self.name = name

    def _emit(self, out, ctx):
        if self.name in ctx.locals:
            out += [E.N.OP_LOCAL, ctx.locals[self.name]]
        elif self.name in ctx.globals:
            out += [E.N.OP_GLOBAL, ctx.globals[self.name]]
        else:
            raise KeyError(f"jdf: unknown symbol {self.name!r}")


class _PyEscape(E.Expr):
    """%{ python expr %}: evaluated via a registered callback; the
    expression sees task locals by name, int globals by name, and the
    program scope (prologue definitions + objects the caller bound via
    builder.scope — reference: JDF inline C sees taskpool globals of any
    type, e.g. the `decision` array of tests/dsl/ptg/choice)."""

    def __init__(self, code):
        self.code = code
        self._names: List[str] = []

    def _emit(self, out, ctx):
        # one slot may carry several names (a comprehension parameter and
        # its iterator alias both bind to the parameter's slot)
        names: Dict[int, List[str]] = {}
        for name, idx in ctx.locals.items():
            names.setdefault(idx, []).append(name)
        code = compile(self.code, "<jdf-escape>", "eval")
        scope = ctx.scope  # live dict: later caller bindings stay visible

        def fn(locs, globs):
            # live scope as eval-globals: no per-call copy of the program
            # scope (it can be large), and later caller bindings stay
            # visible; int globals and task locals shadow it via env
            env = dict(globs)
            for i, v in enumerate(locs):
                for n in names.get(i, ()):
                    env[n] = v
            return int(eval(code, scope if scope is not None else {}, env))

        cb_id = ctx.register_call(fn)
        out += [E.N.OP_CALL, cb_id]


# ------------------------------------------------------------------ build

def parse_jdf(src: str) -> JdfProgram:
    stripped, bodies = _extract_bodies(src)
    prog = _Parser(_lex(stripped), stripped, bodies).parse()
    prog.src = stripped
    return prog


def _target_to_builder(t: JdfDepTarget, flow_name: str):
    if t.kind == "new":
        return None  # pure allocation (arena on the flow)
    if t.kind == "null":
        return None
    if t.kind == "mem":
        return Mem(t.name, *t.args)
    return Ref(t.name, *t.args, flow=t.flow)


class JdfTaskpoolBuilder:
    """Instantiate a parsed JDF program as a ready-to-run Taskpool."""

    def __init__(self, prog: JdfProgram, ctx, globals: Dict[str, int],
                 dtype=np.uint8, shapes: Optional[Dict] = None,
                 arenas: Optional[Dict[str, str]] = None, dev=None,
                 late_bound: Optional[List[str]] = None,
                 filename: Optional[str] = None):
        self.prog = prog
        self.filename = filename or "<jdf>"
        self.ctx = ctx
        self.late_bound = set(late_bound or [])
        self.dtype = np.dtype(dtype)
        self.shapes = shapes or {}
        self.arenas = arenas or {}
        self.dev = dev
        # program scope: prologue definitions + globals
        self.scope: Dict[str, object] = {"np": np}
        if prog.prologue:
            exec(prog.prologue, self.scope)
        gvals: Dict[str, int] = {}
        for g in prog.globals:
            if g.typ.rstrip().endswith("*"):
                # pointer-typed global (reference: collections / user arrays
                # like `decision [type = "int *"]`, tests/dsl/ptg/choice):
                # lives in the program scope, not the int-global table.
                # Must be satisfiable: a registered collection, a caller
                # value, a prologue definition, or a late builder.scope
                # binding (promised via late_bound=[names]).
                if g.name in globals:
                    self.scope[g.name] = globals[g.name]
                elif g.name not in ctx.collections and \
                        g.name not in self.scope and \
                        g.name not in self.late_bound:
                    raise ValueError(
                        f"jdf: pointer global {g.name!r} has no value: "
                        "register a collection under that name, pass it in "
                        "globals=, define it in the prologue, or list it "
                        "in late_bound= and set builder.scope[name]")
                continue
            if g.name in globals:
                gvals[g.name] = int(globals[g.name])
            elif g.default is not None:
                gvals[g.name] = int(eval(str(g.default).strip("()"),
                                         dict(self.scope), dict(gvals)))
            else:
                raise ValueError(f"jdf: global {g.name} has no value")
        self.gvals = gvals
        self.tp = Taskpool(ctx, globals=gvals)
        # escapes compiled at commit() read this live dict (CompileCtx.scope)
        self.tp.jdf_scope = self.scope
        self._startup_hooks: List[Tuple[str, str]] = []  # (class, fn name)
        for jt in prog.tasks:
            self._build_task(jt)

    # nb_local_tasks_fn is deliberately NOT here: it is a %option (pool
    # scope), and accepting it per class would validate-then-ignore it
    _CLASS_PROPS = ("make_key_fn", "startup_fn", "hash_struct",
                    "high_priority")

    def _loc(self, pos: int) -> Optional[str]:
        """file:line of a source offset (body-stripped source is
        newline-preserving, so lines match the original)."""
        if pos < 0:
            return None
        return f"{self.filename}:{self.prog.src[:pos].count(chr(10)) + 1}"

    def _build_task(self, jt: JdfTask):
        tc = self.tp.task_class(jt.name)
        tc.srcloc = self._loc(jt.pos) or tc.srcloc
        tc.jdf_props = dict(jt.props)
        for k in jt.props:
            if k not in self._CLASS_PROPS:
                raise ValueError(f"jdf: {jt.name}: unknown class property "
                                 f"{k!r}")
        if "startup_fn" in jt.props:
            self._startup_hooks.append((jt.name, jt.props["startup_fn"]))
        for (nm, payload) in jt.locals:
            if isinstance(payload, JdfCompr):
                tc.param_compr(nm, payload.lo, payload.hi, payload.value,
                               payload.st, iter_name=payload.iter_name)
            elif isinstance(payload, E.Range):
                tc.locals.append((nm, True, payload))
            else:
                tc.locals.append((nm, False, payload))
        if jt.affinity:
            tc.affinity(jt.affinity[0], *jt.affinity[1])
        if jt.priority is not None:
            tc.priority(jt.priority)
        for fl in jt.flows:
            deps = []
            for d in fl.deps:
                mk = In if d.direction == 0 else Out
                # ptgpp compiler checks (reference messages verbatim:
                # tests/dsl/ptg/ptgpp/output_{NEW,NULL}*.jdf expect them)
                if d.direction == 1:
                    tkinds = [d.target.kind] + (
                        [d.alt.kind] if d.alt is not None else [])
                    if "new" in tkinds:
                        raise ValueError(
                            f"jdf: {jt.name}.{fl.name}: Automatic data "
                            "allocation with NEW only supported in IN "
                            "dependencies.")
                    if "null" in tkinds:
                        raise ValueError(
                            f"jdf: {jt.name}.{fl.name}: NULL data only "
                            "supported in IN dependencies.")
                # reference dep-type semantics (parsec_reshape.c,
                # tests/collections/reshape/): [type = X] reshapes
                # locally through a datacopy future AND types the wire;
                # [type_remote = X] types the wire only; [type_data = X]
                # types the collection read / selective write-back.
                t_full = d.props.get("type")
                t_rem = d.props.get("type_remote")
                t_data = d.props.get("type_data")
                dt = t_rem if t_rem is not None else t_full
                lt = t_full if t_full is not None else t_data
                for nm_, role in ((t_full, "type"),
                                  (t_rem, "type_remote"),
                                  (t_data, "type_data")):
                    if nm_ is not None and nm_ not in self.ctx.datatypes:
                        raise ValueError(
                            f"jdf: {jt.name}.{fl.name}: dep [{role} = "
                            f"{nm_}] names no registered datatype "
                            "(Context.register_datatype*)")
                tgt = _target_to_builder(d.target, fl.name)
                its = d.iters + d.target.iters  # dep-level outer
                loc = self._loc(d.pos)
                if d.alt is not None:
                    alt = _target_to_builder(d.alt, fl.name)
                    built = [mk(tgt, guard=d.guard, dtype=dt, iters=its,
                                ltype=lt),
                             mk(alt, guard=E.UnOp(E.N.OP_NOT, d.guard),
                                dtype=dt, iters=d.iters + d.alt.iters,
                                ltype=lt)]
                else:
                    built = [mk(tgt, guard=d.guard, dtype=dt, iters=its,
                                ltype=lt)]
                for b in built:
                    b.srcloc = loc or b.srcloc
                deps += built
            tc.flow(fl.name, fl.access, *deps,
                    arena=self.arenas.get(fl.name))
        self._attach_bodies(jt, tc)

    def _attach_bodies(self, jt: JdfTask, tc: TaskClass):
        param_names = [nm for (nm, is_r, _) in tc.locals]
        data_flows = [f.name for f in jt.flows if f.access != "CTL"]
        for body in jt.bodies:
            btype = body.props.get("type", "CPU").upper()
            if btype in _DEVICE_TYPES and self.dev is not None:
                reads = [s.strip() for s in
                         body.props.get("reads", ",".join(data_flows))
                         .split(",") if s.strip()]
                writes = [s.strip() for s in
                          body.props.get("writes", "").split(",")
                          if s.strip()]
                if not writes:
                    writes = [f.name for f in jt.flows
                              if f.access in ("RW", "WRITE")]
                code = compile(body.code, f"<jdf-{jt.name}-cuda>", "exec")

                def kernel(*arrs, _code=code, _reads=tuple(reads),
                           _writes=tuple(writes), _scope=self.scope):
                    env = dict(_scope)
                    env["torch"] = torch
                    env.update(dict(zip(_reads, arrs)))
                    exec(_code, env)
                    outs = tuple(env[w] for w in _writes)
                    return outs if len(outs) > 1 else outs[0]

                # the device's launch counts name the chore by its class
                kernel.__name__ = f"{jt.name}_cuda"

                self.dev.attach(tc, self.tp, kernel=kernel, reads=reads,
                                writes=writes, shapes=self.shapes,
                                dtype=self.dtype,
                                batch=body.props.get("batch", "1") != "0")
            elif btype in _DEVICE_TYPES:
                continue  # no device available: skip this incarnation
            else:
                code = compile(body.code, f"<jdf-{jt.name}>", "exec")

                def pybody(view, _code=code, _params=tuple(param_names),
                           _flows=tuple(data_flows), _scope=self.scope):
                    env = dict(_scope)
                    env["this"] = view
                    env["taskpool"] = self.tp  # bodies may addto_nb_tasks
                    env.update({p: view.local(p) for p in _params})
                    env.update(self.gvals)
                    for f in _flows:
                        try:
                            env[f] = view.data(f, self.dtype,
                                               self.shapes.get(f))
                        except RuntimeError:
                            env[f] = None
                    exec(_code, env)

                tc.body(pybody)

    def _scope_fn(self, name: str, what: str):
        fn = self.scope.get(name)
        if not callable(fn):
            raise ValueError(f"jdf: {what} = {name!r} is not a callable in "
                             "the program scope")
        return fn

    def run(self):
        # class startup hooks (reference: startup_fn property,
        # tests/dsl/ptg/user-defined-functions/udf.jdf — there it replaces
        # the generated startup enumerator; here enumeration is interpreted
        # natively, so the hook runs for its side effects before tasks do)
        for name in self.late_bound:
            if name not in self.scope:
                raise ValueError(
                    f"jdf: late_bound global {name!r} was never bound: set "
                    "builder.scope[name] before run() (an unbound name "
                    "would make every escape referencing it evaluate to 0)")
        for cls_name, fn_name in self._startup_hooks:
            self._scope_fn(fn_name, "startup_fn")(self.tp, cls_name)
        # make_key_fn / hash_struct: validated, then intentionally unused —
        # the native engine keys on the exact parameter vector (see module
        # docstring)
        for jt in self.prog.tasks:
            if "make_key_fn" in jt.props:
                self._scope_fn(jt.props["make_key_fn"], "make_key_fn")
            if "hash_struct" in jt.props and \
                    jt.props["hash_struct"] not in self.scope:
                raise ValueError(f"jdf: hash_struct = "
                                 f"{jt.props['hash_struct']!r} not in scope")
        nbfn_name = self.prog.options.get("nb_local_tasks_fn")
        if nbfn_name is not None:
            # %option nb_local_tasks_fn: the user count overrides the
            # enumerated one for termination detection.  Hold the pool open
            # so it cannot complete before the adjustment is applied.
            nbfn = self._scope_fn(nbfn_name, "nb_local_tasks_fn")
            self.tp.set_open(True)
            try:
                self.tp.run()
                delta = int(nbfn(self.tp)) - self.tp.nb_total_tasks
                if delta:
                    self.tp.addto_nb_tasks(delta)
            finally:
                # a raising count fn must not leave the pool open forever
                self.tp.set_open(False)
        else:
            self.tp.run()
        return self.tp


def compile_jdf(src: str, ctx, globals: Dict[str, int], **kw):
    """Parse + instantiate: returns a JdfTaskpoolBuilder (call .run())."""
    return JdfTaskpoolBuilder(parse_jdf(src), ctx, globals, **kw)

"""Task-class builder: the Python-facing PTG authoring API.

A TaskClass declares parameter ranges, derived locals, placement affinity,
dataflow (flows with guarded In/Out deps), priority, and a list of chores
(bodies per device type).  `Taskpool.commit()` compiles each class to the
native spec blob (see native/parsec_core.h spec layout).

This is the hand-written equivalent of what the reference's parsec_ptgpp
compiler emits from a .jdf file (parsec/interfaces/ptg/ptg-compiler/jdf2c.c).

Port of parsec_tpu/core/taskclass.py: the accelerator chore is "cuda",
and host coherence pulls through device/cuda.py.
"""
from __future__ import annotations

import ctypes as C
import os
import sys
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from .. import _native as N
from .expr import Compr, CompileCtx, ExprLike, Range, compile_expr

# directories whose frames are builder plumbing, not authorship: the
# source location of a dep/class is the first frame OUTSIDE these (the
# algos/ops/dsl module or user code that called In()/Out()/task_class();
# the JDF front end stamps its own file:line locations)
_PLUMBING_DIRS = (os.path.dirname(os.path.abspath(__file__)),
                  os.path.join(os.path.dirname(os.path.dirname(
                      os.path.abspath(__file__))), "dsl"))


def _srcloc() -> Optional[str]:
    """file:line of the nearest non-plumbing caller frame (for reporting
    findings at their declaration site)."""
    try:
        f = sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename
            if not any(fn.startswith(d + os.sep) or fn == d
                       for d in _PLUMBING_DIRS):
                return f"{os.path.basename(fn)}:{f.f_lineno}"
            f = f.f_back
    except Exception:
        pass
    return None

ACCESS = {"READ": N.FLOW_READ, "WRITE": N.FLOW_WRITE, "RW": N.FLOW_RW,
          "CTL": N.FLOW_CTL, "R": N.FLOW_READ, "W": N.FLOW_WRITE}

DEVICE_TYPES = {"cpu": N.DEV_CPU, "cuda": N.DEV_CUDA,
                "recursive": N.DEV_RECURSIVE}


class Ref:
    """Reference to a peer task instance's flow: Ref("Gemm", k, m, flow="C").

    Params may be Range(...) on *output* deps (broadcast) and on *CTL input*
    deps (control gather)."""

    def __init__(self, task: str, *params: Union[ExprLike, Range],
                 flow: Optional[str] = None):
        self.task = task
        self.params = list(params)
        self.flow = flow


class Mem:
    """Reference to a datum of a collection: Mem("A", m, n)."""

    def __init__(self, collection: str, *idx: ExprLike):
        self.collection = collection
        self.idx = list(idx)


class _Dep:
    def __init__(self, direction: int, target, guard: Optional[ExprLike],
                 dtype: Optional[str] = None, iters=None,
                 ltype: Optional[str] = None):
        self.direction = direction
        self.target = target  # Ref | Mem | None
        self.guard = guard
        self.dtype = dtype  # wire datatype name (Context.register_datatype)
        # local reshape datatype (JDF `[type = ...]`/`[type_data = ...]`,
        # reference parsec_reshape.c): the dep's data is routed through a
        # new memoized datacopy holding the selected/converted elements;
        # on a Mem OUT dep it selects the write-back region
        self.ltype = ltype
        # bracketed iterators (JDF local indices): [(name, lo, hi, step)];
        # guard and target expressions may reference the names, bounds may
        # reference earlier iterators
        self.iters = list(iters or [])
        self.srcloc = _srcloc()


def In(target=None, guard: Optional[ExprLike] = None,
       dtype: Optional[str] = None, iters=None,
       ltype: Optional[str] = None) -> _Dep:
    return _Dep(0, target, guard, dtype, iters, ltype)


def Out(target=None, guard: Optional[ExprLike] = None,
        dtype: Optional[str] = None, iters=None,
        ltype: Optional[str] = None) -> _Dep:
    return _Dep(1, target, guard, dtype, iters, ltype)


class _Flow:
    def __init__(self, name: str, access: int, deps: Sequence[_Dep],
                 arena: Optional[str]):
        self.name = name
        self.access = access
        self.deps = list(deps)
        self.arena = arena
        self.srcloc = _srcloc()


class _Chore:
    def __init__(self, device_type: int, body_kind: int, body=None,
                 pure: bool = False):
        self.device_type = device_type
        self.body_kind = body_kind
        self.body = body  # callable | qid | None
        self.body_arg = 0  # resolved at commit
        # noop and device chores are table-driven by construction (the
        # device chore dispatches a cached executable from the qid
        # table); a Python callback is opaque unless the author declares
        # it pure — the wave-fusability certificate's body criterion
        # (analysis/plan.py), mirroring pt.call(pure=True)
        self.pure = pure or body_kind in (N.BODY_NOOP, N.BODY_DEVICE)


class TaskClass:
    def __init__(self, name: str):
        self.name = name
        self.locals: List[tuple] = []  # (name, is_range, payload)
        self._affinity: Optional[Mem] = None
        self._priority: Optional[ExprLike] = None
        self.flows: List[_Flow] = []
        self.chores: List[_Chore] = []
        self.id: int = -1  # assigned by Taskpool
        self.srcloc = _srcloc()

    # ---------------------------------------------------------- declaration
    def param(self, name: str, lo: ExprLike, hi: ExprLike,
              step: ExprLike = 1) -> "TaskClass":
        """Declare a range parameter (JDF `k = lo .. hi .. step`)."""
        self.locals.append((name, True, Range(lo, hi, step)))
        return self

    def param_compr(self, name: str, lo: ExprLike, hi: ExprLike,
                    value: ExprLike, step: ExprLike = 1,
                    iter_name: Optional[str] = None) -> "TaskClass":
        """Comprehension parameter (JDF local indices,
        `name = [i = lo..hi..step] value(i)`).  `value` reads the
        iterator through L(name) — the parameter's slot holds the
        iterator while the value expression runs — or through
        `iter_name` when given (JDF sources name the iterator)."""
        self.locals.append(
            (name, True, Compr(lo, hi, value, step, iter_name)))
        return self

    def local(self, name: str, value: ExprLike) -> "TaskClass":
        """Declare a derived local (JDF `loc = expr`)."""
        self.locals.append((name, False, value))
        return self

    def affinity(self, collection: str, *idx: ExprLike) -> "TaskClass":
        """Placement (JDF `: desc(m, n)`): run where this datum lives."""
        self._affinity = Mem(collection, *idx)
        return self

    def priority(self, e: ExprLike) -> "TaskClass":
        self._priority = e
        return self

    def flow(self, name: str, access: str, *deps: _Dep,
             arena: Optional[str] = None) -> "TaskClass":
        self.flows.append(_Flow(name, ACCESS[access.upper()], deps, arena))
        return self

    def body(self, fn: Callable, device: str = "cpu",
             pure: bool = False) -> "TaskClass":
        """Attach a Python body chore.  fn(TaskView) -> None | hook code.

        `pure=True` declares the body a pure function of its declared
        flows (no hidden state read or written beyond the task's own
        tiles): the wave-fusability certifier may then treat a
        homogeneous wave of this class as fusion-eligible.  The
        declaration is trusted, like pt.call(pure=True) — declare it
        only for table-driven tile chores."""
        self.chores.append(_Chore(DEVICE_TYPES[device], N.BODY_CB, fn,
                                  pure=pure))
        return self

    def body_noop(self, device: str = "cpu") -> "TaskClass":
        self.chores.append(_Chore(DEVICE_TYPES[device], N.BODY_NOOP))
        return self

    def body_device(self, qid: int, device: str = "cuda") -> "TaskClass":
        """Attach an ASYNC device chore: the task is pushed onto device
        queue `qid` and completed by the device manager thread."""
        ch = _Chore(DEVICE_TYPES[device], N.BODY_DEVICE)
        ch.body_arg = qid
        self.chores.append(ch)
        return self

    # ---------------------------------------------------------- compilation
    def flow_index(self, name: str) -> int:
        for i, f in enumerate(self.flows):
            if f.name == name:
                return i
        raise KeyError(f"{self.name}: unknown flow {name!r}")

    def local_index(self, name: str) -> int:
        for i, (n, _, _) in enumerate(self.locals):
            if n == name:
                return i
        raise KeyError(f"{self.name}: unknown local {name!r}")

    def compile(self, tp) -> List[int]:
        """Serialize to the native spec blob (version-1 layout)."""
        # ptgpp-style limit diagnostics (reference: the MAX_LOCAL_COUNT /
        # MAX_PARAM_COUNT compiler checks behind
        # tests/dsl/ptg/ptgpp/too_many_*.jdf) — a clear error here beats
        # the native decoder's generic bad-spec failure.  Dep counts per
        # flow are NOT limited in this runtime (no dependency bitmask, so
        # the reference's MAX_DEP_IN/OUT_COUNT has no analog).
        if len(self.locals) > N.MAX_LOCALS:
            raise ValueError(
                f"{self.name}: too many local variables "
                f"({len(self.locals)} > PTC_MAX_LOCALS={N.MAX_LOCALS})")
        if len(self.flows) > N.MAX_FLOWS:
            raise ValueError(
                f"{self.name}: too many flows "
                f"({len(self.flows)} > PTC_MAX_FLOWS={N.MAX_FLOWS})")
        locals_map = {n: i for i, (n, _, _) in enumerate(self.locals)}
        cctx = CompileCtx(locals_map, tp.globals_map, tp._register_call,
                          scope=getattr(tp, "jdf_scope", None))
        # v4: v3 (comprehension locals, per-dep iterators, dtype) + per-dep
        # local reshape type (ltype)
        spec: List[int] = [4, len(self.locals)]
        for (name, is_range, payload) in self.locals:
            if isinstance(payload, Compr):
                spec.append(2)
                spec += compile_expr(payload.lo, cctx)
                spec += compile_expr(payload.hi, cctx)
                spec += compile_expr(payload.step, cctx)
                # the value expr reads this local's slot as the iterator;
                # alias the declared iterator name onto the same slot
                vctx = cctx
                if payload.iter_name:
                    vmap = dict(locals_map)
                    vmap[payload.iter_name] = locals_map[name]
                    vctx = CompileCtx(vmap, tp.globals_map,
                                      tp._register_call, scope=cctx.scope)
                spec += compile_expr(payload.value, vctx)
            elif is_range:
                spec.append(1)
                spec += compile_expr(payload.lo, cctx)
                spec += compile_expr(payload.hi, cctx)
                spec += compile_expr(payload.step, cctx)
            else:
                spec.append(0)
                spec += compile_expr(payload, cctx)
        # affinity
        if self._affinity is not None:
            spec.append(tp.ctx.collections[self._affinity.collection])
            spec.append(len(self._affinity.idx))
            for e in self._affinity.idx:
                spec += compile_expr(e, cctx)
        else:
            spec += [-1, 0]
        spec += compile_expr(self._priority, cctx)
        # flows
        spec.append(len(self.flows))
        for fl in self.flows:
            arena_id = tp.ctx.arenas[fl.arena] if fl.arena else -1
            spec += [fl.access, arena_id, len(fl.deps)]
            for d in fl.deps:
                spec.append(d.direction)
                # bracketed iterators bind scratch slots nb_locals..; the
                # guard and target expressions compile against the
                # extended name map, and iterator k's own bounds see only
                # earlier iterators
                dctx = cctx
                iter_bound_ctxs = []
                if d.iters:
                    if d.direction == 0 and fl.access != N.FLOW_CTL:
                        raise ValueError(
                            f"{self.name}.{fl.name}: bracketed iterators "
                            "on a data IN dep are not supported (a data "
                            "flow has one source); CTL gathers and OUT "
                            "deps only")
                    if len(self.locals) + len(d.iters) > N.MAX_LOCALS:
                        raise ValueError(
                            f"{self.name}: locals + dep iterators exceed "
                            f"the {N.MAX_LOCALS}-slot limit")
                    emap = dict(locals_map)
                    for k, (iname, _, _, _) in enumerate(d.iters):
                        iter_bound_ctxs.append(
                            CompileCtx(dict(emap), tp.globals_map,
                                       tp._register_call, scope=cctx.scope))
                        emap[iname] = len(self.locals) + k
                    dctx = CompileCtx(emap, tp.globals_map,
                                      tp._register_call, scope=cctx.scope)
                spec += compile_expr(d.guard, dctx)
                t = d.target
                if t is None:
                    spec.append(0)  # DEP_NONE
                elif isinstance(t, Ref):
                    peer = tp.class_by_name(t.task)
                    if t.flow is not None:
                        peer_flow = peer.flow_index(t.flow)
                    elif peer.flows:
                        peer_flow = min(len(peer.flows) - 1,
                                        self.flows.index(fl))
                    else:
                        raise ValueError(
                            f"{self.name}.{fl.name}: peer class {t.task!r} "
                            f"has no flows; specify flow= explicitly")
                    spec += [1, peer.id, peer_flow, len(t.params)]
                    for p in t.params:
                        if isinstance(p, Range):
                            spec.append(1)
                            spec += compile_expr(p.lo, dctx)
                            spec += compile_expr(p.hi, dctx)
                            spec += compile_expr(p.step, dctx)
                        else:
                            spec.append(0)
                            spec += compile_expr(p, dctx)
                elif isinstance(t, Mem):
                    spec += [2, tp.ctx.collections[t.collection], len(t.idx)]
                    for e in t.idx:
                        spec += compile_expr(e, dctx)
                else:
                    raise TypeError(f"bad dep target {t!r}")
                spec.append(-1)  # per-dep arena (reserved)
                if d.dtype is not None and d.dtype not in tp.ctx.datatypes:
                    raise ValueError(
                        f"{self.name}: dep dtype {d.dtype!r} names no "
                        "registered datatype — call "
                        "Context.register_datatype first")
                spec.append(tp.ctx.datatypes[d.dtype]
                            if d.dtype is not None else -1)
                spec.append(len(d.iters))
                for k, (_, lo, hi, step) in enumerate(d.iters):
                    spec += compile_expr(lo, iter_bound_ctxs[k])
                    spec += compile_expr(hi, iter_bound_ctxs[k])
                    spec += compile_expr(step, iter_bound_ctxs[k])
                if d.ltype is not None and d.ltype not in tp.ctx.datatypes:
                    raise ValueError(
                        f"{self.name}: dep ltype {d.ltype!r} names no "
                        "registered datatype — call "
                        "Context.register_datatype* first")
                spec.append(tp.ctx.datatypes[d.ltype]
                            if d.ltype is not None else -1)
        # chores
        spec.append(len(self.chores))
        for ch in self.chores:
            if ch.body_kind == N.BODY_CB:
                ch.body_arg = tp._register_body(self, ch.body)
            spec += [ch.device_type, ch.body_kind, ch.body_arg]
        return spec


class TaskView:
    """Body-side view of a task instance: named locals + numpy views of
    flow data."""

    __slots__ = ("_ptr", "_tc", "_tp")

    def __init__(self, ptr, tc: TaskClass, tp):
        self._ptr = ptr
        self._tc = tc
        self._tp = tp

    def local(self, name: str) -> int:
        return N.lib.ptc_task_local(self._ptr, self._tc.local_index(name))

    def __getitem__(self, name: str) -> int:
        return self.local(name)

    def global_(self, name: str) -> int:
        return N.lib.ptc_tp_global(self._tp._ptr, self._tp.globals_map[name])

    @property
    def priority(self) -> int:
        return N.lib.ptc_task_priority(self._ptr)

    def data_ptr(self, flow: str) -> int:
        return N.lib.ptc_task_data_ptr(self._ptr, self._tc.flow_index(flow))

    def data(self, flow: str, dtype=np.uint8, shape=None,
             sync: bool = True) -> np.ndarray:
        """Numpy view over the flow's buffer (host copies).

        sync=True (the default) pulls a newer device-resident copy back to
        host first, so CPU chores never read stale memory after a CUDA
        producer.  The device module passes sync=False for its own reads —
        its cache mirror IS the fresh copy."""
        fi = self._tc.flow_index(flow)
        ptr = N.lib.ptc_task_data_ptr(self._ptr, fi)
        if not ptr:
            raise RuntimeError(
                f"{self._tc.name}: flow {flow!r} has no data attached")
        cptr = N.lib.ptc_task_copy(self._ptr, fi)
        if sync:
            from ..device.cuda import maybe_sync_copy
            maybe_sync_copy(cptr)
        size = N.lib.ptc_copy_size(cptr)
        dt = np.dtype(dtype)
        count = size // dt.itemsize
        buf = (C.c_char * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dt, count=count)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr

    def copy_handle(self, flow: str) -> int:
        return N.lib.ptc_copy_handle(
            N.lib.ptc_task_copy(self._ptr, self._tc.flow_index(flow)))

    def set_copy_handle(self, flow: str, handle: int):
        N.lib.ptc_copy_set_handle(
            N.lib.ptc_task_copy(self._ptr, self._tc.flow_index(flow)), handle)

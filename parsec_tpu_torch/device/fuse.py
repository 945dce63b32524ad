"""Wave and chain fusion on the card: a certified wave dispatches as one
launch, and a certified chain of waves runs as one dispatch.

Port of parsec_tpu/device/fuse.py.  It consumes two in-tree artifacts of
the static analysis (analysis/plan.py):

  certify()            per-(rank, wave) fusability certificates:
                       homogeneous class, table-driven bodies, no
                       intra-wave conflict, one tile signature
  chain_certificates() chain certificates: adjacent certified waves where
                       the producer wave feeds the consumer wave on this
                       rank with matching tile signatures, every consumer
                       input either from the producer wave or a
                       statically known collection tile

Two fusion levels:

  wave   a popped same-class group that passes the ONLINE checks (the
         live re-validation of what the static certificate proves;
         independence, no member writing a copy another member touches,
         is checked against the live task copies) dispatches as ONE
         launch.  That launch is the batched dispatch's own
         (CudaDevice._launch), so this level is observational: it counts
         and marks the DEVICE_DISPATCH begin's aux, and changes no bit.

  chain  when the chain certificates link the popped wave to its
         consumer wave(s), one Python function issues the producer
         wave's chore and then each level's chore, in order, on the
         device's exec stream.  A level's "chain" inputs are gathered by
         lane index from the previous level's output stacks on the card
         (a slice, or one index_select): nothing goes back to the host.
         Its "mem" inputs (collection tiles) are stacked as a dispatch
         stacks a read flow (CudaDevice._lanes_of).  One event recorded
         after the last level orders the parked results' consumers and
         the writeback lane.  The consumer levels' results are PARKED:
         when the runtime later releases and pops the consumer tasks,
         they complete from them with ZERO launches, after a per-flow
         (uid, version) check of every real input copy against what the
         speculation consumed (the discipline of the speculative
         epilogue, widened from one lane to whole waves).  Any mismatch
         (a tile written in between, an upstream miss, an unresolved
         pending link) discards the parked result and the task
         dispatches normally: a stale certificate costs a wasted
         speculation, never a wrong answer.

The certificates depend on a pool's structure alone (its classes'
tables, its globals, the geometry of the collections it reads, the
device's chore attachments, the rank and the analysis knobs), and a
builder run once a solve makes a new pool of the same structure each
time.  So the consumed certificate state is cached per device under a
key rendered exactly from that structure (_structure_key), least
recently used first out: a pool whose key is cached takes the state as
it is (cert_hits), one whose key is not runs the pass and stores its
result (cert_misses), and one whose tables hold what the key cannot
render exactly (a Python callable in an expression, a JDF escape, a
collection of a type without a known geometry) runs the pass uncached,
counted by reason (cert_uncached), never guessed at.  A pool's consumed
state, its parked results and their pending online checks live with the
device's record of the pool (cuda._PoolRecord; the parked results and
checks filed under its key) and go with it when the pool is destroyed
(drop_pool: the parked results count as chain_drops).

Widths are never padded: a chained level launches with exactly its
consumer count, the same call with the same shapes that the unfused
dispatch of a whole wave makes (the reference pads to powers of two to
bound XLA's compiles; on the card padding would waste lanes and change
the batch count a library product sees).  `cache_hits`/`cache_misses`
keep the reference's schema and count the reuse of a chain's marshal
plan (the level structure and widths), keyed like the reference's
executable cache.  Every refusal is COUNTED by reason (never a silent
fallback): it falls back to the normal batched dispatch.  Once a chain's
effects have started, an error fails its tasks.
`PTC_MCA_device_wave_fuse=0` removes this module from the dispatch path
entirely, reproducing the per-group batched dispatch bit for bit.

All fuser state changes on the device's manager thread (the only
dispatcher), but for a destroyed pool's drop (drop_pool, on the thread
that destroys it, once no task of the pool is left): the parked store
is iterated over snapshots, its records popped one key at a time, and
class counts, pins and counters change under the device lock.
"""
from __future__ import annotations

import time
import traceback
from collections import OrderedDict
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _native as N
from ..analysis.flowgraph import LinearCollectionShim
from ..core import expr as E
from ..core.taskclass import Mem, Ref
from ..data import collections as _colls
from ..profiling.trace import KEY_DEVICE_CERT
from ..utils import params as _knobs

# hard bound on parked speculative results (each pins a row of an output
# stack on the card): beyond it the oldest record drops and its task
# falls back to a normal dispatch (counted, never silent)
_PARKED_MAX = 8192

# pool structures whose consumed certificates a device keeps
_CERT_CACHE_MAX = 8

# DEVICE_CERT's END aux: how the pool's certificates were had
_CERT_MISS, _CERT_HIT, _CERT_UNCACHED = range(3)


class _Unkeyable(Exception):
    """A pool table element the structure key cannot render exactly; its
    message is the reason cert_uncached counts."""


def _expr_key(e):
    """An expression of a pool's tables as nested tuples, node for node
    (what analysis/flowgraph.py compiles).  A Python callback or a JDF
    escape reads state the key cannot see: _Unkeyable."""
    if e is None:
        return None
    if isinstance(e, (int, np.integer)):
        return int(e)
    if isinstance(e, str):              # a bare string names a global
        return ("G", e)
    t = type(e)
    if t is E.Const:
        return ("c", int(e.v))
    if t is E.L or t is E.G:
        return (t.__name__, e.name)
    if t is E.BinOp:
        return ("b", e.op, _expr_key(e.a), _expr_key(e.b))
    if t is E.UnOp:
        return ("u", e.op, _expr_key(e.a))
    if t is E.Select:
        return ("s", _expr_key(e.c), _expr_key(e.a), _expr_key(e.b))
    if t is E.Range:
        return ("range", _expr_key(e.lo), _expr_key(e.hi),
                _expr_key(e.step))
    if t is E.Compr:
        return ("compr", _expr_key(e.lo), _expr_key(e.hi),
                _expr_key(e.step), _expr_key(e.value), e.iter_name)
    if t is E.Call:
        raise _Unkeyable("python-call")
    from ..dsl import jdf
    if t is jdf._Name:
        return ("N", e.name)
    if t is jdf._PyEscape:
        raise _Unkeyable("jdf-escape")
    raise _Unkeyable(f"expression:{t.__name__}")


def _target_key(t):
    if t is None:
        return None
    if type(t) is Ref:
        return ("ref", t.task, tuple(_expr_key(p) for p in t.params),
                t.flow)
    if type(t) is Mem:
        return ("mem", t.collection, tuple(_expr_key(x) for x in t.idx))
    raise _Unkeyable(f"target:{type(t).__name__}")


def _collection_key(coll):
    """What a collection's rank_of and tile bytes depend on, by its exact
    type (a subclass may place tiles otherwise: _Unkeyable)."""
    if coll is None:
        return None
    t = type(coll)
    if t is LinearCollectionShim:
        return (t.__name__, int(coll.nodes), int(coll.elem_size))
    if t is _colls.VectorCyclic:
        return (t.__name__, coll.N, coll.nb, coll.nodes, coll.myrank,
                coll.dtype.str)
    if t in (_colls.TwoDimBlockCyclic, _colls.SymTwoDimBlockCyclic,
             _colls.ReplicatedLocal, _colls.SubtileView):
        grid = (coll.P, coll.Q)
    elif t in (_colls.TwoDimBlockCyclicBand,
               _colls.SymTwoDimBlockCyclicBand):
        grid = (coll.off_band.P, coll.off_band.Q, coll.band_size)
    elif t is _colls.TwoDimTabular:
        grid = (coll.table.tobytes(),)
    else:
        raise _Unkeyable(f"collection:{t.__name__}")
    return (t.__name__, coll.M, coll.N, coll.mb, coll.nb, coll.nodes,
            coll.myrank, coll.dtype.str, getattr(coll, "uplo", None)) + grid


def _structure_key(pool, depth: int, max_instances: int) -> tuple:
    """Everything chain_certificates(tp) and its consumption read, as one
    hashable tuple: per class its name, id, parameters, affinity, flows
    (access, arena and its bytes, dependencies with their targets, guards
    and iterators) and chores, and the device's attachment of it (flows,
    shapes, dtypes, the kernel's id: the key holds no reference to it,
    and the certificates read nothing of a kernel, so an id a later
    kernel reuses can only match a structure certified alike); the
    pool's globals; the geometry of every collection it names; the
    context's rank, rank map and the knobs.  A chore's Python body
    enters as its kind and purity, all the certificates read of it.
    _Unkeyable where something cannot be rendered exactly."""
    tp = pool.tp
    ctx = tp.ctx
    colls, classes = set(), []
    for tc in tp.classes:
        flows = []
        for fl in tc.flows:
            deps = []
            for d in fl.deps:
                if type(d.target) is Mem:
                    colls.add(d.target.collection)
                deps.append((d.direction, _target_key(d.target),
                             _expr_key(d.guard),
                             tuple((nm, _expr_key(lo), _expr_key(hi),
                                    _expr_key(st))
                                   for nm, lo, hi, st in d.iters),
                             d.dtype, d.ltype))
            flows.append((fl.name, fl.access, fl.arena,
                          ctx.arena_sizes.get(fl.arena), tuple(deps)))
        aff = tc._affinity
        if aff is not None:
            colls.add(aff.collection)
        body = pool.bodies.get(tc.id)
        attached = None if body is None else (
            id(body.kernel), tuple(body.reads), tuple(body.writes),
            tuple(sorted((f, tuple(s)) for f, s in body.shapes.items())),
            tuple(sorted((f, np.dtype(d).str)
                         for f, d in body.dtypes.items())), body.batch)
        classes.append((
            tc.name, tc.id,
            tuple((nm, bool(is_range), _expr_key(p))
                  for nm, is_range, p in tc.locals),
            _target_key(aff), tuple(flows),
            tuple((ch.device_type, ch.body_kind, bool(ch.pure),
                   ch.body_arg if ch.body_kind == N.BODY_DEVICE else None)
                  for ch in tc.chores),
            attached))
    return (tuple(classes),
            tuple(sorted((nm, i, int(N.lib.ptc_tp_global(tp._ptr, i)))
                         for nm, i in tp.globals_map.items())),
            tuple((nm, _collection_key(ctx.collection_objs.get(nm)))
                  for nm in sorted(colls)),
            ctx.myrank, ctx.rank_map, max_instances, depth)


def _per_lane_bytes(body) -> int:
    """The bytes one lane of `body` reads and writes (its tiles)."""
    total = 0
    for f in list(body.reads) + list(body.writes):
        shp = body.shapes.get(f)
        if shp:
            total += int(np.prod(shp)) * np.dtype(
                body.dtypes.get(f, np.float32)).itemsize
    return total


def _rows(stack: torch.Tensor, lanes: List[int]) -> torch.Tensor:
    """Rows `lanes` of a lane stack, as CudaDevice._lanes_of takes the
    rows of one cached stack: a slice when they are in order, else one
    index_select."""
    if lanes == list(range(lanes[0], lanes[0] + len(lanes))):
        return stack[lanes[0]:lanes[0] + len(lanes)]
    return stack.index_select(0, torch.tensor(lanes, device=stack.device))


class WaveFuser:
    """Per-device wave compiler."""

    def __init__(self, dev):
        self.dev = dev
        self.depth = max(1, int(_knobs.get("device.wave_fuse_depth")))
        # _structure_key -> a pool's consumed chain certificates
        # ({"failed": str|False, "links", "classes", "slots", "by_name"},
        # kept in its record's `cert`), shared by the pools of one
        # structure (least recently used first out)
        self._cert_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self.cert_uncached: Dict[str, int] = {}
        # (pool key, class_id, params) -> parked speculative result
        self._parked: Dict[tuple, dict] = {}
        self._parked_classes: Dict[tuple, int] = {}
        # (pool key, cls_name, params, flow) -> [(rec_key, flow_name)]: chain
        # checks waiting for an upstream consumption to learn its concrete
        # (uid, version); an unresolved pending reads as a miss
        self._pending: Dict[tuple, list] = {}
        self._seen_plans: set = set()  # marshal plans run so far
        self.stats = {"fused_waves": 0, "fused_tasks": 0,
                      "fused_chains": 0, "chain_waves": 0,
                      "chain_parked": 0, "chain_hits": 0,
                      "chain_misses": 0, "chain_drops": 0,
                      "cache_hits": 0, "cache_misses": 0,
                      "cert_hits": 0, "cert_misses": 0}
        self.refused: Dict[str, int] = {}

    # ------------------------------------------------------------ stats
    def _bump(self, key: str, n: int = 1) -> None:
        with self.dev._lock:
            self.stats[key] += n

    def _refuse(self, reason: str, n: int = 1) -> None:
        """Count an explicit refusal by reason (the runtime mirror of
        certify()'s refuse records; there is no silent fallback)."""
        with self.dev._lock:
            self.refused[reason] = self.refused.get(reason, 0) + n

    def snapshot(self) -> dict:
        with self.dev._lock:
            out = dict(self.stats)
            out["refused"] = dict(self.refused)
            out["cert_uncached"] = dict(self.cert_uncached)
        out["enabled"] = True
        out["parked"] = len(self._parked)
        return out

    def clear(self) -> None:
        """Drop parked results and the cache of certificate state (device
        stop, which drops the pool records too)."""
        self._parked.clear()
        self._parked_classes.clear()
        self._pending.clear()
        self._cert_cache.clear()
        with self.dev._lock:
            self.dev._chain_pinned = 0

    def drop_pool(self, key: int) -> None:
        """Drop what is parked for the pool of record key `key` (its
        destroy()): its results, counted as chain_drops, with their pins,
        and its pending checks."""
        for rec_key in [k for k in list(self._parked) if k[0] == key]:
            self._drop(rec_key)
        for k in [k for k in list(self._pending) if k[0] == key]:
            self._pending.pop(k, None)

    # ----------------------------------------------------- certificates
    def _state_for(self, body) -> dict:
        """The consumed chain certificates of a class body's pool, had
        once a pool (_certify) and kept in its record."""
        pool = body.pool
        if pool.cert is None:
            pool.cert = self._certify(pool)
        return pool.cert

    def _certify(self, pool) -> dict:
        """A pool's certificate state: the cached state of its structure
        where a pool of that structure has certified on this device, else
        the pass's (stored where the structure keys).  Its time, key
        included, counts in the device's stats["cert_ns"] (a part of
        mgr_plan_ns) and, while a trace or PINS listens, spans a
        DEVICE_CERT inside the DEVICE_PLAN under way (its END's aux: 0 a
        miss, 1 a hit, 2 uncached)."""
        from .cuda import _in_one_step
        dev = self.dev
        traced = dev.ctx._listening
        span = partial(N.prof_event_held, dev.ctx._ptr, KEY_DEVICE_CERT)
        t0 = _in_one_step([partial(span, 0, -1, 0, dev.qid, 0)] * traced
                          + [time.perf_counter_ns])[-1]
        max_instances = int(_knobs.get("plan.max_instances"))
        try:
            key = _structure_key(pool, self.depth, max_instances)
        except _Unkeyable as e:
            key, why = None, str(e)
        except Exception as e:  # a key must never kill dispatch
            key, why = None, f"key-error: {type(e).__name__}"
        st = None if key is None else self._cert_cache.get(key)
        if st is not None:
            self._cert_cache.move_to_end(key)
            how = _CERT_HIT
            self._bump("cert_hits")
        else:
            st = self._chain_state(pool.tp, max_instances)
            if key is None:
                how = _CERT_UNCACHED
                with dev._lock:
                    self.cert_uncached[why] = \
                        self.cert_uncached.get(why, 0) + 1
            else:
                how = _CERT_MISS
                self._bump("cert_misses")
                if st["failed"] in (False, "enumeration-refused"):
                    # an error may not recur: only answers are kept
                    self._cert_cache[key] = st
                    while len(self._cert_cache) > _CERT_CACHE_MAX:
                        self._cert_cache.popitem(last=False)
        end = [partial(span, 1, -1, 0, dev.qid, how)] * traced
        t1 = _in_one_step([time.perf_counter_ns] + end)[0]
        dev._stats_add("cert_ns", t1 - t0)
        return st

    def _chain_state(self, tp, max_instances: int) -> dict:
        """The certificate pass over a pool, consumed for this device's
        rank.  Extraction failures refuse with a reason and never retry
        (a pool that cannot certify cannot start certifying mid-run)."""
        st = {"failed": False, "links": {}, "classes": {},
              "slots": {}, "by_name": {}}
        try:
            from ..analysis.plan import chain_certificates
            plan = chain_certificates(tp, max_instances)
            if plan is None:
                st["failed"] = "enumeration-refused"
            else:
                idx = plan.chain_index(getattr(self.dev.ctx, "myrank", 0))
                st["links"] = idx["links"]
                st["classes"] = idx["classes"]
                for nm, rec in idx["classes"].items():
                    st["slots"][rec["id"]] = rec["param_slots"]
                    st["by_name"][nm] = rec["id"]
        except Exception as e:  # analysis must never kill dispatch
            st["failed"] = f"certificate-error: {type(e).__name__}"
        return st

    @staticmethod
    def _params(view, slots) -> tuple:
        return tuple(int(N.lib.ptc_task_local(view._ptr, s))
                     for s in slots)

    # ------------------------------------------------- parked consumption
    def has_parked(self, body) -> bool:
        """Whether a chain result of `body`'s class is parked: only then
        can a popped task of it complete from one."""
        return bool(self._parked) and body.tc is not None and \
            (body.pool.key, body.tc.id) in self._parked_classes

    def consume_group(self, body, tasks: List) -> List:
        """Complete every task with a matching parked chain result;
        return the rest for a real dispatch.  The caller has checked
        has_parked(body)."""
        return [t for t in tasks if not self.consume(body, t)]

    def consume(self, body, task) -> bool:
        """Parked-result fast path: complete the task with ZERO launches
        when every input copy matches the (uid, version) the speculation
        consumed.  Returns True when the task was DISPOSED (completed or
        failed)."""
        key, cid = body.pool.key, body.tc.id
        st = body.pool.cert
        slots = st["slots"].get(cid) if st else None
        if slots is None:
            return False
        dev = self.dev
        view = body.make_view(task)
        params = self._params(view, slots)
        rec = self._unpark((key, cid, params))
        if rec is None:
            return False
        ok = not rec["pending"]
        if ok:
            for fname, chk in rec["checks"].items():
                cptr = N.lib.ptc_task_copy(view._ptr,
                                           body.flow_index(fname))
                if N.lib.ptc_copy_handle(cptr) != chk[0] \
                        or N.lib.ptc_copy_version(cptr) != chk[1]:
                    ok = False
                    break
        if not ok:
            # stale speculation (an input changed underneath, or an
            # upstream lane itself missed and never resolved this
            # record's pending check): discard, dispatch normally
            self._bump("chain_misses")
            return False
        try:
            wb_uids = []
            for f in body.writes:
                ostack, j = rec["outs"][f]
                uid, nv = dev._write_out(view, body, f, ostack, j,
                                         rec["event"])
                if f in body.mem_out_flows:
                    wb_uids.append(uid)
                # downstream parked records waiting on this lane's output
                # learn its concrete (uid, version) now
                self._resolve(key, body.tc.name, params, f, uid, nv)
        except Exception:
            traceback.print_exc()
            dev.ctx.task_fail(task)
            return True
        self._bump("chain_hits")
        self._bump("fused_tasks")
        dev._stats_add("tasks")
        if wb_uids:
            dev._wb_q.put(("sync", [task], wb_uids))
            return True
        dev.ctx.task_complete(task)
        return True

    def _unpark(self, rec_key: tuple) -> Optional[dict]:
        """Pop the parked record `rec_key`, if there is one, with its
        class's count and its bytes' pin."""
        rec = self._parked.pop(rec_key, None)
        if rec is not None:
            with self.dev._lock:
                n = self._parked_classes.pop(rec_key[:2], 1) - 1
                if n > 0:
                    self._parked_classes[rec_key[:2]] = n
                self.dev._chain_pinned = max(0, self.dev._chain_pinned
                                             - rec["pin"])
        return rec

    def _drop(self, rec_key: tuple) -> None:
        """Drop a parked record no task consumed (superseded, past
        _PARKED_MAX, or its pool destroyed), counted in chain_drops."""
        if self._unpark(rec_key) is not None:
            self._bump("chain_drops")

    def _resolve(self, key, cls_name, params, flow, uid, ver) -> None:
        lst = self._pending.pop((key, cls_name, params, flow), None)
        if not lst:
            return
        for rec_key, fname in lst:
            rec = self._parked.get(rec_key)
            if rec is not None and fname in rec["pending"]:
                del rec["pending"][fname]
                rec["checks"][fname] = (uid, ver)

    # -------------------------------------------------- wave dispatch
    def dispatch_group(self, body, tasks: List) -> bool:
        """Online-certify a popped same-class group.  Returns True when
        the group (with its certified chain) was dispatched here; False
        hands it back to the normal batched dispatch, with the
        DEVICE_DISPATCH begin's fused mark set when the wave certified."""
        dev = self.dev
        if body.tc is None:
            # a DTD group: no class, so no wave to certify; the device
            # launches it as lanes (not a refusal: the counters stay PTG's)
            return False
        if not body.batch:
            self._refuse("unbatchable-body")
            return False
        views = [body.make_view(t) for t in tasks]
        # independence, against the LIVE copies: no member may write a
        # copy another member touches (the engine's intra-wave order is
        # arbitrary, so such a pair inside one launch would race)
        readers: Dict[int, set] = {}
        writers: Dict[int, set] = {}
        for i, v in enumerate(views):
            for f in body.reads:
                c = N.lib.ptc_task_copy(v._ptr, body.flow_index(f))
                if c:
                    readers.setdefault(c, set()).add(i)
            for f in body.writes:
                c = N.lib.ptc_task_copy(v._ptr, body.flow_index(f))
                if c:
                    writers.setdefault(c, set()).add(i)
        for c, ws in writers.items():
            if len(ws | readers.get(c, set())) > 1:
                self._refuse("intra-wave-conflict")
                return False
        # certified: one wave -> one launch (the batched dispatch's own)
        self._bump("fused_waves")
        self._bump("fused_tasks", len(tasks))
        dev._disp_fused = 1
        try:
            return self._try_chain(body, tasks, views)
        except Exception:
            traceback.print_exc()
            self._refuse("chain:error")
            return False

    # -------------------------------------------------- chain dispatch
    def _try_chain(self, body, tasks: List, views: List) -> bool:
        if self.depth < 2:
            return False
        epi = body.epilogue
        if epi is not None and any(epi.pick(v) is not None for v in views):
            # the speculative epilogue is about to fire inside the normal
            # launch; chaining on top would speculate twice
            self._refuse("chain:epilogue-active")
            return False
        st = self._state_for(body)
        if st["failed"]:
            self._refuse(f"chain:{st['failed']}")
            return False
        slots = st["slots"].get(body.tc.id)
        if not st["links"] or slots is None:
            self._refuse("chain:no-link")
            return False
        lane_params = [self._params(v, slots) for v in views]
        levels = self._plan_levels(st, body, lane_params, len(tasks))
        if not levels:
            return False  # reason already counted
        return self._chain_exec(st, body, tasks, views, lane_params,
                                levels)

    def _plan_levels(self, st, body, lane_params, width0) -> List[dict]:
        """Walk the chain certificates forward from the popped lanes: one
        entry per fused consumer wave, bounded by the depth knob, the
        batched-dispatch byte cap and the device's free residency."""
        dev = self.dev
        links = st["links"]
        # parked stacks live on the card outside the LRU until consumed:
        # bound them by BOTH the byte cap of one dispatch and the free
        # residency (budget - used - reservations - parked).  Under
        # pressure the chain is refused and the wave dispatches normally,
        # so out-of-core spilling keeps its semantics
        with dev._lock:
            free = (dev._cache_bytes - dev._cache_used
                    - dev._pf_reserved - dev._chain_pinned)
        lane0 = _per_lane_bytes(body) * width0
        byte_budget = min(dev.batch_max_bytes - lane0, free - lane0)
        pressured = False
        levels: List[dict] = []
        prev_cls = body.tc.name
        prev_lanes = set(lane_params)
        prev_writes = list(body.writes)
        while 1 + len(levels) < self.depth:
            cons: Dict[tuple, dict] = {}
            for params in prev_lanes:
                for e in links.get((prev_cls, params), ()):
                    cons.setdefault(e["params"], e)
            if not cons:
                if not levels:
                    self._refuse("chain:no-link")
                break
            cnames = {e["cls"] for e in cons.values()}
            if len(cnames) != 1:
                self._refuse("chain:mixed-consumers")
                break
            cname = next(iter(cnames))
            cid = st["by_name"].get(cname)
            cbody = body.pool.bodies.get(cid)
            if cbody is None or not cbody.batch:
                self._refuse("chain:consumer-not-attached")
                break
            if cbody.spec_src is not None or cbody.epilogue is not None:
                self._refuse("chain:epilogue-active")
                break
            # feasibility per consumer: every "wave" spec must point at a
            # lane this segment holds, with a flow the producer writes;
            # "mem" specs need a collection that serves tiles now
            entries = []
            for params in sorted(cons):
                e = cons[params]
                ok = True
                for _fname, spec in e["ins"]:
                    if spec[0] == "wave":
                        ok = spec[1] in prev_lanes \
                            and spec[2] in prev_writes
                    elif spec[0] == "mem":
                        coll = dev.ctx.collection_objs.get(spec[1])
                        ok = coll is not None and hasattr(coll, "data_of")
                    else:
                        ok = False
                    if not ok:
                        break
                if ok:
                    entries.append(e)
            if not entries:
                self._refuse("chain:unresolvable-inputs")
                break
            byte_budget -= _per_lane_bytes(cbody) * len(entries)
            if byte_budget < 0:
                pressured = True
                break  # byte cap / free-residency bound reached
            levels.append({"cls": cname, "cid": cid, "body": cbody,
                           "entries": entries})
            prev_cls = cname
            prev_lanes = {e["params"] for e in entries}
            prev_writes = list(cbody.writes)
        if not levels and pressured:
            self._refuse("chain:residency-pressure")
        return levels

    def _fetch_datum(self, coll_name: str, idx: tuple, shape):
        """An external collection tile a chained consumer reads, as
        (uid, version, host_of): the (uid, version) is what consumption
        re-validates, and host_of() gives the (host tile, scope -1) for
        an h2d.  The device tile itself is resolved when the level's
        lanes are stacked (CudaDevice._lanes_of: the current mirror here,
        a sibling's, else a fresh h2d that stalls this dispatch, counted
        as every dispatch-time stall is).  None when some device holds
        the tile at another version than its host copy (a write in
        flight): the chain is then refused, so that no stale host bytes
        can replace a newer mirror."""
        dev = self.dev
        coll = dev.ctx.collection_objs[coll_name]
        cptr = N.lib.ptc_data_host_copy(coll.data_of(*idx)._ptr)
        uid = dev._copy_uid(cptr)
        ver = N.lib.ptc_copy_version(cptr)
        q, v = dev.ctx.device_get_data_owner(uid)
        if q >= 0 and v != ver:
            return None

        def host_of():
            host = np.asarray(coll.tile(*idx))
            return (host.reshape(shape) if shape is not None else host), -1
        return uid, ver, host_of

    def _marshal(self, levels, lane_params, prev_writes):
        """Every chained level's inputs, before anything runs: per level
        its structure key and per read flow ("chain", write index, lanes)
        or ("mem", the stacked [lanes, *tile] tensor), and the (uid,
        version) each "mem" lane consumed.  None (counted) on a refusal."""
        dev = self.dev
        mem_checks: Dict[tuple, tuple] = {}
        plans: List[list] = []
        structs: List[tuple] = []
        prev_lane_of = {p: i for i, p in enumerate(lane_params)}
        for li, lvl in enumerate(levels):
            cbody = lvl["body"]
            ins_of = [dict(e["ins"]) for e in lvl["entries"]]
            specs: List[tuple] = []
            for fname in cbody.reads:
                fspecs = [ins.get(fname) for ins in ins_of]
                kinds = {s[0] if s else None for s in fspecs}
                if kinds == {"wave"}:
                    pflows = {s[2] for s in fspecs}
                    if len(pflows) != 1:
                        self._refuse("chain:unresolvable-inputs")
                        return None
                    specs.append(("chain",
                                  prev_writes.index(next(iter(pflows))),
                                  [prev_lane_of[s[1]] for s in fspecs]))
                elif kinds == {"mem"}:
                    shape = cbody.shapes.get(fname)
                    keys, hosts = [], []
                    for j, s in enumerate(fspecs):
                        got = self._fetch_datum(s[1], s[2], shape)
                        if got is None:
                            self._refuse("chain:unresolvable-inputs")
                            return None
                        keys.append(got[:2])
                        hosts.append(got[2])
                        mem_checks[(li, j, fname)] = got[:2]
                    if shape is None:
                        self._refuse("chain:unresolvable-inputs")
                        return None
                    specs.append(("mem", dev._lanes_of(
                        keys, shape, cbody.dtypes[fname],
                        lambda i, hosts=hosts: hosts[i]())))
                else:
                    self._refuse("chain:unresolvable-inputs")
                    return None
            plans.append(specs)
            structs.append((cbody.kernel, tuple(s[0] for s in specs),
                            len(lvl["entries"])))
            prev_lane_of = {e["params"]: i
                            for i, e in enumerate(lvl["entries"])}
            prev_writes = list(cbody.writes)
        return plans, tuple(structs), mem_checks

    def _chain_exec(self, st, body, tasks, views, lane_params,
                    levels) -> bool:
        """Run the chain: write out the popped wave, park the speculated
        consumer waves.

        Ordering: the chained levels' marshaling (which can still refuse)
        runs BEFORE the DEVICE_DISPATCH span opens and before any effect,
        so a refusal or a marshaling error falls back to the normal
        batched dispatch with nothing written (its staging stall lands in
        the next span's end).  A kernel error before any write falls back
        too.  Once the effects below have started, an error fails the
        tasks (a dispatch again would write lanes twice).  The popped
        wave's tasks complete once the span has ended, as after a batched
        launch (CudaDevice._disp_close)."""
        dev = self.dev
        key = body.pool.key
        try:
            got = self._marshal(levels, lane_params, list(body.writes))
        except Exception:
            traceback.print_exc()
            self._refuse("chain:error")
            return False
        if got is None:
            return False
        plans, structs, mem_checks = got

        dev._disp_fused = 1 + len(levels)
        dev._disp_open(body, len(tasks))
        complete = 0  # the tasks completing here once the span has ended
        try:
            try:
                pkey = (body.kernel, tuple(body.reads), len(tasks), structs)
                if pkey in self._seen_plans:
                    self._bump("cache_hits")
                else:
                    self._seen_plans.add(pkey)
                    self._bump("cache_misses")
                ins = [dev._lanes_in(views, body, f) for f in body.reads]
                outs0 = dev._outputs(body, body.kernel(*ins), len(tasks),
                                     ins)
                dev._count_launch(body.kernel, len(tasks))
                ev0 = dev._record()
                prev, level_outs = outs0, []
                for lvl, specs in zip(levels, plans):
                    cbody = lvl["body"]
                    width = len(lvl["entries"])
                    lins = [_rows(prev[s[1]], s[2]) if s[0] == "chain"
                            else s[1] for s in specs]
                    prev = dev._outputs(cbody, cbody.kernel(*lins), width,
                                        lins)
                    dev._count_launch(cbody.kernel, width)
                    level_outs.append(prev)
                ev = dev._record()
            except Exception:
                # nothing written yet: the normal batched dispatch of the
                # popped wave runs instead
                traceback.print_exc()
                self._refuse("chain:error")
                return False

            try:
                # ---- level-0 effects: the batched dispatch's own
                wb_stacks = []
                out_uid: Dict[tuple, tuple] = {}
                for f, ostack in zip(body.writes, outs0):
                    uids = []
                    for i, view in enumerate(views):
                        uid, nv = dev._write_out(view, body, f, ostack, i,
                                                 ev0)
                        out_uid[(lane_params[i], f)] = (uid, nv)
                        uids.append(uid)
                    if f in body.mem_out_flows:
                        wb_stacks.append((ostack, uids, ev0))
                with dev._lock:
                    dev.stats["tasks"] += len(tasks)
                    dev.stats["batches"] += 1
                    dev.stats["batched_tasks"] += len(tasks)

                # ---- park the speculated consumer waves
                parked = 0
                prev_cls = body.tc.name
                for li, (lvl, ostacks) in enumerate(zip(levels,
                                                        level_outs)):
                    cbody = lvl["body"]
                    entries = lvl["entries"]
                    ckey = (key, lvl["cid"])
                    # residency of the parked stacks (one level's output
                    # stacks, split across its records; released as each
                    # record is consumed or dropped)
                    share = sum(int(o.nbytes) for o in ostacks) \
                        // len(entries)
                    with dev._lock:
                        dev._chain_pinned += share * len(entries)
                    for j, e in enumerate(entries):
                        rec_key = (key, lvl["cid"], e["params"])
                        rec = {"outs": {f: (ostacks[fi], j) for fi, f in
                                        enumerate(cbody.writes)},
                               "event": ev, "pin": share,
                               "checks": {}, "pending": {}}
                        for fname, spec in e["ins"]:
                            if spec[0] == "wave":
                                if li == 0:
                                    rec["checks"][fname] = \
                                        out_uid[(spec[1], spec[2])]
                                else:
                                    # resolved when the upstream lane is
                                    # consumed; unresolved reads as a miss
                                    rec["pending"][fname] = True
                                    self._pending.setdefault(
                                        (key, prev_cls, spec[1],
                                         spec[2]), []).append(
                                            (rec_key, fname))
                            else:
                                rec["checks"][fname] = \
                                    mem_checks[(li, j, fname)]
                        self._drop(rec_key)  # a superseded record
                        self._parked[rec_key] = rec
                        self._parked_classes[ckey] = \
                            self._parked_classes.get(ckey, 0) + 1
                        parked += 1
                    prev_cls = lvl["cls"]
                over = len(self._parked) - _PARKED_MAX
                if over > 0:  # the oldest, over a snapshot (drop_pool)
                    for k in list(self._parked)[:over]:
                        self._drop(k)
                self._bump("fused_chains")
                self._bump("chain_waves", len(levels))
                self._bump("chain_parked", parked)
                self._publish_hints(st, levels)
                # mem-out coherence and completions ride the writeback
                # lane, exactly as after a batched launch
                if wb_stacks:
                    dev._wb_q.put(("stack", list(tasks), wb_stacks))
                else:
                    complete = len(tasks)
            except Exception:
                # effects already started: failing the tasks is the only
                # sound exit (a dispatch again would write twice)
                traceback.print_exc()
                for t in tasks:
                    dev.ctx.task_fail(t)
        finally:
            dev._disp_close(body, complete)
        for t in tasks[:complete]:
            dev.ctx.task_complete(t)
        return True

    def _publish_hints(self, st, levels) -> None:
        """Predict the NEXT chain segment's external collection reads and
        hand them to the prefetch lane (the chain-granular lookahead): by
        the time that segment dispatches, its tiles are staged mirrors,
        not dispatch-time h2d stalls."""
        if not levels:
            return
        links = st["links"]
        last = levels[-1]
        hints: List[tuple] = []
        seen = set()
        for e in last["entries"]:
            for nxt in links.get((last["cls"], e["params"]), ()):
                for _fname, spec in nxt["ins"]:
                    if spec[0] == "mem" and spec[1:] not in seen:
                        seen.add(spec[1:])
                        hints.append((spec[1], spec[2]))
        if hints:
            self.dev._pf_chain_hints = hints
            self.dev._pf_wake.set()

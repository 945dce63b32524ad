"""Runtime-native tiled collectives: reduce-scatter / all-reduce /
all-gather / broadcast as ptc_coll_* task classes.

Reference role: PaRSEC's `remote_dep` broadcast topologies (chain /
binomial / star, parsec/remote_dep.c:39-47, SURVEY §L4) — collectives
driven by the dependency engine, not by bulk-synchronous library calls.
T3 (arXiv:2401.16677) supplies the overlap lever: track SUB-TILE
production and trigger the collective as slices become ready.  Here a
producer tile enters the collective in `coll.slice`-byte slices (default
= comm.chunk_size, so collective slicing and the wire-v4 watermark /
PUT_CHUNK chunking stay aligned): each slice is its own pipelined
dataflow chain, so the wire — and the downstream partial reduction on
the consumer — starts after the FIRST slice of the tile, not the last.
Big slices additionally stream chunk-granularly inside the wire (the
ready-bytes watermark and the scatter-gather PUT_CHUNK path).

Every class built here is named `ptc_coll_*`: the native core flags the
family by that prefix (core.cpp ptc_tp_add_class), so collective steps
schedule, trace (PROF_KEY_COLL delivery instants), fault-reap and count
(ptc_coll_stats) like any other task — there is no separate collective
engine to keep correct.

Topology is chosen per (message size, rank count, link class) from the
fitted transfer-economics model (comm/economics.py over
BENCH_comm.json), overridable via PTC_MCA_coll_topo (with
coll.topo.ici / coll.topo.dcn per-class overrides, ptc-topo):

  reduce legs   ring | binomial | star as explicit event DAGs (the
                planner below), computed in Python and compiled into
                TWO table-driven task classes (step + leaf) whose
                guards/indices are OP_CALL lookups
  fan-out legs  one src -> Range broadcast riding the native
                ACTIVATE_BCAST trees (star/chain/binomial selected via
                ctx.comm_set_topology — the reference machinery)
  hier (ptc-topo)  two-level trees over a multi-island TopologyModel:
                reduce legs pair binomially INSIDE each island onto a
                local head, then the heads star into the root — exactly
                (islands - 1) DCN crossings; fan-out legs insert a lead
                class on each remote island's leader (src -> leads over
                DCN once, leads -> their members at ici cost)

SPMD contract: every rank must build the same collectives in the same
order (class/arena/collection registration ids are creation-ordered).

Port of parsec_tpu/comm/coll.py.  The collective steps' sums run on the
host, in numpy, as the reference's do, so that both packages' results
agree bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import parsec_tpu_torch as pt

from .economics import HIER, default_economics
from .topology import default_topology, resolve_class_knob

# reduction operators: (elementwise numpy fn, identity for padding)
OPS = {
    "sum": (np.add, 0),
    "max": (np.maximum, None),  # identity filled per-dtype (min value)
    "min": (np.minimum, None),
    "prod": (np.multiply, 1),
}

_NATIVE_TOPO = {"star": "star", "ring": "chain", "chain": "chain",
                "binomial": "binomial",
                # hier's src->leads / lead->members legs are explicit
                # classes; the residual Range activations go direct
                "hier": "star"}


def _op_identity(op: str, dtype) -> float:
    fn, ident = OPS[op]
    if ident is not None:
        return ident
    info = (np.finfo(dtype) if np.issubdtype(dtype, np.floating)
            else np.iinfo(dtype))
    return info.min if op == "max" else info.max


def _record(ctx, kind: str, topo: str):
    st = ctx._coll_py_stats
    if st is None:
        st = ctx._coll_py_stats = {"ops": 0, "by_kind": {}, "by_topo": {}}
    st["ops"] += 1
    st["by_kind"][kind] = st["by_kind"].get(kind, 0) + 1
    st["by_topo"][topo] = st["by_topo"].get(topo, 0) + 1


def _next_uid(ctx) -> int:
    uid = ctx._coll_uid
    ctx._coll_uid = uid + 1
    return uid


def rank_affinity_collection(ctx) -> str:
    """One shared nodes-element collection used ONLY for placement
    (affinity rank_of(r) == r): collective classes have no memory deps —
    all I/O is dataflow + closure reads — but the PTG placement contract
    wants a collection to anchor `: desc(r)` affinity on."""
    name = "__ptc_coll_ranks"
    if name not in ctx.collections:
        arr = np.zeros(max(1, ctx.nodes), dtype=np.uint8)
        ctx.register_linear_collection(name, arr, elem_size=1,
                                       nodes=max(1, ctx.nodes),
                                       myrank=ctx.myrank)
    return name


def _mesh_class(tmodel) -> Optional[str]:
    """Dominant link class of the mesh: "dcn" when the topology spans
    islands (the collective will cross DCN), else "ici"; None for a
    single rank.  Keys the per-class knob/fit resolution (ptc-topo)."""
    if tmodel is None or tmodel.nranks <= 1:
        return None
    return "dcn" if tmodel.n_islands > 1 else "ici"


def _slicing(nbytes: int, itemsize: int,
             cls: Optional[str] = None) -> Tuple[int, int]:
    """(nslices, slice_elems) for one segment of `nbytes`: slices of
    ~coll.slice bytes (default comm.chunk_size, per-link-class override
    comm.chunk_size.{ici,dcn}), at most coll.max_slices per segment —
    each slice is an independent pipelined chain."""
    from ..utils import params as _mca
    q = _mca.get("coll.slice") or resolve_class_knob("comm.chunk_size",
                                                     cls)
    if q <= 0:
        q = 1 << 20
    cap = max(1, _mca.get("coll.max_slices"))
    ns = min(cap, max(1, math.ceil(nbytes / q)))
    elems = max(1, nbytes // itemsize)
    return ns, max(1, math.ceil(elems / ns))


# --------------------------------------------------------------------
# reduction-event planner
# --------------------------------------------------------------------

class _Ev:
    """One reduction step: executes on `rank`, combines side a and side
    b into its R output.  Sides: None | ("ev", i) | ("contrib", cid,
    rank) — resolved by _resolve into ("local", cid) (same-rank closure
    read), ("leaf", li) (cross-rank forwarder task) or ("ext", cid)
    (externally produced Ref contribution)."""

    __slots__ = ("rank", "seg", "a", "b", "cons", "final")

    def __init__(self, rank, seg, a, b):
        self.rank, self.seg, self.a, self.b = rank, seg, a, b
        self.cons: Optional[Tuple[int, int]] = None  # (ev idx, 0=A 1=B)
        self.final = False


class _Plan:
    def __init__(self):
        self.events: List[_Ev] = []
        self.leaves: List[dict] = []  # {rank, seg, cid, cons:(ev, side)}
        self.final_of: Dict[int, int] = {}  # seg -> final event idx
        self.ext_route: Dict[object, Tuple[int, int]] = {}  # cid->(ev,side)

    def _add(self, rank, seg, a, b) -> int:
        ev = _Ev(rank, seg, a, b)
        self.events.append(ev)
        i = len(self.events) - 1
        for side, src in ((0, a), (1, b)):
            if src is not None and src[0] == "ev":
                self.events[src[1]].cons = (i, side)
        return i


def _plan_reduce(nseg: int, nranks: int, root_of: Callable[[int], int],
                 contributors_of: Callable[[int], Sequence[Tuple[int, object]]],
                 topo: str, ext: bool, tmodel=None) -> _Plan:
    """Build the reduction DAG: per segment, local same-rank chains
    first (zero wire traffic), then the cross-rank phase in the chosen
    topology, converging on root_of(seg).  contributors_of(seg) yields
    (rank, contrib_id) pairs; duplicates per rank are chained locally.
    topo == "hier" needs `tmodel` (comm/topology.py): reduce binomially
    inside each island onto a local head, then star the heads into the
    root — (islands - 1) inter-island hops total."""
    plan = _Plan()
    for seg in range(nseg):
        root = root_of(seg)
        by_rank: Dict[int, List[object]] = {}
        order: List[int] = []
        for rank, cid in contributors_of(seg):
            if rank not in by_rank:
                by_rank[rank] = []
                order.append(rank)
            by_rank[rank].append(cid)
        # local chains: one "super" value per contributing rank
        super_of: Dict[int, tuple] = {}
        for rank in order:
            cids = by_rank[rank]
            cur = ("contrib", cids[0], rank)
            for cid in cids[1:]:
                i = plan._add(rank, seg, cur, ("contrib", cid, rank))
                cur = ("ev", i)
            super_of[rank] = cur
        # cross-rank phase
        others = sorted((r for r in order if r != root),
                        key=lambda r: (r - root) % max(1, nranks))
        cur = super_of.get(root)
        if topo == "ring" and others:
            # walk the ring toward the root: each hop adds the local
            # super to the incoming partial (root's own super lands last)
            run = None
            for r in reversed(others):  # farthest-from-root starts
                run = ("ev", plan._add(r, seg, super_of[r], run)) \
                    if run is not None else super_of[r]
            i = plan._add(root, seg, cur, run)
            cur = ("ev", i)
        elif topo == "binomial" and others:
            nodes_list = [root] + others
            state = [super_of.get(r) for r in nodes_list]
            j = 1
            while j < len(nodes_list):
                for p in range(0, len(nodes_list), 2 * j):
                    q = p + j
                    if q >= len(nodes_list) or state[q] is None:
                        continue
                    i = plan._add(nodes_list[p], seg, state[p], state[q])
                    state[p] = ("ev", i)
                j *= 2
            cur = state[0]
        elif topo == HIER and others:
            # two-level (ptc-topo): binomial pairing INSIDE each island
            # onto a local head — the root for its own island, the
            # lowest contributing rank elsewhere — then the root stars
            # the remote heads in.  Intra-island hops ride ici links;
            # only the (islands - 1) head->root hops cross DCN.
            isl_of = ((lambda r: tmodel.island_of(r)) if tmodel
                      else (lambda r: 0))
            groups: Dict[int, List[int]] = {}
            for r in order:
                groups.setdefault(isl_of(r), []).append(r)
            root_isl = isl_of(root)
            head_val: Dict[int, tuple] = {}
            for isl in sorted(groups):
                members = sorted(groups[isl])
                head = root if isl == root_isl else members[0]
                rest = [r for r in members if r != head]
                nodes_list = [head] + rest
                state = [super_of.get(r) for r in nodes_list]
                j = 1
                while j < len(nodes_list):
                    for p in range(0, len(nodes_list), 2 * j):
                        q = p + j
                        if q >= len(nodes_list) or state[q] is None:
                            continue
                        i = plan._add(nodes_list[p], seg,
                                      state[p], state[q])
                        state[p] = ("ev", i)
                    j *= 2
                head_val[isl] = state[0]
            cur = head_val.get(root_isl)
            for isl in sorted(groups):
                if isl == root_isl:
                    continue
                i = plan._add(root, seg, cur, head_val[isl])
                cur = ("ev", i)
        elif others:  # star: the root chains every remote super
            for r in others:
                i = plan._add(root, seg, cur, super_of[r])
                cur = ("ev", i)
        # land the final value in an event ON the root
        if (cur is None or cur[0] != "ev"
                or plan.events[cur[1]].rank != root):
            cur = ("ev", plan._add(root, seg, cur, None))
        plan.events[cur[1]].final = True
        plan.final_of[seg] = cur[1]
    # resolve contrib sides: local read / leaf forwarder / external Ref
    for i, ev in enumerate(plan.events):
        for side, name in ((0, "a"), (1, "b")):
            src = getattr(ev, name)
            if src is None or src[0] != "contrib":
                continue
            _, cid, crank = src
            if ext:
                setattr(ev, name, ("ext", cid))
                plan.ext_route[cid] = (i, side)
            elif crank == ev.rank:
                setattr(ev, name, ("local", cid))
            else:
                plan.leaves.append({"rank": crank, "seg": ev.seg,
                                    "cid": cid, "cons": (i, side)})
                setattr(ev, name, ("leaf", len(plan.leaves) - 1))
    return plan


# --------------------------------------------------------------------
# class emission
# --------------------------------------------------------------------

def _tab(values):
    """Freeze a per-event int table behind an OP_CALL expression."""
    t = list(values)
    return pt.call(lambda locs, g, t=t: t[locs[0]], pure=True)


def _emit_reduce(ctx, tp, uid: int, plan: _Plan, ns: int, arena: str,
                 opf, dtype, local_read=None, final_sink=None,
                 ext_in: Optional[dict] = None):
    """Compile a _Plan into the ptc_coll_{uid}_step / _leaf classes.

    local_read(cid, seg, sl) -> 1-D dtype array (same-rank contribution)
    final_sink(seg, sl, arr)  -> called on the root with the result
    ext_in: {"cls", "flow", "nparams", "params_of"} — external Ref
            contributions (gemm partials, moe per-expert combines)
    Returns the step class name (consumers Ref flow "R" of final events).
    """
    ev = plan.events
    step_name = f"ptc_coll_{uid}_step"
    leaf_name = f"ptc_coll_{uid}_leaf"
    rankc = rank_affinity_collection(ctx)
    sl = pt.L("sl")

    kindnum = {"ev": 1, "local": 2, "leaf": 3, "ext": 4}

    def side_tabs(name):
        kinds = [kindnum[getattr(e, name)[0]] if getattr(e, name) else 0
                 for e in ev]
        idxs = [getattr(e, name)[1] if getattr(e, name)
                and getattr(e, name)[0] in ("ev", "leaf") else 0
                for e in ev]
        cids = [getattr(e, name)[1] if getattr(e, name)
                and getattr(e, name)[0] in ("local", "ext") else None
                for e in ev]
        return kinds, idxs, cids

    a_kind, a_idx, a_cid = side_tabs("a")
    b_kind, b_idx, b_cid = side_tabs("b")
    cons_idx = [e.cons[0] if e.cons else 0 for e in ev]
    cons_side = [e.cons[1] if e.cons else -1 for e in ev]

    def _guard(table, val):
        return _tab([1 if x == val else 0 for x in table])

    step = tp.task_class(step_name)
    step.param("i", 0, len(ev) - 1)
    step.param("sl", 0, ns - 1)
    step.affinity(rankc, _tab([e.rank for e in ev]))

    # IN deps carry NO guards: a guard holding a Python escape would be
    # counted conservatively as a maybe-input (select_input_dep's
    # guard_dyn path) and the step would wait forever.  Selection rides
    # the producer-domain check instead — a table entry of -1 (or an
    # out-of-domain producer param tuple) makes the dep inactive for
    # that instance, exactly and statically.
    def _route(kinds, idxs, want):
        return _tab([idxs[k] if kinds[k] == want else -1
                     for k in range(len(kinds))])

    def _side_deps(kinds, idxs, cids):
        deps = [pt.In(pt.Ref(step_name, _route(kinds, idxs, 1), sl,
                             flow="R"))]
        if plan.leaves:
            deps.append(pt.In(pt.Ref(leaf_name, _route(kinds, idxs, 3),
                                     sl, flow="X")))
        if ext_in is not None:
            oob = ext_in.get("oob") or (-1,) * ext_in["nparams"]
            params = [
                _tab([ext_in["params_of"](c)[k]
                      if (kinds[j] == 4 and c is not None) else oob[k]
                      for j, c in enumerate(cids)])
                for k in range(ext_in["nparams"])]
            deps.append(pt.In(pt.Ref(ext_in["cls"], *params,
                                     flow=ext_in["flow"])))
        return deps

    a_deps = _side_deps(a_kind, a_idx, a_cid)
    b_deps = _side_deps(b_kind, b_idx, b_cid)
    step.flow("A", "READ", *a_deps, arena=arena)
    step.flow("B", "READ", *b_deps, arena=arena)
    step.flow("R", "W",
              pt.Out(pt.Ref(step_name, _tab(cons_idx), sl, flow="A"),
                     guard=_guard(cons_side, 0)),
              pt.Out(pt.Ref(step_name, _tab(cons_idx), sl, flow="B"),
                     guard=_guard(cons_side, 1)),
              arena=arena)

    def step_body(view):
        i, s = view["i"], view["sl"]
        e = ev[i]

        def side(kind, cid):
            if kind == 2:
                return np.ravel(local_read(cid, e.seg, s))
            return None

        a = side(a_kind[i], a_cid[i])
        if a is None and view.data_ptr("A"):
            a = view.data("A", dtype=dtype)
        b = side(b_kind[i], b_cid[i])
        if b is None and view.data_ptr("B"):
            b = view.data("B", dtype=dtype)
        if a is None:
            out = b
        elif b is None:
            out = a
        else:
            out = opf(a[:b.size] if a.size > b.size else a,
                      b[:a.size] if b.size > a.size else b)
        if view.data_ptr("R"):
            r = view.data("R", dtype=dtype)
            r[:out.size] = out
        if e.final and final_sink is not None:
            final_sink(e.seg, s, out)

    step.body(step_body)

    if plan.leaves:
        lv = plan.leaves
        leaf = tp.task_class(leaf_name)
        leaf.param("i", 0, len(lv) - 1)
        leaf.param("sl", 0, ns - 1)
        leaf.affinity(rankc, _tab([l["rank"] for l in lv]))
        leaf.flow("X", "W",
                  pt.Out(pt.Ref(step_name, _tab([l["cons"][0] for l in lv]),
                                sl, flow="B")),
                  arena=arena)

        def leaf_body(view):
            i, s = view["i"], view["sl"]
            src = np.ravel(local_read(lv[i]["cid"], lv[i]["seg"], s))
            x = view.data("X", dtype=dtype)
            x[:src.size] = src

        leaf.body(leaf_body)
    return step_name


def _emit_fanout(ctx, tp, uid: int, nseg: int, ns: int, nranks: int,
                 owner_of: Callable[[int], int], arena: str, dtype,
                 src_in: Optional[Callable] = None,
                 src_read: Optional[Callable] = None,
                 sink: Optional[Callable] = None,
                 tmodel=None):
    """src(s, sl) on the owner -> Range broadcast to every other rank's
    gw(s, q, sl), each sinking the slice locally.  The wire propagation
    of the one-to-all leg follows the NATIVE bcast topology in force
    (ctx.comm_set_topology): star / chain / binomial trees.

    With a multi-island `tmodel` (hier fan-out, ptc-topo) a lead(s, li,
    sl) class is inserted on each REMOTE island's leader: src sends once
    per remote island (the only DCN crossings), each lead re-fans to its
    island's members at ici cost, and src feeds its own island's members
    directly.  gw instances enumerate followers (non-owner, non-lead
    ranks) with owner-island followers first, so the src->local and
    lead->members legs are contiguous Range fans selected by guarded
    Out deps + -1-routed In deps (the _emit_reduce discipline)."""
    src_name = f"ptc_coll_{uid}_src"
    gw_name = f"ptc_coll_{uid}_gw"
    lead_name = f"ptc_coll_{uid}_lead"
    rankc = rank_affinity_collection(ctx)
    s, q, sl = pt.L("s"), pt.L("q"), pt.L("sl")
    owner_tab = [owner_of(i) for i in range(nseg)]
    owner_e = pt.call(lambda locs, g, t=owner_tab: t[locs[0]],
                      pure=True)
    hier = tmodel is not None and tmodel.n_islands > 1 and nranks > 1
    if hier:
        nlead = tmodel.n_islands - 1
        nfol = nranks - 1 - nlead
        lead_rank, fan_rank, n_local, flo, fhi, li_of = [], [], [], [], [], []
        for seg in range(nseg):
            owner = owner_tab[seg]
            oi = tmodel.island_of(owner)
            others = [i for i in range(tmodel.n_islands) if i != oi]
            lead_rank.append([tmodel.leader_of(i) for i in others])
            fr = [r for r in tmodel.island_ranks(oi) if r != owner]
            n_local.append(len(fr))
            lo_row, hi_row = [], []
            for i in others:
                lead = tmodel.leader_of(i)
                mem = [r for r in tmodel.island_ranks(i) if r != lead]
                lo_row.append(len(fr))
                fr.extend(mem)
                hi_row.append(len(fr) - 1)
            fan_rank.append(fr)
            flo.append(lo_row)
            fhi.append(hi_row)
            li_of.append([next((li for li in range(nlead)
                                if lo_row[li] <= p <= hi_row[li]), 0)
                          for p in range(len(fr))])

    src = tp.task_class(src_name)
    src.param("s", 0, nseg - 1)
    src.param("sl", 0, ns - 1)
    src.affinity(rankc, owner_e)
    src.flow("X", "READ", *( [src_in(s, sl)] if src_in else [] ),
             arena=arena)
    o_deps = []
    if hier:
        o_deps.append(pt.Out(pt.Ref(lead_name, s, pt.Range(0, nlead - 1),
                                    sl, flow="X")))
        if nfol > 0:
            o_deps.append(pt.Out(
                pt.Ref(gw_name, s,
                       pt.Range(0, pt.call(
                           lambda l, g, t=n_local: t[l[0]] - 1,
                           pure=True)),
                       sl, flow="X"),
                guard=pt.call(lambda l, g, t=n_local:
                              1 if t[l[0]] > 0 else 0, pure=True)))
    elif nranks > 1:
        o_deps.append(pt.Out(pt.Ref(gw_name, s, pt.Range(0, nranks - 2),
                                    sl, flow="X")))
    src.flow("O", "W", *o_deps, arena=arena)

    def src_body(view):
        i, slc = view["s"], view["sl"]
        if view.data_ptr("X"):
            x = view.data("X", dtype=dtype)
        else:
            x = np.ravel(src_read(i, slc))
        if view.data_ptr("O"):
            o = view.data("O", dtype=dtype)
            o[:x.size] = x
        if sink is not None:
            sink(i, slc, x)

    src.body(src_body)

    if hier:
        lead = tp.task_class(lead_name)
        lead.param("s", 0, nseg - 1)
        lead.param("li", 0, nlead - 1)
        lead.param("sl", 0, ns - 1)
        lead.affinity(rankc, pt.call(
            lambda l, g, t=lead_rank: t[l[0]][l[1]], pure=True))
        lead.flow("X", "READ", pt.In(pt.Ref(src_name, s, sl, flow="O")),
                  arena=arena)
        fan_deps = []
        if nfol > 0:
            fan_deps.append(pt.Out(
                pt.Ref(gw_name, s,
                       pt.Range(pt.call(lambda l, g, t=flo: t[l[0]][l[1]],
                                        pure=True),
                                pt.call(lambda l, g, t=fhi: t[l[0]][l[1]],
                                        pure=True)),
                       sl, flow="X"),
                guard=pt.call(lambda l, g, lo=flo, hi=fhi:
                              1 if hi[l[0]][l[1]] >= lo[l[0]][l[1]] else 0,
                              pure=True)))
        lead.flow("O", "W", *fan_deps, arena=arena)

        def lead_body(view):
            i, slc = view["s"], view["sl"]
            x = view.data("X", dtype=dtype)
            if view.data_ptr("O"):
                o = view.data("O", dtype=dtype)
                o[:x.size] = x
            if sink is not None:
                sink(i, slc, x)

        lead.body(lead_body)

    if (hier and nfol > 0) or (not hier and nranks > 1):
        gw = tp.task_class(gw_name)
        gw.param("s", 0, nseg - 1)
        gw.param("q", 0, (nfol - 1) if hier else (nranks - 2))
        gw.param("sl", 0, ns - 1)
        if hier:
            gw.affinity(rankc, pt.call(
                lambda l, g, t=fan_rank: t[l[0]][l[1]], pure=True))
            # exactly one producer per instance: src for owner-island
            # followers, the island's lead otherwise — the inactive dep
            # routes to -1 (out-of-domain), never a dynamic guard
            gw.flow(
                "X", "READ",
                pt.In(pt.Ref(src_name,
                             pt.call(lambda l, g, t=n_local:
                                     l[0] if l[1] < t[l[0]] else -1,
                                     pure=True),
                             sl, flow="O")),
                pt.In(pt.Ref(lead_name,
                             pt.call(lambda l, g, t=n_local:
                                     l[0] if l[1] >= t[l[0]] else -1,
                                     pure=True),
                             pt.call(lambda l, g, t=li_of: t[l[0]][l[1]],
                                     pure=True),
                             sl, flow="O")),
                arena=arena)
        else:
            gw.affinity(rankc, (owner_e + 1 + q) % nranks)
            gw.flow("X", "READ", pt.In(pt.Ref(src_name, s, sl, flow="O")),
                    arena=arena)

        def gw_body(view):
            if sink is not None:
                sink(view["s"], view["sl"],
                     view.data("X", dtype=dtype))

        gw.body(gw_body)
    return src_name


def _set_fanout_topo(ctx, topo: str):
    ctx.comm_set_topology(_NATIVE_TOPO[topo])


def _restore_topo(ctx):
    from ..utils import params as _mca
    ctx.comm_set_topology(_mca.get("comm.bcast_topo"))


# --------------------------------------------------------------------
# array-level primitives
# --------------------------------------------------------------------

def _prep(local: np.ndarray, nseg: int, op: str,
          cls: Optional[str] = None):
    """Pad the flat local contribution into (nseg, ns, slice_elems) work
    form; padding holds the op identity so sliced reduction of a length
    not divisible by nseg*ns stays exact."""
    flat = np.ravel(local)
    seg_elems = math.ceil(flat.size / nseg) if nseg else 0
    ns, slice_elems = _slicing(seg_elems * flat.itemsize, flat.itemsize,
                               cls)
    work = np.full((nseg, ns, slice_elems), _op_identity(op, flat.dtype),
                   dtype=flat.dtype)
    np.ravel(work)[:flat.size] = flat
    return work, seg_elems, ns, slice_elems


def _run(ctx, tp):
    tp.run()
    tp.wait()


def reduce_scatter(ctx, local: np.ndarray, op: str = "sum",
                   topo: Optional[str] = None) -> np.ndarray:
    """Elementwise-reduce the ranks' equally-shaped `local` arrays and
    return THIS rank's 1/R segment of the result (flat)."""
    R = max(1, ctx.nodes)
    flat = np.ravel(local)
    if R == 1 or not ctx.comm_enabled:
        return flat.copy()
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    topo = econ.choose_topology("reduce", flat.nbytes, R, override=topo,
                                cls=cls, tmodel=tmodel)
    _record(ctx, "reduce_scatter", topo)
    work, seg_elems, ns, slice_elems = _prep(local, R, op, cls)
    out = np.zeros((ns, slice_elems), dtype=flat.dtype)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    plan = _plan_reduce(R, R, lambda s: s,
                        lambda s: [(r, r) for r in range(R)], topo, False,
                        tmodel=tmodel)
    tp = pt.Taskpool(ctx)
    _emit_reduce(ctx, tp, uid, plan, ns, arena, OPS[op][0], flat.dtype,
                 local_read=lambda cid, seg, s: work[seg, s],
                 final_sink=lambda seg, s, arr:
                     out[s].__setitem__(slice(None, arr.size), arr))
    _run(ctx, tp)
    lo = ctx.myrank * seg_elems
    return np.ravel(out)[:max(0, min(flat.size, lo + seg_elems) - lo)]


def all_reduce(ctx, local: np.ndarray, op: str = "sum",
               topo: Optional[str] = None) -> np.ndarray:
    """Elementwise-reduce across ranks, result replicated on every rank
    (same shape as `local`).  Reduce-scatter events feed the fan-out src
    tasks directly (Ref, not memory), so segment k's broadcast starts
    while segment k+1 is still reducing."""
    R = max(1, ctx.nodes)
    flat = np.ravel(local)
    if R == 1 or not ctx.comm_enabled:
        return local.copy()
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    rtopo = econ.choose_topology("reduce", flat.nbytes, R, override=topo,
                                 cls=cls, tmodel=tmodel)
    ftopo = econ.choose_topology("fanout", flat.nbytes // R, R,
                                 override=topo, cls=cls, tmodel=tmodel)
    _record(ctx, "all_reduce", rtopo)
    work, seg_elems, ns, slice_elems = _prep(local, R, op, cls)
    out = np.zeros((R, ns, slice_elems), dtype=flat.dtype)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    plan = _plan_reduce(R, R, lambda s: s,
                        lambda s: [(r, r) for r in range(R)], rtopo, False,
                        tmodel=tmodel)
    tp = pt.Taskpool(ctx)
    step_name = _emit_reduce(
        ctx, tp, uid, plan, ns, arena, OPS[op][0], flat.dtype,
        local_read=lambda cid, seg, s: work[seg, s])
    # wire the final reduce event of each segment into its fan-out src
    fin = pt.call(lambda locs, g, t=plan.final_of: t[locs[0]],
                  pure=True)
    sl = pt.L("sl")
    tp.class_by_name(step_name).flows[2].deps.append(
        pt.Out(pt.Ref(f"ptc_coll_{uid}_src", _tab(
            [plan.events[i].seg for i in range(len(plan.events))]), sl,
            flow="X"),
            guard=_tab([1 if e.final else 0 for e in plan.events])))
    _set_fanout_topo(ctx, ftopo)
    _emit_fanout(ctx, tp, uid, R, ns, R, lambda s: s, arena, flat.dtype,
                 src_in=lambda s, slc: pt.In(
                     pt.Ref(step_name, fin, slc, flow="R")),
                 sink=lambda s, slc, arr:
                     out[s, slc].__setitem__(slice(None, arr.size), arr),
                 tmodel=tmodel if ftopo == HIER else None)
    try:
        _run(ctx, tp)
    finally:
        _restore_topo(ctx)
    full = np.ravel(out.reshape(R, -1)[:, :seg_elems])[:flat.size]
    return full.reshape(local.shape).astype(flat.dtype, copy=False)


def all_gather(ctx, local: np.ndarray,
               topo: Optional[str] = None) -> np.ndarray:
    """Concatenate the ranks' `local` arrays (rank order) on every rank.
    Returns a flat array of R * local.size elements."""
    R = max(1, ctx.nodes)
    flat = np.ravel(local)
    if R == 1 or not ctx.comm_enabled:
        return flat.copy()
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    topo = econ.choose_topology("fanout", flat.nbytes, R, override=topo,
                                cls=cls, tmodel=tmodel)
    _record(ctx, "all_gather", topo)
    ns, slice_elems = _slicing(flat.nbytes, flat.itemsize, cls)
    work = np.zeros((ns, slice_elems), dtype=flat.dtype)
    np.ravel(work)[:flat.size] = flat
    out = np.zeros((R, ns, slice_elems), dtype=flat.dtype)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    tp = pt.Taskpool(ctx)
    _set_fanout_topo(ctx, topo)
    _emit_fanout(ctx, tp, uid, R, ns, R, lambda s: s, arena, flat.dtype,
                 src_read=lambda s, slc: work[slc],
                 sink=lambda s, slc, arr:
                     out[s, slc].__setitem__(slice(None, arr.size), arr),
                 tmodel=tmodel if topo == HIER else None)
    try:
        _run(ctx, tp)
    finally:
        _restore_topo(ctx)
    return np.ravel(out.reshape(R, -1)[:, :flat.size])


def broadcast(ctx, buf: np.ndarray, root: int = 0,
              topo: Optional[str] = None) -> np.ndarray:
    """Broadcast `buf` from `root` (every rank passes a same-shape/dtype
    array; the root's values win).  Returns the received array."""
    R = max(1, ctx.nodes)
    flat = np.ravel(buf)
    if R == 1 or not ctx.comm_enabled:
        return buf.copy()
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    topo = econ.choose_topology("fanout", flat.nbytes, R, override=topo,
                                cls=cls, tmodel=tmodel)
    _record(ctx, "broadcast", topo)
    ns, slice_elems = _slicing(flat.nbytes, flat.itemsize, cls)
    work = np.zeros((ns, slice_elems), dtype=flat.dtype)
    if ctx.myrank == root:
        np.ravel(work)[:flat.size] = flat
    out = np.zeros((ns, slice_elems), dtype=flat.dtype)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    tp = pt.Taskpool(ctx)
    _set_fanout_topo(ctx, topo)
    _emit_fanout(ctx, tp, uid, 1, ns, R, lambda s: root, arena,
                 flat.dtype,
                 src_read=lambda s, slc: work[slc],
                 sink=lambda s, slc, arr:
                     out[slc].__setitem__(slice(None, arr.size), arr),
                 tmodel=tmodel if topo == HIER else None)
    try:
        _run(ctx, tp)
    finally:
        _restore_topo(ctx)
    return np.ravel(out)[:flat.size].reshape(buf.shape)


def restore_topology(ctx):
    """Put the configured default broadcast topology back on the comm
    layer.  In-pool emissions (all_reduce_into, RefReduce(bcast=True))
    leave the chosen fanout topology set — a per-pool restore would race
    other live pools — so a long-lived program restores once on
    teardown."""
    _restore_topo(ctx)


def all_reduce_into(ctx, tp, local: np.ndarray, op: str = "sum",
                    topo: Optional[str] = None) -> np.ndarray:
    """Emit an all-reduce INTO the caller's live taskpool `tp` (ptc-shard
    satellite of the RefReduce machinery): the same ptc_coll_* step /
    leaf / src / gw chains the standalone all_reduce builds, but fused
    into an application pool the caller runs — the collective overlaps
    whatever else that pool is doing instead of bulk-synchronizing.

    Returns a result array (same shape as `local`): ZERO-FILLED now,
    written by the fan-out sink tasks as the pool executes — valid after
    the caller's tp.run()/wait().  The chosen fanout topology stays set
    on the ctx (see restore_topology)."""
    R = max(1, ctx.nodes)
    flat = np.ravel(local)
    res = np.zeros(local.shape, dtype=flat.dtype)
    if R == 1 or not ctx.comm_enabled:
        np.ravel(res)[...] = flat
        return res
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    rtopo = econ.choose_topology("reduce", flat.nbytes, R, override=topo,
                                 cls=cls, tmodel=tmodel)
    ftopo = econ.choose_topology("fanout", flat.nbytes // R, R,
                                 override=topo, cls=cls, tmodel=tmodel)
    _record(ctx, "all_reduce_into", rtopo)
    work, seg_elems, ns, slice_elems = _prep(local, R, op, cls)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    plan = _plan_reduce(R, R, lambda s: s,
                        lambda s: [(r, r) for r in range(R)], rtopo, False,
                        tmodel=tmodel)
    step_name = _emit_reduce(
        ctx, tp, uid, plan, ns, arena, OPS[op][0], flat.dtype,
        local_read=lambda cid, seg, s: work[seg, s])
    fin = pt.call(lambda locs, g, t=plan.final_of: t[locs[0]],
                  pure=True)
    sl = pt.L("sl")
    tp.class_by_name(step_name).flows[2].deps.append(
        pt.Out(pt.Ref(f"ptc_coll_{uid}_src", _tab(
            [plan.events[i].seg for i in range(len(plan.events))]), sl,
            flow="X"),
            guard=_tab([1 if e.final else 0 for e in plan.events])))
    rf = np.ravel(res)

    def sink(s, slc, arr, rf=rf, se=seg_elems, sl_e=slice_elems,
             n=flat.size):
        # work layout rows are ns*slice_elems wide but a segment's
        # LOGICAL payload is seg_elems: clip each slice to its own
        # segment so identity padding never bleeds into the next one
        base = s * se
        lo = base + slc * sl_e
        hi = min(lo + arr.size, base + se, n)
        if hi > lo:
            rf[lo:hi] = arr[:hi - lo]

    _set_fanout_topo(ctx, ftopo)
    _emit_fanout(ctx, tp, uid, R, ns, R, lambda s: s, arena, flat.dtype,
                 src_in=lambda s, slc: pt.In(
                     pt.Ref(step_name, fin, slc, flow="R")),
                 sink=sink,
                 tmodel=tmodel if ftopo == HIER else None)
    return res


def reduce_scatter_into(ctx, tp, local: np.ndarray, op: str = "sum",
                        topo: Optional[str] = None) -> np.ndarray:
    """Emit a reduce-scatter INTO the caller's live taskpool (see
    all_reduce_into).  Returns this rank's 1/R segment buffer (flat):
    zero-filled now, written by the final reduce events as the pool
    executes."""
    R = max(1, ctx.nodes)
    flat = np.ravel(local)
    if R == 1 or not ctx.comm_enabled:
        return flat.copy()
    econ = default_economics()
    tmodel = default_topology(R)
    cls = _mesh_class(tmodel)
    rtopo = econ.choose_topology("reduce", flat.nbytes, R, override=topo,
                                 cls=cls, tmodel=tmodel)
    _record(ctx, "reduce_scatter_into", rtopo)
    work, seg_elems, ns, slice_elems = _prep(local, R, op, cls)
    seg_len = max(0, min(flat.size - ctx.myrank * seg_elems, seg_elems))
    res = np.zeros(seg_len, dtype=flat.dtype)
    uid = _next_uid(ctx)
    arena = f"__ptc_coll_{uid}"
    ctx.register_arena(arena, slice_elems * flat.itemsize)
    plan = _plan_reduce(R, R, lambda s: s,
                        lambda s: [(r, r) for r in range(R)], rtopo, False,
                        tmodel=tmodel)

    def sink(seg, s, arr, me=ctx.myrank, sl_e=slice_elems, n=seg_len):
        if seg != me:
            return
        lo = s * sl_e
        hi = min(lo + arr.size, n)
        if hi > lo:
            res[lo:hi] = arr[:hi - lo]

    _emit_reduce(ctx, tp, uid, plan, ns, arena, OPS[op][0], flat.dtype,
                 local_read=lambda cid, seg, s: work[seg, s],
                 final_sink=sink)
    return res


# --------------------------------------------------------------------
# Ref-contributed reduction (collectives INSIDE an application taskpool)
# --------------------------------------------------------------------

class RefReduce:
    """Reduce task-produced contributions (gemm panel partials, moe
    per-expert combines) into per-segment roots inside an EXISTING
    taskpool, optionally fanning the result back out (all-reduce shape).

    The producer class declares `producer_out_deps(...)` on its output
    flow; each contribution then flows straight into its reduction step
    as an ordinary dependency — the collective starts when the FIRST
    contribution finishes, not when all of them do."""

    def __init__(self, ctx, tp, nseg: int,
                 contributors_of: Callable[[int], Sequence[Tuple[int, object]]],
                 root_of: Callable[[int], int],
                 prod_class: str, prod_flow: str, prod_nparams: int,
                 prod_params_of: Callable[[object], Tuple[int, ...]],
                 arena_bytes: int, dtype, op: str = "sum",
                 topo: Optional[str] = None, bcast: bool = False,
                 final_sink: Optional[Callable] = None,
                 fanout_sink: Optional[Callable] = None):
        R = max(1, ctx.nodes)
        econ = default_economics()
        tmodel = default_topology(R)
        cls = _mesh_class(tmodel)
        self.topo = econ.choose_topology("reduce", arena_bytes, R,
                                         override=topo, cls=cls,
                                         tmodel=tmodel)
        _record(ctx, "ref_reduce", self.topo)
        self.uid = _next_uid(ctx)
        self.arena = f"__ptc_coll_{self.uid}"
        ctx.register_arena(self.arena, arena_bytes)
        self.plan = _plan_reduce(nseg, R, root_of, contributors_of,
                                 self.topo, ext=True, tmodel=tmodel)
        self.step_name = _emit_reduce(
            ctx, tp, self.uid, self.plan, 1, self.arena, OPS[op][0],
            dtype, final_sink=final_sink,
            ext_in={"cls": prod_class, "flow": prod_flow,
                    "nparams": prod_nparams,
                    "params_of": prod_params_of})
        if bcast:
            ftopo = econ.choose_topology("fanout", arena_bytes, R,
                                         override=topo, cls=cls,
                                         tmodel=tmodel)
            _set_fanout_topo(ctx, ftopo)
            fin = pt.call(
                lambda locs, g, t=self.plan.final_of: t[locs[0]],
                pure=True)
            sl = pt.L("sl")
            tp.class_by_name(self.step_name).flows[2].deps.append(
                pt.Out(pt.Ref(f"ptc_coll_{self.uid}_src",
                              _tab([e.seg for e in self.plan.events]),
                              sl, flow="X"),
                       guard=_tab([1 if e.final else 0
                                   for e in self.plan.events])))
            _emit_fanout(ctx, tp, self.uid, nseg, 1, R, root_of,
                         self.arena, dtype,
                         src_in=lambda s, slc: pt.In(
                             pt.Ref(self.step_name, fin, slc, flow="R")),
                         sink=fanout_sink,
                         tmodel=tmodel if ftopo == HIER else None)

    def producer_out_deps(self, cid_of: Callable) -> List:
        """Out deps for the producer's output flow.  cid_of(locals,
        globals) -> this instance's contributor id (must match the ids
        from contributors_of)."""
        route = self.plan.ext_route

        def g(side):
            return pt.call(lambda l, gl, side=side:
                           1 if route[cid_of(l, gl)][1] == side else 0,
                           pure=True)

        idx = pt.call(lambda l, gl: route[cid_of(l, gl)][0],
                      pure=True)
        return [pt.Out(pt.Ref(self.step_name, idx, 0, flow="A"),
                       guard=g(0)),
                pt.Out(pt.Ref(self.step_name, idx, 0, flow="B"),
                       guard=g(1))]

    def final_in_dep(self, seg_local_index: int = 0):
        """In dep on the final reduced value, for a consumer task whose
        local number `seg_local_index` holds the segment id (e.g. a
        store task adding the combine result into memory)."""
        fin = pt.call(lambda l, g, t=self.plan.final_of:
                      t[l[seg_local_index]], pure=True)
        return pt.In(pt.Ref(self.step_name, fin, 0, flow="R"))

    def wire_final_consumer(self, tp, cons_class: str, cons_flow: str,
                            cons_params_of: Callable[[int], Tuple[int, ...]]):
        """Declare the step->consumer edges for final events: the
        consumer instance of segment `seg` is cons_params_of(seg)."""
        evs = self.plan.events
        params = [
            _tab([cons_params_of(e.seg)[k] if e.final else 0
                  for e in evs])
            for k in range(len(cons_params_of(evs[0].seg)))]
        tp.class_by_name(self.step_name).flows[2].deps.append(
            pt.Out(pt.Ref(cons_class, *params, flow=cons_flow),
                   guard=_tab([1 if e.final else 0 for e in evs])))

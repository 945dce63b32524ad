"""ptc-plan: static resource & schedule analysis over PTG flow graphs.

PTG's problem-size-independent symbolic task graph makes ahead-of-time
quantitative analysis possible — the feasibility question the TPU
distributed-LA work poses ("does the working set fit?", arXiv:2112.09017)
can be answered before anything runs.  This module computes, from the
`flowgraph` extraction (engine-exact concretized instance DAG):

  liveness    per-rank peak tile residency in bytes, two numbers per
              rank over a topological wave schedule:
                peak_bytes       the no-eviction working set (what the
                                 device's LRU actually holds when under
                                 budget — the ground-truth-matching
                                 "predicted peak" of the plan-vs-measured
                                 tests)
                live_peak_bytes  the interval-liveness lower bound (the
                                 residency NO schedule can avoid: when
                                 even this exceeds the budget, spilling
                                 is certain, not just likely)
              plus the wave decomposition itself — ready fronts grouped
              by task class per rank, the fusable-wave artifact ROADMAP
              item 2's mega-kernelization (MPK, arXiv:2512.22219) needs
  comm        per-rank and per-(src, dst) delivery-edge bytes from the
              rank mapping (affinity rank_of) of every concretized edge,
              deduplicated per (producer instance, flow, destination
              rank) exactly like the wire's per-rank activation fanout,
              split eager vs rendezvous at the fitted transfer-economics
              threshold (comm/economics.py)
  makespan    critical-path and work/p lower bounds under a per-class
              cost model seeded from the always-on latency
              histograms (or a recorded JSON profile), reported next to
              the *executed* critical path by tools/ptc_plan.py so
              predicted-vs-measured is a first-class regression signal

Two modes, like the verifier: exact bounded enumeration (default), and
a symbolic interval fallback for execution spaces past `max_instances`
— the residency bound degrades to per-class interval counting with an
explicit note, never a silent truncation.

Consumers: `Taskpool.plan()`, the serving front door's admission bytes
(serve/server.py: an unknown `est_bytes` falls back to the static
bound), the device pre-run `plan_check` (device.plan_check knob), and
the `tools/ptc_plan.py` CLI / `make plan-graphs` baseline.

Port of parsec_tpu/analysis/plan.py.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from .. import _native as N
from .flowgraph import (ConcreteGraph, FlowGraph, collection_tile_bytes,
                        extract_flowgraph)

# modeled wire envelope per cross-rank message (frame header + dep
# payload descriptors + rendezvous GET/ACK round), and a static
# control-plane allowance per rank (hello/fence/clock-sync/metrics
# frames): the comm-volume *bound* must stay >= the measured per-rank
# bytes_sent, which counts those frames too
WIRE_ENVELOPE_BYTES = 512
WIRE_STATIC_BYTES = 256 * 1024

DEFAULT_TASK_NS = 1_000


class PlanCheckError(RuntimeError):
    """Raised by the device pre-run plan_check (device.plan_check=error)
    when the predicted device working set exceeds the byte budget and
    out-of-core execution is disabled — the run would pin HBM past
    budget until it OOMs."""


# ------------------------------------------------------------ cost model
class CostModel:
    """Per-class execution-cost model (nanoseconds per instance).

    Sources, best first: a live context's always-on per-class EXEC
    histograms (p50 — `from_context`), a recorded JSON profile
    (`from_json`: {"classes": {name: ns}} or a flat {name: ns}), or the
    uniform default.  `source` names where the numbers came from so a
    plan's makespan bound is auditable."""

    def __init__(self, costs: Optional[Dict[str, float]] = None,
                 default_ns: float = DEFAULT_TASK_NS,
                 source: str = "uniform"):
        self.costs = dict(costs or {})
        self.default_ns = float(default_ns)
        self.source = source

    def ns(self, cls_name: str) -> float:
        return self.costs.get(cls_name, self.default_ns)

    @classmethod
    def from_context(cls, ctx, merged: bool = False) -> Optional["CostModel"]:
        """Seed from the always-on metrics histograms: per-class EXEC p50.
        None when no class has samples yet (cold context)."""
        try:
            hists = ctx.metrics_histograms(merged=merged)
        except Exception:
            return None
        costs = {h.name: h.quantile(0.50) for h in hists
                 if h.kind == N.MET_EXEC and h.name and h.count > 0}
        costs = {k: v for k, v in costs.items() if v > 0}
        if not costs:
            return None
        med = sorted(costs.values())[len(costs) // 2]
        return cls(costs, default_ns=med, source="metrics")

    @classmethod
    def from_json(cls, path: str) -> "CostModel":
        """Load a recorded profile: {"classes": {name: ns}, ...} (the
        ptc_plan --profile schema) or a flat {name: ns} mapping."""
        with open(path) as f:
            doc = json.load(f)
        costs = doc.get("classes", doc) if isinstance(doc, dict) else {}
        costs = {str(k): float(v) for k, v in costs.items()
                 if isinstance(v, (int, float)) and v > 0}
        default = float(doc.get("default_ns", DEFAULT_TASK_NS)) \
            if isinstance(doc, dict) else DEFAULT_TASK_NS
        return cls(costs, default_ns=default, source=path)

    def recalibrated(self, ratios: Dict[str, float],
                     fallback: float = 1.0) -> "CostModel":
        """ptc-pilot: fold live measured/planned calibration ratios
        (scope conformance `per_class[cls]["ratio"]`) into a NEW model
        — each named class's cost scales by its ratio, classes without
        a live ratio (and the default) scale by `fallback` (typically
        the window's median makespan ratio).  The original is never
        mutated: the planner that produced it may still be in use."""
        fb = max(0.0, float(fallback)) or 1.0
        costs = {cls: ns * max(0.0, float(ratios.get(cls, fb)) or fb)
                 for cls, ns in self.costs.items()}
        return CostModel(costs, default_ns=self.default_ns * fb,
                         source=f"{self.source}+recalibrated")

    def to_json(self) -> dict:
        return {"source": self.source, "default_ns": self.default_ns,
                "classes": dict(self.costs)}


def _eager_threshold(ctx, econ=None) -> int:
    """The eager/rendezvous split the comm volume analysis models:
    the live engine's effective threshold when comm is up, else the
    fitted transfer-economics crossover (falling back to the static
    comm.eager_limit param)."""
    try:
        if getattr(ctx, "comm_enabled", False):
            lim = int(ctx.comm_tuning()["eager_limit"])
            if lim > 0:
                return lim
    except Exception:
        pass
    from ..utils import params as _mca
    try:
        fallback = int(_mca.get("comm.eager_limit"))
    except (TypeError, ValueError):
        fallback = 64 * 1024
    if econ is None:
        from ..comm.economics import default_economics
        econ = default_economics()
    return econ.eager_threshold(fallback)


# ------------------------------------------------------------------ plan
class Plan:
    """One pool's static resource & schedule analysis result."""

    def __init__(self, fg: FlowGraph):
        self.fg = fg
        self.cg: Optional[ConcreteGraph] = None
        self.bounded = False          # True = symbolic fallback
        self.notes: List[str] = []
        self.stats: Dict[str, object] = {}
        # per-rank rows: tasks, work_ns, peak_bytes, live_peak_bytes,
        # device_{peak,live_peak}_bytes, comm_{out,in}_bytes,
        # comm_out_msgs, eager_bytes, rdv_bytes, wire_out_bound
        self.per_rank: Dict[int, Dict[str, int]] = {}
        self.edges_bytes: Dict[Tuple[int, int], int] = {}
        self.edges_msgs: Dict[Tuple[int, int], int] = {}
        # collective sub-matrix: (src, dst) -> {"bytes", "msgs"} for
        # edges whose producer is a ptc_coll_* chain class (ptc-shard:
        # the embedded tensor-parallel reduction legs, costed per link
        # class by coll_legs())
        self.coll_edges: Dict[Tuple[int, int], Dict[str, int]] = {}
        # per-rank wave tables: rank -> [{"wave", "tasks", "classes"}]
        self.waves: Dict[int, List[dict]] = {}
        # wave-fusability certificates: one record per (rank, wave) —
        # the MPK-prep artifact: an explicit
        # certify/refuse verdict for every wave, machine-readable
        self.fusability: List[dict] = []
        # wave-chain certificates: one record per adjacent pair of
        # certified waves — `linked` proves the producer wave feeds the
        # consumer wave rank-locally with matching tile signatures, so
        # the device wave compiler (device/fuse.py) may compile both
        # into ONE multi-wave executable; refusals carry reasons
        self.chains: List[dict] = []
        # rank -> (producer cls, params) -> [consumer link dicts]; the
        # runtime consumption side of the chain certificates (see
        # chain_index())
        self._chain_links: Dict[int, Dict[tuple, list]] = {}
        self._chain_classes: Dict[str, dict] = {}
        self.makespan: Dict[str, object] = {}
        self.eager_limit = 0
        self.has_device_classes = False
        # internal: spill-simulation inputs (concrete mode only)
        self._touch: Dict[Tuple[int, str], Dict[object, List[int]]] = {}
        self._dirty_from: Dict[Tuple[int, str], Dict[object, int]] = {}
        self._persistent: Dict[object, bool] = {}
        self._datum_bytes: Dict[object, int] = {}
        self._symbolic_peak: Optional[int] = None

    # ----------------------------------------------------------- queries
    def ranks(self) -> List[int]:
        return sorted(self.per_rank)

    def peak_bytes(self, rank: Optional[int] = None,
                   device_only: bool = False) -> Optional[int]:
        """Predicted peak residency in bytes: the no-eviction working
        set (max over ranks when `rank` is None).  device_only=True
        restricts to data touched by device-chore classes (what the
        device cache actually stages)."""
        key = "device_peak_bytes" if device_only else "peak_bytes"
        if self.bounded:
            return self._symbolic_peak
        rows = ([self.per_rank[rank]] if rank is not None
                else list(self.per_rank.values()))
        if not rows:
            return 0
        return max(r[key] for r in rows)

    def live_peak_bytes(self, rank: Optional[int] = None,
                        device_only: bool = False) -> Optional[int]:
        """Interval-liveness lower bound on residency (the bytes no
        schedule can avoid holding simultaneously)."""
        if self.bounded:
            return None
        key = ("device_live_peak_bytes" if device_only
               else "live_peak_bytes")
        rows = ([self.per_rank[rank]] if rank is not None
                else list(self.per_rank.values()))
        if not rows:
            return 0
        return max(r[key] for r in rows)

    def est_bytes(self, discount_bytes: int = 0,
                  rank: Optional[int] = None) -> Optional[int]:
        """Admission-control byte estimate: the pool's global working
        set (sum of per-rank peaks — every rank holds its own mirrors).
        None only when the symbolic fallback could not bound it.

        `discount_bytes` subtracts working-set bytes the caller knows
        are ALREADY resident and shared (ptc-share: prompt pages
        predicted to map onto frozen prefix-cache pages cost admission
        nothing); the estimate never discounts below 1 byte, so a
        known bound stays distinguishable from the <=0 UNKNOWN
        sentinel serve admission uses.

        `rank` restricts the estimate to ONE rank's peak (ptc-shard:
        a tensor-parallel pool holds 1/R of the weights and KV pages
        per rank, so per-rank admission must not be charged the global
        sum — each rank's server admits against its own residency)."""
        if self.bounded:
            total = self._symbolic_peak
        elif rank is not None:
            row = self.per_rank.get(rank)
            total = row["peak_bytes"] if row is not None else 0
        else:
            total = sum(r["peak_bytes"] for r in self.per_rank.values())
        if total is None:
            return None
        disc = max(0, int(discount_bytes or 0))
        if disc and total > 0:
            total = max(1, total - disc)
        return total

    def comm_bytes(self) -> int:
        return sum(self.edges_bytes.values())

    def fusable_waves(self, rank: Optional[int] = None) -> int:
        """Number of waves certified fusable (one cached executable per
        wave, à la MPK): homogeneous, fusion-eligible bodies, no
        intra-wave dependency or datum conflict, matching tile
        signatures."""
        return sum(1 for c in self.fusability
                   if c["fusable"] and (rank is None or c["rank"] == rank))

    def chained_waves(self, rank: Optional[int] = None) -> int:
        """Number of certified chain LINKS (adjacent wave pairs the
        device wave compiler may fuse into one multi-wave executable)."""
        return sum(1 for c in self.chains
                   if c["linked"] and (rank is None or c["rank"] == rank))

    def chain_index(self, rank: int = 0) -> dict:
        """Certificate-consumption view for the device wave compiler:

          classes  {cls_name: {"id", "param_slots"}} — param_slots are
                   the native local-variable indices whose values form
                   the instance key (the same tuple order the
                   concretized graph uses), so the device can key a
                   LIVE task to its certificate lane with a handful of
                   ptc_task_local reads
          links    {(producer cls, params): [consumer dicts]} for this
                   rank; each consumer dict carries its class, params
                   and per-read-flow input spec:
                     ("wave", producer_params, producer_flow) — comes
                        from the producer wave's output (in-program)
                     ("mem", collection, idx) — an external collection
                        tile, fetchable at speculation time

        Every spec is STATIC; the runtime re-validates all of it
        against live copy versions at consumption, so a stale index can
        only cost a wasted speculation, never a wrong answer."""
        return {"classes": dict(self._chain_classes),
                "links": dict(self._chain_links.get(rank, {}))}

    def wire_out_bound(self, rank: int,
                       cls: Optional[str] = None) -> int:
        """Upper bound on the rank's wire bytes_sent: payload out plus
        the modeled per-message envelope and static control-plane
        allowance.  With `cls` (ptc-topo link class: "host"/"ici"/
        "dcn") only the edges of that class count — the per-class bound
        the topo soak checks against the measured per-class split."""
        if cls is not None:
            tmodel = self._tmodel()
            payload = msgs = 0
            for (s, d), b in self.edges_bytes.items():
                if s == rank and tmodel.class_of(s, d) == cls:
                    payload += b
                    msgs += self.edges_msgs.get((s, d), 0)
            return payload + msgs * WIRE_ENVELOPE_BYTES \
                + WIRE_STATIC_BYTES
        row = self.per_rank.get(rank)
        if row is None:
            return WIRE_STATIC_BYTES
        return (row["comm_out_bytes"]
                + row["comm_out_msgs"] * WIRE_ENVELOPE_BYTES
                + WIRE_STATIC_BYTES)

    # --------------------------------------------- topology (ptc-topo)
    def _nranks_hint(self) -> int:
        n = 0
        for r in self.per_rank:
            n = max(n, int(r) + 1)
        for (s, d) in self.edges_bytes:
            n = max(n, int(s) + 1, int(d) + 1)
        return n

    def _tmodel(self, tmodel=None):
        if tmodel is not None:
            return tmodel
        from ..comm.topology import default_topology
        return default_topology(self._nranks_hint())

    def class_bytes(self, tmodel=None,
                    perm: Optional[List[int]] = None) -> Dict[str, int]:
        """The comm volume split by link class over the exact
        per-(src, dst) traffic matrix.  `perm` (a rank_of remap,
        perm[logical] = physical) reclasses every edge as if the pool
        ran under that mapping — the objective remap_ranks minimizes."""
        from ..comm.topology import LINK_CLASSES
        tm = self._tmodel(tmodel)
        out = {c: 0 for c in LINK_CLASSES}
        for (s, d), b in self.edges_bytes.items():
            ps = perm[s] if perm and s < len(perm) else s
            pd = perm[d] if perm and d < len(perm) else d
            out[tm.class_of(ps, pd)] += b
        return out

    def dcn_bytes(self, tmodel=None,
                  perm: Optional[List[int]] = None) -> int:
        """Predicted inter-island payload bytes (the slow-network spend
        the topo tier exists to shrink)."""
        return self.class_bytes(tmodel, perm)["dcn"]

    def coll_bytes(self) -> int:
        """Total payload bytes carried by ptc_coll_* chain edges (the
        embedded collective's share of comm_bytes())."""
        return sum(r["bytes"] for r in self.coll_edges.values())

    def coll_legs(self, tmodel=None, econ=None) -> List[dict]:
        """Classed collective legs (ptc-shard): one record per
        (src, dst) wire edge produced by a ptc_coll_* chain class,
        carrying its ptc-topo link class and the modeled wire cost
        under the per-class transfer economics —

          {"src", "dst", "cls", "bytes", "msgs", "cost_us"}

        cost_us = (msgs * alpha("rdv", cls) + bytes * beta("rdv", cls))
        in microseconds (rdv mode — coll chunks stream large segments).
        Sorted most-expensive-first, so the top row is the leg a
        topology remap or chunk-size retune should attack.  Empty when
        the pool embeds no collective."""
        if not self.coll_edges:
            return []
        tm = self._tmodel(tmodel)
        if econ is None:
            from ..comm.economics import default_economics
            econ = default_economics()
        legs = []
        for (s, d), r in sorted(self.coll_edges.items()):
            cls = tm.class_of(s, d)
            cost = (r["msgs"] * econ.alpha("rdv", cls)
                    + r["bytes"] * econ.beta("rdv", cls)) * 1e6
            legs.append({"src": s, "dst": d, "cls": cls,
                         "bytes": r["bytes"], "msgs": r["msgs"],
                         "cost_us": float(cost)})
        legs.sort(key=lambda g: -g["cost_us"])
        return legs

    def _perm_cost(self, perm: List[int], tmodel, econ) -> float:
        """Modeled wire seconds of the traffic matrix under `perm`:
        per-edge classed alpha (per message) + beta (per byte)."""
        tot = 0.0
        for (s, d), b in self.edges_bytes.items():
            if s >= len(perm) or d >= len(perm):
                continue
            cls = tmodel.class_of(perm[s], perm[d])
            if cls == "loopback":
                continue
            m = self.edges_msgs.get((s, d), 1)
            tot += (m * econ.alpha("rdv", cls) * 1e-6
                    + b * econ.beta("rdv", cls) * 1e-9)
        return tot

    def remap_ranks(self, tmodel=None, econ=None) -> List[int]:
        """Search rank_of permutations (perm[logical] = physical) that
        minimize the modeled classed wire cost of the EXACT traffic
        matrix — in practice: keep chatty logical ranks inside one ICI
        island so the DCN carries as little as possible.

        Greedy constructive seed (assign logical ranks, heaviest
        talkers first, to the island holding their traffic) followed by
        island-aware pairwise-swap refinement; the identity mapping is
        always a candidate, so the result never predicts worse than
        not remapping.  Returns the identity permutation when the
        topology is flat or no permutation helps — callers can compare
        against list(range(n)) to decide whether to install it
        (Taskpool.run(remap=...), ctx.set_rank_map)."""
        tm = self._tmodel(tmodel)
        n = max(self._nranks_hint(), tm.nranks)
        ident = list(range(n))
        if tm.n_islands <= 1 or n <= 1 or not self.edges_bytes \
                or n > tm.nranks:
            return ident
        if econ is None:
            from ..comm.economics import default_economics
            econ = default_economics()
        sym: Dict[Tuple[int, int], float] = {}
        deg = [0.0] * n
        for (s, d), b in self.edges_bytes.items():
            if s == d or s >= n or d >= n:
                continue
            k = (min(s, d), max(s, d))
            sym[k] = sym.get(k, 0.0) + b
            deg[s] += b
            deg[d] += b
        # greedy: heaviest talkers first, each into the island where
        # its already-placed traffic lives (ties: most free slots)
        slots = [list(tm.island_ranks(i)) for i in range(tm.n_islands)]
        free = [len(sl) for sl in slots]
        isl_of_logical: Dict[int, int] = {}
        assign: Dict[int, int] = {}
        for l in sorted(range(n), key=lambda x: -deg[x]):
            best_i, best_aff = -1, -1.0
            for i in range(tm.n_islands):
                if free[i] <= 0:
                    continue
                aff = sum(sym.get((min(l, o), max(l, o)), 0.0)
                          for o, oi in isl_of_logical.items() if oi == i)
                if aff > best_aff or (aff == best_aff and best_i >= 0
                                      and free[i] > free[best_i]):
                    best_i, best_aff = i, aff
            isl_of_logical[l] = best_i
            assign[l] = slots[best_i][len(slots[best_i]) - free[best_i]]
            free[best_i] -= 1
        greedy = [assign[l] for l in range(n)]

        def refine(perm: List[int]) -> Tuple[List[int], float]:
            perm = list(perm)
            cost = self._perm_cost(perm, tm, econ)
            for _ in range(2 * n):
                improved = False
                for i in range(n):
                    for j in range(i + 1, n):
                        if tm.island_of(perm[i]) == tm.island_of(perm[j]):
                            continue  # island-aware: only DCN-moving swaps
                        perm[i], perm[j] = perm[j], perm[i]
                        c = self._perm_cost(perm, tm, econ)
                        if c < cost - 1e-15:
                            cost, improved = c, True
                        else:
                            perm[i], perm[j] = perm[j], perm[i]
                if not improved:
                    break
            return perm, cost

        cand = [refine(ident), refine(greedy)]
        ident_cost = self._perm_cost(ident, tm, econ)
        best, best_cost = min(cand, key=lambda pc: pc[1])
        if best_cost >= ident_cost - 1e-15:
            return ident
        return best

    # ------------------------------------------------- spill prediction
    def predict_spills(self, cache_bytes: int, rank: int = 0,
                       device_only: bool = True) -> int:
        """Predicted spill count for running this pool on `rank` under
        a device byte budget: a greedy wave-order residency simulation
        (furthest-next-use eviction, the planner's clean-first order).
        A spill is an eviction of a datum written earlier on this rank
        and backed by a collection (dirty persistent mirror -> d2h
        write-back), exactly what device_stats counts as `spills`.
        0 when the working set fits."""
        if self.bounded:
            return 0
        key = (rank, "device" if device_only else "all")
        touch = self._touch.get(key)
        if not touch:
            return 0
        dirty_from = self._dirty_from.get(key, {})
        budget = max(0, int(cache_bytes))
        by_wave: Dict[int, List[object]] = {}
        for d, ws in touch.items():
            for w in ws:
                by_wave.setdefault(w, []).append(d)
        resident: Dict[object, int] = {}   # datum -> next-use wave (-1 end)
        used = 0
        spills = 0

        def is_dirty(d, w) -> bool:
            wrote = dirty_from.get(d)
            return (wrote is not None and wrote <= w
                    and self._persistent.get(d, False))

        for w in sorted(by_wave):
            needed = by_wave[w]
            for d in needed:
                if d not in resident:
                    used += self._datum_bytes.get(d, 0)
                ws = touch[d]
                later = [x for x in ws if x > w]
                resident[d] = later[0] if later else -1
            if used <= budget:
                continue
            # over budget: evict idle datums first (furthest next use,
            # never-again first); a dirty persistent eviction is a
            # spill (d2h write-back), a clean one is free
            needed_set = set(needed)
            order = sorted(
                (d for d in resident if d not in needed_set),
                key=lambda d: (resident[d] != -1, -resident[d]))
            for d in order:
                if used <= budget:
                    break
                used -= self._datum_bytes.get(d, 0)
                if is_dirty(d, w):
                    spills += 1
                del resident[d]
            if used <= budget:
                continue
            # the wave's own footprint exceeds the budget: execution
            # degrades to panel-cyclic within the wave — tiles cycle
            # through the cache, and every dirty one past the horizon
            # must write back at least once.  Clean-first order mirrors
            # the device's eviction preference.
            order = sorted(needed_set & set(resident),
                           key=lambda d: is_dirty(d, w))
            for d in order:
                if used <= budget:
                    break
                used -= self._datum_bytes.get(d, 0)
                if is_dirty(d, w):
                    spills += 1
                del resident[d]
        return spills

    # ------------------------------------------------------------ output
    def to_json(self) -> dict:
        return {
            "bounded": self.bounded,
            "notes": list(self.notes),
            "stats": dict(self.stats),
            "per_rank": {str(r): dict(row)
                         for r, row in self.per_rank.items()},
            "edges_bytes": {f"{s}->{d}": b
                            for (s, d), b in self.edges_bytes.items()},
            "waves": {str(r): [dict(w) for w in ws]
                      for r, ws in self.waves.items()},
            "fusability": [dict(c) for c in self.fusability],
            "fusable_waves": self.fusable_waves(),
            "chains": [dict(c) for c in self.chains],
            "chained_waves": self.chained_waves(),
            "makespan": dict(self.makespan),
            "comm": {
                "total_bytes": self.comm_bytes(),
                "eager_limit": self.eager_limit,
                "coll_bytes": self.coll_bytes(),
                "coll_edges": {f"{s}->{d}": dict(r)
                               for (s, d), r in self.coll_edges.items()},
            },
            "est_bytes": self.est_bytes(),
        }

    def wave_table(self, rank: int = 0, max_rows: int = 32) -> str:
        """Per-wave text table: tasks, classes, live bytes, and the
        fusability verdict (see `fusability` for refusal reasons)."""
        ws = self.waves.get(rank, [])
        fus = {(c["rank"], c["wave"]): c for c in self.fusability}
        lines = [f"{'wave':>5} {'tasks':>6} {'live_bytes':>12} "
                 f"{'fusable':>8}  classes"]
        for row in ws[:max_rows]:
            classes = ", ".join(f"{c}x{n}" for c, n in
                                sorted(row["classes"].items()))
            c = fus.get((rank, row["wave"]))
            verdict = ("-" if c is None
                       else "yes" if c["fusable"] else "no")
            lines.append(f"{row['wave']:>5} {row['tasks']:>6} "
                         f"{row['live_bytes']:>12} {verdict:>8}  "
                         f"{classes}")
        if len(ws) > max_rows:
            lines.append(f"  ... {len(ws) - max_rows} more wave(s)")
        return "\n".join(lines)

    def text(self, waves: bool = False) -> str:
        s = self.stats
        lines = [
            f"ptc-plan: {s.get('classes', 0)} class(es), "
            f"{s.get('instances', 0)} instance(s), "
            f"{s.get('edges', 0)} edge(s), "
            f"{s.get('waves', 0)} wave(s) "
            f"[{s.get('elapsed_ms', 0):.0f} ms]"
            + (" [SYMBOLIC: enumeration refused]" if self.bounded
               else "")]
        if self.bounded:
            peak = (self._symbolic_peak if self._symbolic_peak is not None
                    else "unbounded")
            lines.append(f"  peak residency bound (interval): {peak} B")
        for r in self.ranks():
            row = self.per_rank[r]
            lines.append(
                f"  rank {r}: {row['tasks']} task(s), "
                f"peak {row['peak_bytes']} B "
                f"(liveness floor {row['live_peak_bytes']} B"
                + (f", device {row['device_peak_bytes']} B"
                   if self.has_device_classes else "")
                + f"), comm out {row['comm_out_bytes']} B"
                f"/{row['comm_out_msgs']} msg(s) "
                f"(eager {row['eager_bytes']} B, rdv {row['rdv_bytes']} B)"
                f", work {row['work_ns'] / 1e6:.3f} ms")
        if self.fusability:
            nfus = self.fusable_waves()
            lines.append(
                f"  fusable waves: {nfus}/{len(self.fusability)} "
                "certified (homogeneous, independent, table-driven "
                "bodies, one tile signature)")
        if self.chains:
            lines.append(
                f"  chained waves: {self.chained_waves()}/"
                f"{len(self.chains)} adjacent certified pairs linked "
                "(producer wave feeds consumer wave rank-locally, "
                "matching tile signatures — multi-wave fusable)")
        m = self.makespan
        if m:
            lines.append(
                f"  makespan lower bound: {m['lower_bound_ns'] / 1e6:.3f} ms "
                f"(critical path {m['critical_path_ns'] / 1e6:.3f} ms over "
                f"{m['path_len']} task(s), work/p {m['work_ns'] / 1e6:.3f} ms; "
                f"cost model: {m['cost_source']})")
        for (sr, dr), b in sorted(self.edges_bytes.items()):
            lines.append(f"  edge {sr} -> {dr}: {b} B")
        for n in self.notes:
            lines.append(f"  note: {n}")
        if waves and not self.bounded:
            for r in self.ranks():
                lines.append(f"-- waves, rank {r}:")
                lines.append(self.wave_table(r))
        return "\n".join(lines)


# ------------------------------------------------------------- analysis
def _has_device_chore(tc) -> bool:
    return any(getattr(ch, "body_kind", None) == N.BODY_DEVICE
               for ch in getattr(tc, "chores", []))


def _chore_kinds(tc) -> List[str]:
    """Body kinds of a class, certificate-facing: "noop" / "device" /
    "pure-cb" (a Python body the author declared pure) / "opaque-cb"."""
    out = []
    for ch in getattr(tc, "chores", []):
        bk = getattr(ch, "body_kind", None)
        if bk == N.BODY_NOOP:
            out.append("noop")
        elif bk == N.BODY_DEVICE:
            out.append("device")
        elif getattr(ch, "pure", False):
            out.append("pure-cb")
        else:
            out.append("opaque-cb")
    return out


def _is_write(access: int) -> bool:
    return access in (N.FLOW_WRITE, N.FLOW_RW)


class _Analyzer:
    """One-shot concrete analysis over a concretized flow graph."""

    def __init__(self, fg: FlowGraph, cg: ConcreteGraph, plan: Plan):
        self.fg = fg
        self.cg = cg
        self.plan = plan
        self.rank_of: Dict[tuple, int] = {}
        self.wave: Dict[tuple, int] = {}
        self.datum: Dict[tuple, object] = {}   # (node, fi) -> datum key
        self.inst_set = {(cid, params)
                         for cid, plist in cg.instances.items()
                         for params in plist}
        self._locals: Dict[tuple, list] = {}
        self._unknown_rank_note = False

    def locals_of(self, node) -> list:
        l = self._locals.get(node)
        if l is None:
            cm = self.fg.classes[node[0]]
            l = self._locals[node] = cm.fill_locals(node[1])
        return l

    # --------------------------------------------------------- rank map
    def _rank(self, node) -> int:
        r = self.rank_of.get(node)
        if r is None:
            cm = self.fg.classes[node[0]]
            r = cm.rank_of_instance(self.locals_of(node))
            if r is None:
                r = 0
                if not self._unknown_rank_note:
                    self._unknown_rank_note = True
                    self.plan.notes.append(
                        f"class {cm.name}: no statically-evaluable "
                        "placement affinity; instances assumed rank 0")
            self.rank_of[node] = r
        return r

    # ------------------------------------------------------------ waves
    def compute_waves(self) -> int:
        preds: Dict[tuple, List[tuple]] = {}
        indeg: Dict[tuple, int] = {n: 0 for n in self.inst_set}
        for src, outs in self.cg.succ.items():
            for dst, _certain in outs:
                if dst in indeg:
                    indeg[dst] += 1
                    preds.setdefault(dst, []).append(src)
        ready = [n for n in self.inst_set if indeg[n] == 0]
        for n in ready:
            self.wave[n] = 0
        seen = 0
        while ready:
            n = ready.pop()
            seen += 1
            w = self.wave[n]
            for dst, _certain in self.cg.succ.get(n, ()):
                if dst not in indeg:
                    continue
                if w + 1 > self.wave.get(dst, -1):
                    self.wave[dst] = w + 1
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    ready.append(dst)
        if seen != len(self.inst_set):
            # cyclic graph (a V003 finding): park the unreached tail one
            # wave past the end so the analysis still terminates
            tail = 1 + max(self.wave.values(), default=0)
            for n in self.inst_set:
                self.wave.setdefault(n, tail)
            self.plan.notes.append(
                f"{len(self.inst_set) - seen} instance(s) sit on a "
                "dependency cycle (see ptc-verify V003); scheduled "
                "past the final wave for analysis purposes")
        return 1 + max(self.wave.values(), default=-1)

    # ------------------------------------------------------ datum chains
    def datum_of(self, node, fi) -> object:
        """Root datum of (instance, flow): the collection datum the
        version chain bottoms out in, or a per-(instance, flow)
        temporary (arena copy).  Mirrors the engine's copy flow: an In
        from Mem reads the collection datum, an In from a task reads
        the producer's output copy (recursively), a pure-output flow
        births a fresh arena copy."""
        key = (node, fi)
        memo = self.datum
        stack = [key]
        on_stack = set(stack)
        while stack:
            cur = stack[-1]
            if cur in memo:
                on_stack.discard(cur)
                stack.pop()
                continue
            cnode, cfi = cur
            cm = self.fg.classes[cnode[0]]
            di = self.cg.selected.get(cur)
            if di is None:
                memo[cur] = ("tmp", cnode, cfi)
                on_stack.discard(cur)
                stack.pop()
                continue
            info = cm._dep_info[(cfi, di)]
            if info["kind"] == "mem":
                l = self.locals_of(cnode)
                idx = tuple(fn(l) for fn in info["idx"])
                memo[cur] = ("mem", info["coll"], idx)
                on_stack.discard(cur)
                stack.pop()
                continue
            if info["kind"] != "task":  # In(None): fresh arena copy
                memo[cur] = ("tmp", cnode, cfi)
                on_stack.discard(cur)
                stack.pop()
                continue
            # task source: resolve the producer instance
            peer = self.fg.by_name.get(info["peer"])
            pfi = cm.peer_flow_index(cfi, di)
            pnode = None
            if peer is not None and pfi is not None:
                l = self.locals_of(cnode)
                try:
                    vals = tuple(fn(l) for kind, fn in info["params"]
                                 if kind == "scalar")
                    if len(vals) == len(info["params"]):
                        cand = (peer.id, vals)
                        if cand in self.inst_set:
                            pnode = cand
                except Exception:
                    pnode = None
            if pnode is None:
                memo[cur] = ("tmp", cnode, cfi)
                on_stack.discard(cur)
                stack.pop()
                continue
            parent = (pnode, pfi)
            if parent in memo:
                memo[cur] = memo[parent]
                on_stack.discard(cur)
                stack.pop()
                continue
            if parent in on_stack:  # chain cycle: break with a temp
                memo[cur] = ("tmp", cnode, cfi)
                on_stack.discard(cur)
                stack.pop()
                continue
            stack.append(parent)
            on_stack.add(parent)
        return memo[key]

    def datum_bytes(self, datum, node, fi) -> int:
        plan = self.plan
        b = plan._datum_bytes.get(datum)
        if b is not None:
            return b
        fg = self.fg
        if datum[0] == "mem":
            coll = fg.collection_objs.get(datum[1])
            b = collection_tile_bytes(coll)
            plan._persistent[datum] = True
        else:
            cm = fg.classes[datum[1][0]]
            arena = cm.flows[datum[2]].arena
            b = fg.arena_sizes.get(arena) if arena else None
            plan._persistent[datum] = False
        if b is None:
            # last resort: the consuming flow's arena, else 0 + note
            cm = fg.classes[node[0]]
            arena = cm.flows[fi].arena
            b = fg.arena_sizes.get(arena, 0) if arena else 0
            if b == 0:
                nm = (datum[1] if datum[0] == "mem"
                      else fg.classes[datum[1][0]].name)
                note = (f"payload bytes unknown for data rooted at "
                        f"{nm!r}; counted as 0")
                if note not in plan.notes:
                    plan.notes.append(note)
        plan._datum_bytes[datum] = int(b)
        return int(b)

    # -------------------------------------------------------- residency
    def run(self, cost: CostModel, eager_limit: int, workers: int):
        fg, cg, plan = self.fg, self.cg, self.plan
        n_waves = self.compute_waves()
        plan.eager_limit = eager_limit
        plan.has_device_classes = any(_has_device_chore(cm.tc)
                                      for cm in fg.classes)
        dev_cls = {cm.id for cm in fg.classes if _has_device_chore(cm.tc)}

        # (rank, scope) -> datum -> [touch waves];  scope "all"|"device"
        touch: Dict[Tuple[int, str], Dict[object, List[int]]] = {}
        dirty_from: Dict[Tuple[int, str], Dict[object, int]] = {}
        # per-rank per-wave class counts
        wave_rows: Dict[int, Dict[int, Dict[str, int]]] = {}
        work_ns: Dict[int, float] = {}
        tasks: Dict[int, int] = {}

        for node in self.inst_set:
            cid = node[0]
            cm = fg.classes[cid]
            r = self._rank(node)
            w = self.wave[node]
            tasks[r] = tasks.get(r, 0) + 1
            work_ns[r] = work_ns.get(r, 0.0) + cost.ns(cm.name)
            wr = wave_rows.setdefault(r, {}).setdefault(w, {})
            wr[cm.name] = wr.get(cm.name, 0) + 1
            scopes = [("all", True), ("device", cid in dev_cls)]
            for fi, fl in enumerate(cm.flows):
                if fl.access == N.FLOW_CTL:
                    continue
                datum = self.datum_of(node, fi)
                self.datum_bytes(datum, node, fi)
                for scope, active in scopes:
                    if not active:
                        continue
                    key = (r, scope)
                    touch.setdefault(key, {}).setdefault(
                        datum, []).append(w)
                    if _is_write(fl.access):
                        df = dirty_from.setdefault(key, {})
                        if w < df.get(datum, 1 << 60):
                            df[datum] = w

        for key, tmap in touch.items():
            for d in tmap:
                tmap[d] = sorted(set(tmap[d]))
        plan._touch = touch
        plan._dirty_from = dirty_from

        # liveness sweep per (rank, scope): interval [wmin, wmax]
        def live_curve(key) -> List[int]:
            ev = [0] * (n_waves + 1)
            for d, ws in touch.get(key, {}).items():
                b = plan._datum_bytes.get(d, 0)
                ev[ws[0]] += b
                ev[ws[-1] + 1] -= b
            out, cur = [], 0
            for w in range(n_waves):
                cur += ev[w]
                out.append(cur)
            return out

        ranks = sorted(set(tasks) | {0})
        for r in ranks:
            all_curve = live_curve((r, "all"))
            dev_curve = live_curve((r, "device"))
            total = sum(plan._datum_bytes.get(d, 0)
                        for d in touch.get((r, "all"), {}))
            dev_total = sum(plan._datum_bytes.get(d, 0)
                            for d in touch.get((r, "device"), {}))
            plan.per_rank[r] = {
                "tasks": tasks.get(r, 0),
                "work_ns": int(work_ns.get(r, 0)),
                "peak_bytes": total,
                "live_peak_bytes": max(all_curve, default=0),
                "device_peak_bytes": dev_total,
                "device_live_peak_bytes": max(dev_curve, default=0),
                "comm_out_bytes": 0, "comm_in_bytes": 0,
                "comm_out_msgs": 0, "eager_bytes": 0, "rdv_bytes": 0,
            }
            rows = []
            for w in sorted(wave_rows.get(r, {})):
                classes = wave_rows[r][w]
                rows.append({
                    "wave": w,
                    "tasks": sum(classes.values()),
                    "classes": dict(classes),
                    "homogeneous": len(classes) == 1,
                    "live_bytes": all_curve[w] if w < len(all_curve)
                    else 0,
                })
            plan.waves[r] = rows

        plan.fusability = self.certify()
        plan.chains = self.certify_chains(plan.fusability)
        fus = {(c["rank"], c["wave"]): c for c in plan.fusability}
        for r, rows in plan.waves.items():
            for row in rows:
                c = fus.get((r, row["wave"]))
                if c is not None:
                    row["fusable"] = c["fusable"]

        self._comm_volume(eager_limit)
        self._makespan(cost, workers)
        plan.stats.update({
            "classes": len(fg.classes),
            "instances": cg.nb_instances(),
            "edges": cg.nb_edges,
            "waves": n_waves,
        })

    # ---------------------------------------------------- fusability
    def certify(self) -> List[dict]:
        """Wave-fusability certificates: one explicit certify/refuse
        record per (rank, wave) — never a silent skip.

        A wave certifies (fusable=True) when it could compile into ONE
        cached executable (MPK, arXiv:2512.22219) and run its members
        in any order inside it:

          homogeneous   one task class across the wave (the executable
                        is keyed by class)
          bodies        every chore is table-driven or declared pure
                        ("noop" / "device" / "pure-cb"): an opaque
                        Python callback may read or write state the
                        fused executable cannot see
          independence  no delivery edge between two members (possible
                        only on a cycle-parked tail wave — V003), and
                        no datum written by one member while another
                        member touches it (the engine's wave order is
                        arbitrary within a wave, so such a pair is a
                        race the per-task path hides behind copies and
                        fusion would surface — V010 flags it)
          tile shapes   every member's per-flow payload signature
                        matches (one executable = one set of buffer
                        shapes)

        Structural refusals of a homogeneous wave (intra-wave
        dependency or datum conflict) also surface as verify rule
        V010; body opacity and signature mismatches are plain
        refusals — legal graphs, just not fusable."""
        fg, cg = self.fg, self.cg
        members: Dict[Tuple[int, int], List[tuple]] = {}
        for node in self.inst_set:
            members.setdefault(
                (self._rank(node), self.wave[node]), []).append(node)
        self.members = members  # reused by the chain pass
        certs: List[dict] = []
        for (r, w) in sorted(members):
            nodes = sorted(members[(r, w)])
            classes = sorted({n[0] for n in nodes})
            reasons: List[str] = []
            structural: List[str] = []
            if len(classes) > 1:
                names = sorted(fg.classes[c].name for c in classes)
                cert = {"rank": r, "wave": w, "cls": None,
                        "width": len(nodes), "homogeneous": False,
                        "claimed": False, "fusable": False,
                        "body_kinds": [], "chain_next": False,
                        "reasons": [f"heterogeneous wave "
                                    f"({', '.join(names)})"]}
                certs.append(cert)
                continue
            cm = fg.classes[classes[0]]
            kinds = _chore_kinds(cm.tc)
            claimed = bool(kinds) and all(k != "opaque-cb" for k in kinds)
            if not kinds:
                reasons.append("no body chore")
            elif not claimed:
                reasons.append(
                    "opaque body (Python callback not declared pure; "
                    "see TaskClass.body(pure=))")
            member_set = set(nodes)
            # independence: delivery edges between members (cycle tail)
            dep_pairs = 0
            for n in nodes:
                for dst, _cert in cg.succ.get(n, ()):
                    if dst in member_set:
                        dep_pairs += 1
            if dep_pairs:
                structural.append(
                    f"{dep_pairs} intra-wave dependency edge(s) "
                    "(cycle-parked tail; see V003)")
            # independence: datum conflicts + tile signatures
            touched: Dict[object, set] = {}
            written: Dict[object, set] = {}
            sigs = set()
            for n in nodes:
                sig = []
                for fi, fl in enumerate(cm.flows):
                    if fl.access == N.FLOW_CTL:
                        continue
                    datum = self.datum_of(n, fi)
                    sig.append(self.datum_bytes(datum, n, fi))
                    touched.setdefault(datum, set()).add(n)
                    if _is_write(fl.access):
                        written.setdefault(datum, set()).add(n)
                sigs.add(tuple(sig))
            conflicts = 0
            sample = None
            for datum, writers in written.items():
                others = touched.get(datum, set()) | writers
                if len(others) > 1:
                    conflicts += 1
                    if sample is None:
                        sample = datum
            if conflicts:
                nm = (f"{sample[1]}[{', '.join(str(v) for v in sample[2])}]"
                      if sample and sample[0] == "mem" else "a temporary")
                structural.append(
                    f"{conflicts} intra-wave datum conflict(s) (e.g. "
                    f"{nm} written by one member and touched by "
                    "another with no ordering between them)")
            if len(sigs) > 1:
                reasons.append(
                    f"{len(sigs)} distinct tile signatures across "
                    "members (one executable needs one buffer shape "
                    "set)")
            reasons += structural
            certs.append({
                "rank": r, "wave": w, "cls": cm.name,
                "width": len(nodes), "homogeneous": True,
                "claimed": claimed,
                "fusable": claimed and not reasons,
                "body_kinds": kinds,
                "tile_sig": sorted(sigs)[0] if len(sigs) == 1 else None,
                "chain_next": False,
                "reasons": reasons,
                "structural": bool(structural),
            })
        return certs

    # ------------------------------------------------------ wave chains
    def certify_chains(self, certs: List[dict]) -> List[dict]:
        """Chain certificates: one record per ADJACENT pair of
        individually-certified waves on one rank, proving (or refusing,
        with reasons — never silently) that the pair may compile into a
        single multi-wave executable (the MPK one-level-up step,
        arXiv:2512.22219):

          tile shapes   both waves share one tile signature (one
                        executable = one buffer shape set)
          locality      no certain producer->consumer edge of the pair
                        crosses ranks (a cross-rank edge means the
                        consumer wave cannot complete from locally
                        parked results)
          resolvable    every consumer read flow is either fed by a
                        single certain producer inside the producer
                        wave (in-program dataflow) or is a statically
                        evaluable collection read (fetchable at
                        speculation time); anything else — maybe-edges,
                        multi-source selection, arena-fresh inputs,
                        nonadjacent task sources — refuses

        A `linked` pair feeds Plan.chain_index(): the runtime
        re-validates every input against live copy versions at
        consumption, so these records can only cost a wasted
        speculation when stale, never a wrong answer."""
        fg, cg = self.fg, self.cg
        plan = self.plan
        by_rw = {(c["rank"], c["wave"]): c for c in certs}
        chains: List[dict] = []
        classes_used: Dict[str, dict] = {}

        def _use_class(cm):
            classes_used[cm.name] = {"id": cm.id,
                                     "param_slots": list(cm.range_slots)}

        for (r, w) in sorted(by_rw):
            cert = by_rw[(r, w)]
            nxt = by_rw.get((r, w + 1))
            if not cert.get("fusable") or nxt is None \
                    or not nxt.get("fusable"):
                continue  # only certified pairs get a chain verdict
            rec = {"rank": r, "wave": w, "next_wave": w + 1,
                   "cls": cert["cls"], "next_cls": nxt["cls"],
                   "width": cert["width"], "next_width": nxt["width"],
                   "linked": False, "reasons": []}
            chains.append(rec)
            if cert.get("tile_sig") != nxt.get("tile_sig"):
                rec["reasons"].append(
                    "tile-signature mismatch across the pair (one "
                    "executable needs one buffer shape set)")
                continue
            prod_nodes = set(self.members.get((r, w), ()))
            cons_nodes = self.members.get((r, w + 1), [])
            # locality: certain edges into the consumer wave must stay
            # on this rank (both directions of the pair)
            cross = 0
            for n1 in prod_nodes:
                for dst, certain in cg.succ.get(n1, ()):
                    if certain and self.wave.get(dst) == w + 1 \
                            and self._rank(dst) != r:
                        cross += 1
            if cross:
                rec["reasons"].append(
                    f"{cross} cross-rank producer->consumer edge(s)")
                continue
            lane_links: Dict[tuple, list] = {}
            fed = 0
            for n2 in cons_nodes:
                cm2 = fg.classes[n2[0]]
                l2 = self.locals_of(n2)
                ins: List[tuple] = []
                srcs: List[tuple] = []
                why = None
                for fi, fl in enumerate(cm2.flows):
                    if fl.access not in (N.FLOW_READ, N.FLOW_RW):
                        continue
                    di = cg.selected.get((n2, fi))
                    if di is None:
                        why = (f"{cm2.name} flow {fl.name}: no "
                               "statically resolvable input source")
                        break
                    info = cm2._dep_info[(fi, di)]
                    if info["kind"] == "mem":
                        try:
                            idx = tuple(fn(l2) for fn in info["idx"])
                        except Exception:
                            why = (f"{cm2.name} flow {fl.name}: "
                                   "collection index not evaluable")
                            break
                        ins.append((fl.name,
                                    ("mem", info["coll"], idx)))
                        continue
                    if info["kind"] != "task":
                        why = (f"{cm2.name} flow {fl.name}: "
                               "arena-fresh input (no producer)")
                        break
                    key = (n2, fi)
                    if cg.nmaybe.get(key, 0) \
                            or cg.ncert.get(key, 0) != 1 \
                            or not cg.src_sample.get(key):
                        why = (f"{cm2.name} flow {fl.name}: input "
                               "source not a single certain edge")
                        break
                    src, (pcid, pfi, _pdi), _c = cg.src_sample[key][0]
                    if src not in prod_nodes:
                        why = (f"{cm2.name} flow {fl.name}: producer "
                               f"{cg.node_name(src)} is not in the "
                               "adjacent wave")
                        break
                    pname = fg.classes[pcid].flows[pfi].name
                    ins.append((fl.name, ("wave", src[1], pname)))
                    srcs.append(src)
                if why is not None:
                    rec["reasons"].append(why)
                    lane_links = {}
                    break
                if not srcs:
                    rec["reasons"].append(
                        f"{cg.node_name(n2)} reads nothing from the "
                        "producer wave")
                    lane_links = {}
                    break
                fed += 1
                entry = {"cls": cm2.name, "params": n2[1], "ins": ins}
                _use_class(cm2)
                for src in sorted(set(srcs)):
                    _use_class(fg.classes[src[0]])
                    lane_links.setdefault(
                        (fg.classes[src[0]].name, src[1]),
                        []).append(entry)
            if not lane_links or fed != len(cons_nodes):
                if not rec["reasons"]:
                    rec["reasons"].append("no consumer resolved")
                continue
            rec["linked"] = True
            cert["chain_next"] = True
            rlinks = plan._chain_links.setdefault(r, {})
            for key, entries in lane_links.items():
                # a producer key never spans two wave pairs (waves
                # partition instances), so plain insert is safe
                rlinks.setdefault(key, []).extend(entries)
        plan._chain_classes.update(classes_used)
        return chains

    # ---------------------------------------------------------- comm
    def _comm_volume(self, eager_limit: int):
        fg, cg, plan = self.fg, self.cg, self.plan
        # one payload transfer per (producer instance, flow, dst rank)
        # — the wire's per-rank activation/bcast dedup — plus remote
        # collection write-backs (MSG_PUT) per (instance, dep, owner)
        for node in self.inst_set:
            cm = fg.classes[node[0]]
            src_rank = self._rank(node)
            l = self.locals_of(node)
            sent: set = set()
            for fi, fl in enumerate(cm.flows):
                is_ctl = fl.access == N.FLOW_CTL
                for di, d in enumerate(fl.deps):
                    if d.direction != 1:
                        continue
                    info = cm._dep_info[(fi, di)]
                    if info["kind"] == "none":
                        continue
                    payload = 0
                    if not is_ctl:
                        if d.dtype is not None:
                            payload = fg.datatype_bytes.get(d.dtype) or 0
                        if payload == 0:
                            datum = self.datum_of(node, fi)
                            payload = self.datum_bytes(datum, node, fi)
                    for kind, payload_t, _cert in \
                            cm.out_emissions(fi, di, l):
                        if kind == "task":
                            peer = fg.by_name.get(info["peer"])
                            dst = (peer.id, payload_t)
                            if dst not in self.inst_set:
                                continue
                            dst_rank = self._rank(dst)
                        elif kind == "mem":
                            # payload_t is the evaluated (collection,
                            # idx) — iterator-extended deps included
                            coll = fg.collection_objs.get(payload_t[0])
                            if coll is None:
                                continue
                            try:
                                dst_rank = int(coll.rank_of(*payload_t[1]))
                            except Exception:
                                continue
                        else:
                            continue
                        if dst_rank == src_rank:
                            continue
                        dedup = (fi, dst_rank) if kind == "task" \
                            else (fi, di, dst_rank, payload_t[1])
                        if dedup in sent:
                            continue
                        sent.add(dedup)
                        self._account_edge(src_rank, dst_rank, payload,
                                           eager_limit, cls=cm.name)

    def _account_edge(self, src: int, dst: int, payload: int,
                      eager_limit: int, cls: Optional[str] = None):
        plan = self.plan
        for r in (src, dst):
            if r not in plan.per_rank:
                plan.per_rank[r] = {
                    "tasks": 0, "work_ns": 0, "peak_bytes": 0,
                    "live_peak_bytes": 0, "device_peak_bytes": 0,
                    "device_live_peak_bytes": 0, "comm_out_bytes": 0,
                    "comm_in_bytes": 0, "comm_out_msgs": 0,
                    "eager_bytes": 0, "rdv_bytes": 0}
        srow, drow = plan.per_rank[src], plan.per_rank[dst]
        srow["comm_out_bytes"] += payload
        srow["comm_out_msgs"] += 1
        drow["comm_in_bytes"] += payload
        if payload <= eager_limit:
            srow["eager_bytes"] += payload
        else:
            srow["rdv_bytes"] += payload
        key = (src, dst)
        plan.edges_bytes[key] = plan.edges_bytes.get(key, 0) + payload
        plan.edges_msgs[key] = plan.edges_msgs.get(key, 0) + 1
        if cls is not None and cls.startswith("ptc_coll_"):
            row = plan.coll_edges.setdefault(key, {"bytes": 0, "msgs": 0})
            row["bytes"] += payload
            row["msgs"] += 1

    # ------------------------------------------------------- makespan
    def _makespan(self, cost: CostModel, workers: int):
        fg, cg, plan = self.fg, self.cg, self.plan
        # critical path over CERTAIN edges only: a maybe-edge may not
        # materialize at runtime, so only the certain subgraph yields a
        # sound lower bound
        dist: Dict[tuple, float] = {}
        best_pred: Dict[tuple, Optional[tuple]] = {}
        indeg: Dict[tuple, int] = {n: 0 for n in self.inst_set}
        for src, outs in cg.succ.items():
            for dst, certain in outs:
                if certain and dst in indeg:
                    indeg[dst] += 1
        ready = [n for n in self.inst_set if indeg[n] == 0]
        for n in ready:
            dist[n] = cost.ns(fg.classes[n[0]].name)
            best_pred[n] = None
        while ready:
            n = ready.pop()
            for dst, certain in cg.succ.get(n, ()):
                if not certain or dst not in indeg:
                    continue
                cand = dist[n] + cost.ns(fg.classes[dst[0]].name)
                if cand > dist.get(dst, -1.0):
                    dist[dst] = cand
                    best_pred[dst] = n
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    ready.append(dst)
        cp_ns = 0.0
        path_classes: Dict[str, float] = {}
        path_len = 0
        if dist:
            sink = max(dist, key=lambda n: dist[n])
            cp_ns = dist[sink]
            n = sink
            while n is not None:
                cname = fg.classes[n[0]].name
                path_classes[cname] = (path_classes.get(cname, 0.0)
                                       + cost.ns(cname))
                path_len += 1
                n = best_pred.get(n)
        workers = max(1, workers)
        work_bound = max(
            (row["work_ns"] / workers for row in plan.per_rank.values()),
            default=0.0)
        plan.makespan = {
            "critical_path_ns": int(cp_ns),
            "path_len": path_len,
            "path_classes_ns": {k: int(v)
                                for k, v in path_classes.items()},
            "work_ns": int(work_bound),
            "workers_per_rank": workers,
            "lower_bound_ns": int(max(cp_ns, work_bound)),
            "cost_source": cost.source,
            # the per-class ns assumptions this bound used — the
            # calibration baseline scope conformance compares the live
            # metrics p50s against (ptc-scope)
            "per_class_cost": {fg.classes[cid].name:
                               cost.ns(fg.classes[cid].name)
                               for cid in sorted({n[0]
                                                  for n in self.inst_set})},
        }


# ----------------------------------------------------- symbolic fallback
def _symbolic_plan(fg: FlowGraph, plan: Plan):
    """Interval-mode residency bound for execution spaces too large to
    enumerate: per-class instance-count bounds from the space intervals,
    touched-tile counts capped at each collection's extent.  An upper
    bound on the working set — sound for admission (never under-admits),
    explicit about what it could not bound."""
    plan.bounded = True
    total = 0
    unbounded = False
    coll_caps: Dict[str, int] = {}
    coll_touch: Dict[str, int] = {}
    tmp_bytes = 0
    for cm in fg.classes:
        ivals = cm.space_intervals()
        inst_bound = 1
        for s in cm.range_slots:
            iv = ivals.get(s)
            if iv is None:
                inst_bound = None
                break
            inst_bound *= max(0, iv[1] - iv[0] + 1)
        if inst_bound is None:
            unbounded = True
            plan.notes.append(
                f"class {cm.name}: execution-space bounds leave the "
                "affine fragment; residency bound is incomplete")
            continue
        for fi, fl in enumerate(cm.flows):
            if fl.access == N.FLOW_CTL:
                continue
            mem_colls = {d.target.collection for d in fl.deps
                         if getattr(d.target, "collection", None)}
            if mem_colls:
                for cname in mem_colls:
                    coll = fg.collection_objs.get(cname)
                    tb = collection_tile_bytes(coll) or 0
                    cap = None
                    if coll is not None and hasattr(coll, "mt") \
                            and hasattr(coll, "nt"):
                        cap = int(coll.mt) * int(coll.nt) * tb
                    elif coll is not None and hasattr(coll, "nt"):
                        cap = int(coll.nt) * tb
                    coll_touch[cname] = (coll_touch.get(cname, 0)
                                         + inst_bound * tb)
                    if cap is not None:
                        coll_caps[cname] = cap
            elif fl.arena and not any(d.direction == 0
                                      and d.target is not None
                                      for d in fl.deps):
                # pure-output arena flow: one fresh copy per instance
                # (task-rooted flows are counted at their producer)
                tmp_bytes += inst_bound * fg.arena_sizes.get(fl.arena, 0)
    for cname, b in coll_touch.items():
        cap = coll_caps.get(cname)
        total += min(b, cap) if cap is not None else b
    total += tmp_bytes
    plan._symbolic_peak = None if unbounded else int(total)
    plan.notes.append(
        "concrete enumeration refused: residency bound from interval "
        "counting; comm volume, waves and makespan unavailable (raise "
        "max_instances for exact analysis)")
    plan.stats.update({"classes": len(fg.classes), "instances": 0,
                       "edges": 0, "waves": 0})


def certify_waves(fg: FlowGraph, cg: ConcreteGraph) -> List[dict]:
    """Standalone wave-fusability certification over an already-
    concretized graph (no cost model or economics needed): the records
    `Plan.fusability` carries, computed for consumers that only need
    the certificates (the V010 verify rule).  Empty when enumeration
    was refused."""
    if cg.bounded:
        return []
    plan = Plan(fg)
    an = _Analyzer(fg, cg, plan)
    an.compute_waves()
    return an.certify()


def chain_certificates(tp, max_instances: Optional[int] = None
                       ) -> Optional[Plan]:
    """Wave + chain certification only — the device wave compiler's
    certificate-consumption entry point (no cost model, economics or
    comm analysis: a fraction of a full plan).  Returns a Plan whose
    `fusability`, `chains` and `chain_index()` are populated, or None
    when concrete enumeration was refused (the compiler then refuses
    fusion with an explicit reason, never a silent guess)."""
    from .flowgraph import extract_flowgraph
    if max_instances is None:
        from ..utils import params as _mca
        max_instances = int(_mca.get("plan.max_instances"))
    fg = extract_flowgraph(tp)
    cg = fg.concretize(max_instances=max_instances)
    if cg.bounded:
        return None
    plan = Plan(fg)
    plan.cg = cg
    an = _Analyzer(fg, cg, plan)
    an.compute_waves()
    plan.fusability = an.certify()
    plan.chains = an.certify_chains(plan.fusability)
    return plan


# ---------------------------------------------------------------- driver
def plan_graph(fg: FlowGraph, max_instances: Optional[int] = None,
               cost: Optional[CostModel] = None,
               econ=None, workers: Optional[int] = None) -> Plan:
    """Run the static resource & schedule analysis over an extracted
    flow graph.  `cost` defaults to the context's live metrics
    histograms when they carry samples, else the uniform model."""
    t0 = time.perf_counter()
    if max_instances is None:
        from ..utils import params as _mca
        max_instances = int(_mca.get("plan.max_instances"))
    plan = Plan(fg)
    ctx = fg.tp.ctx
    if cost is None:
        cost = CostModel.from_context(ctx) or CostModel()
    if workers is None:
        try:
            workers = int(ctx.nb_workers)
        except Exception:
            workers = 1
    cg = fg.concretize(max_instances=max_instances)
    plan.notes += cg.notes
    # the concretized instance DAG is kept for downstream consumers
    # (the ptc-tune schedule simulator walks its edges)
    plan.cg = cg
    if cg.bounded:
        _symbolic_plan(fg, plan)
    else:
        eager = _eager_threshold(ctx, econ)
        _Analyzer(fg, cg, plan).run(cost, eager, workers)
    plan.stats["elapsed_ms"] = (time.perf_counter() - t0) * 1e3
    return plan


def plan_taskpool(tp, max_instances: Optional[int] = None,
                  cost: Optional[CostModel] = None,
                  econ=None, workers: Optional[int] = None) -> Plan:
    """Extract + plan a Taskpool (committed or not; nothing executes)."""
    return plan_graph(extract_flowgraph(tp), max_instances=max_instances,
                      cost=cost, econ=econ, workers=workers)


def compare_critpath(plan: Plan, trace) -> dict:
    """Predicted vs *executed* critical path (profiling.critpath over a
    level-2 trace): the first-class regression signal ptc_plan --trace
    prints.  ratio < 1 means the prediction under-ran the measured path
    (expected: the bound is a lower bound)."""
    from ..profiling.critpath import critical_path
    executed = critical_path(trace)
    pred = int(plan.makespan.get("critical_path_ns", 0))
    exe = int(executed.get("total_ns", 0))
    return {
        "predicted_ns": pred,
        "executed_ns": exe,
        "ratio": round(pred / exe, 4) if exe else None,
        "predicted_path_len": plan.makespan.get("path_len", 0),
        "executed_path_len": len(executed.get("path", [])),
        "cost_source": plan.makespan.get("cost_source"),
    }


# -------------------------------------------------- fleet placement cost
def placement_cost(est_bytes: int, shared_bytes: int, queued_bytes: int,
                   active_pools: int, burn_rate: float,
                   migrate_bytes: int = 0, econ=None,
                   mem_gbps: float = 16.0,
                   migrate_cls: Optional[str] = None) -> float:
    """Modeled seconds-until-done for placing ONE request on ONE replica
    — the scalar the fleet router minimizes (serve/router.py).  Three
    legs, all in seconds so they compose with the fitted transfer
    economics:

      cold work     the bytes the replica must actually produce —
                    est_bytes minus the prefix bytes its frozen-page
                    index already holds (never below 1: the ptc-plan
                    UNKNOWN sentinel convention) — through a nominal
                    host-memory bandwidth.  Prefix locality enters the
                    score HERE, as saved bytes, commensurable with the
                    wire leg rather than an ad-hoc bonus term.
      queue         the replica's admitted-but-unfinished bytes plus a
                    per-active-pool slot cost of a QUARTER request
                    equivalent (continuous batching overlaps active
                    sequences, so an occupied slot delays a newcomer by
                    a fraction of a request, not a full one — and
                    keeping it in byte-time units means locality vs
                    occupancy trades off identically at toy and
                    production page sizes), scaled by (1 + burn_rate):
                    a replica burning its SLO budget serves its backlog
                    slower than its steady-state bandwidth suggests, so
                    pressure is super-linear.
      wire          econ.cost() of any frozen pages the router would
                    migrate to create the locality it is pricing in
                    (disaggregated prefill->decode handoff) — one
                    rendezvous transfer per bundle on today's chunked
                    pull path.  `migrate_cls` (ptc-topo link class of
                    the donor->target leg, e.g. "dcn") prices it with
                    the classed fit: a migration that wins inside an
                    island can honestly lose across islands.

    Pure arithmetic under a static model (deliberately so: deterministic
    placement tests pin tie-breaks), sharing TransferEconomics with the
    collective selector so a refit of BENCH_comm.json moves BOTH."""
    if econ is None:
        from ..comm.economics import default_economics
        econ = default_economics()
    per_byte = 1.0 / (max(float(mem_gbps), 1e-3) * (1 << 30))
    cold = max(1, int(est_bytes) - int(shared_bytes)) * per_byte
    queue = (max(0, int(queued_bytes))
             + 0.25 * max(0, int(active_pools)) * max(1, int(est_bytes))
             ) * per_byte
    queue *= 1.0 + max(0.0, float(burn_rate))
    wire = econ.cost(int(migrate_bytes), "rdv", cls=migrate_cls) \
        if migrate_bytes else 0.0
    return cold + queue + wire

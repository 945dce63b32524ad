"""Fleet front door: prefix-locality routing across Server replicas,
disaggregated prefill/decode roles, and content-hash KV page migration.

Port of parsec_tpu/serve/router.py.  One Router places requests across
N replicas (each an InferenceEngine + Server on its OWN Context / rank
group) by a scored policy over each replica's cheap `Server.advertise()`
snapshot:

  locality   the prompt's frozen-page key chain (the SAME
             ops.paged_attention.prefix_page_keys content hashes the
             engine freezes under) probed against the replica's
             advertised key digest — predicted warm bytes, computed
             WITHOUT touching the replica, and exact by construction:
             a predicted hit is precisely what acquire_prefix will map
  load       advertised occupancy (active pools, queued bytes) scaled
             by the tenant SLO burn rate — pressure is super-linear on
             a replica burning its error budget
  migration  when another replica holds pages this one lacks, the
             router prices moving them (transfer-economics wire legs)
             against prefilling them cold, and migrates when cheaper

All three legs fold into ONE scalar via analysis.plan.placement_cost
(seconds-until-done under the static model), so the policy is
deterministic and unit-pinnable: min cost wins, ties break to the
lowest replica index.  The wire legs are priced with the fitted
transfer economics (comm.economics), not with a measurement of this
card.

Role disaggregation: replicas marked role="prefill" never serve decode
traffic — prefill_then_decode() runs the compute-bound prefill there
(max_new=0: freeze pages, emit nothing), migrates the frozen pages to
the chosen decode replica (in-process here, or over the chunked wire
with comm/migrate.build_page_migration), and submits the real request
fully warm.  Because frozen page bytes are a pure function of their
content key, the disaggregated output is BIT-IDENTICAL to a
single-replica run.

Re-placement: a request still QUEUED (never past admission, so never
decoding) on a replica whose health flips (closed, or SLO burn breach —
the /healthz 503 condition) is cancelled and re-placed on a healthy
replica; the cancelled->rerouted counter pair proves nothing is
silently dropped.  A decoding sequence is NEVER re-placed.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..analysis.plan import placement_cost
from ..comm.economics import default_economics
from ..comm.migrate import migrate_keys, wanted_keys
from ..ops.paged_attention import prefix_page_keys

__all__ = ["KeyDigest", "RoutePolicy", "Replica", "FleetHandle",
           "Router"]


# ------------------------------------------------------------- digest
class KeyDigest:
    """Compact mergeable summary of a replica's frozen content keys.

    mode="set"    the exact key set — deterministic (zero false
                  positives: predicted warm length == acquire_prefix's
                  result, which the placement tests pin)
    mode="bloom"  an m-bit Bloom filter (k hashes of the hex key) —
                  constant-size for fleets whose key population
                  outgrows the advertisement; predictions become upper
                  bounds (false positives only — never false negatives,
                  so a warm page is never missed)

    Mergeable: `merge` unions two digests (set union / bitwise OR), so
    a tier of routers can fold replica digests upward."""

    def __init__(self, mode: str = "set", keys: Sequence = (),
                 m: int = 4096, k: int = 3, bits: int = 0):
        if mode not in ("set", "bloom"):
            raise ValueError(f"unknown digest mode {mode!r}")
        self.mode = mode
        self.m = int(m)
        self.k = int(k)
        self._keys = set(str(x) for x in keys) if mode == "set" else set()
        self._bits = int(bits)
        if mode == "bloom":
            for key in keys:
                self.add(key)

    def _hashes(self, key) -> List[int]:
        h = hashlib.sha1(str(key).encode()).digest()
        return [int.from_bytes(h[4 * i:4 * i + 4], "little") % self.m
                for i in range(self.k)]

    def add(self, key):
        if self.mode == "set":
            self._keys.add(str(key))
        else:
            for b in self._hashes(key):
                self._bits |= 1 << b

    def __contains__(self, key) -> bool:
        if self.mode == "set":
            return str(key) in self._keys
        return all(self._bits >> b & 1 for b in self._hashes(key))

    def __len__(self) -> int:
        return len(self._keys) if self.mode == "set" else \
            bin(self._bits).count("1")

    def predict_warm(self, keys: Sequence) -> int:
        """Longest leading run of `keys` present — the router-side twin
        of PagePool.probe (exact for mode="set")."""
        n = 0
        for key in keys:
            if key not in self:
                break
            n += 1
        return n

    def merge(self, other: "KeyDigest") -> "KeyDigest":
        if self.mode != other.mode:
            raise ValueError("cannot merge digests of different modes")
        if self.mode == "set":
            out = KeyDigest("set", self._keys | other._keys)
        else:
            if (self.m, self.k) != (other.m, other.k):
                raise ValueError("bloom digests differ in (m, k)")
            out = KeyDigest("bloom", m=self.m, k=self.k,
                            bits=self._bits | other._bits)
        return out

    def to_advert(self) -> dict:
        if self.mode == "set":
            return {"mode": "set", "n": len(self._keys),
                    "keys": sorted(self._keys)}
        return {"mode": "bloom", "m": self.m, "k": self.k,
                "bits": format(self._bits, "x")}

    @classmethod
    def from_advert(cls, advert: Optional[dict]) -> "KeyDigest":
        """Parse the Server.advertise()["prefix"] payload.  Missing or
        garbled adverts decode to an empty set digest — an unreachable
        replica just looks cold."""
        if not isinstance(advert, dict):
            return cls("set")
        if advert.get("mode") == "bloom":
            try:
                bits = int(str(advert.get("bits", "0")), 16)
            except ValueError:
                bits = 0
            return cls("bloom", m=advert.get("m", 4096),
                       k=advert.get("k", 3), bits=bits)
        return cls("set", advert.get("keys") or ())


# ------------------------------------------------------------- policy
class RoutePolicy:
    """Placement knobs.

      mem_gbps      nominal replica memory bandwidth for the cold-work
                    and queue legs of placement_cost
      migrate       price page migration into placement and perform it
                    when it wins (False: locality only counts pages
                    already local)
      digest_mode   advisory — replicas advertise "set" by default;
                    a bloom advert is parsed transparently
      replace_unhealthy
                    re-place still-queued requests off replicas whose
                    healthy() flips false
      econ          TransferEconomics for the wire legs (defaults to
                    comm.economics.default_economics(), the fitted
                    model)
      topo          TopologyModel over REPLICA INDICES (replica i is
                    "rank" i of the fleet mesh).  Migration
                    legs are priced at the (donor, target) link class,
                    so a cross-island donor pays the DCN rate and an
                    intra-island donor the ICI rate; the donor choice
                    itself minimizes the classed cost.  Defaults to
                    the PTC_MCA_comm_topology spec over the fleet size
                    (flat when unset — the pre-topo behavior)."""

    def __init__(self, mem_gbps: float = 16.0, migrate: bool = True,
                 digest_mode: str = "set",
                 replace_unhealthy: bool = True, econ=None,
                 topo=None):
        self.mem_gbps = float(mem_gbps)
        self.migrate = bool(migrate)
        self.digest_mode = digest_mode
        self.replace_unhealthy = bool(replace_unhealthy)
        self.econ = econ or default_economics()
        self.topo = topo


# ------------------------------------------------------------ replica
class Replica:
    """One fleet member: an InferenceEngine (+ its Server) on its own
    Context / rank group.  role: "mixed" (default — prefill + decode),
    "decode" (placement target), "prefill" (feeder: only prefill_warm
    jobs land here; its frozen pages migrate out)."""

    def __init__(self, engine, role: str = "mixed",
                 name: Optional[str] = None):
        if role not in ("mixed", "decode", "prefill"):
            raise ValueError(f"unknown replica role {role!r}")
        self.engine = engine
        self.role = role
        self.name = name or engine.server.name

    @property
    def server(self):
        return self.engine.server

    @property
    def pool(self):
        return self.engine.pool

    def advertise(self) -> dict:
        return self.server.advertise()


# ------------------------------------------------------------- handle
class FleetHandle:
    """One routed request across its (possibly re-placed) lifetime.
    `handle` is the CURRENT engine RequestHandle; `reroutes` counts
    re-placements (each paired with a server-side `cancelled`)."""

    __slots__ = ("prompt", "max_new", "tenant", "handle", "replica",
                 "reroutes")

    def __init__(self, prompt, max_new, tenant, handle, replica):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.tenant = tenant
        self.handle = handle
        self.replica = replica
        self.reroutes = 0

    @property
    def state(self) -> str:
        return self.handle.state

    @property
    def tokens(self):
        return self.handle.tokens

    @property
    def generated(self):
        return self.handle.generated

    @property
    def outputs(self):
        return self.handle.outputs


# -------------------------------------------------------------- router
class Router:
    """The fleet front door.  submit() scores decode-capable replicas
    and places; prefill_then_decode() runs the disaggregated handoff;
    run() drives every replica's engine loop plus the re-placement
    pump in one thread."""

    def __init__(self, replicas: Sequence, policy: Optional[RoutePolicy]
                 = None):
        self.replicas: List[Replica] = [
            r if isinstance(r, Replica) else Replica(r) for r in replicas]
        if not any(r.role != "prefill" for r in self.replicas):
            raise ValueError("fleet needs at least one decode-capable "
                             "replica")
        self.policy = policy or RoutePolicy()
        self._lock = threading.Lock()
        self._handles: List[FleetHandle] = []
        self.counters = {"placed": 0, "rerouted": 0, "reroute_failed": 0,
                         "prefill_jobs": 0, "migrated_pages": 0,
                         "migrated_bytes": 0, "migration_dups": 0}
        # register on each replica's context (deduped — replicas may
        # share one) so LiveMonitor samples carry the fleet table from
        # any replica's sink
        seen = set()
        for r in self.replicas:
            ctx = r.engine.ctx
            if id(ctx) in seen:
                continue
            seen.add(id(ctx))
            routers = getattr(ctx, "_routers", None)
            if routers is None:
                routers = ctx._routers = []
            routers.append(self)

    # ----------------------------------------------------------- scoring
    def _decode_replicas(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas)
                if r.role != "prefill"]

    def page_keys(self, prompt: Sequence[int]) -> List[str]:
        model = self.replicas[0].engine.model
        return prefix_page_keys(model.model_id, prompt, model.cfg.page)

    def score(self, prompt: Sequence[int],
              adverts: Optional[Dict[int, dict]] = None) -> List[dict]:
        """One row per decode-capable replica: the placement_cost legs,
        the predicted warm length, and the migration plan considered.
        `adverts` injects snapshots (deterministic tests); by default
        each replica is polled live.  Rows for unhealthy replicas carry
        cost=inf (never chosen while an alternative exists)."""
        keys = self.page_keys(prompt)
        model = self.replicas[0].engine.model
        P = model.cfg.page
        n_pages = (len(prompt) + P - 1) // P
        idxs = self._decode_replicas()
        snap = {}
        for i in idxs:
            snap[i] = (adverts or {}).get(i) or \
                self.replicas[i].advertise()
        digests = {i: KeyDigest.from_advert(snap[i].get("prefix"))
                   for i in idxs}
        warms = {i: digests[i].predict_warm(keys) for i in idxs}
        best_warm = max(warms.values()) if warms else 0
        topo = self.policy.topo
        if topo is None:
            from ..comm.topology import default_topology
            topo = default_topology(len(self.replicas))
        rows = []
        for i in idxs:
            ad = snap[i]
            pb = (ad.get("prefix") or {}).get("page_bytes") or \
                self.replicas[i].pool.bytes_per_page
            est = n_pages * pb
            warm = warms[i]
            extra = max(0, best_warm - warm) if self.policy.migrate \
                else 0
            row = {"replica": i, "warm": warm,
                   "healthy": bool(ad.get("healthy", True)),
                   "burn": float(ad.get("slo_burn_rate") or 0.0),
                   "migrate_pages": 0, "migrate_from": None,
                   "migrate_cls": None}
            # a replica whose controller raised admission pricing is already shedding load — fold the advertised
            # pressure into the burn leg so the fleet steers new
            # placements away BEFORE the replica's /healthz flips
            press = float(ad.get("admission_pressure") or 0.0)
            base = dict(est_bytes=est,
                        queued_bytes=int(ad.get("queued_bytes") or 0),
                        active_pools=int(ad.get("active_pools") or 0),
                        burn_rate=row["burn"] + press,
                        econ=self.policy.econ,
                        mem_gbps=self.policy.mem_gbps)
            cost = placement_cost(shared_bytes=warm * pb,
                                  migrate_bytes=0, **base)
            if extra:
                # donor candidates: any OTHER replica advertising the
                # full best_warm chain.  Each donor's leg is priced at
                # ITS link class (an intra-island donor at ici, a
                # cross-island one at dcn), and the cheapest
                # classed donor wins (ties -> lowest index).
                best_mig = None
                for j in sorted(warms):
                    if j == i or warms[j] < warm + extra:
                        continue
                    cls = topo.class_of(j, i)
                    cmig = placement_cost(
                        shared_bytes=(warm + extra) * pb,
                        migrate_bytes=extra * pb,
                        migrate_cls=cls, **base)
                    if best_mig is None or cmig < best_mig[0]:
                        best_mig = (cmig, j, cls)
                if best_mig is not None and best_mig[0] < cost:
                    cost = best_mig[0]
                    row["migrate_pages"] = extra
                    row["migrate_from"] = best_mig[1]
                    row["migrate_cls"] = best_mig[2]
            if not row["healthy"]:
                cost = float("inf")
            row["cost"] = cost
            rows.append(row)
        return rows

    # --------------------------------------------------------- placement
    def _choose(self, rows: List[dict]) -> dict:
        return min(rows, key=lambda r: (r["cost"], r["replica"]))

    def submit(self, prompt: Sequence[int], max_new: int,
               tenant: str = "default",
               adverts: Optional[Dict[int, dict]] = None) -> FleetHandle:
        """Scored placement: pick the min-cost decode-capable replica,
        perform the priced-in page migration (if it won), submit.  The
        decision lands in the chosen replica's scope registry as a
        structured "route_place" event (per-replica scores included)."""
        rows = self.score(prompt, adverts=adverts)
        best = self._choose(rows)
        rep = self.replicas[best["replica"]]
        if best["migrate_pages"] and best["migrate_from"] is not None:
            keys = self.page_keys(prompt)
            self.migrate(keys, dst=rep,
                         src=self.replicas[best["migrate_from"]])
        handle = rep.engine.submit(prompt, max_new, tenant=tenant)
        fh = FleetHandle(prompt, max_new, tenant, handle, rep)
        with self._lock:
            self._handles.append(fh)
            self.counters["placed"] += 1
        rep.engine.scope.record_event(
            "route_place", replica=best["replica"], rid=handle.rid,
            tenant=tenant, warm=best["warm"], cost=best["cost"],
            migrate_pages=best["migrate_pages"],
            scores=[{"replica": r["replica"],
                     "cost": r["cost"], "warm": r["warm"]}
                    for r in rows])
        return fh

    # --------------------------------------------------------- migration
    def migrate(self, keys: Sequence, dst: Replica,
                src: Optional[Replica] = None) -> dict:
        """Move the frozen pages `keys` the destination lacks from
        `src` (or the first other replica holding them).  Receiver-
        driven dedup: already-held keys move ZERO bytes.  In-process
        transport here; rank-group fleets run the same contract over
        the chunked wire (comm.migrate.build_page_migration)."""
        wanted = wanted_keys(dst.pool, keys)
        held = len(list(keys)) - len(wanted)
        agg = {"requested": len(list(keys)), "transferred": 0,
               "skipped_held": held, "skipped_missing": 0, "bytes": 0}
        srcs = [src] if src is not None else \
            [r for r in self.replicas if r is not dst]
        for s in srcs:
            if not wanted:
                break
            res = migrate_keys(s.pool, dst.pool, wanted)
            agg["transferred"] += res["transferred"]
            agg["skipped_held"] += res["skipped_held"]
            agg["bytes"] += res["bytes"]
            wanted = wanted_keys(dst.pool, wanted)
        agg["skipped_missing"] = len(wanted)
        with self._lock:
            self.counters["migrated_pages"] += agg["transferred"]
            self.counters["migrated_bytes"] += agg["bytes"]
            self.counters["migration_dups"] += agg["skipped_held"]
        dst.engine.scope.record_event(
            "page_migration", to=dst.name,
            transferred=agg["transferred"], bytes=agg["bytes"],
            skipped_held=agg["skipped_held"],
            skipped_missing=agg["skipped_missing"])
        return agg

    # ----------------------------------------------- disaggregated roles
    def prefill_then_decode(self, prompt: Sequence[int], max_new: int,
                            tenant: str = "default") -> FleetHandle:
        """The production fleet split: run the compute-bound prefill on
        a prefill-role replica (max_new=0 — pages freeze, nothing is
        emitted), migrate the frozen pages to the best decode replica,
        then submit the real request there — its prefill maps every
        full page warm (acquire_prefix) and only the partial tail page
        stages cold.  Frozen bytes are pure functions of their keys, so
        the output is bit-identical to an undisaggregated run.  With no
        prefill-role replica configured this degrades to submit()."""
        pres = [r for r in self.replicas if r.role == "prefill"]
        if not pres:
            return self.submit(prompt, max_new, tenant=tenant)
        pre = min(pres, key=lambda r: (r.advertise()["active_pools"]
                                       + r.advertise()["queue_depth"]))
        pre.engine.prefill_warm(prompt, tenant=tenant)
        with self._lock:
            self.counters["prefill_jobs"] += 1
        pre.engine.run(timeout_s=120.0)  # drive the warm job to freeze
        rows = [r for r in self.score(prompt)
                if r["cost"] != float("inf")]
        best = self._choose(rows or self.score(prompt))
        rep = self.replicas[best["replica"]]
        self.migrate(self.page_keys(prompt), dst=rep, src=pre)
        handle = rep.engine.submit(prompt, max_new, tenant=tenant)
        fh = FleetHandle(prompt, max_new, tenant, handle, rep)
        with self._lock:
            self._handles.append(fh)
            self.counters["placed"] += 1
        rep.engine.scope.record_event(
            "route_place", replica=best["replica"], rid=handle.rid,
            tenant=tenant, warm=best["warm"], cost=best["cost"],
            disaggregated=True, prefill_replica=pre.name)
        return fh

    # ------------------------------------------------------ re-placement
    def _pump(self) -> int:
        """Re-place still-QUEUED requests off unhealthy replicas.  A
        ticket past admission (running — i.e. prefilling or decoding)
        is NEVER touched; Server.cancel enforces that atomically, so a
        racing admission simply wins.  Every successful cancel pairs
        with a rerouted++ (or reroute_failed++ when no healthy replica
        exists — still visible, never silent)."""
        if not self.policy.replace_unhealthy:
            return 0
        moved = 0
        with self._lock:
            handles = list(self._handles)
        for fh in handles:
            ticket = fh.handle.ticket
            if ticket is None or ticket.state != "queued":
                continue
            if fh.replica.server.healthy():
                continue
            if not fh.replica.server.cancel(ticket):
                continue  # raced into running: leave it be
            fh.handle.state = "cancelled"
            fh.handle.done_t = time.monotonic()
            old = fh.replica
            rows = [r for r in self.score(fh.prompt)
                    if r["cost"] != float("inf") and
                    self.replicas[r["replica"]] is not old]
            if not rows:
                with self._lock:
                    self.counters["reroute_failed"] += 1
                old.engine.scope.record_event(
                    "route_replace_failed", rid=fh.handle.rid,
                    from_replica=old.name)
                continue
            best = self._choose(rows)
            rep = self.replicas[best["replica"]]
            fh.handle = rep.engine.submit(fh.prompt, fh.max_new,
                                          tenant=fh.tenant)
            fh.replica = rep
            fh.reroutes += 1
            moved += 1
            with self._lock:
                self.counters["rerouted"] += 1
            rep.engine.scope.record_event(
                "route_replace", rid=fh.handle.rid,
                from_replica=old.name, to_replica=rep.name,
                cost=best["cost"])
        return moved

    # ------------------------------------------------------- fleet loop
    def _busy(self) -> bool:
        return any(r.engine.pending() or r.engine._inflight
                   for r in self.replicas)

    def run(self, timeout_s: float = 120.0):
        """Drive every replica's continuous-batching loop round-robin
        (launch + reap, exactly engine.run's internals) plus the
        re-placement pump, until the whole fleet is quiescent."""
        deadline = time.monotonic() + timeout_s
        while self._busy():
            if time.monotonic() > deadline:
                raise TimeoutError("fleet loop exceeded its deadline")
            progressed = self._pump()
            for r in self.replicas:
                progressed += r.engine._launch()
                progressed += r.engine._reap()
            if not progressed:
                time.sleep(0.0005)
        for r in self.replicas:
            r.engine.run(timeout_s=max(1.0,
                                       deadline - time.monotonic()))

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Router counters + per-replica occupancy/prefix rows (the live
        sampler's fleet row)."""
        with self._lock:
            out = {"router": dict(self.counters), "replicas": {}}
        for i, r in enumerate(self.replicas):
            ad = r.advertise()
            ps = r.pool.stats()
            out["replicas"][r.name] = {
                "index": i, "role": r.role,
                "healthy": ad["healthy"],
                "active_pools": ad["active_pools"],
                "queue_depth": ad["queue_depth"],
                "slo_burn_rate": ad["slo_burn_rate"],
                "pfx_hit": ps["hit_rate"],
                "frozen_live": ps["frozen_live"],
                "imported": ps["imported"],
                "exported": ps["exported"],
                "migrated_in_bytes": ps["migrated_in_bytes"],
            }
        return out

    def close(self):
        for r in self.replicas:
            routers = getattr(r.engine.ctx, "_routers", None)
            if routers is not None and self in routers:
                routers.remove(self)
            r.engine.close()
